// Backward of unmasked bf16 multi-head attention for training: dQ, dK and
// dV of out = softmax(q k^T * scale) v, given dO, with every score
// recomputed in tiles on the chip and none written to device memory.
//
// Replaces no TPU kernel: the JAX package differentiates its plain formula
// (mint_tpu/ops/attention.py:127-142, the custom VJP of pallas_attention),
// and so did the port's AttentionFunction until this kernel family came,
// materialising the [B, H, Nq, Nk] scores, P, dP and dS in device memory
// in several casts and passes.  ops/attention.py's
// attention_backward_reference is the plain version of this arithmetic.
//
// Arithmetic (the VJP of ops/attention.py's attention_formula, never in a
// lower precision than the formula): S = Q K^T in f32 (bf16 operands,
// wgmma's f32 accumulators), times scale; the softmax in f32 through
// each row's log-sum-exp; dP = dO V^T in f32; D = sum_j P_ij dP_ij in f32
// (the softmax backward's term); dS = P (dP - D) scale in f32.  P is
// rounded to bf16 only as the operand of dV = P^T dO, and dS only as the
// operand of dQ = dS K and dK = dS^T Q, where the formula rounds them too;
// dQ, dK and dV accumulate in f32 and are rounded once, on the store.
//
// What bounds it on an H100: the least work is 10 Nq Nk D flops a (batch,
// head) pair against 7 [N, D] tensors of traffic; at FACT's cross-modal
// call (q[32,10,360,80]) 33 GFLOP (0.034 ms at 989 TFLOP/s) and 129 MB
// (0.039 ms at 3.35 TB/s): near the ridge.  The plain VJP moved some
// 2.7 GB of scores there.  The design keeps every N x N tile in registers
// and pays for it in recomputation.  Both kernels are one warpgroup a
// block (64 rows, 16 a warp) and Hopper's wgmma on tiles that TMA lays out
// as the forward kernels' (attention_tc.cuh's TcTile: 64-column slabs
// with the 128-byte swizzle, 16-column ones with the 32-byte one): two
// tiles resident, the A operands of the block's rows, and two streamed
// through two stages on mbarriers, the B operands.  A from shared memory,
// not registers, leaves the accumulators of heads up to 128 columns
// (dK and dV: 128 registers a thread) room without spills.
//
// - rows_kernel, a block a (pair, 64 query rows): Q's and dO's tiles
//   stay while K's and V's 64-key tiles stream by, twice.  The first pass
//   forms S and dP a tile and keeps each row's running max, sum of exp
//   and sum of exp * dP (online, per thread; merged across the four
//   threads of a row at the end): the log-sum-exp and D, stored for the
//   second kernel.  The second pass forms S and dP
//   again, then P exactly normalised, dS, and dQ += dS K with dS's
//   accumulators as A fragments (wgmma's accumulator layout is its
//   A-fragment layout) and K's tile as an N-major B.
// - columns_kernel, a block a (pair, 64 keys): K's and V's tiles stay
//   while Q's and dO's 64-row tiles and their rows' statistics stream
//   by.  It forms the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//   P^T and dS^T from the statistics, and dV += P^T dO, dK += dS^T Q,
//   dO's and Q's tiles as N-major Bs.
//
// So each score is formed three times (eight N x N x D products a pair
// where the least is five), but nothing N x N leaves the chip, and no
// atomics: each output element is summed by one thread in one order, so
// the same inputs give the same bits on every call and graph replay.
// Head dims are instances of the dim rounded up to 16 (16-128), TMA's
// zeros past it.
//
// Layouts: q, k, v and dO are [B, H, N, D] views with any strides on B, H
// and N that are whole 16-byte steps, D contiguous and a multiple of 8,
// bases 16-byte aligned (the model's fused-QKV views and its merged-head
// gradient as they are: TMA addresses them, attention_tc.cuh's kTmaView);
// dQ, dK and dV are written through strides too.  ops/attention.py's
// backward_kernels takes every other layout, f32 and heads over 128 to
// the plain VJP.

#include "attention_tc.cuh"

namespace mint_attention_bwd {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: four warps of 16 rows
constexpr int kRows = 64;      // a block's query rows (rows) or keys (columns)
constexpr int kStages = 2;     // tiles of the stream in shared memory

struct Params {
  const bf16 *q, *k, *v, *dout;
  bf16 *dq, *dk, *dv;
  // [pairs, nqp] each, nqp = nq rounded up to 64 rows: each row's
  // log2-sum-exp2 of S scale log2(e), and D.
  float *lse, *delta;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  long long bh0;
  int heads, nq, nk, nqp, d;
  float scale, scale_log2;
};

// Shared memory: kStages + 1 mbarriers (the stages', the resident tiles'),
// then (1 KB aligned, the swizzle's atoms) the two resident tiles, kStages
// stages of two tiles, and (columns_kernel) each stage's statistics, two
// rows of 64 floats.
constexpr int kBarBytes = 64;

template <int D>
constexpr size_t smem_bytes() {
  return kBarBytes + 1024 +
         (size_t)(kStages + 1) * 2 * TcTile<D>::kBytes + kStages * 512;
}

struct Smem {
  uint64_t* full;      // the stages' barriers, then the resident tiles'
  uint8_t* resident;   // two tiles
  uint8_t* ring;       // kStages x two tiles
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  const uint32_t base = mint::smem_addr(raw) + kBarBytes;
  uint8_t* tiles = raw + kBarBytes + (1024 - base % 1024) % 1024;
  return {reinterpret_cast<uint64_t*>(raw), tiles,
          tiles + 2 * TcTile<D>::kBytes};
}

// A step's two score products, issued and waited for: s = A0 B0^T and
// dp = A1 B1^T, A0 and A1 the resident tiles, B0 and B1 a stage's, all
// K-major.
template <int D>
__device__ __forceinline__ void scores(const uint8_t* a, const uint8_t* b,
                                       float (&s)[32], float (&dp)[32]) {
  using T = TcTile<D>;
  mint::wgmma_fence();
  tc_scores_ss<D>(a, b, s, false);
  tc_scores_ss<D>(a + T::kBytes, b + T::kBytes, dp, false);
  mint::wgmma_commit();
  mint::wgmma_wait<0>();
}

// One thread arms `bar` for `bytes` and loads tile t of two views (maps a,
// b: their wide and narrow slabs) into dst, one after the other, by TMA.
template <int D>
__device__ __forceinline__ void load_tiles(const CUtensorMap* aw,
                                           const CUtensorMap* an,
                                           const CUtensorMap* bw,
                                           const CUtensorMap* bn,
                                           uint8_t* dst, uint64_t* bar,
                                           int t, int h, int b,
                                           uint32_t bytes) {
  using T = TcTile<D>;
  mint::mbar_expect_tx(bar, bytes);
  for (int x = 0; x < 2; ++x) {
    uint8_t* tile = dst + x * T::kBytes;
    for (int i = 0; i < T::kWide; ++i)
      mint::tma_load_4d(tile + i * T::kWideBytes, x ? bw : aw, bar, 64 * i,
                        kRows * t, h, b);
    for (int i = 0; i < T::kNarrow; ++i)
      mint::tma_load_4d(tile + T::kWide * T::kWideBytes + i * T::kNarrowBytes,
                        x ? bn : an, bar, 64 * T::kWide + 16 * i, kRows * t,
                        h, b);
  }
}

// 2^x by the SFU's ex2.approx.ftz (2 ulps, as exp2f; results below
// 2^-126 flushed to zero, 2^-inf = 0).  An H100 ran both kernels ~5%
// faster on it than on exp2f, with the same bits at the flagship's shapes.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulators of a 64 x 64 tile as bf16 A fragments of its four 16-column
// steps (x[4 n + e]: row g + 8 (e / 2), column 8 n + 2 t + e % 2).
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[kRows / 16][4]) {
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        a[j][2 * hh + r] = pack_bf16(x[4 * (2 * j + hh) + 2 * r],
                                     x[4 * (2 * j + hh) + 2 * r + 1]);
}

// dQ and the rows' statistics: a block a (pair, 64 query rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const __grid_constant__ CUtensorMap qwide,
                const __grid_constant__ CUtensorMap qnarrow,
                const __grid_constant__ CUtensorMap kwide,
                const __grid_constant__ CUtensorMap knarrow,
                const __grid_constant__ CUtensorMap vwide,
                const __grid_constant__ CUtensorMap vnarrow,
                const __grid_constant__ CUtensorMap owide,
                const __grid_constant__ CUtensorMap onarrow, const Params p) {
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);
  const long long bh = p.bh0 + blockIdx.y;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  const int row = blockIdx.x * kRows + 16 * warp + g;
  const int tiles = (p.nk + kRows - 1) / kRows, steps = 2 * tiles;
  // Step i (the first pass's tiles, then the second's) in stage i % kStages.
  auto load = [&](int i) {
    load_tiles<D>(&kwide, &knarrow, &vwide, &vnarrow,
                  sm.ring + (i % kStages) * 2 * T::kBytes,
                  sm.full + i % kStages, i < tiles ? i : i - tiles, h, b,
                  2 * T::kBytes);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) mint::mbar_init(sm.full + i, 1);
    mint::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_tiles<D>(&qwide, &qnarrow, &owide, &onarrow, sm.resident,
                  sm.full + kStages, blockIdx.x, h, b, 2 * T::kBytes);
    for (int i = 0; i < min(kStages, steps); ++i) load(i);
  }
  // Rows g (r = 0) and g + 8 (r = 1) over this thread's keys: running max,
  // sum of exp2 and sum of exp2 * dP; then the row's log2-sum-exp2 and D.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float dqw[T::kWide ? T::kWide : 1][32];
  float dqn[T::kNarrow ? T::kNarrow : 1][8];
  mint::mbar_wait_or_trap(sm.full + kStages, 0);
  for (int i = 0; i < steps; ++i) {
    const uint8_t* kt = sm.ring + (i % kStages) * 2 * T::kBytes;
    const int t = i < tiles ? i : i - tiles;
    const int valid = p.nk - kRows * t;
    mint::mbar_wait_or_trap(sm.full + i % kStages, (i / kStages) & 1);
    float s[32], dp[32];
    scores<D>(sm.resident, kt, s, dp);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      s[x] = 8 * (x / 4) + 2 * t4 + x % 2 < valid ? s[x] * p.scale_log2
                                                   : -INFINITY;
    if (i < tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          tmax = fmaxf(tmax, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
        const float mn = fmaxf(m[r], tmax);
        if (mn == -INFINITY) continue;  // no key of this thread's yet
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = exp2_ftz(s[4 * n + 2 * r + e] - mn);
            ls += pe;
            as += pe * dp[4 * n + 2 * r + e];
          }
        const float alpha = exp2_ftz(m[r] - mn);  // 0 while m[r] is -inf
        l[r] = l[r] * alpha + ls;
        a[r] = a[r] * alpha + as;
        m[r] = mn;
      }
      if (i + 1 == tiles) {
        // Merge the four threads of each row; store its statistics.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
            const float ao = __shfl_xor_sync(0xffffffffu, a[r], off);
            const float mn = fmaxf(m[r], mo);
            const float fa = m[r] == -INFINITY ? 0.f : exp2_ftz(m[r] - mn);
            const float fo = mo == -INFINITY ? 0.f : exp2_ftz(mo - mn);
            l[r] = l[r] * fa + lo * fo;
            a[r] = a[r] * fa + ao * fo;
            m[r] = mn;
          }
          a[r] /= l[r];         // D
          m[r] += log2f(l[r]);  // log2-sum-exp2
          if (t4 == 0 && row + 8 * r < p.nq) {
            p.lse[bh * p.nqp + row + 8 * r] = m[r];
            p.delta[bh * p.nqp + row + 8 * r] = a[r];
          }
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        s[x] = exp2_ftz(s[x] - m[x % 4 / 2]) * (dp[x] - a[x % 4 / 2]) *
               p.scale;
      uint32_t ds[kRows / 16][4];
      to_frags(s, ds);
      tc_pv<D>(dqw, dqn, ds, kt, valid, t > 0);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage i % kStages
    if (threadIdx.x == 0 && i + kStages < steps) load(i + kStages);
  }
  store_head<D>(dqw, dqn, p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.n, row,
                p.nq, p.d, 0, true, t4);
}

// dK and dV: a block a (pair, 64 keys).
template <int D>
__global__ void __launch_bounds__(kThreads)
    columns_kernel(const __grid_constant__ CUtensorMap qwide,
                   const __grid_constant__ CUtensorMap qnarrow,
                   const __grid_constant__ CUtensorMap kwide,
                   const __grid_constant__ CUtensorMap knarrow,
                   const __grid_constant__ CUtensorMap vwide,
                   const __grid_constant__ CUtensorMap vnarrow,
                   const __grid_constant__ CUtensorMap owide,
                   const __grid_constant__ CUtensorMap onarrow,
                   const Params p) {
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);
  float* stats =
      reinterpret_cast<float*>(sm.ring + kStages * 2 * T::kBytes);
  const long long bh = p.bh0 + blockIdx.y;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  const int key = blockIdx.x * kRows + 16 * warp + g;
  const int tiles = (p.nq + kRows - 1) / kRows;
  // Query tile i (its Q and dO tiles, its rows' log2-sum-exp2 and D) in
  // stage i % kStages.
  auto load = [&](int i) {
    uint64_t* bar = sm.full + i % kStages;
    float* st = stats + (i % kStages) * 2 * kRows;
    load_tiles<D>(&qwide, &qnarrow, &owide, &onarrow,
                  sm.ring + (i % kStages) * 2 * T::kBytes, bar, i, h, b,
                  2 * T::kBytes + 2 * kRows * sizeof(float));
    mint::bulk_load(st, p.lse + bh * p.nqp + kRows * i, kRows * 4, bar);
    mint::bulk_load(st + kRows, p.delta + bh * p.nqp + kRows * i, kRows * 4,
                    bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) mint::mbar_init(sm.full + i, 1);
    mint::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_tiles<D>(&kwide, &knarrow, &vwide, &vnarrow, sm.resident,
                  sm.full + kStages, blockIdx.x, h, b, 2 * T::kBytes);
    for (int i = 0; i < min(kStages, tiles); ++i) load(i);
  }
  float dkw[T::kWide ? T::kWide : 1][32], dvw[T::kWide ? T::kWide : 1][32];
  float dkn[T::kNarrow ? T::kNarrow : 1][8];
  float dvn[T::kNarrow ? T::kNarrow : 1][8];
  mint::mbar_wait_or_trap(sm.full + kStages, 0);
  for (int i = 0; i < tiles; ++i) {
    const uint8_t* qt = sm.ring + (i % kStages) * 2 * T::kBytes;
    const float* st = stats + (i % kStages) * 2 * kRows;
    const int valid = p.nq - kRows * i;
    mint::mbar_wait_or_trap(sm.full + i % kStages, (i / kStages) & 1);
    float s[32], dp[32];
    scores<D>(sm.resident, qt, s, dp);  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int c = 8 * (x / 4) + 2 * t4 + x % 2;
      const float pe =
          c < valid ? exp2_ftz(s[x] * p.scale_log2 - st[c]) : 0.f;
      s[x] = pe;
      dp[x] = c < valid ? pe * (dp[x] - st[kRows + c]) * p.scale : 0.f;
    }
    uint32_t fp[kRows / 16][4], fds[kRows / 16][4];
    to_frags(s, fp);
    to_frags(dp, fds);
    tc_pv<D>(dvw, dvn, fp, qt + T::kBytes, valid, i > 0);  // dV += P^T dO
    tc_pv<D>(dkw, dkn, fds, qt, valid, i > 0);             // dK += dS^T Q
    __syncthreads();  // every warp is done with stage i % kStages
    if (threadIdx.x == 0 && i + kStages < tiles) load(i + kStages);
  }
  store_head<D>(dkw, dkn, p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.n, key,
                p.nk, p.d, 0, true, t4);
  store_head<D>(dvw, dvn, p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.n, key,
                p.nk, p.d, 0, true, t4);
}

template <int D>
cudaError_t launch(const Params& base, const long long* st, int batch,
                   cudaStream_t stream) {
  // Maps of q, k, v and dO: [B, H, N, d] views by TMA (kTmaView).
  CUtensorMap maps[4][2] = {};
  const void* views[4] = {base.q, base.k, base.v, base.dout};
  const int rows[4] = {base.nq, base.nk, base.nk, base.nq};
  for (int i = 0; i < 4; ++i)
    if (!tc_maps<D>(maps[i], views[i], st + 3 * i, kTmaView, batch,
                    base.heads, rows[i], base.d))
      return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  for (const void* kernel : {(const void*)rows_kernel<D>,
                             (const void*)columns_kernel<D>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long pairs = (long long)batch * base.heads;
  const cudaError_t err = over_pairs(
      pairs, (base.nq + kRows - 1) / kRows, 1, [&](dim3 grid, long long bh0) {
        Params p = base;
        p.bh0 = bh0;
        rows_kernel<D><<<grid, kThreads, smem, stream>>>(
            maps[0][0], maps[0][1], maps[1][0], maps[1][1], maps[2][0],
            maps[2][1], maps[3][0], maps[3][1], p);
      });
  if (err != cudaSuccess) return err;
  return over_pairs(
      pairs, (base.nk + kRows - 1) / kRows, 1, [&](dim3 grid, long long bh0) {
        Params p = base;
        p.bh0 = bh0;
        columns_kernel<D><<<grid, kThreads, smem, stream>>>(
            maps[0][0], maps[0][1], maps[1][0], maps[1][1], maps[2][0],
            maps[2][1], maps[3][0], maps[3][1], p);
      });
}

}  // namespace mint_attention_bwd

// q, k, v, dout (the gradient of the output), dq, dk, dv: [B, H, N, D]
// bf16 views, strides[21] the (b, h, n) strides in elements of each in that
// order; stats: 2 * B * H * nqp floats of workspace, nqp = nq rounded up
// to 64 (the rows' statistics).  Returns cudaErrorInvalidValue for what
// the kernels do not take (D over 128 or not a multiple of 8, a base or
// stride off a 16-byte step).
extern "C" int mint_attention_bwd_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* stats, const long long* strides,
                                       int batch, int heads, int nq, int nk,
                                       int d, float scale, void* stream) {
  using namespace mint_attention_bwd;
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || d <= 0 ||
      d > kMaxD || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, dout, (const void*)dq, (const void*)dk,
                          (const void*)dv, (const void*)stats})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 21; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)batch * heads;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.nqp = (nq + kRows - 1) / kRows * kRows;
  p.lse = static_cast<float*>(stats);
  p.delta = p.lse + pairs * p.nqp;
  Strides* all[7] = {&p.sq, &p.sk, &p.sv, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 7; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.bh0 = 0;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16) {
    case 1: return (int)launch<16>(p, strides, batch, s);
    case 2: return (int)launch<32>(p, strides, batch, s);
    case 3: return (int)launch<48>(p, strides, batch, s);
    case 4: return (int)launch<64>(p, strides, batch, s);
    case 5: return (int)launch<80>(p, strides, batch, s);
    case 6: return (int)launch<96>(p, strides, batch, s);
    case 7: return (int)launch<112>(p, strides, batch, s);
    default: return (int)launch<128>(p, strides, batch, s);
  }
}
