// The resident bf16 attention schedule over kTmaPairs views and its
// launch (attention_tc.cuh's Route; csrc/attention.cu's notes describe the
// kernel): a source of its own, so that nvcc builds it beside the others
// and the flagship's instances carry none of its code.
//
// A kTmaPairs view's token rows alternate between two 16-byte phases (the
// model's fused QKV views at hidden 804 over 12 heads, D = 67: 4824-byte
// rows).  Each parity of K's and V's rows is a TMA map of its own over
// every other token, and its tiles land in shared memory as TMA writes
// them: the head o_0 columns into the even rows' tiles and o_1 = o_0 +- 4
// into the odd rows'.  No thread moves tile data; the 4 columns are made
// up in registers, where the products read them:
// - S = Q.K^T is wgmma with Q's fragments in registers (read once from
//   device memory at the even rows' frame).  The keys run the even rows'
//   tiles, then the odd rows'; between the runs every warp moves its Q
//   fragments 4 columns by shuffles (shift4), so each run's scores are
//   one wgmma chain over its tiles as they lie.
// - P.V: the odd rows' V tiles hold the head 4 columns off the even
//   rows' in N, which no descriptor can shift.  Between the runs the
//   accumulators move 4 columns by the same shuffles, once a block, and
//   the odd rows' products add to them; the output is stored from the odd
//   rows' frame.  Each run is a loop of its own with the shift between
//   them: inside one loop over both runs, ptxas serialised every wgmma of
//   the kernel (C7515: an ordinary instruction writing accumulators
//   inside their pipeline stage; 0.0977 ms against 0.0924 at
//   q[20,12,360,67] on an H100).  The odd rows' own accumulators, folded
//   in at the end, held both sums in registers (128 and spills at D = 80,
//   0.133 ms), even with the even sums parked in shared memory.
// Both passes, the exactly normalised P rounded to bf16, the tiles and
// the ring of V tiles are the flagship's (tc_resident).  One wgmma
// sequence a warpgroup, and no thread moves tile data in shared memory
// (the staged design before it did, while a product ran: ptxas
// serialised its wgmma, C7520, and the load/store units moved the odd
// rows' tiles at a third of TMA's rate on an H100).

#include "attention_tc.cuh"

namespace {

// Moves this thread's share of a fragment row of G 8-column groups
// `delta` columns along it (4: column c takes column c - 4's value; -4:
// column c + 4's), zeros shifted in at the end it leaves.  Group n holds
// columns 8 n + 2 t and 8 n + 2 t + 1 of thread t = lane % 4 in each of
// its E values (rows, or the halves of a bf16 pair), at(n, i) value i: a
// column 4 away is thread t ^ 2's, in the same group or the next, one
// shuffle a value.  Every lane of the warp calls it.
template <int G, int E, typename V, typename At>
__device__ __forceinline__ void shift4(At at, int delta) {
  const bool lo = (threadIdx.x & 2) == 0;  // t < 2
  if (delta > 0) {
#pragma unroll
    for (int n = G - 1; n >= 0; --n)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int down = n > 0 ? n - 1 : 0;
        const V send = lo ? at(n, i) : n > 0 ? at(down, i) : V(0);
        at(n, i) = __shfl_xor_sync(0xffffffffu, send, 2);
      }
  } else {
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int up = n + 1 < G ? n + 1 : n;
        const V send = lo ? (n + 1 < G ? at(up, i) : V(0)) : at(n, i);
        at(n, i) = __shfl_xor_sync(0xffffffffu, send, 2);
      }
  }
}

// Q's fragments (wgmma_rs's A: k-step kk's a[2 j + r] hold columns
// 16 kk + 8 j + 2 t and the next of row g + 8 r) moved `delta` columns.
template <int N>
__device__ __forceinline__ void shift_q(uint32_t (&qf)[N][4], int delta) {
  mint::keep(qf);
  shift4<2 * N, 2, uint32_t>(
      [&](int n, int r) -> uint32_t& { return qf[n / 2][2 * (n % 2) + r]; },
      delta);
  mint::keep(qf);
}

// Value i (rows g, g + 8 by i / 2; columns 2 t + i % 2) of 8-column
// group n of a P.V accumulator pair: the wide slabs' 8 groups each, then
// the narrow ones' 2.
template <int D>
__device__ __forceinline__ float& acc_ref(
    float (&ow)[TcTile<D>::kWide ? TcTile<D>::kWide : 1][32],
    float (&on)[TcTile<D>::kNarrow ? TcTile<D>::kNarrow : 1][8], int n,
    int i) {
  using T = TcTile<D>;
  constexpr int W = 8 * T::kWide;
  return n < W ? ow[min(n / 8, T::kWide ? T::kWide - 1 : 0)][4 * (n % 8) + i]
               : on[min(max(n - W, 0) / 2, T::kNarrow ? T::kNarrow - 1 : 0)]
                   [4 * ((n - W) & 1) + i];
}

// The P.V accumulators moved `delta` columns (shift4 over acc_ref's
// groups).
template <int D>
__device__ __forceinline__ void shift_acc(
    float (&ow)[TcTile<D>::kWide ? TcTile<D>::kWide : 1][32],
    float (&on)[TcTile<D>::kNarrow ? TcTile<D>::kNarrow : 1][8],
    int delta) {
  mint::keep(ow);
  mint::keep(on);
  shift4<D / 8, 4, float>(
      [&](int n, int i) -> float& { return acc_ref<D>(ow, on, n, i); },
      delta);
  mint::keep(ow);
  mint::keep(on);
}

// Tiles past 80 columns hold more registers a thread than the 128 that two
// blocks an SM leave; from 112 columns a block's tiles take more than half
// of the SM's shared memory at 360 keys anyway.
template <int D>
constexpr int kPairsBlocksPerSm = D > 80 ? 1 : 2;

// One block per (64 * warpgroups query rows, batch*head bh0 +
// blockIdx.y), as tc_resident's.  kwide .. vnarrow: the even rows' maps of
// K and V (wide and narrow slabs), kwide1 .. vnarrow1 the odd rows';
// kstep / vstep a head's column step in them; `lag` K's parities' lag bits
// (bit p: parity p's map based 8 bytes early, its columns 4 on), then V's.
template <int D>
__global__ void __launch_bounds__(128 * kTcMaxWgs, kPairsBlocksPerSm<D>)
    attention_tc_pairs_kernel(
        const __nv_bfloat16* __restrict__ q, Strides qs_,
        const __grid_constant__ CUtensorMap kwide,
        const __grid_constant__ CUtensorMap knarrow,
        const __grid_constant__ CUtensorMap vwide,
        const __grid_constant__ CUtensorMap vnarrow,
        const __grid_constant__ CUtensorMap kwide1,
        const __grid_constant__ CUtensorMap knarrow1,
        const __grid_constant__ CUtensorMap vwide1,
        const __grid_constant__ CUtensorMap vnarrow1, int kstep, int vstep,
        int lag, __nv_bfloat16* __restrict__ out, Strides os_, int heads,
        int nq, int nk, int d, float scale_log2, long long bh0, bool pairs) {
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* ks = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;
  // The even rows' ne keys in te tiles, then the odd rows' in `to`; a
  // tile's real keys valid_of(t).
  const int ne = (nk + 1) / 2, te = (ne + kTcKeys - 1) / kTcKeys;
  const int tiles = te + (nk - ne + kTcKeys - 1) / kTcKeys;
  const int to = tiles - te;
  auto valid_of = [&](int t) {
    return t < te ? ne - kTcKeys * t : nk - ne - kTcKeys * (t - te);
  };
  // K tile t at ks + t * T::kBytes, V tiles in a ring of kTcVStages after
  // them; K tile t completes on kbar[t], V tile t on vbar[t].
  auto ktile = [&](int t) { return ks + t * T::kBytes; };
  uint8_t* vs = ks + tiles * T::kBytes;
  uint64_t* kbar = bars;
  uint64_t* vbar = bars + tiles;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int q0 = blockIdx.x * kTcWgRows * (blockDim.x / 128);
  // The head's first column in parity par's map of an operand whose
  // parities' lag bits are `lags`; its boxes start on the 16-byte step at
  // or before it.  ko / vo: where it lies in the even rows' K and V tiles;
  // dk / dv: how far the odd rows' lie from those (4 either way).
  auto first = [&](int step, int lags, int par) {
    return 4 * (lags >> par & 1) + h * step;
  };
  const int ko = first(kstep, lag, 0) % 8;
  const int vo = first(vstep, lag >> 2, 0) % 8;
  const int dk = first(kstep, lag, 1) % 8 - ko;
  const int dv = first(vstep, lag >> 2, 1) % 8 - vo;
  // One thread starts the TMA loads: K's (v_op false) or V's tile t from
  // its parity's maps, a slab per box, a tile per mbarrier.
  const CUtensorMap *kw0 = &kwide, *kn0 = &knarrow, *vw0 = &vwide,
                    *vn0 = &vnarrow, *kw1 = &kwide1, *kn1 = &knarrow1,
                    *vw1 = &vwide1, *vn1 = &vnarrow1;
  auto load = [&](bool v_op, int t, uint8_t* dst, uint64_t* bar) {
    const bool odd = t >= te;
    const CUtensorMap* wide = v_op ? (odd ? vw1 : vw0) : (odd ? kw1 : kw0);
    const CUtensorMap* narrow = v_op ? (odd ? vn1 : vn0) : (odd ? kn1 : kn0);
    const int c0 =
        first(v_op ? vstep : kstep, v_op ? lag >> 2 : lag, odd) / 8 * 8;
    const int row = kTcKeys * (odd ? t - te : t);
    mint::mbar_expect_tx(bar, T::kBytes);
    for (int i = 0; i < T::kWide; ++i)
      mint::tma_load_4d(dst + i * T::kWideBytes, wide, bar, c0 + 64 * i, row,
                        0, b);
    for (int i = 0; i < T::kNarrow; ++i)
      mint::tma_load_4d(dst + T::kWide * T::kWideBytes + i * T::kNarrowBytes,
                        narrow, bar, c0 + 64 * T::kWide + 16 * i, row, 0, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * tiles; ++i) mint::mbar_init(bars + i, 1);
    mint::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Every K tile, then the first V tiles: pass 1 starts on key 0 while
    // the rest lands.
    for (int t = 0; t < tiles; ++t) load(false, t, ktile(t), kbar + t);
    for (int t = 0; t < min(tiles, kTcVStages); ++t)
      load(true, t, vs + t * T::kBytes, vbar + t);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  const int row = q0 + kTcWgRows * wg + 16 * warp + g;

  // Q's fragments at the even rows' K frame.
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, q + b * qs_.b + h * qs_.h, qs_.n, row, nq, d, ko, t4);
  float s[32];

  // Pass 1: max and sum of exp2(s - max) of rows g and g + 8 over this
  // thread's keys, then merged across the 4 threads of a row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  for (int t = 0; t < tiles; ++t) {
    if (t == te) shift_q(qf, dk);  // the odd rows' frame
    mint::mbar_wait_or_trap(kbar + t, 0);
    tc_scores<D>(qf, ktile(t), s);
    mint::wgmma_wait<0>();
    const int valid = valid_of(t);
    if (valid >= kTcKeys)
      tile_stats<true>(s, m, l, valid, t4, scale_log2);
    else
      tile_stats<false>(s, m, l, valid, t4, scale_log2);
  }
  row_stats(m, l, inv_l);
  if (to > 0) shift_q(qf, -dk);  // the even rows' again

  // Pass 2, a run at a time (the even rows' tiles, then the odd rows'):
  // P, then P.V (tc_pv), the first product (keys 0-15 of tile 0: always
  // valid) overwriting the accumulators; once every warpgroup is done
  // with V tile t, its ring slot takes tile t + kTcVStages.  Between the
  // runs Q and the accumulators move 4 columns, to the odd rows' K and V
  // frames, and the odd rows' products add to them.  Each run is a loop
  // of its own, the shift outside both (inside one loop over both runs,
  // ptxas serialised every wgmma of the kernel: C7515, an ordinary
  // instruction writing accumulators inside their pipeline stage).
  constexpr int kW1 = T::kWide ? T::kWide : 1;
  constexpr int kN1 = T::kNarrow ? T::kNarrow : 1;
  float ow[kW1][32], on[kN1][8];
#pragma unroll
  for (int run = 0; run < 2; ++run) {
    if (run == 1) {
      if (to == 0) break;
      shift_q(qf, dk);
      shift_acc<D>(ow, on, dv);
    }
    for (int t = run ? te : 0; t < (run ? tiles : te); ++t) {
      tc_scores<D>(qf, ktile(t), s);
      mint::wgmma_wait<0>();
      const int valid = valid_of(t);
      uint32_t a[kTcKeys / 16][4];
      if (valid >= kTcKeys)
        tile_probs<true>(s, a, m, inv_l, valid, t4, scale_log2);
      else
        tile_probs<false>(s, a, m, inv_l, valid, t4, scale_log2);
      mint::mbar_wait_or_trap(vbar + t, 0);
      tc_pv<D>(ow, on, a, vs + t % kTcVStages * T::kBytes, valid, t > 0);
      if (t + kTcVStages < tiles) {
        __syncthreads();  // every warpgroup's P.V of tile t is done
        if (threadIdx.x == 0)
          load(true, t + kTcVStages, vs + (t % kTcVStages) * T::kBytes,
               vbar + t + kTcVStages);
      }
    }
  }
  store_head<D>(ow, on, out + b * os_.b + h * os_.h, os_.n, row, nq, d,
                to > 0 ? vo + dv : vo, pairs, t4);
}

// The kTmaPairs launch; D: the tiles' width.
template <int D>
cudaError_t launch_tc_pairs(const __nv_bfloat16* q, Strides qs,
                            const void* k, const void* v, const long long* st,
                            __nv_bfloat16* out, Strides os, int batch,
                            int heads, int nq, int nk, int d,
                            float scale_log2, bool pairs,
                            cudaStream_t stream) {
  const int wgs = nq > kTcWgRows ? 2 : 1;
  const size_t smem = tc_smem_bytes(D, pair_tiles(nk));
  // Maps of K's and V's even rows (the first of each pair), then odd.
  CUtensorMap km[2][2] = {}, vm[2][2] = {};
  int klag = 0, vlag = 0;
  if (!tc_pair_maps<D>(km, klag, k, st + 3, batch, heads, nk, d) ||
      !tc_pair_maps<D>(vm, vlag, v, st + 6, batch, heads, nk, d))
    return cudaErrorInvalidValue;
  auto kernel = attention_tc_pairs_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned x = (unsigned)((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs));
  return over_pairs(
      (long long)batch * heads, x, 1, [&](dim3 grid, long long bh0) {
        kernel<<<grid, 128 * wgs, smem, stream>>>(
            q, qs, km[0][0], km[0][1], vm[0][0], vm[0][1], km[1][0],
            km[1][1], vm[1][0], vm[1][1], (int)st[4], (int)st[7],
            klag | vlag << 2, out, os, heads, nq, nk, d, scale_log2, bh0,
            pairs);
      });
}

}  // namespace

int launch_bf16_pairs(const void* q, const void* k, const void* v,
                      void* out, const long long* st, int width, int batch,
                      int heads, int nq, int nk, int d, float scale_log2,
                      bool pairs, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, os{st[9], st[10], st[11]};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (width) {
#define MINT_CASE(D)                                                        \
  case D:                                                                   \
    return (int)launch_tc_pairs<D>(qp, qs, k, v, st, o, os, batch, heads,   \
                                   nq, nk, d, scale_log2, pairs, stream);
    MINT_CASE(16)
    MINT_CASE(32)
    MINT_CASE(48)
    MINT_CASE(64)
    MINT_CASE(80)
    MINT_CASE(96)
    MINT_CASE(112)
    MINT_CASE(128)
#undef MINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
