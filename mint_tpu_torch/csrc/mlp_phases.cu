// The bf16 fused MLP's fc2 where W2^T's rows lie off TMA's 16-byte step
// (the tma_phases load: W2^T's row stride F no multiple of 8; F = 3070:
// rows of 6140 bytes) — gemm_tc_phases_kernel and its launch.  mlp.cu has
// the flagship's kernel, the plan and the C entry (its header says what
// bounds the MLP on an H100), mlp_routes.cu the other layouts' kernels; a
// source of its own, so that nvcc builds it beside them.
//
// Row o of W2^T starts F o % 8 columns past a 16-byte step (its base on
// one), so its rows fall into P = 8 / gcd(F, 8) phases (2, 4 or 8), row o
// in phase p = o % P at c_p = F p % 8 columns past its step.  TMA takes no
// row off a step, and the load/store units move staged rows at a third of
// TMA's rate on an H100 (the staged route, gemm_tc_any_kernel, ran this
// fc2 at about 0.34 ms against the aligned 0.079), so each phase is a TMA
// map of its own over every P-th row (2 F P bytes apart: a whole step),
// based at the step at or before its rows' first column: its tiles hold
// columns k0 - c_p .. k0 + 63 - c_p of its rows, as TMA writes them.  The
// shift is made up where the operand is in registers: the product is
// c^T = W2^T act^T, W2^T wgmma's register operand A, each thread reading
// its own rows from its phase's tile at their own c_p (the last c_p
// columns from the next k-tile's), and the activation B from shared
// memory, its tiles on TMA as the flagship's fc2 has them.  One wgmma
// sequence for every phase, no branch around it.
//
// A block: 128 of W2^T's rows (c's columns; two consumer warpgroups of 64)
// by kPhBN = 200 activation rows (c's rows; wgmma's N), a producer warp,
// a ring of 4 stages (each the activation's 64-column tile and every
// phase's tile of the same 64 map columns; one more stage of W2^T alone
// past the last k-tile where a phase spills into it).  The epilogue adds
// b2 by row and stores through shared memory, so that c's rows are
// written 16 bytes at a time; split K writes f32 sums that reduce_tc adds.
// Odd F (kOdd: c_p odd, a bf16 pair across two 4-byte words) reads the
// fragments 2 bytes at a time.

#include <algorithm>
#include <numeric>

#include "mlp_tc.cuh"
#include "wgmma.cuh"

namespace mint_mlp {
namespace {

constexpr int kPhRows = 128;         // W2^T's rows a block (c's columns)
constexpr int kPhBN = 200;           // activation rows a block (c's rows)
constexpr int kPhStages = 4;         // ring depth
constexpr int kMaxPhases = 8;
constexpr int kOutLd = kPhRows + 8;  // the epilogue's tile rows (272 bytes)
constexpr uint32_t kActBytes = kPhBN * kTcBK * 2;
constexpr uint32_t kWBytes = kPhRows * kTcBK * 2;  // P tiles of 128 / P rows
constexpr uint32_t kStageBytes = kActBytes + kWBytes;
constexpr size_t kPhSmem =
    1024 + (size_t)kPhStages * kStageBytes + 2 * kPhStages * sizeof(uint64_t);
static_assert(kActBytes % 1024 == 0 && kWBytes % (1024 * kMaxPhases) == 0,
              "tiles on the swizzle's 1 KB atoms");
static_assert((size_t)kPhBN * kOutLd * 2 <= kPhStages * kStageBytes,
              "the epilogue's tile fits the ring");

struct PhaseMaps {
  CUtensorMap m[kMaxPhases];
};

// The bf16 at column x (< 128) of row `row` of the 64-column tiles
// cur | nxt.
__device__ __forceinline__ uint32_t elem(const uint8_t* cur,
                                         const uint8_t* nxt, int row, int x) {
  return *reinterpret_cast<const uint16_t*>(
      (x < kTcBK ? cur : nxt) + swizzled(row, 2 * (x % kTcBK)));
}

// This thread's A fragments of a k-tile (wgmma_rs: rows wr and wr + dr of
// its phase's tiles; k-step kk: columns 16 kk + 2 t (+ 8) and the next),
// its rows' columns from c on in `cur` and, past 64, in `nxt` (the next
// k-tile's); columns from `live` on zeros (past K in the last k-tile,
// where `nxt` holds zeros or, past a phase's map, nothing loaded).
template <bool kOdd>
__device__ __forceinline__ void w_frags(uint32_t (&fr)[kTcBK / 16][4],
                                        const uint8_t* cur,
                                        const uint8_t* nxt, int wr, int dr,
                                        int c, int t, int live) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * kk + 2 * t + 8 * (e >> 1);
      const int row = wr + dr * (e & 1), x = c + col;
      if constexpr (kOdd) {
        const uint32_t lo = col < live ? elem(cur, nxt, row, x) : 0u;
        const uint32_t hi = col + 1 < live ? elem(cur, nxt, row, x + 1) : 0u;
        fr[kk][e] = lo | hi << 16;
      } else {  // x even: the pair is one 4-byte word of one tile
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            (x < kTcBK ? cur : nxt) + swizzled(row, 2 * (x % kTcBK)));
        fr[kk][e] = col < live ? v : 0u;
      }
    }
}

// c [m, n] = a [m, k] w [n, k]^T + bias (fc2: a the activation on TMA's
// map amap, w W2^T in `phases` phases, wmaps; ld8 its row stride % 8),
// split `split` ways over K into `part` (f32 [split, m, n]) when > 1.
template <bool kOdd>
__global__ void __launch_bounds__(kTcThreads, 1)
    gemm_tc_phases_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ PhaseMaps wmaps,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ c,
                          float* __restrict__ part, int m, int n, int k,
                          int ld8, int phases, int ldc, int split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mint::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + (1024 - raw % 1024) % 1024;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kPhStages * kStageBytes);
  uint64_t* empty = full + kPhStages;
  const int P = phases;
  const uint32_t phase_bytes = kWBytes / P;  // a phase's tile
  const int o0 = blockIdx.x * kPhRows, m0 = blockIdx.y * kPhBN;
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  const int per = (ktiles + split - 1) / split;
  const int kt0 = min(ktiles, (int)blockIdx.z * per);
  const int nt = min(ktiles, kt0 + per) - kt0;
  // Phase p's rows start c_p columns past a step, their map's columns.
  auto shift_of = [&](int p) { return ld8 * p % 8; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPhStages; ++s) {
      mint::mbar_init(full + s, 1);
      mint::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    // Stage j holds k-tile kt0 + j: the activation's tile, and each
    // phase's tile of its map columns 64 (kt0 + j) ..; stage nt W2^T's
    // alone, those of phases whose map reaches it (the columns the last
    // k-tile's rows run into).  A phase with no rows (n < P) loads none.
    if (threadIdx.x == 256 && nt > 0) {
      for (int j = 0; j <= nt; ++j) {
        const int s = j % kPhStages, x = kTcBK * (kt0 + j);
        if (j >= kPhStages)
          mint::mbar_wait_or_trap(empty + s, (j / kPhStages - 1) & 1);
        uint8_t* st = ring + s * kStageBytes;
        uint32_t bytes = j < nt ? kActBytes : 0;
#pragma unroll
        for (int p = 0; p < kMaxPhases; ++p)
          if (p < P && p < n && x < k + shift_of(p)) bytes += phase_bytes;
        mint::mbar_expect_tx(full + s, bytes);
        if (j < nt) mint::tma_load_2d(st, &amap, full + s, x, m0);
#pragma unroll
        for (int p = 0; p < kMaxPhases; ++p)
          if (p < P && p < n && x < k + shift_of(p))
            mint::tma_load_2d(st + kActBytes + p * phase_bytes, &wmaps.m[p],
                              full + s, x, o0 / P);
      }
    }
    return;
  }

  // This thread's rows r and r + 8 of the block's 128, W2^T's rows
  // o0 + r and o0 + r + 8: phase p = r % P (16-row warps and 64-row
  // warpgroups hold whole runs of the P phases), rows wr and wr + 8 / P
  // of that phase's tiles.  (Ordering the block's rows phase by phase, so
  // that a warp's lanes read 8 different rows of the swizzle, ran 2-11%
  // slower on an H100: the loads' bank conflicts are not what bounds it.)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r = 64 * wg + 16 * warp + g;
  const int p = r % P, cp = shift_of(p), wr = r / P, dr = 8 / P;
  float acc[kPhBN / 2];
#pragma unroll
  for (int i = 0; i < kPhBN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    const int s = j % kPhStages, s1 = (j + 1) % kPhStages;
    mint::mbar_wait_or_trap(full + s, (j / kPhStages) & 1);
    mint::mbar_wait_or_trap(full + s1, ((j + 1) / kPhStages) & 1);
    const uint8_t* st = ring + s * kStageBytes;
    uint32_t fr[kTcBK / 16][4];
    w_frags<kOdd>(fr, st + kActBytes + p * phase_bytes,
                  ring + s1 * kStageBytes + kActBytes + p * phase_bytes, wr,
                  dr, cp, t, k - kTcBK * (kt0 + j));
    mint::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)  // 32 bytes along the row
      mint::wgmma_rs<kPhBN, 0>(acc, fr[kk],
                               mint::smem_desc(st + 32 * kk, 16, 1024, 1));
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    // Stage j is done with (k-tile j - 1 read its first columns before).
    if (threadIdx.x % 128 == 0) mint::mbar_arrive(empty + s);
  }

  // acc[4 jj + e]: c^T's row r + 8 (e / 2) (c's column o0 + ..), column
  // 8 jj + 2 t + e % 2 (c's row m0 + ..).
  const int o_lo = o0 + r, o_hi = o0 + r + 8;
  if (split > 1) {  // split z's raw sums; reduce_tc finishes
    float* pz = part + (size_t)blockIdx.z * m * n;
#pragma unroll
    for (int jj = 0; jj < kPhBN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = e >> 1 ? o_hi : o_lo;
        const int mr = m0 + 8 * jj + 2 * t + (e & 1);
        if (o < n && mr < m) pz[(size_t)mr * n + o] = acc[4 * jj + e];
      }
    return;
  }
  const float b_lo = o_lo < n ? __bfloat162float(bias[o_lo]) : 0.f;
  const float b_hi = o_hi < n ? __bfloat162float(bias[o_hi]) : 0.f;
  mint::named_bar_sync(1, 256);  // both warpgroups' products: ring free
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
  for (int jj = 0; jj < kPhBN / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(8 * jj + 2 * t + (e & 1)) * kOutLd +
           (e >> 1 ? o_hi : o_lo) - o0] =
          __float2bfloat16_rn(acc[4 * jj + e] + (e >> 1 ? b_hi : b_lo));
  mint::named_bar_sync(1, 256);
  // c's rows m0 .., 16 units of 8 columns each, a unit a thread.
  const bool vec = reinterpret_cast<uintptr_t>(c) % 16 == 0 && ldc % 8 == 0;
  for (int u = threadIdx.x; u < kPhBN * (kPhRows / 8); u += 256) {
    const int rr = u / (kPhRows / 8), q = u % (kPhRows / 8);
    const int mr = m0 + rr, o = o0 + 8 * q;
    if (mr >= m || o >= n) continue;
    const __nv_bfloat16* src = tile + rr * kOutLd + 8 * q;
    __nv_bfloat16* dst = c + (size_t)mr * ldc + o;
    if (vec && o + 8 <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && o + i < n; ++i) dst[i] = src[i];
    }
  }
}

// The TMA maps of w [rows, k]'s phases (its base on a 16-byte step, its
// rows w.ld apart, w.ld no multiple of 8): phase p's rows p, p + P, ..
// (w.ld P elements apart: a whole step), based c_p = w.ld p % 8 columns
// before each (at the step at or before its first column), boxes of 64
// columns x 128 / P rows with the 128-byte swizzle; columns past
// k + c_p and rows past the last zeros.  false where TMA refuses one.
bool phase_maps(PhaseMaps* maps, int* phases, const Operand& w, int rows,
                int k) {
  const int P = 8 / std::gcd((int)(w.ld % 8), 8);
  *phases = P;
  if (P < 2) return false;
  for (int p = 0; p < P && p < rows; ++p) {
    const int cp = (int)(w.ld * p % 8);
    const cuuint64_t dims[2] = {(cuuint64_t)(k + cp),
                                (cuuint64_t)((rows - p + P - 1) / P)};
    const cuuint64_t strides[1] = {2ull * w.ld * P};
    const cuuint32_t box[2] = {kTcBK, (cuuint32_t)(kPhRows / P)};
    if (!mint::make_map(&maps->m[p], w.p + p * w.ld - cp, 2, dims, strides,
                        box, CU_TENSOR_MAP_SWIZZLE_128B))
      return false;
  }
  return true;
}

template <bool kOdd>
cudaError_t gemm_tc_phases(const Operand& a, const Operand& w,
                           const bf16* bias, bf16* c, int ldc, float* part,
                           int m, int n, int k, int split,
                           cudaStream_t stream) {
  CUtensorMap amap;
  PhaseMaps wmaps = {};
  int phases = 0;
  if (!tc_map(&amap, a.p, m, k, a.ld, kPhBN) ||
      !phase_maps(&wmaps, &phases, w, n, k))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc_phases_kernel<kOdd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPhSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kPhRows - 1) / kPhRows, (m + kPhBN - 1) / kPhBN,
                  split);
  gemm_tc_phases_kernel<kOdd><<<grid, kTcThreads, kPhSmem, stream>>>(
      amap, wmaps, bias, c, part, m, n, k, (int)(w.ld % 8), phases, ldc,
      split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  return reduce_tc(kActNone, part, bias, c, m, n, ldc, split, stream);
}

}  // namespace

int tc_phases_split(int m, int n, int k, int sms) {
  // Tiles of 128 of c's columns by kPhBN of its rows: tc_split's rule.
  const long long tiles =
      (long long)((n + kPhRows - 1) / kPhRows) * ((m + kPhBN - 1) / kPhBN);
  if (tiles >= sms) return 1;
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  return std::max(1, (int)std::min<long long>(
                         std::min(kMaxSplit, ktiles / 4), sms / tiles));
}

cudaError_t tc_phases_pass(int bn, const Operand& a, const Operand& w,
                           const bf16* bias, bf16* c, int ldc, float* part,
                           int m, int n, int k, int split,
                           cudaStream_t stream) {
  if (bn != kPhBN || a.load != kTma || w.load != kTmaPhases)
    return cudaErrorInvalidValue;
  return w.ld % 2 ? gemm_tc_phases<true>(a, w, bias, c, ldc, part, m, n, k,
                                         split, stream)
                  : gemm_tc_phases<false>(a, w, bias, c, ldc, part, m, n, k,
                                          split, stream);
}

}  // namespace mint_mlp
