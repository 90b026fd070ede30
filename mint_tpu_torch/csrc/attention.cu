// Unmasked multi-head attention forward: out = softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel mint_tpu/ops/attention.py::_attn_kernel
// (wrapped by pallas_attention, attention.py:72).  Same arithmetic: scores
// in f32, then scaled; max subtracted before exp; P = exp / sum cast to the
// input type before P.V; P.V accumulated in f32 and cast to the input type.
// Unlike the TPU kernel, Nq may be smaller than Nk (the decode's final
// block has 48 queries against 360 keys).
//
// What bounds it on an H100: at FACT's shapes (Nk <= 360, D = 80) one
// head's K and V are 230 KB in f32, over the 227 KB of shared memory a
// block can use, so the TPU kernel's whole-head tile does not carry over;
// the work is 4*Nq*Nk*D flops per head against (2*Nq + 2*Nk)*D elements of
// traffic, so it is compute-bound: on the f32 FMA pipes (67 TFLOP/s) for
// exact f32, on the tensor cores (989 TFLOP/s bf16) for bf16.
//
// Both kernels stream K and V through shared memory in tiles of keys
// (32 for f32, 64 for bf16).  Keys past Nk in the last tile take no part
// (the TPU kernel's -1e30 mask).
//
// - f32 (attention_kernel): exact f32 on the FMA pipes (no TF32), one
//   pass with an online softmax.  Casting P to f32 is a no-op, so nothing
//   needs the exactly normalised P before P.V: each row keeps a running
//   max and sum, and its f32 P.V accumulator is rescaled by
//   exp(old max - new max) when the max rises, then divided by the sum at
//   the end (exact up to f32 rounding).  One block per (batch*head, 16 x
//   warps query rows), up to 4 warps, each warp owning 16 rows, so no
//   reduction crosses warps and Nq = 48 takes 3 full warps.  Q sits in
//   shared memory for the whole pass; 32-key K and V tiles arrive by
//   cp.async, V(t) while the scores of tile t are computed and K(t+1)
//   during its P.V.  At D = 80 a block takes 53 KB, so four fit an SM.
//   Register micro-tiles make FMAs most of the issued instructions: for
//   the scores a lane owns 4 rows x 4 keys, fed by float4 reads along D of
//   Q and K (8 shared-memory loads per 64 FMAs); for P.V it owns 2 rows x
//   NQ float4 columns of D, fed by float4 reads of P along the keys and of
//   V along D (22 loads per 160 FMAs at D = 80).  Row strides are padded
//   so that those reads are free of bank conflicts.  FACT's D = 80 has an
//   instance of its own with every loop over D unrolled (1.4x to 1.9x as
//   fast as the general one on an H100).  At q[20,10,360,80] the work is
//   8.3 GFLOP, 0.124 ms at the 67 TFLOP/s FMA peak.
// - bf16 (attention_tc_kernel): two passes over the keys: the first finds
//   each row's max and sum of exp (online, merged across the threads that
//   share a row with shuffles), the second forms the exactly normalised
//   P, rounds it to bf16 as the TPU kernel does, and accumulates P.V.
//   Recomputing Q.K^T costs a third more flops but makes P the
//   reference's normalisation (no rescaled accumulator), so the bf16
//   rounding of P matches the plain version.  One block of 4 warps per
//   (batch*head, 64-query tile), 16 query rows per warp held as mma A
//   fragments;
//   Q.K^T and P.V on mma.sync.m16n8k16 with f32 accumulators, P taken
//   from the score registers as P.V's A operand, V transposed into shared
//   memory as its B operand.  Needs D a multiple of 16.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxD = 128;

// Merge (m, l) with (mo, lo): running max and sum of exp(s - max).
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  const float a = (m == -INFINITY) ? 0.f : l * expf(m - mn);
  const float b = (mo == -INFINITY) ? 0.f : lo * expf(mo - mn);
  m = mn;
  l = a + b;
}

// ---- f32 on the FMA pipes ------------------------------------------------

constexpr int kWarpRows = 16;  // query rows per warp
constexpr int kMaxWarps = 4;   // warps per block
constexpr int kKTile = 32;     // keys per K and V tile
constexpr int kLdP = kKTile + 4;  // P row: (stride / 4) odd, as in tile_ld

// Floats per row of a Q, K or V tile in shared memory: the head dim
// rounded up to a float4, padded so that (stride / 4) is odd: eight rows
// read at one float4 column then fall in eight different bank quads.
__host__ __device__ __forceinline__ int tile_ld(int d) {
  const int d4 = (d + 3) / 4;
  return 4 * (d4 % 2 ? d4 + 2 : d4 + 1);
}

size_t smem_bytes(int d, int warps) {
  return sizeof(float) *
         ((size_t)(kWarpRows * warps + 2 * kKTile) * tile_ld(d) +
          (size_t)warps * kWarpRows * (kLdP + 2));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Issues the copies of rows [r0, r0 + rows) of a [n, d] matrix into
// dst[rows][ld]; rows past n are zero-filled.  Columns d .. ld stay as
// they are (zeroed once by the kernel when d is not a multiple of 4).
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0, int rows,
                                          int n, int d) {
  if (d % 4 == 0) {
    const int d4 = d / 4;
    for (int i = threadIdx.x; i < rows * d4; i += blockDim.x) {
      const int r = i / d4;
      const int c = 4 * (i - r * d4);
      const bool ok = r0 + r < n;
      mint::cp_async16(dst + r * ld + c,
                       ok ? src + (size_t)(r0 + r) * d + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      const bool ok = r0 + r < n;
      mint::cp_async4(dst + r * ld + c,
                      ok ? src + (size_t)(r0 + r) * d + c : src, ok);
    }
  }
}

// One block per (batch*head, 16 * warps query rows); each warp owns 16
// rows.  NQ: float4 columns of the head dim per lane in P.V (d <= 16 NQ);
// D4: d / 4 when fixed at compile time (FACT's d = 80), else 0.
template <int NQ, int D4>
__global__ void __launch_bounds__(32 * kMaxWarps)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int nq, int nk, int d, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = tile_ld(D4 ? 4 * D4 : d);
  const int d4 = D4 ? D4 : (d + 3) / 4;
  const int dd = D4 ? 4 * D4 : d;  // d, a constant when D4 is set
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qs = reinterpret_cast<float*>(smem4);  // [16 * warps][ld]
  float* ks = qs + kWarpRows * warps * ld;      // [kKTile][ld]
  float* vs = ks + kKTile * ld;                 // [kKTile][ld]
  float* ps = vs + kKTile * ld + warp * kWarpRows * (kLdP + 2);  // [16][kLdP]
  float* alpha_s = ps + kWarpRows * kLdP;  // [16]: this tile's rescale
  float* l_s = alpha_s + kWarpRows;        // [16]: final row sums

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kWarpRows * warps;
  const float* qh = q + (size_t)bh * nq * d;
  const float* kh = k + (size_t)bh * nk * d;
  const float* vh = v + (size_t)bh * nk * d;

  if (!D4 && d % 4) {  // zero the pad columns d .. 4 d4 of Q, K and V
    const int pad = 4 * d4 - d;
    const int rows = kWarpRows * warps + 2 * kKTile;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
      qs[(i / pad) * ld + d + i % pad] = 0.f;
  }
  load_rows(qs, ld, qh, q0, kWarpRows * warps, nq, dd);
  load_rows(ks, ld, kh, 0, kKTile, nk, dd);
  mint::cp_async_commit();

  // Scores: rows sr + 4 i, keys sc + 8 j of the tile.  P.V: rows pr + 8 i,
  // head-dim float4 columns pq + 4 u.
  const int sr = lane / 8, sc = lane % 8;
  const int pr = lane / 4, pq = lane % 4;
  const float* qw = qs + (warp * kWarpRows + sr) * ld;

  float m[4], lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
  }
  float4 acc[2][NQ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < NQ; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    // K(t) has landed for every thread, and every warp is done with V(t-1).
    mint::cp_async_wait<0>();
    __syncthreads();
    load_rows(vs, ld, vh, k0, kKTile, nk, dd);  // overlaps the scores
    mint::cp_async_commit();

    constexpr int kJ = kKTile / 8;  // keys per lane
    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
    const float* kt = ks + sc * ld;
#pragma unroll
    for (int c = 0; c < 4 * d4; c += 4) {
      float4 kv[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) kv[j] = ld4(kt + 8 * j * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = ld4(qw + 4 * i * ld + c);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // Online softmax: a row's keys sit on the 8 lanes of equal sr.
    const int valid = nk - k0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        s[i][j] = (sc + 8 * j < valid) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);  // finite: key k0 is valid
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      m[i] = mn;
      float sum = 0.f;
      float* prow = ps + (sr + 4 * i) * kLdP + sc;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float p = expf(s[i][j] - mn);
        prow[8 * j] = p;
        sum += p;
      }
      lsum[i] = lsum[i] * alpha + sum;
      if (sc == 0) alpha_s[sr + 4 * i] = alpha;
    }

    // V(t) has landed, and every warp is done with K(t).
    mint::cp_async_wait<0>();
    __syncthreads();
    if (k0 + kKTile < nk) load_rows(ks, ld, kh, k0 + kKTile, kKTile, nk, dd);
    mint::cp_async_commit();  // K(t+1) overlaps P.V

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = alpha_s[pr + 8 * i];
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        acc[i][u].x *= alpha;
        acc[i][u].y *= alpha;
        acc[i][u].z *= alpha;
        acc[i][u].w *= alpha;
      }
    }
    // P is 0 past the valid keys and V's rows there are zero-filled.
    const int keys = (min(kKTile, valid) + 3) & ~3;
    const float* p0 = ps + pr * kLdP;
    const float* vt = vs + 4 * pq;
    for (int kk = 0; kk < keys; kk += 4) {
      const float4 pa = ld4(p0 + kk);
      const float4 pb = ld4(p0 + 8 * kLdP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a0 = get(pa, e), a1 = get(pb, e);
        const float* vrow = vt + (kk + e) * ld;
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
          if (pq + 4 * u < d4) {
            const float4 vv = ld4(vrow + 16 * u);
            acc[0][u].x = fmaf(a0, vv.x, acc[0][u].x);
            acc[0][u].y = fmaf(a0, vv.y, acc[0][u].y);
            acc[0][u].z = fmaf(a0, vv.z, acc[0][u].z);
            acc[0][u].w = fmaf(a0, vv.w, acc[0][u].w);
            acc[1][u].x = fmaf(a1, vv.x, acc[1][u].x);
            acc[1][u].y = fmaf(a1, vv.y, acc[1][u].y);
            acc[1][u].z = fmaf(a1, vv.z, acc[1][u].z);
            acc[1][u].w = fmaf(a1, vv.w, acc[1][u].w);
          }
        }
      }
    }
  }

  // Row sums: merge the 8 lanes of a row, hand them to the P.V layout.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lsum[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (sc == 0) l_s[sr + 4 * i] = l;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * kWarpRows + pr + 8 * i;
    if (row >= nq) continue;
    const float l = l_s[pr + 8 * i];
    float* orow = out + ((size_t)bh * nq + row) * d;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int c = 4 * (pq + 4 * u);
      if (c >= d) continue;
      const float4 o = make_float4(acc[i][u].x / l, acc[i][u].y / l,
                                   acc[i][u].z / l, acc[i][u].w / l);
      if (d % 4 == 0) {
        *reinterpret_cast<float4*>(orow + c) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) orow[c + e] = get(o, e);
      }
    }
  }
}

// ---- bf16 on tensor cores -------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcQTile = 16 * kTcWarps;    // query rows per block, 16 a warp
constexpr int kTcKTile = 64;               // keys per shared-memory tile
constexpr int kTcDSteps = kMaxD / 16;      // 16-wide steps of the head dim
constexpr int kPad = 8;                    // bf16 padding per smem row

size_t tc_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kTcQTile + kTcKTile) * (d + kPad) +
          (size_t)d * (kTcKTile + kPad));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + rows) of a [n, d] matrix into dst[rows][ld], zero past n.
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst, int ld,
                                             const __nv_bfloat16* src,
                                             int r0, int rows, int n,
                                             int d) {
  const int dv = d / 8;
  for (int i = threadIdx.x; i < rows * dv; i += kTcThreads) {
    const int r = i / dv;
    const int c = (i - r * dv) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Rows [r0, r0 + kTcKTile) of a [n, d] matrix, transposed into
// dst[d][ld], zero past n (P.V reads V as mma's column-major B operand).
__device__ __forceinline__ void tc_load_cols(__nv_bfloat16* dst, int ld,
                                             const __nv_bfloat16* src,
                                             int r0, int n, int d) {
  const int dv = d / 8;
  for (int i = threadIdx.x; i < kTcKTile * dv; i += kTcThreads) {
    const int r = i / dv;
    const int c = (i - r * dv) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = e[j];
  }
}

// Scores of this warp's 16 query rows against the tile's keys:
// s[j] is the 16x8 tile of keys [8j, 8j + 8), scaled; keys >= valid are
// -inf.  Fragment layout: s[j][0..1] row g, s[j][2..3] row g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void tc_scores(
    const uint32_t (&qf)[kTcDSteps][4], const __nv_bfloat16* ks, int ld,
    int dsteps, int g, int t, float scale, int valid,
    float (&s)[kTcKTile / 8][4]) {
#pragma unroll
  for (int j = 0; j < kTcKTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kTcDSteps; ++kk) {
    if (kk >= dsteps) break;
#pragma unroll
    for (int j = 0; j < kTcKTile / 8; ++j) {
      const __nv_bfloat16* p = ks + (8 * j + g) * ld + 16 * kk + 2 * t;
      mint::mma_bf16(s[j], qf[kk], ld32(p), ld32(p + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < kTcKTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = (8 * j + 2 * t + (e & 1) < valid) ? s[j][e] * scale
                                                  : -INFINITY;
}

__global__ void __launch_bounds__(kTcThreads)
    attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int nq, int nk,
                        int d, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = d + kPad;
  constexpr int ldv = kTcKTile + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][ld]
  __nv_bfloat16* ks = qs + kTcQTile * ld;                        // [64][ld]
  __nv_bfloat16* vt = ks + kTcKTile * ld;                        // [d][ldv]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTcQTile;
  const __nv_bfloat16* qh = q + (size_t)bh * nq * d;
  const __nv_bfloat16* kh = k + (size_t)bh * nk * d;
  const __nv_bfloat16* vh = v + (size_t)bh * nk * d;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int dsteps = d / 16;

  tc_load_rows(qs, ld, qh, q0, kTcQTile, nq, d);
  __syncthreads();
  uint32_t qf[kTcDSteps][4];
#pragma unroll
  for (int kk = 0; kk < kTcDSteps; ++kk)
    if (kk < dsteps) mint::load_a(qs, ld, 16 * warp, 16 * kk, g, t, qf[kk]);

  float s[kTcKTile / 8][4];
  // Pass 1: max and sum of exp(s - max) of rows g (r = 0) and g + 8 (r = 1)
  // over this thread's columns, then merged across the 4 threads of a row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < nk; k0 += kTcKTile) {
    __syncthreads();
    tc_load_rows(ks, ld, kh, k0, kTcKTile, nk, d);
    __syncthreads();
    tc_scores(qf, ks, ld, dsteps, g, t, scale, nk - k0, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcKTile / 8; ++j)
        tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float mn = fmaxf(m[r], tmax);
      if (mn == -INFINITY) continue;  // no valid key in this thread's columns yet
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTcKTile / 8; ++j)
        sum += expf(s[j][2 * r] - mn) + expf(s[j][2 * r + 1] - mn);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mn)) + sum;
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge_stats(m[r], l[r], mo, lo);
    }

  // Pass 2: P = exp(s - max) / sum rounded to bf16, straight from the
  // score registers into the A operand of P.V.
  float o[2 * kTcDSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kTcDSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTcKTile) {
    __syncthreads();
    tc_load_rows(ks, ld, kh, k0, kTcKTile, nk, d);
    tc_load_cols(vt, ldv, vh, k0, nk, d);
    __syncthreads();
    const int valid = nk - k0;
    tc_scores(qf, ks, ld, dsteps, g, t, scale, valid, s);
#pragma unroll
    for (int kk = 0; kk < kTcKTile / 16; ++kk) {
      if (16 * kk >= valid) break;
      // The C layout of score tiles 2kk and 2kk+1 is the A layout of one
      // 16-key step: a[0]/a[2] row g, a[1]/a[3] row g + 8.
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[2 * h + r] = pack_bf16(
              expf(s[2 * kk + h][2 * r] - m[r]) / l[r],
              expf(s[2 * kk + h][2 * r + 1] - m[r]) / l[r]);
#pragma unroll
      for (int n = 0; n < 2 * kTcDSteps; ++n) {
        if (n >= d / 8) break;
        const __nv_bfloat16* p = vt + (8 * n + g) * ldv + 16 * kk + 2 * t;
        mint::mma_bf16(o[n], a, ld32(p), ld32(p + 8));
      }
    }
  }

  const int row = q0 + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 2 * kTcDSteps; ++n) {
    if (n >= d / 8) break;
    const int col = 8 * n + 2 * t;
    if (row < nq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)bh * nq + row) * d + col) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (row + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)bh * nq + row + 8) * d + col) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || bh > 65535)
    return (int)cudaErrorInvalidValue;
  // As many 16-row warps as the query rows need, up to kMaxWarps.
  const int warps = min(kMaxWarps, (nq + kWarpRows - 1) / kWarpRows);
  const size_t smem = smem_bytes(d, warps);
  // FACT's head dim has its own instance, with every loop over D unrolled.
  auto kernel = d == 80   ? attention_kernel<5, 20>
                : d <= 80 ? attention_kernel<5, 0>
                          : attention_kernel<8, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kWarpRows * warps;
  const dim3 grid((nq + rows - 1) / rows, bh);
  kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), nq, nk, d,
      scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || d % 16 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kTcQTile - 1) / kTcQTile, bh);
  using bf16 = __nv_bfloat16;
  attention_tc_kernel<<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), nq, nk, d,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, nq, d], k and v [bh, nk, d], out [bh, nq, d]; all contiguous and
// 16-byte aligned.  f32: d <= 128.  bf16: d a multiple of 16, <= 128.
extern "C" int mint_attention_f32(const void* q, const void* k,
                                  const void* v, void* out, int bh, int nq,
                                  int nk, int d, float scale, void* stream) {
  return launch_f32(q, k, v, out, bh, nq, nk, d, scale, stream);
}

extern "C" int mint_attention_bf16(const void* q, const void* k,
                                   const void* v, void* out, int bh, int nq,
                                   int nk, int d, float scale,
                                   void* stream) {
  return launch_bf16(q, k, v, out, bh, nq, nk, d, scale, stream);
}

extern "C" const char* mint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
