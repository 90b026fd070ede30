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
// Both kernels stream K and V through shared memory in 64-key tiles and
// make two passes over the keys: the first finds each row's max and sum
// of exp (online, merged across the threads that share a row with
// shuffles), the second forms the exactly normalised P, rounds it to the
// input type as the TPU kernel does, and accumulates P.V.  Recomputing
// Q.K^T costs a third more flops but makes P the reference's
// normalisation (no rescaled accumulator), so the bf16 rounding of P
// matches the plain version.  Keys past Nk in the last tile take no part
// (the TPU kernel's -1e30 mask).
//
// - f32 (attention_kernel): one block of 256 threads per (batch*head,
//   32-query tile), 8 threads per query row, FMA dot products from f32
//   tiles in shared memory.
// - bf16 (attention_tc_kernel): one block of 4 warps per (batch*head,
//   64-query tile), 16 query rows per warp held as mma A fragments;
//   Q.K^T and P.V on mma.sync.m16n8k16 with f32 accumulators, P taken
//   from the score registers as P.V's A operand, V transposed into shared
//   memory as its B operand.  Needs D a multiple of 16.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQTile = 32;         // query rows per block
constexpr int kKTile = 64;         // keys per shared-memory tile
constexpr int kLanesPerRow = 8;    // threads sharing one query row
constexpr int kMaxD = 128;
constexpr int kMaxDPerLane = kMaxD / kLanesPerRow;
constexpr int kColsPerLane = kKTile / kLanesPerRow;

size_t smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         ((size_t)kQTile * ld + 2 * (size_t)kKTile * ld +
          (size_t)kQTile * (kKTile + 1));
}

// Loads rows [k0, k0 + kKTile) of a [n, d] matrix into smem[kKTile][ld]
// zero-filling rows >= n.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int k0,
                                          int n, int d, int ld) {
  for (int i = threadIdx.x; i < kKTile * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] =
        (k0 + r < n) ? src[(size_t)(k0 + r) * d + c] : 0.f;
  }
}

// Scores of this thread's query row against its kColsPerLane key columns
// of the current tile: s[j] = (q . k_col) * scale, col = lane + 8 * j.
__device__ __forceinline__ void tile_scores(const float* qrow,
                                            const float* ks, int lane,
                                            int d, int ld, float scale,
                                            float (&s)[kColsPerLane]) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
  for (int e = 0; e < d; ++e) {
    const float qv = qrow[e];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      s[j] = fmaf(qv, ks[(lane + kLanesPerRow * j) * ld + e], s[j]);
  }
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] *= scale;
}

// Merge (m, l) with (mo, lo): running max and sum of exp(s - max).
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  const float a = (m == -INFINITY) ? 0.f : l * expf(m - mn);
  const float b = (mo == -INFINITY) ? 0.f : lo * expf(mo - mn);
  m = mn;
  l = a + b;
}

__global__ void __launch_bounds__(kThreads)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int nq, int nk, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                   // [kQTile][ld]
  float* ks = qs + kQTile * ld;       // [kKTile][ld]
  float* vs = ks + kKTile * ld;       // [kKTile][ld]
  float* ps = vs + kKTile * ld;       // [kQTile][kKTile + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const float* qh = q + (size_t)bh * nq * d;
  const float* kh = k + (size_t)bh * nk * d;
  const float* vh = v + (size_t)bh * nk * d;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;

  for (int i = threadIdx.x; i < kQTile * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    qs[r * ld + c] =
        (q0 + r < nq) ? qh[(size_t)(q0 + r) * d + c] : 0.f;
  }
  const float* qrow = qs + row * ld;
  float s[kColsPerLane];

  // Pass 1: row max and sum of exp(s - max).
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    __syncthreads();
    load_tile(ks, kh, k0, nk, d, ld);
    __syncthreads();
    tile_scores(qrow, ks, lane, d, ld, scale, s);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (k0 + lane + kLanesPerRow * j < nk) merge_stats(m, l, s[j], 1.f);
  }
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    merge_stats(m, l, mo, lo);
  }

  // Pass 2: P = exp(s - max) / sum, then P.V.
  float acc[kMaxDPerLane];
#pragma unroll
  for (int j = 0; j < kMaxDPerLane; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    __syncthreads();
    load_tile(ks, kh, k0, nk, d, ld);
    load_tile(vs, vh, k0, nk, d, ld);
    __syncthreads();
    tile_scores(qrow, ks, lane, d, ld, scale, s);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + kLanesPerRow * j;
      ps[row * (kKTile + 1) + c] = (k0 + c < nk) ? expf(s[j] - m) / l : 0.f;
    }
    __syncthreads();
    const int cols = min(kKTile, nk - k0);
    for (int c = 0; c < cols; ++c) {
      const float p = ps[row * (kKTile + 1) + c];
      const float* vrow = vs + c * ld;
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int e = lane + kLanesPerRow * j;
        if (e < d) acc[j] = fmaf(p, vrow[e], acc[j]);
      }
    }
  }

  if (q0 + row < nq) {
    float* orow = out + ((size_t)bh * nq + q0 + row) * d;
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) {
      const int e = lane + kLanesPerRow * j;
      if (e < d) orow[e] = acc[j];
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
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kQTile - 1) / kQTile, bh);
  attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
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
