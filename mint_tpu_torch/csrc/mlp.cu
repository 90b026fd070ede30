// Fused transformer MLP forward: out = gelu_tanh(x W1 + b1) W2 + b2.
//
// Replaces the Pallas TPU kernel mint_tpu/ops/mlp.py::_kernel (wrapped by
// _fused_mlp_fwd_2d, mlp.py:53).  Same cast points: fc1 accumulates in
// f32, bias and tanh-GELU in f32, the activation is rounded to x's type
// (mlp.py:47), fc2 accumulates in f32, b2 is added in f32, and the result
// is cast to x's type.  Like the TPU kernel, the [M, F] activation never
// reaches device memory.
//
// Weights are read in nn.Linear's layout: w1t = W1^T [F, H] and
// w2t = W2^T [O, F] (the Python wrapper takes the JAX layout [H, F],
// [F, O] and transposes its views, which is free for the model's own
// nn.Linear weights).
//
// What bounds it on an H100: the TPU kernel keeps both weight matrices
// resident in VMEM, 2*800*3072 values (9.8 MB bf16, 19.7 MB f32); a block
// here has 227 KB, so the weights are streamed from L2 (50 MB holds them)
// by every row tile.  At FACT's M (B*360 rows) the work is 4*M*H*F flops:
// compute-bound, and the f32 FMA pipes (67 TFLOP/s) are 15x slower than
// the bf16 tensor cores (989 TFLOP/s).  Hence two kernels:
//
// - bf16 (mlp_tc_kernel): tensor cores through mma.sync.m16n8k16 (f32
//   accumulate).  One block of 8 warps per 32-row tile of x; the x tile
//   sits in shared memory as bf16, and the block's [32, O] f32 output
//   accumulator lives in registers (each warp owns every 8th 8-column
//   tile, O <= 1024).  The block walks F in chunks of 64: each warp
//   computes 8 activation columns of fc1 for both 16-row halves, reading
//   its w1t rows straight from L2 as mma B fragments; bias + GELU in f32,
//   rounded to bf16, land in a shared-memory chunk; then every warp adds
//   that chunk's fc2 contribution to its accumulator tiles.  With 32 rows
//   per block the weights cross L2 M/32 times; more rows would not fit
//   the accumulator in registers.
// - f32 (mlp_kernel): the reference's scoring path must stay exact f32
//   (no TF32), so it runs on the FMA pipes: one block of 256 threads per
//   16-row tile, the x tile in shared memory transposed ([H][16], so one
//   16-byte load broadcasts four rows), the [16, O] accumulator in
//   registers (16 rows x 4 columns per thread), fc1 of each 64-column
//   chunk split over 4 slices of H and summed in shared memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                  // rows of x per block
constexpr int kChunk = 64;                 // F columns per chunk
constexpr int kSlices = kThreads / kChunk;  // fc1 split of H
constexpr int kOutPerThread = 4;           // O <= kThreads * 4
constexpr int kVec = 8;                    // elements per vector load

size_t smem_bytes(int h) {
  return sizeof(float) * ((size_t)h * kRows + kSlices * kRows * kChunk +
                          kChunk * kRows);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
  const float k = 0.7978845608028654f;
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// Eight consecutive floats at p (16-byte aligned) into o.
__device__ __forceinline__ void load8(const float* p, float (&o)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// Sixteen consecutive floats at p (16-byte aligned) into r.
__device__ __forceinline__ void load16(const float* p, float (&r)[kRows]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const float4 t = p4[i];
    r[4 * i] = t.x;
    r[4 * i + 1] = t.y;
    r[4 * i + 2] = t.z;
    r[4 * i + 3] = t.w;
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
               const float* __restrict__ b1, const float* __restrict__ w2t,
               const float* __restrict__ b2, float* __restrict__ out, int m,
               int h, int f, int o) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [h][kRows]
  float* red = xs + (size_t)h * kRows;          // [kSlices][kRows][kChunk]
  float* hs = red + kSlices * kRows * kChunk;   // [kChunk][kRows]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  for (int i = tid; i < kRows * h; i += kThreads) {
    const int r = i / h;
    const int c = i - r * h;
    xs[c * kRows + r] =
        (row0 + r < m) ? x[(size_t)(row0 + r) * h + c] : 0.f;
  }
  __syncthreads();

  float acc[kRows][kOutPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) acc[r][j] = 0.f;

  const int fl = tid % kChunk;   // fc1: this thread's column in the chunk
  const int slice = tid / kChunk;  // fc1: this thread's slice of H
  const int hv = h / kVec;
  float xr[kRows];
  float w[kVec];

  for (int c0 = 0; c0 < f; c0 += kChunk) {
    // fc1 partial sums over this thread's slice of H.
    float a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = 0.f;
    if (c0 + fl < f) {
      const float* wrow = w1t + (size_t)(c0 + fl) * h;
      for (int kv = slice; kv < hv; kv += kSlices) {
        load8(wrow + kv * kVec, w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          load16(xs + (kv * kVec + e) * kRows, xr);
#pragma unroll
          for (int r = 0; r < kRows; ++r) a[r] = fmaf(xr[r], w[e], a[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      red[(slice * kRows + r) * kChunk + fl] = a[r];
    __syncthreads();

    // Sum the slices, add b1, GELU: activation chunk.
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i - r * kChunk;
      float v = 0.f;
      if (c0 + c < f) {
        float s = 0.f;
#pragma unroll
        for (int sl = 0; sl < kSlices; ++sl)
          s += red[(sl * kRows + r) * kChunk + c];
        v = gelu_tanh(s + b1[c0 + c]);
      }
      hs[c * kRows + r] = v;
    }
    __syncthreads();

    // fc2: acc[r][j] += sum_c hs[c][r] * w2t[o_j][c0 + c].
    const int cv = min(kChunk, f - c0) / kVec;
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int oc = tid + j * kThreads;
      if (oc >= o) continue;
      const float* wrow = w2t + (size_t)oc * f + c0;
      for (int v8 = 0; v8 < cv; ++v8) {
        load8(wrow + v8 * kVec, w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          load16(hs + (v8 * kVec + e) * kRows, xr);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][j] = fmaf(xr[r], w[e], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int oc = tid + j * kThreads;
    if (oc >= o) continue;
    const float bias = b2[oc];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < m)
        out[(size_t)(row0 + r) * o + oc] = acc[r][j] + bias;
  }
}

// ---- bf16 on tensor cores -------------------------------------------------

constexpr int kTcRows = 32;       // rows of x per block: two 16-row m-tiles
constexpr int kTcWarps = kThreads / 32;
constexpr int kTcChunk = 8 * kTcWarps;  // F columns per chunk: 8 per warp
constexpr int kTcMaxTiles = 16;   // fc2 8-column tiles per warp: O <= 1024
constexpr int kTcKGroup = 5;      // fc1 k-steps whose B loads go together
constexpr int kPad = 8;           // bf16 padding per shared-memory row

size_t tc_smem_bytes(int h) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kTcRows * (h + kPad) + kTcRows * (kTcChunk + kPad));
}

// B fragment of 8 columns x 16 k from a [n, k] row-major matrix (nn.Linear
// layout): p points at row (n0 + g), column (k0 + 2 t).
__device__ __forceinline__ void load_b(const __nv_bfloat16* p, uint32_t& b0,
                                       uint32_t& b1) {
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// GELU of two fc1 sums (bias added), rounded to bf16, stored as a pair.
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v0,
                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
}

__global__ void __launch_bounds__(kThreads, 1)
    mlp_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w1t,
                  const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2t,
                  const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, int m, int h, int f,
                  int o) {
  extern __shared__ float4 smem4[];
  const int ldx = h + kPad;
  constexpr int ldh = kTcChunk + kPad;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [32][ldx]
  __nv_bfloat16* hs = xs + kTcRows * ldx;                        // [32][ldh]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row0 = blockIdx.x * kTcRows;

  const int hv = h / 8;
  for (int i = tid; i < kTcRows * hv; i += kThreads) {
    const int r = i / hv;
    const int c = (i - r * hv) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < m)
      v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * h + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
  __syncthreads();

  // acc[mt][jj]: rows 16 mt.., columns 8 (warp + kTcWarps jj)..
  float acc[2][kTcMaxTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jj = 0; jj < kTcMaxTiles; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.f;
  const int n_tiles = o / 8;
  const int ksteps = h / 16;

  for (int c0 = 0; c0 < f; c0 += kTcChunk) {
    // fc1: this warp's 8 activation columns, both 16-row halves.
    const int fcol = c0 + 8 * warp;
    if (fcol < f) {
      float h0[4] = {0.f, 0.f, 0.f, 0.f};
      float h1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* wrow = w1t + (size_t)(fcol + g) * h + 2 * t;
      for (int ks = 0; ks < ksteps; ks += kTcKGroup) {
        uint32_t b[kTcKGroup][2];
#pragma unroll
        for (int u = 0; u < kTcKGroup; ++u)
          if (ks + u < ksteps) load_b(wrow + (ks + u) * 16, b[u][0], b[u][1]);
#pragma unroll
        for (int u = 0; u < kTcKGroup; ++u) {
          if (ks + u < ksteps) {
            uint32_t a[4];
            mint::load_a(xs, ldx, 0, (ks + u) * 16, g, t, a);
            mint::mma_bf16(h0, a, b[u][0], b[u][1]);
            mint::load_a(xs, ldx, 16, (ks + u) * 16, g, t, a);
            mint::mma_bf16(h1, a, b[u][0], b[u][1]);
          }
        }
      }
      // + b1, GELU in f32, rounded to bf16 (mlp.py:47).
      const int col = 8 * warp + 2 * t;
      const float bias0 = __bfloat162float(b1[c0 + col]);
      const float bias1 = __bfloat162float(b1[c0 + col + 1]);
      __nv_bfloat16* hrow = hs + g * ldh + col;
      store_act(hrow, h0[0] + bias0, h0[1] + bias1);
      store_act(hrow + 8 * ldh, h0[2] + bias0, h0[3] + bias1);
      store_act(hrow + 16 * ldh, h1[0] + bias0, h1[1] + bias1);
      store_act(hrow + 24 * ldh, h1[2] + bias0, h1[3] + bias1);
    }
    __syncthreads();

    // fc2: acc += activation chunk . w2t[:, c0 : c0 + kc]^T.
    const int kc = min(kTcChunk, f - c0);
    for (int k0 = 0; k0 < kc; k0 += 16) {
      uint32_t a0[4], a1[4];
      mint::load_a(hs, ldh, 0, k0, g, t, a0);
      mint::load_a(hs, ldh, 16, k0, g, t, a1);
      uint32_t b[kTcMaxTiles][2];
#pragma unroll
      for (int jj = 0; jj < kTcMaxTiles; ++jj) {
        const int j = warp + kTcWarps * jj;
        if (j < n_tiles)
          load_b(w2t + (size_t)(8 * j + g) * f + c0 + k0 + 2 * t, b[jj][0],
                 b[jj][1]);
      }
#pragma unroll
      for (int jj = 0; jj < kTcMaxTiles; ++jj) {
        if (warp + kTcWarps * jj < n_tiles) {
          mint::mma_bf16(acc[0][jj], a0, b[jj][0], b[jj][1]);
          mint::mma_bf16(acc[1][jj], a1, b[jj][0], b[jj][1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jj = 0; jj < kTcMaxTiles; ++jj) {
    const int j = warp + kTcWarps * jj;
    if (j >= n_tiles) continue;
    const int col = 8 * j + 2 * t;
    const float bias0 = __bfloat162float(b2[col]);
    const float bias1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * mt + 8 * half + g;
        if (row < m)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * o + col) =
              __floats2bfloat162_rn(acc[mt][jj][2 * half] + bias0,
                                    acc[mt][jj][2 * half + 1] + bias1);
      }
  }
}

int launch_f32(const void* x, const void* w1t, const void* b1,
               const void* w2t, const void* b2, void* out, int m, int h,
               int f, int o, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0 || h % kVec || f % kVec ||
      o > kThreads * kOutPerThread)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kRows - 1) / kRows);
  mlp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(out), m, h, f, o);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w1t, const void* b1,
                const void* w2t, const void* b2, void* out, int m, int h,
                int f, int o, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0 || h % 16 || f % 16 || o % 8 ||
      o > 8 * kTcWarps * kTcMaxTiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kTcRows - 1) / kTcRows);
  using bf16 = __nv_bfloat16;
  mlp_tc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1t),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2t),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), m, h, f, o);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, h], w1t [f, h], b1 [f], w2t [o, f], b2 [o], out [m, o]; all
// contiguous and 16-byte aligned.  f32: h and f multiples of 8, o <= 1024.
// bf16: h and f multiples of 16, o a multiple of 8 and <= 1024.
extern "C" int mint_mlp_f32(const void* x, const void* w1t, const void* b1,
                            const void* w2t, const void* b2, void* out, int m,
                            int h, int f, int o, void* stream) {
  return launch_f32(x, w1t, b1, w2t, b2, out, m, h, f, o, stream);
}

extern "C" int mint_mlp_bf16(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* out,
                             int m, int h, int f, int o, void* stream) {
  return launch_bf16(x, w1t, b1, w2t, b2, out, m, h, f, o, stream);
}
