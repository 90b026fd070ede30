// The element-wise kernels of EDGE's FiLM-conditioned decoder
// (models/edge.py), bf16 rows in and out, f32 arithmetic:
//
// - film_residual_kernel: h + (1 + gamma) * a + beta, the residual of each
//   of a decoder layer's three sub-layers, gamma and beta one row of a
//   [B, 2C] tensor a sequence (the FiLM linear's output: gamma its first C
//   columns, beta its last), row r of h and a in sequence r / seq.
//   Plain PyTorch makes three or four passes over the [rows, C] operands
//   (the product, the two adds and the cast); this is one: h and a read
//   once, the output written once, gamma and beta from L1/L2; the same
//   bits as the plain version.
// - rotary_kernel<kNorm>: the rotary rotation of a row's channels by its
//   position p (pos0 + r % seq), interleaved by pairs:
//   z'[2i] = z[2i] cos(p t_i) - z[2i+1] sin(p t_i),
//   z'[2i+1] = z[2i+1] cos(p t_i) + z[2i] sin(p t_i), with (cos, sin) read
//   from a table the caller computes once ([positions, C/2] float2).  With
//   kNorm the row is first LayerNorm'd (f32 statistics, the f32 affine,
//   rounded to bf16, as csrc/layer_norm.cu computes it), the normed row
//   written too where asked (self-attention's V reads it), and the rounded
//   values rotated: one read of h where LayerNorm and then the rotation
//   would read it and write it twice more.  Products and sums are rounded
//   one at a time (__fmul_rn / __fadd_rn, no contraction), as PyTorch
//   computes t * cos + rotate_half(t) * sin, so the plain version gives
//   the same bits.
//
// No TPU kernel is replaced: the JAX package has no EDGE.  Bound by bytes.
// film_residual_kernel takes 8 bf16 a thread (16-byte loads): C a multiple
// of 8 and every row 16-byte aligned, as the decoder's fresh [rows, C]
// activations are; the entry refuses other rows.  rotary_kernel takes one
// warp a row, four rows a block, the row in registers as bf16 pairs (even C
// up to 1024).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace mint_film {
namespace {

constexpr int kWarps = 4;                  // rows a block (rotary)
constexpr int kMaxCols = 1024;             // held in registers
constexpr int kPairs = kMaxCols / 2 / 32;  // bf16 pairs a lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Each product and sum rounded on its own, in PyTorch's order (no fused
// multiply-add), so the plain version gives the same bits.
__device__ __forceinline__ float film(float h, float a, float g, float b) {
  return __fadd_rn(__fadd_rn(h, __fmul_rn(__fadd_rn(1.f, g), a)), b);
}

// 8 bf16 a thread: one 16-byte load of each operand.
__global__ void __launch_bounds__(256)
    film_residual_kernel(const __nv_bfloat16* __restrict__ h,
                         const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ gb,
                         __nv_bfloat16* __restrict__ out, long long rows,
                         int cols, int seq, long long ld_gb) {
  const int per_row = cols / 8;
  const long long n = rows * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int col = (int)(i % per_row) * 8;
    const size_t at = (size_t)row * cols + col;
    const __nv_bfloat16* g = gb + (row / seq) * ld_gb + col;
    const __nv_bfloat16* b = g + cols;
    const uint4 hv = *reinterpret_cast<const uint4*>(h + at);
    const uint4 av = *reinterpret_cast<const uint4*>(a + at);
    const uint4 gv = *reinterpret_cast<const uint4*>(g);
    const uint4 bv = *reinterpret_cast<const uint4*>(b);
    const auto* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
    const auto* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
    const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const auto* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
    uint4 ov;
    auto* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 hf = __bfloat1622float2(h2[j]);
      const float2 af = __bfloat1622float2(a2[j]);
      const float2 gf = __bfloat1622float2(g2[j]);
      const float2 bf = __bfloat1622float2(b2[j]);
      o2[j] = __floats2bfloat162_rn(film(hf.x, af.x, gf.x, bf.x),
                                    film(hf.y, af.y, gf.y, bf.y));
    }
    *reinterpret_cast<uint4*>(out + at) = ov;
  }
}

// One warp a row: (LayerNorm with kNorm, the normed row written where
// `normed` is not null, then) the rotation of the row by its position.
template <bool kNorm>
__global__ void __launch_bounds__(kWarps * 32)
    rotary_kernel(const __nv_bfloat162* __restrict__ x,
                  const float2* __restrict__ gamma,
                  const float2* __restrict__ beta,
                  const float2* __restrict__ table,
                  __nv_bfloat162* __restrict__ normed,
                  __nv_bfloat162* __restrict__ rotated, int rows, int pairs,
                  int seq, int pos0, float inv_cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat162* xr = x + (size_t)row * pairs;
  float2 v[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < pairs ? __bfloat1622float2(xr[i]) : make_float2(0.f, 0.f);
  }
  if constexpr (kNorm) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) sum += v[j].x + v[j].y;
    const float mean = warp_sum(sum) * inv_cols;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      if (lane + 32 * j < pairs) {
        const float a = v[j].x - mean, b = v[j].y - mean;
        sq += a * a + b * b;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_cols + eps);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = lane + 32 * j;
      if (i < pairs) {
        const float2 g = gamma[i], b = beta[i];
        const __nv_bfloat162 n = __floats2bfloat162_rn(
            (v[j].x - mean) * rstd * g.x + b.x,
            (v[j].y - mean) * rstd * g.y + b.y);
        if (normed != nullptr) normed[(size_t)row * pairs + i] = n;
        v[j] = __bfloat1622float2(n);  // the rotation reads the rounded row
      }
    }
  }
  const float2* cs = table + (size_t)(pos0 + row % seq) * pairs;
  __nv_bfloat162* orow = rotated + (size_t)row * pairs;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = lane + 32 * j;
    if (i < pairs) {
      const float2 t = cs[i];  // (cos, sin)
      const float lo = __fadd_rn(__fmul_rn(v[j].x, t.x),
                                 __fmul_rn(-v[j].y, t.y));
      const float hi = __fadd_rn(__fmul_rn(v[j].y, t.x),
                                 __fmul_rn(v[j].x, t.y));
      orow[i] = __floats2bfloat162_rn(lo, hi);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace
}  // namespace mint_film

using namespace mint_film;

// h, a and out [rows, cols] bf16, contiguous (out may be h), 16-byte
// aligned; gb [B, 2 cols] bf16, rows ld_gb elements apart, 16-byte aligned,
// B = rows / seq; cols and ld_gb multiples of 8.
extern "C" int mint_film_residual_bf16(const void* h, const void* a,
                                       const void* gb, void* out,
                                       long long rows, int cols, int seq,
                                       long long ld_gb, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 || seq <= 0 || rows % seq ||
      ld_gb < 2 * cols || ld_gb % 8 || !aligned(h, 16) || !aligned(a, 16) ||
      !aligned(gb, 16) || !aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  const long long n = rows * cols / 8;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132LL * 16);
  film_residual_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(gb), static_cast<__nv_bfloat16*>(out),
      rows, cols, seq, ld_gb);
  return (int)cudaGetLastError();
}

// x [rows, cols] bf16, contiguous; table [positions, cols / 2] float2
// (cos, sin), positions > pos0 + seq - 1; rotated [rows, cols] bf16.  With
// gamma and beta (f32 [cols], both or neither) the rows are LayerNorm'd
// first (eps), and the normed rows written to `normed` unless it is null
// (no LayerNorm: normed must be null).  Even cols up to 1024.
extern "C" int mint_film_rotary_bf16(const void* x, const void* gamma,
                                     const void* beta, const void* table,
                                     void* normed, void* rotated, int rows,
                                     int cols, int seq, int pos0, float eps,
                                     void* stream) {
  const bool norm = gamma != nullptr;
  if (rows <= 0 || cols <= 0 || cols % 2 || cols > kMaxCols || seq <= 0 ||
      pos0 < 0 || (gamma == nullptr) != (beta == nullptr) ||
      (!norm && normed != nullptr) || !aligned(x, 4) || !aligned(rotated, 4) ||
      !aligned(table, 8) || (normed != nullptr && !aligned(normed, 4)) ||
      (norm && (!aligned(gamma, 8) || !aligned(beta, 8))))
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kWarps - 1) / kWarps;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* xp = static_cast<const __nv_bfloat162*>(x);
  const auto* gp = static_cast<const float2*>(gamma);
  const auto* bp = static_cast<const float2*>(beta);
  const auto* tp = static_cast<const float2*>(table);
  auto* np = static_cast<__nv_bfloat162*>(normed);
  auto* rp = static_cast<__nv_bfloat162*>(rotated);
  if (norm)
    rotary_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, bp, tp, np, rp, rows, cols / 2, seq, pos0, 1.0f / cols, eps);
  else
    rotary_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, bp, tp, np, rp, rows, cols / 2, seq, pos0, 1.0f / cols, eps);
  return (int)cudaGetLastError();
}
