// LayerNorm of bf16 rows with f32 scale and bias, as Flax's
// LayerNorm(dtype=bfloat16) computes it (mint_tpu/models/layers.py:143-153
// keeps the parameters f32): each row's mean and variance in f32, the
// affine in f32 with the f32 parameters, the output rounded to bf16 once.
// PyTorch's CUDA layer_norm takes no bf16 input with f32 parameters, so
// the plain version (ops/layer_norm.py) casts the input to f32 and the
// output back: three launches where this kernel is one.  It replaces no
// TPU kernel: the JAX package leaves LayerNorm to XLA, which fuses the
// casts.
//
// The same kernel without parameters (gamma and beta both null) is Flax's
// LayerNorm(use_scale=False, use_bias=False, dtype=bfloat16), the
// LayerNorms of a model whose affines are folded into the next matmul
// (mint_tpu_torch/models/fold.py): the statistics in f32, the output
// (x - mean) * rstd rounded to bf16 once.  A template parameter picks the
// form at compile time, so the affine-free launch reads no parameters.
//
// Bound by bytes (about 8 f32 operations per 4 bytes moved): each x is
// read once and each output written once.  One warp per row, four rows a
// block; the row stays in registers (bf16 pairs, 32-bit loads, 128 bytes
// a warp per step) across three passes over it: the mean, the sum of
// squared deviations from it, then the affine.  That form takes rows of up
// to kMaxCols columns, an even count.  Any other row (wider, or odd) takes
// the wide form: the same warp a row and the same three passes, each
// reading the row again (single bf16 values, 64 bytes a warp per step),
// the second and third from L1 or L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // rows a block
constexpr int kMaxCols = 1024;            // held in registers
constexpr int kPairs = kMaxCols / 2 / 32;  // bf16 pairs a lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kAffine>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                           const float2* __restrict__ gamma,
                           const float2* __restrict__ beta,
                           __nv_bfloat162* __restrict__ out, int rows,
                           int pairs, float inv_cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat162* xr = x + (size_t)row * pairs;
  float2 v[kPairs];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < pairs ? __bfloat1622float2(xr[i]) : make_float2(0.f, 0.f);
    sum += v[j].x + v[j].y;
  }
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
  __nv_bfloat162* orow = out + (size_t)row * pairs;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = lane + 32 * j;
    if (i < pairs) {
      if constexpr (kAffine) {
        const float2 g = gamma[i], b = beta[i];
        orow[i] = __floats2bfloat162_rn((v[j].x - mean) * rstd * g.x + b.x,
                                        (v[j].y - mean) * rstd * g.y + b.y);
      } else {
        orow[i] = __floats2bfloat162_rn((v[j].x - mean) * rstd,
                                        (v[j].y - mean) * rstd);
      }
    }
  }
}

// The wide form: rows of any width, read from memory in each pass.
template <bool kAffine>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_wide_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           __nv_bfloat16* __restrict__ out, int rows,
                           int cols, float inv_cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * cols;
  float sum = 0.f;
  for (int i = lane; i < cols; i += 32) sum += __bfloat162float(xr[i]);
  const float mean = warp_sum(sum) * inv_cols;
  float sq = 0.f;
  for (int i = lane; i < cols; i += 32) {
    const float a = __bfloat162float(xr[i]) - mean;
    sq += a * a;
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_cols + eps);
  __nv_bfloat16* orow = out + (size_t)row * cols;
  for (int i = lane; i < cols; i += 32) {
    const float v = (__bfloat162float(xr[i]) - mean) * rstd;
    if constexpr (kAffine)
      orow[i] = __float2bfloat16_rn(v * gamma[i] + beta[i]);
    else
      orow[i] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x and out [rows, cols] bf16, row-major; gamma and beta [cols] f32, or
// both null (no affine); any cols > 0.  Even rows of up to 1024 columns
// whose pointers allow 4-byte bf16 pairs (8-byte parameter pairs) take the
// register form, every other the wide form.
extern "C" int mint_layer_norm_bf16(const void* x, const void* gamma,
                                    const void* beta, void* out, int rows,
                                    int cols, float eps, void* stream) {
  if (rows <= 0 || cols <= 0 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kWarps - 1) / kWarps;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(gamma) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(beta) % 8 == 0;
  if (cols % 2 || cols > kMaxCols || !aligned) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* gp = static_cast<const float*>(gamma);
    const auto* bp = static_cast<const float*>(beta);
    auto* op = static_cast<__nv_bfloat16*>(out);
    if (gamma != nullptr)
      layer_norm_wide_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
          xp, gp, bp, op, rows, cols, 1.0f / cols, eps);
    else
      layer_norm_wide_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
          xp, gp, bp, op, rows, cols, 1.0f / cols, eps);
    return (int)cudaGetLastError();
  }
  const auto* xp = static_cast<const __nv_bfloat162*>(x);
  const auto* gp = static_cast<const float2*>(gamma);
  const auto* bp = static_cast<const float2*>(beta);
  auto* op = static_cast<__nv_bfloat162*>(out);
  if (gamma != nullptr)
    layer_norm_bf16_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, bp, op, rows, cols / 2, 1.0f / cols, eps);
  else
    layer_norm_bf16_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        xp, gp, bp, op, rows, cols / 2, 1.0f / cols, eps);
  return (int)cudaGetLastError();
}
