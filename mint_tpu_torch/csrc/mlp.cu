// Fused transformer MLP forward: out = gelu_tanh(x W1 + b1) W2 + b2.
//
// Replaces the Pallas TPU kernel mint_tpu/ops/mlp.py::_kernel (wrapped by
// _fused_mlp_fwd_2d, mlp.py:53).  Same cast points: fc1 accumulates in
// f32, bias and tanh-GELU in f32, the activation is rounded to x's type
// (mlp.py:47), fc2 accumulates in f32, b2 is added in f32, and the result
// is cast to x's type.  Like the TPU kernel, the bf16 kernel never writes
// the [M, F] activation to device memory; the f32 path does (below).
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
// - f32 (gemm_nt_kernel, launched twice): the reference's scoring path
//   must stay exact f32 (no TF32), so it runs on the FMA pipes, whose
//   67 TFLOP/s make the MLP compute-bound: 4*M*H*F flops (1.06 ms at
//   M = 7200 and peak).  What keeps FMA pipes busy is reuse of every value
//   loaded into shared memory, which a [M, O] f32 accumulator in registers
//   forbids (it capped the first design at 16 rows per block, 8 flops per
//   weight byte).  So the f32 path is two register-blocked SGEMM passes:
//   fc1 with a b1 + tanh-GELU epilogue into an f32 scratch [M, F] that
//   the caller allocates, then fc2 with a b2 epilogue.  The round trip of
//   the scratch (2 * 4 * M * F bytes, 0.05 ms at M = 7200) is about 5% of
//   the FMA floor.  Each pass computes C = A B^T with A [M, K] and
//   B [N, K] both K-contiguous (x, the scratch and nn.Linear weights as
//   they are).  A block of 256 threads owns a 112 x 80 output tile (O =
//   800 makes 10 column tiles; F = 3072 makes 39, the last 32 wide), or
//   144 x 80 where the grid makes 4 or more waves (fc1 at batch 20); each
//   thread a 7 x 5 (9 x 5) outer-product micro-tile, rows ty + 16 i and
//   columns tx + 16 j, fed
//   by float4 reads along K, so 12 shared-memory loads feed 140 FMAs.  A and
//   B k-tiles of 32 arrive by cp.async in a 3-stage ring, so loads overlap
//   the FMAs, with one barrier per k-tile; a weight value in shared memory
//   feeds all of the block's rows.  Two blocks share an SM.  When a
//   pass has too few tiles to fill the card (the decode's last block,
//   M = B * 48), K is split over up to 8 blocks per tile and a second
//   kernel adds the split sums in a fixed order, then bias and GELU: no
//   atomics, so results repeat bit for bit.  (Tiles from 64x64 to
//   144x128 were timed on an H100: 112x80 is the fastest or within 4% of
//   it at every M of the decode; 144x80 is 4% faster at fc1's M = 7200,
//   and 112x80 alone there made the f32 batch-20 decode 1% slower.)

#include <math.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
  const float k = 0.7978845608028654f;
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// ---- f32 on the FMA pipes ------------------------------------------------

constexpr int kTN = 5;           // per-thread micro-tile columns
constexpr int kBN = 16 * kTN;    // 80 columns of c per block
constexpr int kTM = 7;           // micro-tile rows: 112 rows of c per block
constexpr int kTallTM = 9;       // 144 rows, for grids of many tiles
constexpr int kBK = 32;          // K per shared-memory stage
constexpr int kLd = kBK + 4;     // padded row: 16-byte aligned, and eight
                                 // rows read at one column hit 8 bank quads
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kChunks = kBK / 4;            // 16-byte copies per tile row
constexpr int kCopyRows = kThreads / kChunks;  // tile rows per copy pass
constexpr int kMaxSplit = 8;

template <int TM>
constexpr size_t gemm_smem() {
  return sizeof(float) * kStages * (16 * TM + kBN) * kLd;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One (16 TM x 80) tile of c = a b^T over the K range of split blockIdx.z:
// a [M, K], b [N, K] row-major, K a multiple of 4.  With one split the
// epilogue adds bias and applies tanh-GELU when kGelu and writes c [M, N];
// with several, split z writes its raw sum to c + z * M * N and
// reduce_kernel finishes.
template <int TM, bool kGelu>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ c,
                   int m, int n, int k, int split) {
  constexpr int kBM = 16 * TM;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [kStages][kBM][kLd]
  float* bs = as + kStages * kBM * kLd;         // [kStages][kBN][kLd]

  const int tid = threadIdx.x;
  // A warp is 4 x 8 threads: its A reads touch 4 rows, its B reads 8.
  const int lane = tid % 32, warp = tid / 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kper = ((k + split - 1) / split + kBK - 1) / kBK * kBK;
  const int kb = blockIdx.z * kper;
  const int ke = min(k, kb + kper);
  const int tiles = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  // This thread copies column cc of rows cr + kCopyRows p of each tile;
  // rows past m or n, and columns past the split's end, are zero-filled.
  const int cr = tid / kChunks, cc = 4 * (tid % kChunks);
  const float* ag = a + (size_t)(m0 + cr) * k + kb + cc;
  const float* bg = b + (size_t)(n0 + cr) * k + kb + cc;
  const int soff = cr * kLd + cc;
  auto load = [&](int t) {
    const bool kok = kb + t * kBK + cc < ke;
    float* ad = as + (t % kStages) * kBM * kLd + soff;
    float* bd = bs + (t % kStages) * kBN * kLd + soff;
#pragma unroll
    for (int r = 0; r < kBM; r += kCopyRows) {
      if (r + cr >= kBM) break;
      const bool ok = kok && m0 + r + cr < m;
      mint::cp_async16(ad + r * kLd, ok ? ag + (size_t)r * k + t * kBK : a,
                       ok);
    }
#pragma unroll
    for (int r = 0; r < kBN; r += kCopyRows) {
      if (r + cr >= kBN) break;
      const bool ok = kok && n0 + r + cr < n;
      mint::cp_async16(bd + r * kLd, ok ? bg + (size_t)r * k + t * kBK : b,
                       ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load(s);
    mint::cp_async_commit();
  }

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (for every thread after the barrier), and every
    // thread is done with tile t - 1, whose slot the next copy reuses.
    mint::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < tiles) load(t + kStages - 1);
    mint::cp_async_commit();

    const float* at = as + (t % kStages) * kBM * kLd + ty * kLd;
    const float* bt = bs + (t % kStages) * kBN * kLd + tx * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 bv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = ld4(bt + 16 * j * kLd + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = ld4(at + 16 * i * kLd + kk);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
  }

  float* cz = c + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= n) continue;
    const float bj = split == 1 ? bias[col] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < m) {
        const float v = acc[i][j] + bj;
        cz[(size_t)row * n + col] = (kGelu && split == 1) ? gelu_tanh(v) : v;
      }
    }
  }
}

// c = epilogue(part[0] + ... + part[split - 1] + bias), summed in that
// order, so the result does not depend on the schedule.
template <bool kGelu>
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ bias,
                              float* __restrict__ c, int m, int n,
                              int split) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < split; ++s) v += part[s * mn + i];
    v += bias[i % n];
    c[i] = kGelu ? gelu_tanh(v) : v;
  }
}

long long tiles(int m, int n, int tm) {
  return (long long)((m + 16 * tm - 1) / (16 * tm)) * ((n + kBN - 1) / kBN);
}

// How one pass runs on `sms` SMs: 144-row tiles when they make at least 4
// waves of two blocks per SM (fewer L2 bytes per flop, small tail), else
// 112-row tiles; K is split only while the tiles cannot fill every SM's
// two block slots, into enough parts to give each SM about three blocks
// (the decode's small-M blocks), with at least 4 k-tiles per part.
struct Pass {
  bool tall;
  int split;
};

Pass plan_pass(int m, int n, int k, int sms) {
  if (tiles(m, n, kTallTM) >= 8LL * sms) return {true, 1};
  const long long t = tiles(m, n, kTM);
  if (t >= 2LL * sms) return {false, 1};
  const int cap = std::max(1, std::min(kMaxSplit, k / (4 * kBK)));
  return {false, (int)std::min<long long>(cap, (3LL * sms + t - 1) / t)};
}

struct Plan {
  Pass fc1, fc2;
  size_t scratch;  // floats: activation [m, f] + split partials
};

// SM count of the current device, asked once per device.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*sms = cache[dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev].store(*sms);
  return err;
}

cudaError_t plan_f32(int m, int h, int f, int o, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->fc1 = plan_pass(m, f, h, sms);
  p->fc2 = plan_pass(m, o, f, sms);
  const size_t part1 = p->fc1.split > 1 ? (size_t)p->fc1.split * m * f : 0;
  const size_t part2 = p->fc2.split > 1 ? (size_t)p->fc2.split * m * o : 0;
  p->scratch = (size_t)m * f + std::max(part1, part2);
  return cudaSuccess;
}

template <int TM, bool kGelu>
cudaError_t launch_gemm(const float* a, const float* b, const float* bias,
                        float* c, int m, int n, int k, int split,
                        cudaStream_t stream) {
  constexpr size_t smem = gemm_smem<TM>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_nt_kernel<TM, kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + 16 * TM - 1) / (16 * TM), split);
  gemm_nt_kernel<TM, kGelu><<<grid, kThreads, smem, stream>>>(a, b, bias, c,
                                                              m, n, k, split);
  return cudaGetLastError();
}

// c = epilogue(a b^T + bias) as planned; part holds the split sums.
template <bool kGelu>
cudaError_t gemm(const float* a, const float* b, const float* bias, float* c,
                 float* part, int m, int n, int k, Pass pass,
                 cudaStream_t stream) {
  float* dst = pass.split > 1 ? part : c;
  cudaError_t err =
      pass.tall
          ? launch_gemm<kTallTM, kGelu>(a, b, bias, dst, m, n, k, 1, stream)
          : launch_gemm<kTM, kGelu>(a, b, bias, dst, m, n, k, pass.split,
                                    stream);
  if (err != cudaSuccess || pass.split == 1) return err;
  const int blocks =
      (int)std::min<long long>(1024, ((long long)m * n + 255) / 256);
  reduce_kernel<kGelu><<<blocks, 256, 0, stream>>>(part, bias, c, m, n,
                                                   pass.split);
  return cudaGetLastError();
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
               const void* w2t, const void* b2, void* scratch, void* out,
               int m, int h, int f, int o, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0 || h % 8 || f % 8)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_f32(m, h, f, o, &p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* act = static_cast<float*>(scratch);
  float* part = act + (size_t)m * f;
  err = gemm<true>(static_cast<const float*>(x),
                   static_cast<const float*>(w1t),
                   static_cast<const float*>(b1), act, part, m, f, h, p.fc1,
                   s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<false>(act, static_cast<const float*>(w2t),
                          static_cast<const float*>(b2),
                          static_cast<float*>(out), part, m, o, f, p.fc2, s);
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
// contiguous and 16-byte aligned.  f32: h and f multiples of 8, and
// scratch an f32 buffer of mint_mlp_f32_scratch(m, h, f, o) floats (the
// activation, then split partial sums).  bf16: h and f multiples of 16, o
// a multiple of 8 and <= 1024.
extern "C" long long mint_mlp_f32_scratch(int m, int h, int f, int o) {
  Plan p;
  if (m <= 0 || f <= 0 || o <= 0 || plan_f32(m, h, f, o, &p) != cudaSuccess)
    return -1;
  return (long long)p.scratch;
}

extern "C" int mint_mlp_f32(const void* x, const void* w1t, const void* b1,
                            const void* w2t, const void* b2, void* scratch,
                            void* out, int m, int h, int f, int o,
                            void* stream) {
  return launch_f32(x, w1t, b1, w2t, b2, scratch, out, m, h, f, o, stream);
}

extern "C" int mint_mlp_bf16(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* out,
                             int m, int h, int f, int o, void* stream) {
  return launch_bf16(x, w1t, b1, w2t, b2, out, m, h, f, o, stream);
}
