// Fused transformer MLP forward: out = gelu_tanh(x W1 + b1) W2 + b2.
//
// Replaces the Pallas TPU kernel mint_tpu/ops/mlp.py::_kernel (wrapped by
// _fused_mlp_fwd_2d, mlp.py:53).  Same cast points: fc1 accumulates in
// f32, bias and tanh-GELU in f32, the activation is rounded to x's type
// (mlp.py:47), fc2 accumulates in f32, b2 is added in f32, and the result
// is cast to x's type.  Unlike the TPU kernel, both paths here write the
// [M, F] activation to device memory between two GEMM passes (below).
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
// the bf16 tensor cores (989 TFLOP/s).  Keeping the [M, O] output of the
// fused form in registers caps a block at a few rows, so every weight
// byte feeds few flops; both paths therefore run two GEMM passes,
// C = A B^T with A [M, K] and B [N, K] both K-contiguous (x, the scratch
// and nn.Linear weights as they are): fc1 with a b1 + tanh-GELU epilogue
// into a scratch [M, F] the caller allocates, then fc2 with a b2 epilogue.
//
// - bf16 (gemm_tc_kernel, launched twice): Hopper's TMA and wgmma.  The
//   scratch is bf16, the TPU kernel's own rounding point; its round trip
//   is 88 MB at M = 7200, ~0.026 ms at 3.35 TB/s against the 0.0716 ms
//   tensor-core floor.  A block owns a 128 x BN tile of C (BN = 192 for
//   fc1: F = 3072 makes 16 column tiles; 200 for fc2: O = 800 makes 4).
//   Its producer warp streams 64-wide k-tiles of A and B through a
//   4-stage ring of 128-byte-swizzled shared-memory stages (TMA, one
//   full / empty mbarrier pair per stage); two consumer warpgroups of 64
//   rows each run four m64nBNk16 wgmma per stage on them, f32
//   accumulators in registers, and free the stage.  When a pass has fewer
//   tiles than SMs (the decode's last block, M = B * 48; batch 1), K is
//   split over up to 8 blocks per tile into f32 partial sums that a second
//   kernel adds in a fixed order, then bias (and GELU): no atomics, so
//   results repeat bit for bit.
// - f32 (gemm_nt_kernel, launched twice): the reference's scoring path
//   must stay exact f32 (no TF32), so it runs on the FMA pipes, whose
//   67 TFLOP/s make the MLP compute-bound: 4*M*H*F flops (1.06 ms at
//   M = 7200 and peak).  What keeps FMA pipes busy is reuse of every value
//   loaded into shared memory (the fused first design managed 8 flops per
//   weight byte), so each pass is a register-blocked SGEMM; the f32
//   scratch's round trip (2 * 4 * M * F bytes, 0.05 ms at M = 7200) is
//   about 5% of the FMA floor.  A block of 256 threads owns a 112 x 80
//   output tile (O = 800 makes 10 column tiles; F = 3072 makes 39, the
//   last 32 wide), or 144 x 80 where the grid makes 4 or more waves (fc1
//   at batch 20); each thread a 7 x 5 (9 x 5) outer-product micro-tile,
//   rows ty + 16 i and columns tx + 16 j, fed by float4 reads along K, so
//   12 shared-memory loads feed 140 FMAs.  A and
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
#include "wgmma.cuh"

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

// ---- bf16 on tensor cores: two wgmma GEMM passes ------------------------

constexpr int kTcBM = 128;      // rows of c per block: 2 consumer warpgroups
constexpr int kTcBK = 64;       // K per stage: one 128-byte swizzled row
constexpr int kTcStages = 4;    // TMA ring depth
constexpr int kTcThreads = 2 * 128 + 32;  // + one producer warp
constexpr int kTcBN1 = 192;     // fc1 columns per block (F = 3072: 16)
constexpr int kTcBN2 = 200;     // fc2 columns per block (O = 800: 4)

template <int BN>
constexpr size_t tc_smem() {
  // 1 KB of slack to align the ring to the 128-byte swizzle's 1 KB atoms.
  return 1024 + (size_t)kTcStages * (kTcBM + BN) * kTcBK * 2 +
         2 * kTcStages * sizeof(uint64_t);
}

// One (128 x BN) tile of c = a b^T over the K range of split blockIdx.z:
// a [M, K] and b [N, K] bf16, row-major, read by TMA (128-byte swizzle)
// into a ring of kTcStages stages.  Warp 8 is the producer: one lane waits
// for a free stage, announces its bytes and issues its two loads.
// Warpgroups 0 and 1 each own 64 rows: they wait for a full stage, run
// four m64nBNk16 wgmma on it, and free it.  With one split the epilogue
// adds the bias in f32 (then tanh-GELU when kGelu) and writes c as bf16;
// with several, split z writes its raw f32 sum to part + z * M * N and
// reduce_tc_kernel finishes.
template <int BN, bool kGelu>
__global__ void __launch_bounds__(kTcThreads, 1)
    gemm_tc_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ c, float* __restrict__ part,
                   int m, int n, int k, int split) {
  constexpr uint32_t kABytes = kTcBM * kTcBK * 2;
  constexpr uint32_t kBBytes = BN * kTcBK * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mint::smem_addr(smem_raw);
  uint8_t* as = smem_raw + (1024 - raw % 1024) % 1024;  // [stages][128][64]
  uint8_t* bs = as + kTcStages * kABytes;               // [stages][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kTcStages * kBBytes);
  uint64_t* empty = full + kTcStages;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  const int per = (ktiles + split - 1) / split;
  const int kt0 = blockIdx.z * per;
  const int nt = max(0, min(ktiles, kt0 + per) - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mint::mbar_init(full + s, 1);
      mint::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages) mint::mbar_wait(empty + s, (i / kTcStages - 1) & 1);
        mint::mbar_expect_tx(full + s, kABytes + kBBytes);
        mint::tma_load_2d(as + s * kABytes, &amap, full + s, (kt0 + i) * kTcBK,
                          m0);
        mint::tma_load_2d(bs + s * kBBytes, &bmap, full + s, (kt0 + i) * kTcBK,
                          n0);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int s = i % kTcStages;
    mint::mbar_wait(full + s, (i / kTcStages) & 1);
    const uint8_t* at = as + s * kABytes + wg * 64 * 128;
    const uint8_t* bt = bs + s * kBBytes;
    mint::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)  // 32 bytes along the row
      mint::wgmma_ss<BN>(acc, mint::smem_desc(at + 32 * kk, 16, 1024, 1),
                         mint::smem_desc(bt + 32 * kk, 16, 1024, 1));
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) mint::mbar_arrive(empty + s);
  }

  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row0 = m0 + 64 * wg + 16 * warp + g;
  float* pz = part + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= n) continue;  // n is a multiple of 8: col + 1 < n too
    const float bias0 = split == 1 ? __bfloat162float(bias[col]) : 0.f;
    const float bias1 = split == 1 ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= m) continue;
      float v0 = acc[4 * j + 2 * hh] + bias0;
      float v1 = acc[4 * j + 2 * hh + 1] + bias1;
      if (split > 1) {
        *reinterpret_cast<float2*>(pz + (size_t)row * n + col) =
            make_float2(v0, v1);
        continue;
      }
      if (kGelu) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(c + (size_t)row * n + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// c = bf16(epilogue(part[0] + ... + part[split - 1] + bias)), summed in
// that order in f32, so the result does not depend on the schedule.
template <bool kGelu>
__global__ void reduce_tc_kernel(const float* __restrict__ part,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ c, int m, int n,
                                 int split) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < split; ++s) v += part[s * mn + i];
    v += __bfloat162float(bias[i % n]);
    c[i] = __float2bfloat16_rn(kGelu ? gelu_tanh(v) : v);
  }
}

// K is split only while the tiles cannot give every SM a block, into as
// many parts as fill the card, each of at least 4 k-tiles.
int tc_split(int m, int n, int k, int bn, int sms) {
  const long long tiles =
      (long long)((m + kTcBM - 1) / kTcBM) * ((n + bn - 1) / bn);
  if (tiles >= sms) return 1;
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  return std::max(1, (int)std::min<long long>(
                         std::min(kMaxSplit, ktiles / 4), sms / tiles));
}

struct TcPlan {
  int split1, split2;
  size_t act_bytes, bytes;  // the bf16 activation, then f32 split sums
};

cudaError_t plan_bf16(int m, int h, int f, int o, TcPlan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->split1 = tc_split(m, f, h, kTcBN1, sms);
  p->split2 = tc_split(m, o, f, kTcBN2, sms);
  p->act_bytes = ((size_t)m * f * 2 + 255) / 256 * 256;
  const size_t part1 = p->split1 > 1 ? (size_t)p->split1 * m * f : 0;
  const size_t part2 = p->split2 > 1 ? (size_t)p->split2 * m * o : 0;
  p->bytes = p->act_bytes + 4 * std::max(part1, part2);
  return cudaSuccess;
}

// TMA map of a row-major [rows, cols] bf16 matrix, boxes of 64 columns
// (128 bytes, swizzled) x box_rows rows.
bool tc_map(CUtensorMap* map, const void* p, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * cols};
  const cuuint32_t box[2] = {kTcBK, (cuuint32_t)box_rows};
  return mint::make_map(map, p, 2, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// c [m, n] = epilogue(a [m, k] b[n, k]^T + bias), split `split` ways.
template <int BN, bool kGelu>
cudaError_t gemm_tc(const __nv_bfloat16* a, const __nv_bfloat16* b,
                    const __nv_bfloat16* bias, __nv_bfloat16* c, float* part,
                    int m, int n, int k, int split, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  if (!tc_map(&amap, a, m, k, kTcBM) || !tc_map(&bmap, b, n, k, BN))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc_kernel<BN, kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kTcBM - 1) / kTcBM, split);
  gemm_tc_kernel<BN, kGelu><<<grid, kTcThreads, smem, stream>>>(
      amap, bmap, bias, c, part, m, n, k, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const int blocks =
      (int)std::min<long long>(1024, ((long long)m * n + 255) / 256);
  reduce_tc_kernel<kGelu><<<blocks, 256, 0, stream>>>(part, bias, c, m, n,
                                                      split);
  return cudaGetLastError();
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
                const void* w2t, const void* b2, void* scratch, void* out,
                int m, int h, int f, int o, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0 || h % 16 || f % 16 || o % 8)
    return (int)cudaErrorInvalidValue;
  TcPlan p;
  cudaError_t err = plan_bf16(m, h, f, o, &p);
  if (err != cudaSuccess) return (int)err;
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  auto* act = static_cast<bf16*>(scratch);
  auto* part =
      reinterpret_cast<float*>(static_cast<uint8_t*>(scratch) + p.act_bytes);
  err = gemm_tc<kTcBN1, true>(static_cast<const bf16*>(x),
                              static_cast<const bf16*>(w1t),
                              static_cast<const bf16*>(b1), act, part, m, f,
                              h, p.split1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_tc<kTcBN2, false>(act, static_cast<const bf16*>(w2t),
                                     static_cast<const bf16*>(b2),
                                     static_cast<bf16*>(out), part, m, o, f,
                                     p.split2, s);
}

}  // namespace

// x [m, h], w1t [f, h], b1 [f], w2t [o, f], b2 [o], out [m, o]; all
// contiguous and 16-byte aligned.  f32: h and f multiples of 8, and
// scratch an f32 buffer of mint_mlp_f32_scratch(m, h, f, o) floats (the
// activation, then split partial sums).  bf16: h and f multiples of 16, o
// a multiple of 8, and scratch a buffer of mint_mlp_bf16_scratch(m, h, f,
// o) bytes (the bf16 activation, then f32 split partial sums).
extern "C" long long mint_mlp_f32_scratch(int m, int h, int f, int o) {
  Plan p;
  if (m <= 0 || f <= 0 || o <= 0 || plan_f32(m, h, f, o, &p) != cudaSuccess)
    return -1;
  return (long long)p.scratch;
}

extern "C" long long mint_mlp_bf16_scratch(int m, int h, int f, int o) {
  TcPlan p;
  if (m <= 0 || f <= 0 || o <= 0 || plan_bf16(m, h, f, o, &p) != cudaSuccess)
    return -1;
  return (long long)p.bytes;
}

extern "C" int mint_mlp_f32(const void* x, const void* w1t, const void* b1,
                            const void* w2t, const void* b2, void* scratch,
                            void* out, int m, int h, int f, int o,
                            void* stream) {
  return launch_f32(x, w1t, b1, w2t, b2, scratch, out, m, h, f, o, stream);
}

extern "C" int mint_mlp_bf16(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* scratch,
                             void* out, int m, int h, int f, int o,
                             void* stream) {
  return launch_bf16(x, w1t, b1, w2t, b2, scratch, out, m, h, f, o, stream);
}
