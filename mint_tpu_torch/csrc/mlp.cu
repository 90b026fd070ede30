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
//   Any widths: rows and a K range that 16-byte copies cannot address (K
//   or a row stride not a multiple of 4 floats) take 4-byte copies, each
//   zero-filled past K (the kVec = false instance).
// - bf16 at any widths, every operand read where it lies (no padded copy):
//   the wrapper (ops/mlp.py's bf16_plan) picks each pass's column tile and
//   how each operand is loaded, and passes them here.  Column tiles: the
//   fewest of the pass's instances, the flagship's on a tie (fc1 192 or
//   200: F = 3080 makes 16 of 200, not 17 of 192; fc2 200 or 208: O = 804
//   makes 4 of 208, not 5 of 200, whose fifth tile 4 wide made 2.16 waves
//   on 132 SMs at M = 7200 instead of 1.73).  Loads: TMA where the base
//   and the row stride are whole 16-byte steps (the flagship's operands;
//   TMA zero-fills the ragged last k-tile and rows past N); fc1 at hidden
//   widths 4 columns past a step (804), x's and W1^T's rows 8 bytes past a
//   16-byte step every other row, by TMA over their even rows and over
//   their odd rows (gemm_tc_pairs_kernel, mlp_routes.cu); fc2 at MLP
//   widths no multiple of 8 (F = 3070), W2^T's rows in 2, 4 or 8 phases
//   off the step, by TMA over each phase's rows, the shift made up in
//   registers (gemm_tc_phases_kernel, mlp_phases.cu); else
//   gemm_tc_any_kernel (mlp_routes.cu), whose producer warpgroup stages
//   the operand (any element-aligned base or stride: x off a 16-byte
//   base): the aligned 16-byte words around each row's k-tile by
//   cp.async, zero-filled past K and past the last row, then moved in
//   shared memory into the swizzled stage by each row's byte phase
//   (correct, but about twice the time of a TMA-fed pass).  The
//   activation is the kernel's own, its rows F rounded up to 64 apart
//   (bf16_plan's), so fc2's activation is always TMA's (the map's columns
//   stop at F: zeros past it).  An odd O
//   or F is stored a column at a time where a pair would straddle 4
//   bytes.

#include <math.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"
#include "mlp_tc.cuh"
#include "wgmma.cuh"

namespace mint_mlp {
namespace {

constexpr int kThreads = 256;

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

template <int TM>
constexpr size_t gemm_smem() {
  return sizeof(float) * kStages * (16 * TM + kBN) * kLd;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One (16 TM x 80) tile of c = a b^T over the K range of split blockIdx.z:
// a [M, K] and b [N, K] with rows lda and ldb floats apart.  kVec: K, lda
// and ldb multiples of 4 and both bases 16-byte aligned (16-byte copies),
// else 4-byte ones.  With one split the epilogue adds bias and applies
// tanh-GELU when kGelu and writes c [M, N] (rows ldc apart); with several,
// split z writes its raw sum to c + z * M * N (rows N apart) and
// reduce_kernel finishes.
template <int TM, bool kGelu, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ c,
                   int m, int n, int k, int lda, int ldb, int ldc,
                   int split) {
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

  // This thread copies columns cc .. cc + 3 of rows cr + kCopyRows p of
  // each tile; rows past m or n, and columns past the split's end, are
  // zero-filled.
  const int cr = tid / kChunks, cc = 4 * (tid % kChunks);
  const float* ag = a + (size_t)(m0 + cr) * lda + kb + cc;
  const float* bg = b + (size_t)(n0 + cr) * ldb + kb + cc;
  const int soff = cr * kLd + cc;
  // Copies the 4 columns at src (the first `cols` of them real) to dst.
  auto copy4 = [&](float* dst, const float* src, bool row_ok, int cols) {
    if constexpr (kVec) {
      const bool ok = row_ok && cols > 0;
      mint::cp_async16(dst, ok ? src : a, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && e < cols;
        mint::cp_async4(dst + e, ok ? src + e : a, ok);
      }
    }
  };
  auto load = [&](int t) {
    const int cols = ke - (kb + t * kBK + cc);  // real columns from cc on
    float* ad = as + (t % kStages) * kBM * kLd + soff;
    float* bd = bs + (t % kStages) * kBN * kLd + soff;
#pragma unroll
    for (int r = 0; r < kBM; r += kCopyRows) {
      if (r + cr >= kBM) break;
      copy4(ad + r * kLd, ag + (size_t)r * lda + t * kBK, m0 + r + cr < m,
            cols);
    }
#pragma unroll
    for (int r = 0; r < kBN; r += kCopyRows) {
      if (r + cr >= kBN) break;
      copy4(bd + r * kLd, bg + (size_t)r * ldb + t * kBK, n0 + r + cr < n,
            cols);
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
  const size_t ld_out = split == 1 ? ldc : n;
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
        cz[row * ld_out + col] = (kGelu && split == 1) ? gelu_tanh(v) : v;
      }
    }
  }
}

// c = epilogue(part[0] + ... + part[split - 1] + bias), summed in that
// order, so the result does not depend on the schedule; c's rows ldc apart.
template <bool kGelu>
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ bias,
                              float* __restrict__ c, int m, int n, int ldc,
                              int split) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < split; ++s) v += part[s * mn + i];
    v += bias[i % n];
    c[i / n * ldc + i % n] = kGelu ? gelu_tanh(v) : v;
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

// The f32 activation's row stride: F rounded up to 4 floats, so that its
// rows start on 16 bytes.
int act_ld(int f) { return (f + 3) / 4 * 4; }

cudaError_t plan_f32(int m, int h, int f, int o, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->fc1 = plan_pass(m, f, h, sms);
  p->fc2 = plan_pass(m, o, f, sms);
  const size_t part1 = p->fc1.split > 1 ? (size_t)p->fc1.split * m * f : 0;
  const size_t part2 = p->fc2.split > 1 ? (size_t)p->fc2.split * m * o : 0;
  p->scratch = (size_t)m * act_ld(f) + std::max(part1, part2);
  return cudaSuccess;
}

template <int TM, bool kGelu, bool kVec>
cudaError_t launch_gemm(const float* a, const float* b, const float* bias,
                        float* c, int m, int n, int k, int lda, int ldb,
                        int ldc, int split, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem<TM>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_nt_kernel<TM, kGelu, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + 16 * TM - 1) / (16 * TM), split);
  gemm_nt_kernel<TM, kGelu, kVec><<<grid, kThreads, smem, stream>>>(
      a, b, bias, c, m, n, k, lda, ldb, ldc, split);
  return cudaGetLastError();
}

template <int TM, bool kGelu>
cudaError_t launch_gemm(const float* a, const float* b, const float* bias,
                        float* c, int m, int n, int k, int lda, int ldb,
                        int ldc, int split, cudaStream_t stream) {
  const bool vec = k % 4 == 0 && lda % 4 == 0 && ldb % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch_gemm<TM, kGelu, true>(a, b, bias, c, m, n, k, lda, ldb,
                                            ldc, split, stream)
             : launch_gemm<TM, kGelu, false>(a, b, bias, c, m, n, k, lda,
                                             ldb, ldc, split, stream);
}

// c = epilogue(a b^T + bias) as planned (a's rows lda apart, b's K, c's
// ldc); part holds the split sums.
template <bool kGelu>
cudaError_t gemm(const float* a, const float* b, const float* bias, float* c,
                 float* part, int m, int n, int k, int lda, int ldc,
                 Pass pass, cudaStream_t stream) {
  float* dst = pass.split > 1 ? part : c;
  cudaError_t err =
      pass.tall ? launch_gemm<kTallTM, kGelu>(a, b, bias, dst, m, n, k, lda,
                                              k, ldc, 1, stream)
                : launch_gemm<kTM, kGelu>(a, b, bias, dst, m, n, k, lda, k,
                                          ldc, pass.split, stream);
  if (err != cudaSuccess || pass.split == 1) return err;
  const int blocks =
      (int)std::min<long long>(1024, ((long long)m * n + 255) / 256);
  reduce_kernel<kGelu><<<blocks, 256, 0, stream>>>(part, bias, c, m, n, ldc,
                                                   pass.split);
  return cudaGetLastError();
}

// ---- bf16 on tensor cores: two wgmma GEMM passes ------------------------
// (the tiles: mlp_tc.cuh; the other layouts' kernels: mlp_routes.cu)

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
    if (col >= n) continue;  // n is even: col + 1 < n too
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
// kStrided: c's rows ldc apart (the activation at F no multiple of 8),
// else n.
template <bool kGelu, bool kStrided = false>
__global__ void reduce_tc_kernel(const float* __restrict__ part,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ c, int m, int n,
                                 int ldc, int split) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < split; ++s) v += part[s * mn + i];
    v += __bfloat162float(bias[i % n]);
    c[kStrided ? i / n * ldc + i % n : i] =
        __float2bfloat16_rn(kGelu ? gelu_tanh(v) : v);
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

// The column tiles each pass has an instance for (ops/mlp.py's TILES).
bool tc_tile_ok(int pass, int bn) {
  return pass == 1 ? bn == kTcBN1 || bn == 200 : bn == kTcBN2 || bn == 208;
}

struct TcPlan {
  int split1, split2;
  size_t act_bytes, bytes;  // the bf16 activation, then f32 split sums
};

// ld_act: the bf16 activation's row stride (bf16_plan's: F rounded up to
// 64, rows on 128-byte lines for fc2's TMA loads); phases: W2^T on
// tma_phases (fc2's tiles then 128 of its columns by bn2 of its rows).
cudaError_t plan_bf16(int m, int h, int f, int o, int bn1, int bn2,
                      long long ld_act, bool phases, TcPlan* p) {
  if (!tc_tile_ok(1, bn1) || !tc_tile_ok(2, bn2) || ld_act < f ||
      ld_act % 8)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->split1 = tc_split(m, f, h, bn1, sms);
  p->split2 = phases ? tc_phases_split(m, o, f, sms)
                     : tc_split(m, o, f, bn2, sms);
  p->act_bytes = ((size_t)m * ld_act * 2 + 255) / 256 * 256;
  const size_t part1 = p->split1 > 1 ? (size_t)p->split1 * m * f : 0;
  const size_t part2 = p->split2 > 1 ? (size_t)p->split2 * m * o : 0;
  p->bytes = p->act_bytes + 4 * std::max(part1, part2);
  return cudaSuccess;
}

// Whether `o` ([rows, k]) lies where its route can load it: TMA wants the
// base and the row stride on 16-byte steps, tma_pairs the base on one and
// the stride 8 bytes past one, tma_phases the base on one and the stride
// not, staged an element-aligned base; rows overlap nowhere.
bool load_ok(const Operand& o, int rows, int k) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(o.p);
  if (rows > 1 && o.ld < k) return false;
  switch (o.load) {
    case kTma: return p % 16 == 0 && o.ld % 8 == 0;
    case kTmaPairs: return p % 16 == 0 && o.ld % 8 == 4 && rows > 1;
    case kTmaPhases: return p % 16 == 0 && o.ld % 8 != 0 && rows > 1;
    case kStaged: return p % 2 == 0;
  }
  return false;
}

// c [m, n] = epilogue(a [m, k] b[n, k]^T + bias), split `split` ways, on
// the flagship's kernel: a and b on TMA (rows lda and ldb apart), c's rows
// n apart, n even.
template <int BN, bool kGelu>
cudaError_t gemm_tc(const __nv_bfloat16* a, long long lda,
                    const __nv_bfloat16* b, long long ldb,
                    const __nv_bfloat16* bias, __nv_bfloat16* c, float* part,
                    int m, int n, int k, int split, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  if (!tc_map(&amap, a, m, k, lda, kTcBM) ||
      !tc_map(&bmap, b, n, k, ldb, BN))
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
  return reduce_tc(kGelu, part, bias, c, m, n, n, split, stream);
}

// One pass on the instance of its column tile bn: fc1 on tma_pairs where
// both operands are; fc2 on gemm_tc_phases_kernel where W2^T is on
// tma_phases; the flagship's kernel where the pass is laid out as the
// flagship's (bn its width, both operands on TMA, c's rows n apart, n
// even); else gemm_tc_any_kernel.
template <bool kGelu>
cudaError_t tc_pass(int bn, const Operand& a, const Operand& b,
                    const __nv_bfloat16* bias, __nv_bfloat16* c, int ldc,
                    float* part, int m, int n, int k, int split,
                    cudaStream_t s) {
  constexpr int kFlagship = kGelu ? kTcBN1 : kTcBN2;
  if (a.load == kTmaPairs || b.load == kTmaPairs) {  // fc1's, both or none
    if (!kGelu || a.load != b.load) return cudaErrorInvalidValue;
    return tc_pairs_pass(bn, a, b, bias, c, ldc, part, m, n, k, split, s);
  }
  if (a.load == kTmaPhases || b.load == kTmaPhases) {  // fc2's W2^T alone
    if (kGelu) return cudaErrorInvalidValue;
    return tc_phases_pass(bn, a, b, bias, c, ldc, part, m, n, k, split, s);
  }
  if (bn == kFlagship && a.load == kTma && b.load == kTma && ldc == n &&
      n % 2 == 0)
    return gemm_tc<kFlagship, kGelu>(a.p, a.ld, b.p, b.ld, bias, c, part, m,
                                     n, k, split, s);
  return tc_any_pass(kGelu, bn, a, b, bias, c, ldc, part, m, n, k, split, s);
}

int launch_f32(const void* x, const void* w1t, const void* b1,
               const void* w2t, const void* b2, void* scratch, void* out,
               int m, int h, int f, int o, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_f32(m, h, f, o, &p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ldf = act_ld(f);
  float* act = static_cast<float*>(scratch);
  float* part = act + (size_t)m * ldf;
  err = gemm<true>(static_cast<const float*>(x),
                   static_cast<const float*>(w1t),
                   static_cast<const float*>(b1), act, part, m, f, h, h, ldf,
                   p.fc1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<false>(act, static_cast<const float*>(w2t),
                          static_cast<const float*>(b2),
                          static_cast<float*>(out), part, m, o, f, ldf, o,
                          p.fc2, s);
}

// lds: the row strides of x, w1t, w2t and the activation (elements);
// plan: fc1's and fc2's column tiles, then the loads of x, w1t, the
// activation and w2t (ops/mlp.py's bf16_plan).  An instance or a route the
// operands do not allow is refused (cudaErrorInvalidValue).
int launch_bf16(const void* x, const void* w1t, const void* b1,
                const void* w2t, const void* b2, void* scratch, void* out,
                const long long* lds, const int* plan, int m, int h, int f,
                int o, void* stream) {
  using bf16 = __nv_bfloat16;
  if (m <= 0 || h <= 0 || f <= 0 || o <= 0 || plan[4] != kTma)
    return (int)cudaErrorInvalidValue;
  const Operand xa{static_cast<const bf16*>(x), lds[0], plan[2]};
  const Operand w1a{static_cast<const bf16*>(w1t), lds[1], plan[3]};
  const int ldf = (int)lds[3];
  auto* act = static_cast<bf16*>(scratch);
  const Operand acta{act, ldf, kTma};
  const Operand w2a{static_cast<const bf16*>(w2t), lds[2], plan[5]};
  if (!load_ok(xa, m, h) || !load_ok(w1a, f, h) || !load_ok(acta, m, f) ||
      !load_ok(w2a, o, f))
    return (int)cudaErrorInvalidValue;
  TcPlan p;
  cudaError_t err =
      plan_bf16(m, h, f, o, plan[0], plan[1], ldf, plan[5] == kTmaPhases, &p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  auto* part =
      reinterpret_cast<float*>(static_cast<uint8_t*>(scratch) + p.act_bytes);
  err = tc_pass<true>(plan[0], xa, w1a, static_cast<const bf16*>(b1), act,
                      ldf, part, m, f, h, p.split1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)tc_pass<false>(plan[1], acta, w2a,
                             static_cast<const bf16*>(b2),
                             static_cast<bf16*>(out), o, part, m, o, f,
                             p.split2, s);
}

}  // namespace

// TMA map of a row-major [rows, cols] bf16 matrix whose rows are ld
// elements apart, boxes of 64 columns (128 bytes, swizzled) x box_rows
// rows; zeros past cols and rows.
bool tc_map(CUtensorMap* map, const void* p, int rows, int cols, long long ld,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * ld};
  const cuuint32_t box[2] = {kTcBK, (cuuint32_t)box_rows};
  return mint::make_map(map, p, 2, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t reduce_tc(bool gelu, const float* part, const bf16* bias, bf16* c,
                      int m, int n, int ldc, int split, cudaStream_t stream) {
  const int blocks =
      (int)std::min<long long>(1024, ((long long)m * n + 255) / 256);
  if (gelu && ldc == n)
    reduce_tc_kernel<true><<<blocks, 256, 0, stream>>>(part, bias, c, m, n,
                                                       ldc, split);
  else if (gelu)
    reduce_tc_kernel<true, true><<<blocks, 256, 0, stream>>>(
        part, bias, c, m, n, ldc, split);
  else if (ldc == n)
    reduce_tc_kernel<false><<<blocks, 256, 0, stream>>>(part, bias, c, m, n,
                                                        ldc, split);
  else
    reduce_tc_kernel<false, true><<<blocks, 256, 0, stream>>>(
        part, bias, c, m, n, ldc, split);
  return cudaGetLastError();
}

}  // namespace mint_mlp

using namespace mint_mlp;

// x [m, h], w1t [f, h], b1 [f], w2t [o, f], b2 [o], out [m, o].  f32: all
// contiguous, any widths, scratch an f32 buffer of mint_mlp_f32_scratch(m,
// h, f, o) floats (the activation, then split partial sums).  bf16: any
// widths, x's and the weights' rows lds[0..2] elements apart (each row
// contiguous), the activation's lds[3], loaded and tiled as `plan` says
// (launch_bf16), biases and out contiguous, and scratch a 256-byte aligned
// buffer of mint_mlp_bf16_scratch(m, h, f, o, plan[0], plan[1], lds[3])
// bytes (the bf16 activation, then f32 split partial sums).
extern "C" long long mint_mlp_f32_scratch(int m, int h, int f, int o) {
  Plan p;
  if (m <= 0 || f <= 0 || o <= 0 || plan_f32(m, h, f, o, &p) != cudaSuccess)
    return -1;
  return (long long)p.scratch;
}

extern "C" long long mint_mlp_bf16_scratch(int m, int h, int f, int o,
                                           int bn1, int bn2, int ld_act) {
  // Enough for fc2 on either kernel (tma_phases splits by its own tiles).
  TcPlan p, q;
  if (m <= 0 || f <= 0 || o <= 0 ||
      plan_bf16(m, h, f, o, bn1, bn2, ld_act, false, &p) != cudaSuccess ||
      plan_bf16(m, h, f, o, bn1, bn2, ld_act, true, &q) != cudaSuccess)
    return -1;
  return (long long)std::max(p.bytes, q.bytes);
}

extern "C" int mint_mlp_f32(const void* x, const void* w1t, const void* b1,
                            const void* w2t, const void* b2, void* scratch,
                            void* out, int m, int h, int f, int o,
                            void* stream) {
  return launch_f32(x, w1t, b1, w2t, b2, scratch, out, m, h, f, o, stream);
}

extern "C" int mint_mlp_bf16(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* scratch,
                             void* out, const long long* lds, const int* plan,
                             int m, int h, int f, int o, void* stream) {
  return launch_bf16(x, w1t, b1, w2t, b2, scratch, out, lds, plan, m, h, f, o,
                     stream);
}
