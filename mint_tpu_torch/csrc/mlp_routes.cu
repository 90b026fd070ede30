// The bf16 fused MLP's kernels for layouts other than the flagship's
// (mlp.cu has the flagship's, the plan and the C entry; ops/mlp.py's
// bf16_plan picks the route): gemm_tc_any_kernel, a GEMM pass at any
// column tile of the instance set with each operand on TMA or staged
// through shared memory, and gemm_tc_pairs_kernel, fc1 at hidden widths
// whose rows lie 8 bytes past a 16-byte step every other row.  What
// bounds them and why they are built so: mlp.cu's header.
#include <math.h>

#include <algorithm>

#include "mlp_tc.cuh"
#include "wgmma.cuh"

namespace mint_mlp {
namespace {

constexpr int kProducerWarps = 4;  // a warpgroup: copies and moves
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kTcAnyThreads = 256 + kProducers;
constexpr int kRawWords = 9;  // 16-byte words a row's 128-byte k-tile spans
constexpr int kRawPitch = 16 * kRawWords;
constexpr int kRawSlots = 2;
constexpr int kRawLag = kRawSlots - 1;  // tiles of raw copies in flight
constexpr int kStagedStages = 3;  // ring depth beside the raw slots

// Dynamic shared memory of gemm_tc_any_kernel<BN>: the ring (kTcStages
// deep on TMA alone, kStagedStages beside the raw slots when an operand
// is staged), the raw slots, the mbarriers.  227 KB at BN = 208, staged.
template <int BN>
constexpr size_t tc_any_smem(bool staged) {
  return 1024 +
         (size_t)(staged ? kStagedStages : kTcStages) * (kTcBM + BN) *
             kTcBK * 2 +
         (staged ? (size_t)kRawSlots * (kTcBM + BN) * kRawPitch : 0) +
         2 * kTcStages * sizeof(uint64_t);
}

// Where row `row`'s k-tile from column k0 starts.
__device__ __forceinline__ const __nv_bfloat16* row_at(const Operand& o,
                                                       int row, int k0) {
  return o.p + row * o.ld + k0;
}

// Producer thread p's share of the raw copies of rows r0 .. r0 + R of `o`
// at k-tile k0: a row's kRawWords aligned 16-byte words from the one that
// holds its column k0, each copied where it holds one of the row's
// columns below k (so it lies in the row's allocation), else zero-filled.
// Thread p < 9 * (kProducers / 9) copies word p % 9 of rows p / 9,
// p / 9 + kProducers / 9, ...: a warp's copies are consecutive words.
// The caller commits.
template <int R>
__device__ __forceinline__ void copy_raw(uint8_t* raw, const Operand& o,
                                         int r0, int rows, int k0, int k,
                                         int p) {
  constexpr int kRowsAPass = kProducers / kRawWords;
  if (p >= kRowsAPass * kRawWords) return;
  const int w = p % kRawWords, live = 2 * min(kTcBK, k - k0);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(o.p) & ~static_cast<uintptr_t>(15);
#pragma unroll 4
  for (int r = p / kRawWords; r < R; r += kRowsAPass) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row_at(o, r0 + r, k0));
    const int sh = (int)(a % 16);
    const bool ok = r0 + r < rows && 16 * w < sh + live;
    mint::cp_async16(raw + r * kRawPitch + 16 * w,
                     reinterpret_cast<const void*>(ok ? a - sh + 16 * w : any),
                     ok);
  }
}

// The 16 bytes at s (kStep-byte aligned, kStep = 16, 8, 4, or 2: then s is
// 2 bytes past a 4-byte step) in shared memory, by loads of kStep bytes
// (2: five 4-byte words shifted by 16 bits).
template <int kStep>
__device__ __forceinline__ uint4 lds16(const uint8_t* s) {
  if constexpr (kStep == 16) {
    return *reinterpret_cast<const uint4*>(s);
  } else if constexpr (kStep == 8) {
    const uint2 lo = *reinterpret_cast<const uint2*>(s);
    const uint2 hi = *reinterpret_cast<const uint2*>(s + 8);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else if constexpr (kStep == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s - 2);
    const uint32_t x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3], x4 = w[4];
    return make_uint4(__funnelshift_r(x0, x1, 16), __funnelshift_r(x1, x2, 16),
                      __funnelshift_r(x2, x3, 16), __funnelshift_r(x3, x4, 16));
  }
}

// Row r of the stage tile from its raw words at src (the row's k-tile sh
// bytes in): 16-byte chunk q of the row (columns 8q .. 8q + 7) into chunk
// q ^ (r % 8); columns from `live` on zeroed.
template <int kStep>
__device__ __forceinline__ void move_row(uint8_t* dst, const uint8_t* src,
                                         int r, int live) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint4 v = lds16<kStep>(src + 16 * q);
    if (live < kTcBK) {  // the last k-tile
      const int cols = live - 8 * q;
      uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] &= 2 * i + 1 < cols ? 0xffffffffu : 2 * i < cols ? 0xffffu : 0u;
    }
    *reinterpret_cast<uint4*>(dst + 128 * r + ((q ^ (r & 7)) << 4)) = v;
  }
}

// Producer thread p's share of moving rows r0 .. r0 + R from the raw slot
// into the swizzled stage tile, a row a thread: its loads as wide as its
// byte phase allows; rows past `rows` zero.
template <int R>
__device__ __forceinline__ void move_raw(uint8_t* tile, const uint8_t* raw,
                                         const Operand& o, int r0, int rows,
                                         int k0, int k, int p) {
  const int live = min(kTcBK, k - k0);
  for (int r = p; r < R; r += kProducers) {
    if (r0 + r >= rows) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<uint4*>(tile + 128 * r + 16 * q) =
            make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int sh =
        (int)(reinterpret_cast<uintptr_t>(row_at(o, r0 + r, k0)) % 16);
    const uint8_t* src = raw + r * kRawPitch + sh;
    if (sh == 0)
      move_row<16>(tile, src, r, live);
    else if (sh % 8 == 0)
      move_row<8>(tile, src, r, live);
    else if (sh % 4 == 0)
      move_row<4>(tile, src, r, live);
    else
      move_row<2>(tile, src, r, live);
  }
}

// gemm_tc_kernel's product (the same consumers and split) over operands
// loaded by their routes, and c's rows ldc apart.  Warps 8-11 are the
// producers.  With both operands on TMA, thread 256 alone runs the
// flagship's loop over a kTcStages ring.  With one staged, the ring is
// kStagedStages deep beside kRawSlots raw slots: for k-tile i the
// producers copy tile i + 1's raw words (cp.async, one group), wait for
// tile i's, and after thread 256 has seen its stage free (and put the TMA
// operand's load in flight) and a barrier among them, move tile i into
// its stage, fence the moves for wgmma's (async proxy) reads and arrive on
// the stage's full mbarrier (kProducers arrivals, + 1 of thread 256
// announcing TMA's bytes where an operand is on TMA); a second barrier
// frees the raw slot.  The epilogue stores a pair of columns where it is
// 4-byte aligned and both exist (odd n or ldc break that on every other
// row), else one column at a time.
template <int BN, bool kGelu>
__global__ void __launch_bounds__(kTcAnyThreads, 1)
    gemm_tc_any_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const Operand a, const Operand b,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ c, float* __restrict__ part,
                       int m, int n, int k, int ldc, int split) {
  constexpr uint32_t kABytes = kTcBM * kTcBK * 2;
  constexpr uint32_t kBBytes = BN * kTcBK * 2;
  const bool staged = a.load != kTma || b.load != kTma;
  const int stages = staged ? kStagedStages : kTcStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mint::smem_addr(smem_raw);
  uint8_t* as = smem_raw + (1024 - raw % 1024) % 1024;  // [stages][128][64]
  uint8_t* bs = as + stages * kABytes;                  // [stages][BN][64]
  uint8_t* ra = bs + stages * kBBytes;  // [slots][128][kRawPitch], staged
  uint8_t* rb = ra + (staged ? kRawSlots * kTcBM * kRawPitch : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      rb + (staged ? kRawSlots * BN * kRawPitch : 0));
  uint64_t* empty = full + kTcStages;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  const int per = (ktiles + split - 1) / split;
  const int kt0 = blockIdx.z * per;
  const int nt = max(0, min(ktiles, kt0 + per) - kt0);
  const uint32_t tma_bytes =
      (a.load == kTma ? kABytes : 0) + (b.load == kTma ? kBBytes : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mint::mbar_init(full + s,
                      (tma_bytes ? 1 : 0) + (staged ? kProducers : 0));
      mint::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producers
    const int p = threadIdx.x - 256;
    // Thread 256: waits for stage i's slot, then TMA's loads into it.
    auto tma = [&](int i) {
      const int s = i % stages, k0 = (kt0 + i) * kTcBK;
      if (i >= stages) mint::mbar_wait(empty + s, (i / stages - 1) & 1);
      if (!tma_bytes) return;
      mint::mbar_expect_tx(full + s, tma_bytes);
      if (a.load == kTma)
        mint::tma_load_2d(as + s * kABytes, &amap, full + s, k0, m0);
      if (b.load == kTma)
        mint::tma_load_2d(bs + s * kBBytes, &bmap, full + s, k0, n0);
    };
    if (!staged) {
      if (p == 0)
        for (int i = 0; i < nt; ++i) tma(i);
      return;
    }
    auto copy = [&](int i) {  // tile i's raw words into its slot
      const int j = i % kRawSlots, k0 = (kt0 + i) * kTcBK;
      if (a.load != kTma)
        copy_raw<kTcBM>(ra + j * kTcBM * kRawPitch, a, m0, m, k0, k, p);
      if (b.load != kTma)
        copy_raw<BN>(rb + j * BN * kRawPitch, b, n0, n, k0, k, p);
    };
    for (int i = 0; i < kRawLag; ++i) {
      if (i < nt) copy(i);
      mint::cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      const int s = i % stages, j = i % kRawSlots, k0 = (kt0 + i) * kTcBK;
      if (i + kRawLag < nt) copy(i + kRawLag);
      mint::cp_async_commit();
      if (p == 0) tma(i);
      mint::cp_async_wait<kRawLag>();  // this thread's copies of tile i
      mint::named_bar_sync(1, kProducers);  // everyone's; stage s free
      if (a.load != kTma)
        move_raw<kTcBM>(as + s * kABytes, ra + j * kTcBM * kRawPitch, a, m0,
                        m, k0, k, p);
      if (b.load != kTma)
        move_raw<BN>(bs + s * kBBytes, rb + j * BN * kRawPitch, b, n0, n,
                     k0, k, p);
      mint::fence_proxy_async();
      mint::mbar_arrive(full + s);
      mint::named_bar_sync(1, kProducers);  // slot j read: free again
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int s = i % stages;
    mint::mbar_wait(full + s, (i / stages) & 1);
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;  // even
    if (col >= n) continue;
    const bool two = col + 1 < n;
    const float bias0 = split == 1 ? __bfloat162float(bias[col]) : 0.f;
    const float bias1 =
        split == 1 && two ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= m) continue;
      float v0 = acc[4 * j + 2 * hh] + bias0;
      float v1 = acc[4 * j + 2 * hh + 1] + bias1;
      if (split > 1) {
        const size_t at = (size_t)blockIdx.z * m * n + (size_t)row * n + col;
        float* dst = part + at;
        if (two && at % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
        continue;
      }
      if (kGelu) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      __nv_bfloat16* dst = c + (size_t)row * ldc + col;
      if (two && (row & ldc & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (two) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---- bf16 fc1 on tma_pairs: x and W1^T with rows 8 bytes past a step -----

// At hidden widths 4 columns past a 16-byte step (804: rows of 1608
// bytes), x's and W1^T's rows alternate between two 16-byte phases, so
// each is two TMA maps of every other row (2 rows apart: 3216 bytes, a
// whole step): the even rows', whose tiles hold columns k0 .. k0 + 63, and
// the odd rows', based 8 bytes early, whose tiles hold k0 - 4 .. k0 + 59.
// A block's 128 rows are 64 even ones (warpgroup 0's) and the 64 odd ones
// between them (warpgroup 1's); its BN columns are BN / 2 even W1^T rows
// and the BN / 2 odd ones, each half a product of N = BN / 2.  Where A's
// and B's tiles hold the same columns (even x even, odd x odd) the
// product is wgmma's from shared memory, as on TMA (`same`).  Where they
// do not (`cross`), A is wgmma's register operand: each warpgroup reads
// its own tile's fragments once, as TMA laid them (ldmatrix), and moves
// them 4 columns to the other parity's frame by warp shuffles
// (attention_pairs.cu's shift4), the neighbouring tile's 4 columns
// shifted in: even rows +4 (the tile before's last four), odd rows -4 (the
// next tile's first four).  So the odd rows' cross product of tile i
// needs tile i + 1: both warpgroups run it one step behind, in iteration
// i + 1 beside the same product of tile i + 1 (tiles i and i + 1 held,
// the rest of the ring in flight).  The shift runs between wgmma chains,
// never inside one, the same code in both warpgroups (each its direction
// by selects: a branch a warpgroup around the wgmma made ptxas serialise
// it, C7520).  Columns before 0 (the row before's last four, in both odd
// tiles at k-tile 0) meet zeros in A.  The column tile stays 192 (halves
// of 96): at x[7200, 804] its 57 x 16 blocks make 6.9 waves on 132 SMs,
// where 256 (N = 128) makes 5.2, so six waves of blocks a third longer,
// and 208 or 224 seven such waves; two products of N = 96 a k-step cost
// the flagship's fc1 nothing.  The epilogue stores each row's even and
// odd columns as pairs.  On an H100 (fc1 at x[7200, 804]): the design
// before it, A's cross fragments read 4 columns off with 16 shared-memory
// loads a thread a k-tile and the odd rows waiting for tile i + 1, 0.184
// ms; this one 0.173, against 0.124 for the flagship's fc1.  A fifth ring
// stage bought nothing (scripts/torch_mlp_bringup.py's pairs_5_stages),
// nor did blocks in clusters of two sharing their W1^T tile by TMA
// multicast; the flagship's route at hidden 808, whose rows start 16
// bytes into a 32-byte sector every other row as these do, ran 8% slower
// than at 816 (PERF.md).
constexpr int kPairsStages = 4;

template <int BN>
struct Pairs {
  static constexpr int kN = BN / 2;
  // The odd rows' half of a B stage starts on the next 1 KB (the swizzle's
  // atom); a stage is two halves.
  static constexpr uint32_t kHalf = (kN * 128 + 1023) / 1024 * 1024;
  static constexpr uint32_t kABytes = kTcBM * kTcBK * 2;
  static constexpr uint32_t kBBytes = 2 * kHalf;
  static constexpr size_t kSmem =
      1024 + (size_t)kPairsStages * (kABytes + kBBytes) +
      2 * kPairsStages * sizeof(uint64_t);
};

// This warp's A fragment of k-step kk (wgmma_rs: rows 16 warp + g and
// + 8, columns 16 kk + 2 t (+ 8) and the next) of a 128-byte-swizzled
// tile of 64 rows, by one ldmatrix: lane l gives the address of row
// 16 warp + 8 (l / 8 % 2) + l % 8 of 8-column block 2 kk + l / 16.
__device__ __forceinline__ void ld_frag(uint32_t (&a)[4], const uint8_t* tile,
                                        int kk, int warp, int lane) {
  const int r = 16 * warp + 8 * (lane / 8 % 2) + lane % 8;
  const uint32_t addr = mint::smem_addr(
      tile + 128 * r + (((2 * kk + lane / 16) ^ (r & 7)) << 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

template <int N>
__device__ __forceinline__ void ld_frags(uint32_t (&a)[N][4],
                                         const uint8_t* tile, int warp,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) ld_frag(a[kk], tile, kk, warp, lane);
}

// x = the fragments p (one tile's 8 column groups; group n, row r in
// p[n / 2][2 (n % 2) + r]) moved 4 columns: `up` (column c takes c - 4's,
// the tile before's last group `cin` shifted in) or down (c takes c + 4's,
// the next tile's first group `cin`).  A column 4 away is lane t ^ 2's,
// in the same group or the next: lanes t < 2 send their group n (up) or
// n + 1 (down), the others n - 1 (up) or n; one shuffle a value.
template <int N>
__device__ __forceinline__ void shift_frags(uint32_t (&x)[N][4],
                                            const uint32_t (&p)[N][4],
                                            const uint32_t (&cin)[2], bool up,
                                            bool lo) {
  constexpr int G = 2 * N;
  auto at = [&](int n, int r) { return p[n / 2][2 * (n % 2) + r]; };
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t below = n > 0 ? at(n - 1, r) : cin[r];
      const uint32_t above = n + 1 < G ? at(n + 1, r) : cin[r];
      const uint32_t send = lo ? (up ? at(n, r) : above)
                               : (up ? below : at(n, r));
      x[n / 2][2 * (n % 2) + r] = __shfl_xor_sync(0xffffffffu, send, 2);
    }
  mint::keep(x);
}

template <int BN, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
    gemm_tc_pairs_kernel(const __grid_constant__ CUtensorMap a_even,
                         const __grid_constant__ CUtensorMap a_odd,
                         const __grid_constant__ CUtensorMap b_even,
                         const __grid_constant__ CUtensorMap b_odd,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ c,
                         float* __restrict__ part, int m, int n, int k,
                         int ldc, int split) {
  using P = Pairs<BN>;
  constexpr int N2 = P::kN;
  constexpr int kSteps = kTcBK / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mint::smem_addr(smem_raw);
  uint8_t* as = smem_raw + (1024 - raw % 1024) % 1024;  // [stages][128][64]
  uint8_t* bs = as + kPairsStages * P::kABytes;  // [stages][2][kHalf]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kPairsStages * P::kBBytes);
  uint64_t* empty = full + kPairsStages;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTcBM;
  // Split z's k-tiles kt0 .. kt1 - 1; the ring holds tiles lo .. hi - 1,
  // one more on each side where there is one (the cross products shift in
  // 4 columns of the tiles around).  Unsplit (an instance of its own: the
  // split's bookkeeping cost the unsplit pass 7% at x[1440,804]), all.
  const int ktiles = (k + kTcBK - 1) / kTcBK;
  int kt0 = 0, kt1 = ktiles, lo = 0, hi = ktiles;
  if constexpr (kSplit) {
    const int per = (ktiles + split - 1) / split;
    kt0 = min(ktiles, (int)blockIdx.z * per);
    kt1 = min(ktiles, kt0 + per);
    lo = max(0, kt0 - 1);
    hi = min(ktiles, kt1 + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPairsStages; ++s) {
      mint::mbar_init(full + s, 1);
      mint::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256 && kt0 < kt1) {
      for (int i = lo; i < hi; ++i) {
        const int j = i - lo, s = j % kPairsStages;
        if (j >= kPairsStages)
          mint::mbar_wait_or_trap(empty + s, (j / kPairsStages - 1) & 1);
        mint::mbar_expect_tx(full + s, P::kABytes + 2 * N2 * kTcBK * 2);
        uint8_t* at = as + s * P::kABytes;
        uint8_t* bt = bs + s * P::kBBytes;
        mint::tma_load_2d(at, &a_even, full + s, i * kTcBK, m0 / 2);
        mint::tma_load_2d(at + 64 * 128, &a_odd, full + s, i * kTcBK, m0 / 2);
        mint::tma_load_2d(bt, &b_even, full + s, i * kTcBK, n0 / 2);
        mint::tma_load_2d(bt + P::kHalf, &b_odd, full + s, i * kTcBK, n0 / 2);
      }
    }
    return;
  }

  // Warpgroup wg (0: the even rows, 1: the odd ones): `same`, its rows x
  // W1^T's rows of its parity, and `cross`, its rows x the other parity's.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = 16 * warp + g;  // in the warpgroup's 64
  const bool up = wg == 0, lo_lane = t < 2;
  float same[N2 / 2], cross[N2 / 2];
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) same[i] = cross[i] = 0.f;
  auto slot = [&](int i) { return (unsigned)(i - lo) % kPairsStages; };
  auto a_tile = [&](int i) -> uint8_t* {
    return as + slot(i) * P::kABytes + wg * 64 * 128;
  };
  auto b_tile = [&](int i, int odd) {
    return bs + slot(i) * P::kBBytes + odd * P::kHalf;
  };
  auto wait_full = [&](int i) {  // a fault in the ring traps, not hangs
    mint::mbar_wait_or_trap(full + slot(i),
                            ((unsigned)(i - lo) / kPairsStages) & 1);
  };
  auto desc = [](const uint8_t* p, int j) {
    return mint::smem_desc(p + 32 * j, 16, 1024, 1);
  };
  auto release = [&](int i) {
    if (threadIdx.x % 128 == 0) mint::mbar_arrive(empty + slot(i));
  };
  // prev: this warpgroup's fragments of the tile before, as they lie; x:
  // them moved to the other parity's frame (the cross product's A); c7:
  // the group 7 of the tile before that (the even rows' carry).
  uint32_t prev[kSteps][4], cur[kSteps][4], x[kSteps][4];
  uint32_t c7[2] = {0u, 0u}, cin[2];
  if (kt0 < kt1) {
    if (lo < kt0) {  // split: the tile before's last group
      wait_full(lo);
      uint32_t f[4];
      ld_frag(f, a_tile(lo), kSteps - 1, warp, lane);
      c7[0] = f[2];
      c7[1] = f[3];
    }
    wait_full(kt0);
    if (kt0 == 0) {  // the odd rows' first columns: the row before's tail
      if (wg == 1 && threadIdx.x % 128 < 64) {
        *reinterpret_cast<uint2*>(a_tile(0) + swizzled(threadIdx.x % 128, 0)) =
            make_uint2(0u, 0u);
        mint::fence_proxy_async();
      }
      mint::named_bar_sync(1 + wg, 128);
    }
    ld_frags(prev, a_tile(kt0), warp, lane);
    const uint8_t* b_same = b_tile(kt0, wg);
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mint::wgmma_ss<N2>(same, desc(a_tile(kt0), j), desc(b_same, j));
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    if (lo < kt0) release(lo);
  }
  // Tile i's same product and tile i - 1's cross product, the shift
  // between the chains.
  for (int i = kt0 + 1; i < kt1; ++i) {
    wait_full(i);
    ld_frags(cur, a_tile(i), warp, lane);
    cin[0] = up ? c7[0] : cur[0][0];
    cin[1] = up ? c7[1] : cur[0][1];
    c7[0] = prev[kSteps - 1][2];
    c7[1] = prev[kSteps - 1][3];
    shift_frags(x, prev, cin, up, lo_lane);
    const uint8_t* b_same = b_tile(i, wg);
    const uint8_t* b_cross = b_tile(i - 1, !wg);
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mint::wgmma_ss<N2>(same, desc(a_tile(i), j), desc(b_same, j));
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mint::wgmma_rs<N2, 0>(cross, x[j], desc(b_cross, j));
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    release(i - 1);  // both products of tile i - 1 are done
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) prev[j][e] = cur[j][e];
  }
  // The last tile's cross product: the odd rows shift in the next tile's
  // first group where there is one (split), else zeros.
  if (kt0 < kt1) {
    uint32_t f[4] = {0u, 0u, 0u, 0u};
    if (kt1 < hi) {
      wait_full(kt1);
      ld_frag(f, a_tile(kt1), 0, warp, lane);
    }
    cin[0] = up ? c7[0] : f[0];
    cin[1] = up ? c7[1] : f[1];
    shift_frags(x, prev, cin, up, lo_lane);
    const uint8_t* b_cross = b_tile(kt1 - 1, !wg);
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mint::wgmma_rs<N2, 0>(cross, x[j], desc(b_cross, j));
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
  }

  // same / cross [4 jj + e]: row row + 8 (e / 2) of the warpgroup's
  // parity, column 8 jj + 2 t + e % 2 of a half: W1^T's row (column of c)
  // n0 + 2 (that) + its parity (wg for same, !wg for cross).
#pragma unroll
  for (int jj = 0; jj < N2 / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mr = m0 + 2 * (row + 8 * (e / 2)) + wg;
      const int col = n0 + 2 * (8 * jj + 2 * t + e % 2);
      if (mr >= m || col >= n) continue;
      const float ev = wg ? cross[4 * jj + e] : same[4 * jj + e];
      const float od = wg ? same[4 * jj + e] : cross[4 * jj + e];
      if constexpr (kSplit) {  // split z's raw sums; reduce_tc finishes
        const size_t at = ((size_t)blockIdx.z * m + mr) * n + col;
        if (col + 1 < n && at % 2 == 0) {
          *reinterpret_cast<float2*>(part + at) = make_float2(ev, od);
        } else {
          part[at] = ev;
          if (col + 1 < n) part[at + 1] = od;
        }
        continue;
      }
      const float v0 = gelu_tanh(ev + __bfloat162float(bias[col]));
      __nv_bfloat16* dst = c + (size_t)mr * ldc + col;
      if (col + 1 < n) {
        const float v1 = gelu_tanh(od + __bfloat162float(bias[col + 1]));
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
      }
    }
  }
}

// TMA map of every other row of a row-major [rows, cols] bf16 matrix whose
// rows are ld elements apart, from row `first` (0 or 1): its rows 2 ld
// apart; `shift` columns before each row (its base that many elements
// early: 4 for rows 8 bytes past a 16-byte step), boxes of 64 columns x
// box_rows.
bool pairs_map(CUtensorMap* map, const __nv_bfloat16* p, int rows, int cols,
               long long ld, int first, int shift, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)(cols + shift),
                              (cuuint64_t)((rows - first + 1) / 2)};
  const cuuint64_t strides[1] = {4ull * ld};
  const cuuint32_t box[2] = {kTcBK, (cuuint32_t)box_rows};
  return rows > first &&
         mint::make_map(map, p + first * ld - shift, 2, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// fc1 c [m, n] = gelu(a [m, k] b [n, k]^T + bias) on tma_pairs: a and b
// with rows ld apart, ld 4 past a multiple of 8, bases on 16-byte steps.
template <int BN>
cudaError_t gemm_tc_pairs(const Operand& a, const Operand& b,
                          const __nv_bfloat16* bias, __nv_bfloat16* c,
                          int ldc, float* part, int m, int n, int k,
                          int split, cudaStream_t stream) {
  CUtensorMap ae, ao, be, bo;
  if (!pairs_map(&ae, a.p, m, k, a.ld, 0, 0, 64) ||
      !pairs_map(&ao, a.p, m, k, a.ld, 1, 4, 64) ||
      !pairs_map(&be, b.p, n, k, b.ld, 0, 0, BN / 2) ||
      !pairs_map(&bo, b.p, n, k, b.ld, 1, 4, BN / 2))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Pairs<BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      split == 1 ? gemm_tc_pairs_kernel<BN, false>
                 : gemm_tc_pairs_kernel<BN, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kTcBM - 1) / kTcBM, split);
  if (split == 1) {
    gemm_tc_pairs_kernel<BN, false><<<grid, kTcThreads, smem, stream>>>(
        ae, ao, be, bo, bias, c, part, m, n, k, ldc, split);
    return cudaGetLastError();
  }
  gemm_tc_pairs_kernel<BN, true><<<grid, kTcThreads, smem, stream>>>(
      ae, ao, be, bo, bias, c, part, m, n, k, ldc, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_tc(true, part, bias, c, m, n, ldc, split, stream);
}

// The same on gemm_tc_any_kernel: a and b by their routes, c's rows ldc
// apart.
template <int BN, bool kGelu>
cudaError_t gemm_tc_any(const Operand& a, const Operand& b,
                        const __nv_bfloat16* bias, __nv_bfloat16* c, int ldc,
                        float* part, int m, int n, int k, int split,
                        cudaStream_t stream) {
  CUtensorMap amap{}, bmap{};
  if ((a.load == kTma && !tc_map(&amap, a.p, m, k, a.ld, kTcBM)) ||
      (b.load == kTma && !tc_map(&bmap, b.p, n, k, b.ld, BN)))
    return cudaErrorInvalidValue;
  const size_t smem =
      tc_any_smem<BN>(a.load != kTma || b.load != kTma);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tc_any_kernel<BN, kGelu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kTcBM - 1) / kTcBM, split);
  gemm_tc_any_kernel<BN, kGelu><<<grid, kTcAnyThreads, smem, stream>>>(
      amap, bmap, a, b, bias, c, part, m, n, k, ldc, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  return reduce_tc(kGelu, part, bias, c, m, n, ldc, split, stream);
}

}  // namespace

cudaError_t tc_any_pass(bool gelu, int bn, const Operand& a, const Operand& b,
                        const bf16* bias, bf16* c, int ldc, float* part,
                        int m, int n, int k, int split, cudaStream_t stream) {
  if (gelu && bn == kTcBN1)
    return gemm_tc_any<kTcBN1, true>(a, b, bias, c, ldc, part, m, n, k, split,
                                     stream);
  if (gelu && bn == 200)
    return gemm_tc_any<200, true>(a, b, bias, c, ldc, part, m, n, k, split,
                                  stream);
  if (!gelu && bn == kTcBN2)
    return gemm_tc_any<kTcBN2, false>(a, b, bias, c, ldc, part, m, n, k,
                                      split, stream);
  if (!gelu && bn == 208)
    return gemm_tc_any<208, false>(a, b, bias, c, ldc, part, m, n, k, split,
                                   stream);
  return cudaErrorInvalidValue;
}

cudaError_t tc_pairs_pass(int bn, const Operand& a, const Operand& b,
                          const bf16* bias, bf16* c, int ldc, float* part,
                          int m, int n, int k, int split,
                          cudaStream_t stream) {
  return bn == kTcBN1 ? gemm_tc_pairs<kTcBN1>(a, b, bias, c, ldc, part, m, n,
                                              k, split, stream)
                      : cudaErrorInvalidValue;
}

}  // namespace mint_mlp
