// Unmasked multi-head attention forward: out = softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel mint_tpu/ops/attention.py::_attn_kernel
// (wrapped by pallas_attention, attention.py:72).  Same arithmetic: scores
// in f32, then scaled; max subtracted before exp; P = exp / sum cast to the
// input type before P.V; P.V accumulated in f32 and cast to the input type.
// Unlike the TPU kernel, Nq may be smaller than Nk (the decode's final
// block has 48 queries against 360 keys).
//
// Layouts: q, k and v are [B, H, N, D] views with any strides on B, H and
// N and D contiguous: the model passes views of its fused QKV projection,
// a [B, N, 3, H, D] buffer, as they are.  The output is written through
// strides too; the wrapper hands it [B, N, H, D] storage, so the model's
// merge of the heads is a view.  Neither side copies.
//
// What bounds it on an H100: the work is 4*Nq*Nk*D flops per head against
// (2*Nq + 2*Nk)*D elements of traffic.  At FACT's shapes (Nk <= 360,
// D = 80) exact f32 is compute-bound on the FMA pipes (67 TFLOP/s;
// 0.124 ms at q[20,10,360,80]); bf16 on the tensor cores (989 TFLOP/s)
// is bound by its bytes (46 MB, 0.0138 ms at 3.35 TB/s at that shape).
//
// - f32 (attention_kernel): exact f32 on the FMA pipes (no TF32), one
//   pass with an online softmax.  Casting P to f32 is a no-op, so nothing
//   needs the exactly normalised P before P.V: each row keeps a running
//   max and sum, and its f32 P.V accumulator is rescaled by
//   exp(old max - new max) when the max rises, then divided by the sum at
//   the end (exact up to f32 rounding).  One head's K and V (230 KB at
//   Nk = 360) exceed the 227 KB of shared memory a block can use, so they
//   stream in 32-key tiles; keys past Nk in the last tile take no part
//   (the TPU kernel's -1e30 mask).  One block per (batch*head, 16 x
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
//   fast as the general one on an H100).
// - bf16 (attention_tc_kernel): Hopper's TMA and wgmma, two passes over
//   the keys: the first finds each row's max and sum of exp (online,
//   merged across the four threads that share a row), the second forms
//   the exactly normalised P, rounds it to bf16 as the TPU kernel does,
//   and accumulates P.V.  Recomputing Q.K^T costs a third more tensor-core
//   work and a second exp per score, but makes P the reference's
//   normalisation, so the bf16 rounding of P matches the plain version.
//   Both passes read every key, so a block holds the head's whole K in
//   shared memory (57.6 KB at Nk = 360), loaded once; V, read only by the
//   second pass, streams through a ring of 3 tiles.  One thread issues
//   every load by TMA, each 64-key tile completing on its own mbarrier, so
//   the first pass starts on key 0 while the rest is still arriving; the
//   only block barrier is the one that frees a V slot.  Both products are
//   wgmma with A in registers: Q's fragments, read once from device
//   memory, for Q.K^T (m64n64k16, K as a K-major B); P straight from the
//   score accumulators, whose layout is wgmma's A-fragment layout, for P.V
//   (V as an N-major B, so V needs no transpose).  A tile holds the head
//   dim as 64-column slabs with the 128-byte swizzle and 16-column slabs
//   with the 32-byte swizzle (D = 80: one of each), one TMA box each, so
//   the loads move rows of 128 or 32 contiguous bytes.  A block is one
//   warpgroup per 64 query rows, two when Nq > 64 (three blocks per head
//   at Nq = 360, 600 for the batch-20 decode); at D = 80 and Nk = 360 it
//   takes 92 KB and at most 128 registers a thread, so two blocks share an
//   SM.  Needs D a multiple of 16, and the head's K within shared memory
//   (Nk <= 1216 at D = 80, 704 at D = 128; ops/attention.py's
//   bf16_max_keys mirrors tc_smem_bytes and raises above it).

#include <math.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 128;

// Strides, in elements, of a [B, H, N, D] view (D contiguous).
struct Strides {
  long long b, h, n;
};

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

// Issues the copies of rows [r0, r0 + rows) of an [n, d] matrix whose rows
// are `stride` elements apart into dst[rows][ld]; rows past n are
// zero-filled.  vec: 16-byte copies (d, the stride and the base are
// multiples of 4 floats), else 4-byte ones.  Columns d .. ld stay as they
// are (zeroed once by the kernel when d is not a multiple of 4).
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int rows, int n, int d,
                                          bool vec) {
  if (vec) {
    const int d4 = d / 4;
    for (int i = threadIdx.x; i < rows * d4; i += blockDim.x) {
      const int r = i / d4;
      const int c = 4 * (i - r * d4);
      const bool ok = r0 + r < n;
      mint::cp_async16(dst + r * ld + c,
                       ok ? src + (r0 + r) * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      const bool ok = r0 + r < n;
      mint::cp_async4(dst + r * ld + c,
                      ok ? src + (r0 + r) * stride + c : src, ok);
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
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     int heads, int nq, int nk, int d, float scale,
                     bool vec) {
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

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kWarpRows * warps;
  const float* qh = q + b * qs_.b + h * qs_.h;
  const float* kh = k + b * ks_.b + h * ks_.h;
  const float* vh = v + b * vs_.b + h * vs_.h;

  if (!D4 && d % 4) {  // zero the pad columns d .. 4 d4 of Q, K and V
    const int pad = 4 * d4 - d;
    const int rows = kWarpRows * warps + 2 * kKTile;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
      qs[(i / pad) * ld + d + i % pad] = 0.f;
  }
  load_rows(qs, ld, qh, qs_.n, q0, kWarpRows * warps, nq, dd, vec);
  load_rows(ks, ld, kh, ks_.n, 0, kKTile, nk, dd, vec);
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
    load_rows(vs, ld, vh, vs_.n, k0, kKTile, nk, dd, vec);  // overlaps the scores
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
    if (k0 + kKTile < nk)
      load_rows(ks, ld, kh, ks_.n, k0 + kKTile, kKTile, nk, dd, vec);
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
  float* oh = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * kWarpRows + pr + 8 * i;
    if (row >= nq) continue;
    const float l = l_s[pr + 8 * i];
    float* orow = oh + row * os_.n;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int c = 4 * (pq + 4 * u);
      if (c >= d) continue;
      const float4 o = make_float4(acc[i][u].x / l, acc[i][u].y / l,
                                   acc[i][u].z / l, acc[i][u].w / l);
      if (vec) {
        *reinterpret_cast<float4*>(orow + c) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) orow[c + e] = get(o, e);
      }
    }
  }
}

// ---- bf16 on tensor cores: TMA + wgmma ----------------------------------

constexpr int kTcWgRows = 64;     // query rows per warpgroup (wgmma's M)
constexpr int kTcMaxWgs = 2;      // warpgroups per block
constexpr int kTcKeys = 64;       // keys per K / V tile (N of the scores)
constexpr int kTcVStages = 3;     // V tiles resident at a time (a ring)
constexpr int kTcBarBytes = 1024;     // mbarriers at the start of smem
constexpr int kTcMaxTiles = kTcBarBytes / 8 / 2;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block can use on an H100

// A K or V tile in shared memory: the head dim in 64-column slabs with the
// 128-byte swizzle (rows of 128 bytes), then 16-column slabs with the
// 32-byte swizzle (rows of 32 bytes): D = 80 is one of each, 10 KB for 64
// keys.  Each slab is one TMA box, so a load moves rows of 128 or 32
// contiguous bytes (unswizzled 8-column boxes, rows of 16 bytes, made the
// loads half of the kernel's time on an H100).
template <int D>
struct TcTile {
  static constexpr int kWide = D / 64;          // 64-column slabs
  static constexpr int kNarrow = D % 64 / 16;   // 16-column slabs
  static constexpr int kWideBytes = kTcKeys * 128;
  static constexpr int kNarrowBytes = kTcKeys * 32;
  static constexpr int kBytes = kWide * kWideBytes + kNarrow * kNarrowBytes;
};

// Every K tile, and up to kTcVStages V tiles.
size_t tc_smem_bytes(int d, int tiles) {
  // 1 KB of slack to align the tiles to the swizzle's 1 KB atoms.
  return 2 * kTcBarBytes +
         (size_t)(tiles + std::min(tiles, kTcVStages)) * kTcKeys * 2 * d;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Merge (m, l) with (mo, lo): running max and sum of exp2(s - max).
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  const float a = (m == -INFINITY) ? 0.f : l * exp2f(m - mn);
  const float b = (mo == -INFINITY) ? 0.f : lo * exp2f(mo - mn);
  m = mn;
  l = a + b;
}

// Descriptor of a swizzled slab: 128-byte (layout 1) or 32-byte (layout 3)
// rows, 8-row groups `group` bytes apart.  Both offsets get that stride:
// as a K-major operand only the one between 8-row groups is read, and as
// an N-major one the slab is exactly one swizzle atom wide, so only the
// one between 8-row groups along K is.
__device__ __forceinline__ uint64_t slab_desc(const void* p, uint32_t group,
                                              uint32_t layout) {
  return mint::smem_desc(p, group, group, layout);
}

// Issues (and commits; the caller waits) the scores of this warpgroup's
// 64 query rows against K tile kt: s[4 n + e] = q . k of row (warp's 16
// rows) g + 8 (e / 2) and key 8 n + 2 t + e % 2 of the tile, unscaled.
template <int D>
__device__ __forceinline__ void tc_scores(const uint32_t (&qf)[D / 16][4],
                                          const uint8_t* kt, float (&s)[32]) {
  using T = TcTile<D>;
  mint::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns: 32 bytes into a wide slab's rows, or a narrow slab.
    const uint64_t desc =
        kk < 4 * T::kWide
            ? slab_desc(kt + (kk / 4) * T::kWideBytes + 32 * (kk % 4), 1024, 1)
            : slab_desc(kt + T::kWide * T::kWideBytes +
                            (kk - 4 * T::kWide) * T::kNarrowBytes,
                        256, 3);
    mint::wgmma_rs<64, 0>(s, qf[kk], desc, kk > 0);  // k-step 0 overwrites
  }
  mint::wgmma_commit();
}

// One block per (batch*head, 64 * warpgroups query rows); warpgroup w
// owns rows q0 + 64 w ..; within it warp j owns 16 rows, and a thread
// rows g and g + 8 of those (g = lane / 4, t = lane % 4).
template <int D>
__global__ void __launch_bounds__(128 * kTcMaxWgs, 2)
    attention_tc_kernel(const __nv_bfloat16* __restrict__ q, Strides qs_,
                        const __grid_constant__ CUtensorMap kwide,
                        const __grid_constant__ CUtensorMap knarrow,
                        const __grid_constant__ CUtensorMap vwide,
                        const __grid_constant__ CUtensorMap vnarrow,
                        __nv_bfloat16* __restrict__ out, Strides os_,
                        int heads, int nq, int nk, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* ks = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;
  const int tiles = (nk + kTcKeys - 1) / kTcKeys;
  uint8_t* vs = ks + tiles * T::kBytes;  // [kTcVStages][T::kBytes]
  uint64_t* kbar = bars;          // K tile t
  uint64_t* vbar = bars + tiles;  // V tile t

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kTcWgRows * (blockDim.x / 128);
  // One thread issues the TMA loads: a slab per box, a tile per mbarrier.
  auto load = [&](const CUtensorMap* wide, const CUtensorMap* narrow,
                  uint8_t* dst, uint64_t* bar, int t) {
    mint::mbar_expect_tx(bar, T::kBytes);
    for (int i = 0; i < T::kWide; ++i)
      mint::tma_load_4d(dst + i * T::kWideBytes, wide, bar, 64 * i,
                        kTcKeys * t, h, b);
    for (int i = 0; i < T::kNarrow; ++i)
      mint::tma_load_4d(dst + T::kWide * T::kWideBytes + i * T::kNarrowBytes,
                        narrow, bar, 64 * T::kWide + 16 * i, kTcKeys * t, h,
                        b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * tiles; ++i) mint::mbar_init(bars + i, 1);
    mint::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Every K tile, then the first V tiles: pass 1 starts on key 0 while
    // the rest lands.
    for (int t = 0; t < tiles; ++t)
      load(&kwide, &knarrow, ks + t * T::kBytes, kbar + t, t);
    for (int t = 0; t < min(tiles, kTcVStages); ++t)
      load(&vwide, &vnarrow, vs + t * T::kBytes, vbar + t, t);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  const int row = q0 + kTcWgRows * wg + 16 * warp + g;

  // Q's A fragments straight from device memory (each is read once):
  // k-step kk holds columns 16 kk + 2 t (a[0], a[1]) and + 8 (a[2], a[3]).
  uint32_t qf[D / 16][4];
  {
    const bf16* q0p = q + b * qs_.b + h * qs_.h + row * qs_.n + 2 * t4;
    const bf16* q8p = q0p + 8 * qs_.n;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = row < nq ? ld32(q0p + 16 * kk) : 0u;
      qf[kk][1] = row + 8 < nq ? ld32(q8p + 16 * kk) : 0u;
      qf[kk][2] = row < nq ? ld32(q0p + 16 * kk + 8) : 0u;
      qf[kk][3] = row + 8 < nq ? ld32(q8p + 16 * kk + 8) : 0u;
    }
  }

  // Pass 1: max and sum of exp2(s - max) (s in log2 units) of rows g
  // (r = 0) and g + 8 (r = 1) over this thread's keys, then merged across
  // the 4 threads of a row.
  float s[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    mint::mbar_wait(kbar + t, 0);
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    // Only the last tile has keys to mask; the others skip the test.
    auto stats = [&](auto full) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[16];  // scaled scores (the accumulators stay unwritten)
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[2 * n + e] = (decltype(full)::value || 8 * n + 2 * t4 + e < valid)
                               ? s[4 * n + 2 * r + e] * scale_log2
                               : -INFINITY;
            tmax = fmaxf(tmax, x[2 * n + e]);
          }
        const float mn = fmaxf(m[r], tmax);
        if (mn == -INFINITY) continue;  // no valid key in this thread's columns yet
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += exp2f(x[i] - mn);
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * exp2f(m[r] - mn)) + sum;
        m[r] = mn;
      }
    };
    if (valid >= kTcKeys)
      stats(std::true_type());
    else
      stats(std::false_type());
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge_stats(m[r], l[r], mo, lo);
    }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // Pass 2: P = exp2(s - max) / sum rounded to bf16, from the score
  // registers into the A fragments of P.V (score tiles 2 j and 2 j + 1 make
  // the 16-key step j: a[0] / a[2] row g, a[1] / a[3] row g + 8).  P.V runs
  // one m64n64k16 per wide slab of V and one m64n16k16 per narrow one; the
  // first (tile 0, keys 0-15: always valid) overwrites the accumulators.
  // Once every warpgroup is done with V tile t, its ring slot takes tile
  // t + kTcVStages.
  float ow[T::kWide ? T::kWide : 1][32];
  float on[T::kNarrow ? T::kNarrow : 1][8];
  for (int t = 0; t < tiles; ++t) {
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    uint32_t a[kTcKeys / 16][4];
    auto probs = [&](auto full) {
#pragma unroll
      for (int j = 0; j < kTcKeys / 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 2 * j + hh;
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p[e] = (decltype(full)::value || 8 * n + 2 * t4 + e < valid)
                         ? exp2f(s[4 * n + 2 * r + e] * scale_log2 - m[r]) *
                               inv_l[r]
                         : 0.f;
            a[j][2 * hh + r] = pack_bf16(p[0], p[1]);
          }
    };
    if (valid >= kTcKeys)
      probs(std::true_type());
    else
      probs(std::false_type());
    mint::mbar_wait(vbar + t, 0);
    const uint8_t* vt = vs + (t % kTcVStages) * T::kBytes;
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      if (16 * j >= valid) break;  // the same for the whole warpgroup
      const int acc = t > 0 || j > 0;
#pragma unroll
      for (int w = 0; w < T::kWide; ++w)
        mint::wgmma_rs<64, 1>(
            ow[w], a[j],
            slab_desc(vt + w * T::kWideBytes + 16 * j * 128, 1024, 1), acc);
#pragma unroll
      for (int w = 0; w < T::kNarrow; ++w)
        mint::wgmma_rs<16, 1>(
            on[w], a[j],
            slab_desc(vt + T::kWide * T::kWideBytes + w * T::kNarrowBytes +
                          16 * j * 32,
                      256, 3),
            acc);
    }
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    if (t + kTcVStages < tiles) {
      __syncthreads();  // every warpgroup's P.V of tile t is done
      if (threadIdx.x == 0)
        load(&vwide, &vnarrow, vs + (t % kTcVStages) * T::kBytes,
             vbar + t + kTcVStages, t + kTcVStages);
    }
  }

  bf16* oh = out + b * os_.b + h * os_.h;
  auto store = [&](int col, float v0, float v1, float v2, float v3) {
    if (row < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row * os_.n + col) =
          __floats2bfloat162_rn(v0, v1);
    if (row + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (row + 8) * os_.n + col) =
          __floats2bfloat162_rn(v2, v3);
  };
#pragma unroll
  for (int w = 0; w < T::kWide; ++w)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store(64 * w + 8 * n + 2 * t4, ow[w][4 * n], ow[w][4 * n + 1],
            ow[w][4 * n + 2], ow[w][4 * n + 3]);
#pragma unroll
  for (int w = 0; w < T::kNarrow; ++w)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store(64 * T::kWide + 16 * w + 8 * n + 2 * t4, on[w][4 * n],
            on[w][4 * n + 1], on[w][4 * n + 2], on[w][4 * n + 3]);
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               const long long* st, int batch, int heads, int nq, int nk,
               int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  // 16-byte copies when every row starts on a float4.
  bool vec = d % 4 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 4 == 0;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const dim3 grid((nq + rows - 1) / rows, (unsigned)bh);
  kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), qs, ks, vs, os,
      heads, nq, nk, d, scale, vec);
  return (int)cudaGetLastError();
}

// TMA map of one [B, H, N, D] bf16 view: dims (D, N, H, B), boxes of
// `cols` columns x 64 rows with the given swizzle.  Strides of size-1 dims
// are free; give them a legal value.
bool tc_map(CUtensorMap* map, const void* p, const long long* st, int batch,
            int heads, int n, int d, int cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {
      2ull * (n > 1 ? st[2] : d), 2ull * (heads > 1 ? st[1] : d),
      2ull * (batch > 1 ? st[0] : d)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, kTcKeys, 1, 1};
  return mint::make_map(map, p, 4, dims, strides, box, swizzle);
}

template <int D>
cudaError_t launch_tc(const __nv_bfloat16* q, Strides qs, const void* k,
                      const void* v, const long long* st,
                      __nv_bfloat16* out, Strides os, int batch, int heads,
                      int nq, int nk, float scale_log2, cudaStream_t stream) {
  const int wgs = nq > kTcWgRows ? 2 : 1;
  const int tiles = (nk + kTcKeys - 1) / kTcKeys;
  const size_t smem = tc_smem_bytes(D, tiles);
  if (tiles > kTcMaxTiles || smem > kSmemLimit) return cudaErrorInvalidValue;
  // Maps of the wide and the narrow slabs; one that a head dim does not
  // use is never read (it is encoded as a narrow one, always legal).
  CUtensorMap kw, kn, vw, vn;
  const bool wide = TcTile<D>::kWide > 0;
  const int wc = wide ? 64 : 16;
  const auto ws = wide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!tc_map(&kw, k, st + 3, batch, heads, nk, D, wc, ws) ||
      !tc_map(&kn, k, st + 3, batch, heads, nk, D, 16,
              CU_TENSOR_MAP_SWIZZLE_32B) ||
      !tc_map(&vw, v, st + 6, batch, heads, nk, D, wc, ws) ||
      !tc_map(&vn, v, st + 6, batch, heads, nk, D, 16,
              CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs),
                  batch * heads);
  attention_tc_kernel<D><<<grid, 128 * wgs, smem, stream>>>(
      q, qs, kw, kn, vw, vn, out, os, heads, nq, nk, scale_log2);
  return cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                const long long* st, int batch, int heads, int nq, int nk,
                int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || d % 16 ||
      bh > 65535 || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  const int even[6] = {0, 1, 2, 9, 10, 11};  // 4-byte loads of q, stores of out
  for (int i : even)
    if (st[i] % 2) return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, os{st[9], st[10], st[11]};
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
#define MINT_CASE(D)                                                   \
  case D:                                                              \
    return (int)launch_tc<D>(qp, qs, k, v, st, o, os, batch, heads, nq, \
                             nk, scale_log2, s);
    MINT_CASE(16)
    MINT_CASE(32)
    MINT_CASE(48)
    MINT_CASE(64)
    MINT_CASE(80)
    MINT_CASE(96)
    MINT_CASE(112)
    MINT_CASE(128)
#undef MINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, nq, d], k and v [B, H, nk, d] and out [B, H, nq, d], each a view
// with D contiguous and strides[12] = (b, h, n) strides in elements of q,
// k, v and out, in that order.  f32: d <= 128.  bf16: d a multiple of 16,
// <= 128; q, k and v 16-byte aligned with strides of whole 8-element
// steps (TMA), and the head's K and V within shared memory.
extern "C" int mint_attention_f32(const void* q, const void* k,
                                  const void* v, void* out,
                                  const long long* strides, int batch,
                                  int heads, int nq, int nk, int d,
                                  float scale, void* stream) {
  return launch_f32(q, k, v, out, strides, batch, heads, nq, nk, d, scale,
                    stream);
}

extern "C" int mint_attention_bf16(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides, int batch,
                                   int heads, int nq, int nk, int d,
                                   float scale, void* stream) {
  return launch_bf16(q, k, v, out, strides, batch, heads, nq, nk, d, scale,
                     stream);
}

extern "C" const char* mint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
