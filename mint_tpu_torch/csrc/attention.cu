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
// - f32, heads over 128 (attention_wide_kernel): the same schedule and
//   arithmetic over the whole head dim, each score computed once.  Q's
//   rows sit in shared memory for the whole pass; K(t) and V(t) alternate
//   in one buffer each (V(t) lands while the scores of tile t are
//   computed, K(t + 1) during its P.V).  Blocks of 8 warps (128 rows)
//   share each tile: at D = 256 a row is 260 floats, so Q takes 133 KB,
//   a 32-key K and V tile 33 KB each and P 19 KB, 219 KB of the 227 KB a
//   block may use (D = 130: rows of 140 floats, 127 KB).  A lane's P.V
//   micro-tile is 2 rows x NQ float4 columns, NQ = 9, 12 or 16 for output
//   chunks of up to 144, 192 or 256 columns, every column computed with no
//   test (1.6x as fast as testing each against the chunk on an H100): 128
//   accumulators a lane at D = 256, within the 255 registers a thread of
//   a 256-thread block may take (ptxas: 238).  Past 256 columns the
//   grid's z axis cuts the output into chunks of at most 256 (each block
//   still computes every score over the whole head) and the block takes as
//   many warps as fit, down to one: heads of up to 1016 columns
//   (ops/attention.py's MAX_HEAD_DIM).
// - bf16 (attention_tc_kernel, attention_tc_stream_kernel): Hopper's TMA
//   and wgmma, two passes over the keys: the first finds each row's max
//   and sum of exp (online, merged across the four threads that share a
//   row), the second forms the exactly normalised P, rounds it to bf16 as
//   the TPU kernel does (attn.astype(v.dtype)), and accumulates P.V.
//   Recomputing Q.K^T costs a third more tensor-core work and a second
//   exp per score, but makes P the reference's normalisation, so the
//   bf16 rounding of P matches the plain version; a one-pass online
//   softmax would round an unnormalised P and change the bf16 output.
//   K, V and Q tiles hold the head dim as 64-column slabs with the
//   128-byte swizzle and 16-column slabs with the 32-byte swizzle (D = 80:
//   one of each), one TMA box each, so the loads move rows of 128 or 32
//   contiguous bytes; TMA's zero fill pads a head dim that is not a
//   multiple of 16 (the wrapper pads a layout TMA cannot address to 8
//   columns with zeros) and the keys past Nk, which are masked out of the
//   max and the sum.
//   The resident kernel (the flagship's): both passes read every key, so
//   a block holds the head's whole K in shared memory (57.6 KB at Nk =
//   360), loaded once; V, read only by the second pass, streams through a
//   ring of 3 tiles.  One thread issues every load by TMA, each 64-key
//   tile completing on its own mbarrier, so the first pass starts on key
//   0 while the rest is still arriving; the only block barrier is the one
//   that frees a V slot.  Both products are wgmma with A in registers:
//   Q's fragments, read once from device memory, for Q.K^T (m64n64k16, K
//   as a K-major B); P straight from the score accumulators, whose layout
//   is wgmma's A-fragment layout, for P.V (V as an N-major B, so V needs
//   no transpose).  A block is one warpgroup per 64 query rows, two when
//   Nq > 64 (three blocks per head at Nq = 360, 600 for the batch-20
//   decode); at D = 80 and Nk = 360 it takes 92 KB and at most 128
//   registers a thread, so two blocks share an SM.  It runs while the
//   head's K fits: D <= 128 and Nk <= 1216 at D = 80, 704 at D = 128
//   (ops/attention.py's bf16_max_keys mirrors tc_smem_bytes).
//   The streamed kernel takes every other head: keys past that, and head
//   dims over 128.  It is warp-specialised: one producer warp, whose one
//   thread issues every TMA load, and up to three consumer warpgroups of
//   64 query rows.  Q's tiles, over the whole head dim, come in once and
//   stay in shared memory, wgmma's A by descriptor, so each pass computes
//   each score once for any head up to 256 wide, and no register holds Q.
//   K, then K and V, pass through a ring of up to 8 tiles in the order the
//   passes read them, each slot with a full and an empty mbarrier:
//   consumers free a slot by arriving on its empty barrier once their
//   wgmma on it has retired, so no block barrier stands between a slot and
//   its next load, and the producer runs as far ahead as the ring.  P.V is
//   one m64nNk16 a 16-key step over all the wide slabs of V (N = 64, 128,
//   192 or 256) and one over the narrow ones (N = 16, 32 or 48).  At D =
//   256: Q 64 KB for 128 rows, 32 KB a 64-key tile, a ring of 5 (224 KB
//   in all); the P.V accumulator is 128 registers a consumer thread, the
//   scores 32 and P's fragments 16.  ptxas budgets the block's registers
//   for its threads rounded up to whole warpgroups: 168 a thread with two
//   consumer warpgroups, 128 with three, which the consumers of chunks up
//   to 96 columns fit (12 consumer warps an SM for the long-key heads);
//   setmaxnreg, which would hand a producer warpgroup's registers to the
//   consumers, left that budget as it was in this toolchain.  So the
//   consumers keep one score buffer and wait for each product before its
//   slot is freed; past 176 columns ptxas still spills and serialises the
//   wgmma chain.
//   Heads over 256 run output chunks of at most 256 columns on the grid's
//   z axis: every block computes the scores over all the chunks of Q and
//   K (each chunk of a K tile a load of the ring) and P.V over its own
//   chunk of V; Q's chunks all stay resident, up to a head of 1344
//   columns.  No config reaches that, but the JAX kernel takes it.
//   The ring's waits trap after ~2^24 polls instead of hanging the card.
//
// Both kernels put the (batch, head) pairs on the grid's y axis, at most
// 65535 a launch; the C entry points launch as many times as B * H needs,
// each launch starting at pair bh0.

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
constexpr int kWideMaxWarps = 8;  // warps a block of attention_wide_kernel
constexpr int kWideMaxD = 256;    // output columns a block of it owns
constexpr size_t kSmemLimit = 232448;  // 227 KB a block can use on an H100

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

// attention_wide_kernel: Q's rows and a K tile over the whole head dim d,
// a V tile over the dc columns of the block's output chunk, and P.
size_t wide_smem_bytes(int d, int dc, int warps) {
  return sizeof(float) *
         ((size_t)(kWarpRows * warps + kKTile) * tile_ld(d) +
          (size_t)kKTile * tile_ld(dc) +
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

// Scores of one 32-key tile: s[i][j] += q(row sr + 4 i) . k(key sc + 8 j)
// over the float4 columns [0, d4) of the tile (qw: this lane's first Q
// row, kt: its first K row, both `ld` floats a row).
template <int kJ>
__device__ __forceinline__ void scores_fma(float (&s)[4][kJ], const float* qw,
                                           const float* kt, int ld, int d4) {
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
}

// Online softmax of one tile's scores (`valid` of its keys are real): a
// row's keys sit on the 8 lanes of equal sr.  Writes P = exp(s - new max)
// to ps, each row's rescale of the old sums to alpha_s, and updates the
// running max m and this lane's sum lsum.
template <int kJ>
__device__ __forceinline__ void softmax_tile(float (&s)[4][kJ], float (&m)[4],
                                             float (&lsum)[4], float* ps,
                                             float* alpha_s, int sr, int sc,
                                             int valid, float scale) {
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
    const float mn = fmaxf(m[i], mx);  // finite: the tile's first key is valid
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
}

// acc = acc * alpha + P.V over `keys` keys (a multiple of 4) of the tile:
// rows pr + 8 i, head-dim float4 columns pq + 4 u below d4 (kGuard), or
// all 4 NQ of them (the columns past d4 read whatever follows in shared
// memory, into accumulators that are never stored).  P is 0 past the
// valid keys and V's rows there are zero-filled.
template <int NQ, bool kGuard = true>
__device__ __forceinline__ void pv_fma(float4 (&acc)[2][NQ], const float* ps,
                                       const float* alpha_s, const float* vs,
                                       int ld, int pr, int pq, int keys,
                                       int d4) {
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
        if (!kGuard || pq + 4 * u < d4) {
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

// Divides this warp's accumulators by their rows' sums (this lane's
// partial sums merged across the 8 lanes of a row, handed to the P.V
// layout through l_s) and writes rows row0 + pr + 8 i below nq, columns
// [0, d) of each (orow0: row row0's first output column).
template <int NQ>
__device__ __forceinline__ void write_rows(const float4 (&acc)[2][NQ],
                                           const float (&lsum)[4], float* l_s,
                                           float* orow0, long long ostride,
                                           int row0, int nq, int d, bool vec,
                                           int sr, int sc, int pr, int pq) {
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
    const int row = row0 + pr + 8 * i;
    if (row >= nq) continue;
    const float l = l_s[pr + 8 * i];
    float* orow = orow0 + (row - row0) * ostride;
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

// One block per (batch*head bh0 + blockIdx.y, 16 * warps query rows); each
// warp owns 16 rows.  NQ: float4 columns of the head dim per lane in P.V
// (d <= 16 NQ); D4: d / 4 when fixed at compile time (FACT's d = 80), else 0.
template <int NQ, int D4>
__global__ void __launch_bounds__(32 * kMaxWarps)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     int heads, int nq, int nk, int d, float scale,
                     bool vec, long long bh0) {
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

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
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

  constexpr int kJ = kKTile / 8;  // keys per lane
  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    // K(t) has landed for every thread, and every warp is done with V(t-1).
    mint::cp_async_wait<0>();
    __syncthreads();
    load_rows(vs, ld, vh, vs_.n, k0, kKTile, nk, dd, vec);  // overlaps the scores
    mint::cp_async_commit();

    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
    scores_fma<kJ>(s, qw, ks + sc * ld, ld, d4);
    const int valid = nk - k0;
    softmax_tile<kJ>(s, m, lsum, ps, alpha_s, sr, sc, valid, scale);

    // V(t) has landed, and every warp is done with K(t).
    mint::cp_async_wait<0>();
    __syncthreads();
    if (k0 + kKTile < nk)
      load_rows(ks, ld, kh, ks_.n, k0 + kKTile, kKTile, nk, dd, vec);
    mint::cp_async_commit();  // K(t+1) overlaps P.V

    pv_fma<NQ>(acc, ps, alpha_s, vs, ld, pr, pq,
               (min(kKTile, valid) + 3) & ~3, d4);
  }

  const int row0 = q0 + warp * kWarpRows;
  write_rows<NQ>(acc, lsum, l_s, out + b * os_.b + h * os_.h + row0 * os_.n,
                 os_.n, row0, nq, d, vec, sr, sc, pr, pq);
}

// Heads wider than kMaxD: one block per (batch*head bh0 + blockIdx.y,
// 16 * warps query rows, output chunk blockIdx.z of dc columns; one chunk
// unless d > kWideMaxD).  attention_kernel's schedule over the whole head
// dim: Q's rows sit in shared memory for the whole pass, K(t) and V(t)
// alternate in one buffer each (V(t) lands during the scores of tile t,
// K(t + 1) during its P.V), each score is computed once, over all d
// columns, and P.V covers the block's chunk.  NQ: float4 columns of the
// chunk per lane in P.V (dc <= 16 NQ), all of them computed, with no test
// a column: V's last row reads at most 16 NQ - tile_ld(dc) <= 60 floats
// past the V tile, into P.
template <int NQ>
__global__ void __launch_bounds__(32 * kWideMaxWarps)
    attention_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          Strides qs_, Strides ks_, Strides vs_, Strides os_,
                          int heads, int nq, int nk, int d, int dc,
                          float scale, bool vec, long long bh0) {
  extern __shared__ float4 smem4[];
  const int ld = tile_ld(d), ldv = tile_ld(dc);
  const int d4 = (d + 3) / 4, dc4 = (dc + 3) / 4;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = kWarpRows * warps;
  float* qs = reinterpret_cast<float*>(smem4);  // [rows][ld]
  float* ks = qs + rows * ld;                   // [kKTile][ld]
  float* vs = ks + kKTile * ld;                 // [kKTile][ldv]
  float* ps = vs + kKTile * ldv + warp * kWarpRows * (kLdP + 2);
  float* alpha_s = ps + kWarpRows * kLdP;
  float* l_s = alpha_s + kWarpRows;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int q0 = blockIdx.x * rows;
  const int c0 = blockIdx.z * dc;        // this block's output columns
  const int dcz = min(dc, d - c0);
  const float* qh = q + b * qs_.b + h * qs_.h;
  const float* kh = k + b * ks_.b + h * ks_.h;
  const float* vh = v + b * vs_.b + h * vs_.h + c0;

  if (d % 4) {  // Q's and K's pad columns d .. 4 d4 read as zeros
    const int pad = 4 * d4 - d;
    for (int i = threadIdx.x; i < (rows + kKTile) * pad; i += blockDim.x)
      qs[(i / pad) * ld + d + i % pad] = 0.f;
  }
  load_rows(qs, ld, qh, qs_.n, q0, rows, nq, d, vec);
  load_rows(ks, ld, kh, ks_.n, 0, kKTile, nk, d, vec);
  mint::cp_async_commit();

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

  constexpr int kJ = kKTile / 8;
  for (int k0 = 0; k0 < nk; k0 += kKTile) {
    // K(t) has landed for every thread, and every warp is done with V(t-1).
    mint::cp_async_wait<0>();
    __syncthreads();
    load_rows(vs, ldv, vh, vs_.n, k0, kKTile, nk, dcz, vec);
    mint::cp_async_commit();  // V(t) overlaps the scores

    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
    scores_fma<kJ>(s, qw, ks + sc * ld, ld, d4);
    const int valid = nk - k0;
    softmax_tile<kJ>(s, m, lsum, ps, alpha_s, sr, sc, valid, scale);

    // V(t) has landed, and every warp is done with K(t).
    mint::cp_async_wait<0>();
    __syncthreads();
    if (k0 + kKTile < nk)
      load_rows(ks, ld, kh, ks_.n, k0 + kKTile, kKTile, nk, d, vec);
    mint::cp_async_commit();  // K(t+1) overlaps P.V

    pv_fma<NQ, false>(acc, ps, alpha_s, vs, ldv, pr, pq,
                      (min(kKTile, valid) + 3) & ~3, dc4);
  }

  const int row0 = q0 + warp * kWarpRows;
  write_rows<NQ>(acc, lsum, l_s,
                 out + b * os_.b + h * os_.h + row0 * os_.n + c0, os_.n, row0,
                 nq, dcz, vec, sr, sc, pr, pq);
}

// ---- bf16 on tensor cores: TMA + wgmma ----------------------------------

constexpr int kTcWgRows = 64;     // query rows per warpgroup (wgmma's M)
constexpr int kTcMaxWgs = 2;      // warpgroups per block
constexpr int kTcKeys = 64;       // keys per K / V tile (N of the scores)
constexpr int kTcVStages = 3;     // V tiles resident at a time (a ring)
constexpr int kTcBarBytes = 1024;     // mbarriers at the start of smem
constexpr int kTcMaxTiles = kTcBarBytes / 8 / 2;
// The streamed kernel: head-dim chunks of at most kStreamMaxW columns, a
// ring of at most kStreamMaxSlots tiles, at most kStreamMaxWgs consumer
// warpgroups a block (chunks up to kStreamWideW take three, wider ones
// two: see launch_tc_stream).
constexpr int kStreamMaxW = 256;
constexpr int kStreamMaxSlots = 8;
constexpr int kStreamMaxWgs = 3;
constexpr int kStreamWideW = 96;
constexpr int kStreamProducer = 32;  // the producer warp's threads

// A K, V or Q tile in shared memory (64 rows): the head dim in 64-column
// slabs with the 128-byte swizzle (rows of 128 bytes), then 16-column slabs
// with the 32-byte swizzle (rows of 32 bytes): D = 80 is one of each, 10
// KB for 64 keys.  Each slab is one TMA box, so a load moves rows of 128
// or 32 contiguous bytes (unswizzled 8-column boxes, rows of 16 bytes, made
// the loads half of the kernel's time on an H100).
template <int D>
struct TcTile {
  static constexpr int kWide = D / 64;          // 64-column slabs
  static constexpr int kNarrow = D % 64 / 16;   // 16-column slabs
  static constexpr int kWideBytes = kTcKeys * 128;
  static constexpr int kNarrowBytes = kTcKeys * 32;
  static constexpr int kBytes = kWide * kWideBytes + kNarrow * kNarrowBytes;
};

// The resident schedule: every K tile, and up to kTcVStages V tiles.
size_t tc_smem_bytes(int d, int tiles) {
  // 1 KB of slack to align the tiles to the swizzle's 1 KB atoms.
  return 2 * kTcBarBytes +
         (size_t)(tiles + std::min(tiles, kTcVStages)) * kTcKeys * 2 * d;
}

// The streamed kernel: Q's tiles (`wgs` warpgroups, `chunks` of the head
// dim each) and the ring.
size_t tc_stream_smem_bytes(int w, int wgs, int chunks, int slots) {
  return 2 * kTcBarBytes + (size_t)(wgs * chunks + slots) * kTcKeys * 2 * w;
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

// mbar_wait that ends the kernel with a trap, an error its launch reports,
// where a phase never completes (some 2^24 polls, seconds): a fault in the
// streamed kernel's ring then fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = mint::smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done = 0;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
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

// Byte offset in a TcTile<D> of k-step kk's 16 columns (32 bytes into a
// wide slab's rows, or a narrow slab), and that slab's descriptor.
template <int D>
__device__ __forceinline__ uint64_t kstep_desc(const uint8_t* tile, int kk) {
  using T = TcTile<D>;
  return kk < 4 * T::kWide
             ? slab_desc(tile + (kk / 4) * T::kWideBytes + 32 * (kk % 4),
                         1024, 1)
             : slab_desc(tile + T::kWide * T::kWideBytes +
                             (kk - 4 * T::kWide) * T::kNarrowBytes,
                         256, 3);
}

// Issues (and commits; the caller waits) the scores of this warpgroup's
// 64 query rows against K tile kt: s[4 n + e] = q . k of row (warp's 16
// rows) g + 8 (e / 2) and key 8 n + 2 t + e % 2 of the tile, unscaled;
// added to s where `acc` (a later chunk of the head dim), else written.
// Q from registers (its A fragments).
template <int D>
__device__ __forceinline__ void tc_scores(const uint32_t (&qf)[D / 16][4],
                                          const uint8_t* kt, float (&s)[32]) {
  mint::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mint::wgmma_rs<64, 0>(s, qf[kk], kstep_desc<D>(kt, kk), kk > 0);
  mint::wgmma_commit();
}

// The same with Q's tile qt in shared memory (wgmma's A by descriptor),
// issued only: the caller fences, commits and waits.
template <int D>
__device__ __forceinline__ void tc_scores_ss(const uint8_t* qt,
                                             const uint8_t* kt,
                                             float (&s)[32], bool acc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mint::wgmma_ss<64>(s, kstep_desc<D>(qt, kk), kstep_desc<D>(kt, kk),
                       acc || kk > 0);
}

// Pass 1's update of rows g (r = 0) and g + 8 (r = 1) by one score tile:
// the running max m and sum l of exp2(s - max) (s in log2 units) over this
// thread's keys, `valid` of the tile's keys real (kFull: all of them; only
// the last tile has keys to mask, the others skip the test).
template <bool kFull>
__device__ __forceinline__ void tile_stats(const float (&s)[32],
                                           float (&m)[2], float (&l)[2],
                                           int valid, int t4,
                                           float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[16];  // scaled scores (the accumulators stay unwritten)
    float tmax = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[2 * n + e] = (kFull || 8 * n + 2 * t4 + e < valid)
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
}

// Pass 2's P = exp2(s - max) / sum of one score tile rounded to bf16, from
// the score registers into the A fragments of P.V (score tiles 2 j and
// 2 j + 1 make the 16-key step j: a[0] / a[2] row g, a[1] / a[3] row
// g + 8); zeros for keys past `valid`.
template <bool kFull>
__device__ __forceinline__ void tile_probs(const float (&s)[32],
                                           uint32_t (&a)[kTcKeys / 16][4],
                                           const float (&m)[2],
                                           const float (&inv_l)[2],
                                           int valid, int t4,
                                           float scale_log2) {
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
          p[e] = (kFull || 8 * n + 2 * t4 + e < valid)
                     ? exp2f(s[4 * n + 2 * r + e] * scale_log2 - m[r]) *
                           inv_l[r]
                     : 0.f;
        a[j][2 * hh + r] = pack_bf16(p[0], p[1]);
      }
}

// Merges each row's (max, sum) across the 4 threads that share it and
// returns 1 / sum of rows g and g + 8.
__device__ __forceinline__ void row_stats(float (&m)[2], float (&l)[2],
                                          float (&inv_l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge_stats(m[r], l[r], mo, lo);
    }
    inv_l[r] = 1.f / l[r];
  }
}

// Columns col and col + 1 of rows `row` (v0, v1) and `row + 8` (v2, v3)
// of a head's output oh, those below nq and below dz; in pairs of 4 bytes
// where the output's strides allow (`pairs`).
__device__ __forceinline__ void store_out(__nv_bfloat16* oh,
                                          long long stride, int row, int nq,
                                          int col, int dz, bool pairs,
                                          float v0, float v1, float v2,
                                          float v3) {
  if (col >= dz) return;
  if (pairs && col + 1 < dz) {
    if (row < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row * stride + col) =
          __floats2bfloat162_rn(v0, v1);
    if (row + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (row + 8) * stride + col) =
          __floats2bfloat162_rn(v2, v3);
    return;
  }
  const bool second = col + 1 < dz;
  if (row < nq) {
    oh[row * stride + col] = __float2bfloat16_rn(v0);
    if (second) oh[row * stride + col + 1] = __float2bfloat16_rn(v1);
  }
  if (row + 8 < nq) {
    oh[(row + 8) * stride + col] = __float2bfloat16_rn(v2);
    if (second) oh[(row + 8) * stride + col + 1] = __float2bfloat16_rn(v3);
  }
}

// The resident schedule.  One block per (64 * warpgroups query rows,
// batch*head bh0 + blockIdx.y); warpgroup w owns rows q0 + 64 w ..;
// within it warp j owns 16 rows, and a thread rows g and g + 8 of those
// (g = lane / 4, t = lane % 4).  D: the head dim rounded up to 16, at most
// 128.
template <int D>
__global__ void __launch_bounds__(128 * kTcMaxWgs, 2)
    attention_tc_kernel(const __nv_bfloat16* __restrict__ q, Strides qs_,
                        const __grid_constant__ CUtensorMap kwide,
                        const __grid_constant__ CUtensorMap knarrow,
                        const __grid_constant__ CUtensorMap vwide,
                        const __grid_constant__ CUtensorMap vnarrow,
                        __nv_bfloat16* __restrict__ out, Strides os_,
                        int heads, int nq, int nk, int d, float scale_log2,
                        long long bh0, bool pairs) {
  using bf16 = __nv_bfloat16;
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* ks = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;
  const int tiles = (nk + kTcKeys - 1) / kTcKeys;
  // K tile t at ks + t * T::kBytes, V tiles in a ring of kTcVStages after
  // them; K tile t completes on kbar[t], V tile t on vbar[t].
  uint8_t* vs = ks + tiles * T::kBytes;
  uint64_t* kbar = bars;
  uint64_t* vbar = bars + tiles;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
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

  // Q's A fragments straight from device memory: k-step kk holds columns
  // 16 kk + 2 t (a[0], a[1]) and + 8 (a[2], a[3]); zeros past the rows and
  // past the head dim (a pair starting below an odd d reads q's zero
  // padding at column d).
  uint32_t qf[D / 16][4];
  const bf16* q0p = q + b * qs_.b + h * qs_.h + row * qs_.n + 2 * t4;
  const bf16* q8p = q0p + 8 * qs_.n;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk;
    const bool lo = col + 2 * t4 < d, hi = col + 8 + 2 * t4 < d;
    qf[kk][0] = row < nq && lo ? ld32(q0p + col) : 0u;
    qf[kk][1] = row + 8 < nq && lo ? ld32(q8p + col) : 0u;
    qf[kk][2] = row < nq && hi ? ld32(q0p + col + 8) : 0u;
    qf[kk][3] = row + 8 < nq && hi ? ld32(q8p + col + 8) : 0u;
  }
  float s[32];

  // Pass 1: max and sum of exp2(s - max) of rows g and g + 8 over this
  // thread's keys, then merged across the 4 threads of a row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  for (int t = 0; t < tiles; ++t) {
    mint::mbar_wait(kbar + t, 0);
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    if (valid >= kTcKeys)
      tile_stats<true>(s, m, l, valid, t4, scale_log2);
    else
      tile_stats<false>(s, m, l, valid, t4, scale_log2);
  }
  row_stats(m, l, inv_l);

  // Pass 2: P, then P.V: one m64n64k16 per wide slab of V and one
  // m64n16k16 per narrow one; the first (tile 0, keys 0-15: always valid)
  // overwrites the accumulators.  Once every warpgroup is done with V tile
  // t, its ring slot takes tile t + kTcVStages.
  float ow[T::kWide ? T::kWide : 1][32];
  float on[T::kNarrow ? T::kNarrow : 1][8];
  for (int t = 0; t < tiles; ++t) {
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    uint32_t a[kTcKeys / 16][4];
    if (valid >= kTcKeys)
      tile_probs<true>(s, a, m, inv_l, valid, t4, scale_log2);
    else
      tile_probs<false>(s, a, m, inv_l, valid, t4, scale_log2);
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
#pragma unroll
  for (int w = 0; w < T::kWide; ++w)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store_out(oh, os_.n, row, nq, 64 * w + 8 * n + 2 * t4, d, pairs,
                ow[w][4 * n], ow[w][4 * n + 1], ow[w][4 * n + 2],
                ow[w][4 * n + 3]);
#pragma unroll
  for (int w = 0; w < T::kNarrow; ++w)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store_out(oh, os_.n, row, nq, 64 * T::kWide + 16 * w + 8 * n + 2 * t4,
                d, pairs, on[w][4 * n], on[w][4 * n + 1], on[w][4 * n + 2],
                on[w][4 * n + 3]);
}

// The streamed kernel, warp-specialised.  One block per (64 * wgs query
// rows, batch*head bh0 + blockIdx.y, W-column chunk blockIdx.z of the
// output: one unless d > kStreamMaxW) of wgs consumer warpgroups (wgs <=
// kWgs; warpgroup w owns rows q0 + 64 w ..) and one producer warp after
// them, whose lane 0 issues every TMA load.  W: the chunk width, a
// multiple of 16 up to 256; `chunks` of them cover the head dim d.
// Shared memory: Q's tiles of each consumer's rows, one a chunk of the
// head dim, loaded once (qbar); then a ring of `slots` tiles, slot i
// filled on full[i] and freed on empty[i] (one arrival a consumer warp,
// once its wgmma on the slot has retired).  The ring carries the loads in
// the order the passes read them: pass 1 reads K tile t chunk c as load
// t * chunks + c; pass 2 reads, a tile at a time, its K chunks then its V
// chunk z.  Load j takes slot j % slots at its (j / slots)-th use, so one
// counter gives both sides each load's slot and mbarrier parity.  A
// consumer holds one slot at a time: the producer runs up to `slots`
// loads ahead of the slowest warpgroup.
template <int W, int kWgs>
__global__ void __launch_bounds__(128 * kWgs + kStreamProducer, 1)
    attention_tc_stream_kernel(const __grid_constant__ CUtensorMap qwide,
                               const __grid_constant__ CUtensorMap qnarrow,
                               const __grid_constant__ CUtensorMap kwide,
                               const __grid_constant__ CUtensorMap knarrow,
                               const __grid_constant__ CUtensorMap vwide,
                               const __grid_constant__ CUtensorMap vnarrow,
                               __nv_bfloat16* __restrict__ out, Strides os_,
                               int heads, int nq, int nk, int d, int chunks,
                               int slots, float scale_log2, long long bh0,
                               bool pairs) {
  using T = TcTile<W>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStreamMaxSlots;
  uint64_t* qbar = empty + kStreamMaxSlots;
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* qs = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;
  const int wgs = (blockDim.x - kStreamProducer) / 128;
  uint8_t* ring = qs + wgs * chunks * T::kBytes;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int q0 = blockIdx.x * kTcWgRows * wgs;
  const int z = blockIdx.z;  // output columns W z .. W z + W
  const int tiles = (nk + kTcKeys - 1) / kTcKeys;
  const int pass1 = tiles * chunks;
  const int total = pass1 + tiles * (chunks + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mint::mbar_init(full + i, 1);
      mint::mbar_init(empty + i, 4 * wgs);
    }
    mint::mbar_init(qbar, 1);
    mint::mbar_fence_init();
  }
  __syncthreads();

  // The branch of a role, known to be uniform across each warp.
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == wgs) {  // producer
    if (threadIdx.x != 128 * wgs) return;
    // The 64-row box of a map at (col, row), a slab per box.
    auto load = [&](const CUtensorMap* wide, const CUtensorMap* narrow,
                    uint8_t* dst, uint64_t* bar, int row, int col) {
      for (int i = 0; i < T::kWide; ++i)
        mint::tma_load_4d(dst + i * T::kWideBytes, wide, bar, col + 64 * i,
                          row, h, b);
      for (int i = 0; i < T::kNarrow; ++i)
        mint::tma_load_4d(
            dst + T::kWide * T::kWideBytes + i * T::kNarrowBytes, narrow,
            bar, col + 64 * T::kWide + 16 * i, row, h, b);
    };
    // Q's tiles of the consumers with rows below nq (the others' rows
    // are never stored, and their scores never read).
    const int live = min(wgs, (nq - q0 + kTcWgRows - 1) / kTcWgRows);
    mint::mbar_expect_tx(qbar, live * chunks * T::kBytes);
    for (int w = 0; w < live; ++w)
      for (int c = 0; c < chunks; ++c)
        load(&qwide, &qnarrow, qs + (w * chunks + c) * T::kBytes, qbar,
             q0 + kTcWgRows * w, W * c);
    for (int j = 0; j < total; ++j) {
      const int i = j % slots, use = j / slots;
      if (use > 0) mbar_wait_or_trap(empty + i, (use - 1) & 1);
      mint::mbar_expect_tx(full + i, T::kBytes);
      uint8_t* dst = ring + i * T::kBytes;
      if (j < pass1) {
        load(&kwide, &knarrow, dst, full + i, kTcKeys * (j / chunks),
             W * (j % chunks));
      } else {
        const int t = (j - pass1) / (chunks + 1);
        const int r = (j - pass1) % (chunks + 1);
        if (r < chunks)
          load(&kwide, &knarrow, dst, full + i, kTcKeys * t, W * r);
        else
          load(&vwide, &vnarrow, dst, full + i, kTcKeys * t, W * z);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = q0 + kTcWgRows * wg + 16 * warp + g;
  const uint8_t* qt = qs + wg * chunks * T::kBytes;
  // Load `next` is the next to read; release() frees its slot once this
  // warp's products on it have retired.
  int next = 0;
  auto acquire = [&]() -> const uint8_t* {
    mbar_wait_or_trap(full + next % slots, (next / slots) & 1);
    return ring + (next % slots) * T::kBytes;
  };
  auto release = [&]() {
    if (lane == 0) mint::mbar_arrive(empty + next % slots);
    ++next;
  };
  float s[32];
  // The scores of the next key tile, summed over the chunks of the head
  // dim (Q's tiles from shared memory), each K slot freed as soon as its
  // product is done.
  auto scores = [&]() {
    for (int c = 0; c < chunks; ++c) {
      mint::wgmma_fence();
      tc_scores_ss<W>(qt + c * T::kBytes, acquire(), s, c > 0);
      mint::wgmma_commit();
      mint::wgmma_wait<0>();
      release();
    }
  };
  mbar_wait_or_trap(qbar, 0);

  // Pass 1: each row's max and sum, as the resident kernel's.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  for (int t = 0; t < tiles; ++t) {
    scores();
    const int valid = nk - kTcKeys * t;
    if (valid >= kTcKeys)
      tile_stats<true>(s, m, l, valid, t4, scale_log2);
    else
      tile_stats<false>(s, m, l, valid, t4, scale_log2);
  }
  row_stats(m, l, inv_l);

  // Pass 2: P (exactly normalised, rounded to bf16), then P.V over the
  // whole chunk: a k-step is one m64nNk16 over every wide slab of V (N =
  // 64 kWide, the slabs kWideBytes apart) and one over every narrow slab
  // (N = 16 kNarrow); the first (tile 0, keys 0-15) overwrites the
  // accumulators.
  constexpr int kNW = 64 * T::kWide, kNN = 16 * T::kNarrow;
  float ow[kNW ? kNW / 2 : 1];
  float on[kNN ? kNN / 2 : 1];
  for (int t = 0; t < tiles; ++t) {
    scores();
    const int valid = nk - kTcKeys * t;
    uint32_t a[kTcKeys / 16][4];
    if (valid >= kTcKeys)
      tile_probs<true>(s, a, m, inv_l, valid, t4, scale_log2);
    else
      tile_probs<false>(s, a, m, inv_l, valid, t4, scale_log2);
    const uint8_t* vt = acquire();
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      if (16 * j >= valid) break;  // the same for the whole warpgroup
      const int acc = t > 0 || j > 0;
      if constexpr (kNW > 0)
        mint::wgmma_rs<kNW, 1>(
            ow, a[j],
            mint::smem_desc(vt + 16 * j * 128, T::kWideBytes, 1024, 1), acc);
      if constexpr (kNN > 0)
        mint::wgmma_rs<kNN, 1>(
            on, a[j],
            mint::smem_desc(vt + T::kWide * T::kWideBytes + 16 * j * 32,
                            T::kNarrowBytes, 256, 3),
            acc);
    }
    mint::wgmma_commit();
    mint::wgmma_wait<0>();
    release();
  }

  __nv_bfloat16* oh = out + b * os_.b + h * os_.h + W * z;
  const int dz = d - W * z;  // this chunk's columns below d
#pragma unroll
  for (int n = 0; n < kNW / 8; ++n)
    store_out(oh, os_.n, row, nq, 8 * n + 2 * t4, dz, pairs, ow[4 * n],
              ow[4 * n + 1], ow[4 * n + 2], ow[4 * n + 3]);
#pragma unroll
  for (int n = 0; n < kNN / 8; ++n)
    store_out(oh, os_.n, row, nq, kNW + 8 * n + 2 * t4, dz, pairs, on[4 * n],
              on[4 * n + 1], on[4 * n + 2], on[4 * n + 3]);
}

// Launches `kernel` on grid (x, the (batch, head) pairs, z) as many times
// as the pairs need, at most 65535 (the grid's y axis) a launch; `launch`
// (grid, bh0) launches one.
template <typename Launch>
cudaError_t over_pairs(long long pairs, unsigned x, unsigned z,
                       Launch launch) {
  for (long long bh0 = 0; bh0 < pairs; bh0 += 65535) {
    const dim3 grid(x, (unsigned)std::min<long long>(65535, pairs - bh0), z);
    launch(grid, bh0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               const long long* st, int batch, int heads, int nq, int nk,
               int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0)
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
  int warps = min(kMaxWarps, (nq + kWarpRows - 1) / kWarpRows);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d > kMaxD) {
    // Output chunks of at most kWideMaxD columns, as even as float4 steps
    // allow; up to kWideMaxWarps warps, as many as fit in shared memory.
    const int chunks = (d + kWideMaxD - 1) / kWideMaxD;
    const int dc = ((d + chunks - 1) / chunks + 3) / 4 * 4;
    warps = min(kWideMaxWarps, (nq + kWarpRows - 1) / kWarpRows);
    while (warps > 1 && wide_smem_bytes(d, dc, warps) > kSmemLimit) --warps;
    const size_t smem = wide_smem_bytes(d, dc, warps);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    auto kernel = dc <= 144   ? attention_wide_kernel<9>
                  : dc <= 192 ? attention_wide_kernel<12>
                              : attention_wide_kernel<16>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int rows = kWarpRows * warps;
    return (int)over_pairs(
        bh, (unsigned)((nq + rows - 1) / rows), (unsigned)chunks,
        [&](dim3 grid, long long bh0) {
          kernel<<<grid, 32 * warps, smem, s>>>(qp, kp, vp, op, qs, ks, vs,
                                               os, heads, nq, nk, d, dc,
                                               scale, vec, bh0);
        });
  }
  const int rows = kWarpRows * warps;
  const unsigned x = (unsigned)((nq + rows - 1) / rows);
  const size_t smem = smem_bytes(d, warps);
  // FACT's head dim has its own instance, with every loop over D unrolled.
  auto kernel = d == 80   ? attention_kernel<5, 20>
                : d <= 80 ? attention_kernel<5, 0>
                          : attention_kernel<8, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)over_pairs(bh, x, 1, [&](dim3 grid, long long bh0) {
    kernel<<<grid, 32 * warps, smem, s>>>(qp, kp, vp, op, qs, ks, vs, os,
                                         heads, nq, nk, d, scale, vec, bh0);
  });
}

// TMA map of one [B, H, N, cols] bf16 view: dims (cols, N, H, B), boxes of
// `box` columns x 64 rows with the given swizzle; columns past `cols` (and
// rows past N) read as zeros.  Strides of size-1 dims are free; give them
// a legal value.
bool tc_map(CUtensorMap* map, const void* p, const long long* st, int batch,
            int heads, int n, int cols, int box, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)n,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t free = 16ull * ((cols + 7) / 8);  // 16-byte steps
  const cuuint64_t strides[3] = {n > 1 ? 2ull * st[2] : free,
                                 heads > 1 ? 2ull * st[1] : free,
                                 batch > 1 ? 2ull * st[0] : free};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, kTcKeys, 1, 1};
  return mint::make_map(map, p, 4, dims, strides, boxes, swizzle);
}

// The maps of a TcTile<D>'s wide and narrow slabs over one view; one that
// a head dim does not use is never read (it is encoded as a narrow one,
// always legal).
template <int D>
bool tc_maps(CUtensorMap (&maps)[2], const void* p, const long long* st,
             int batch, int heads, int n, int d) {
  const bool wide = TcTile<D>::kWide > 0;
  return tc_map(&maps[0], p, st, batch, heads, n, d, wide ? 64 : 16,
                wide ? CU_TENSOR_MAP_SWIZZLE_128B
                     : CU_TENSOR_MAP_SWIZZLE_32B) &&
         tc_map(&maps[1], p, st, batch, heads, n, d, 16,
                CU_TENSOR_MAP_SWIZZLE_32B);
}

// The resident schedule; D: the head dim rounded up to 16.
template <int D>
cudaError_t launch_tc(const __nv_bfloat16* q, Strides qs, const void* k,
                      const void* v, const long long* st,
                      __nv_bfloat16* out, Strides os, int batch, int heads,
                      int nq, int nk, int d, float scale_log2, bool pairs,
                      cudaStream_t stream) {
  const int wgs = nq > kTcWgRows ? 2 : 1;
  const size_t smem = tc_smem_bytes(D, (nk + kTcKeys - 1) / kTcKeys);
  CUtensorMap km[2], vm[2];
  if (!tc_maps<D>(km, k, st + 3, batch, heads, nk, d) ||
      !tc_maps<D>(vm, v, st + 6, batch, heads, nk, d))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned x = (unsigned)((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs));
  return over_pairs((long long)batch * heads, x, 1,
                    [&](dim3 grid, long long bh0) {
                      attention_tc_kernel<D><<<grid, 128 * wgs, smem, stream>>>(
                          q, qs, km[0], km[1], vm[0], vm[1], out, os, heads,
                          nq, nk, d, scale_log2, bh0, pairs);
                    });
}

// The streamed kernel; W: the chunk width.  Consumer warpgroups for the
// query rows, up to three (so 12 consumer warps an SM) where W <=
// kStreamWideW and two past it: ptxas budgets registers for the launch
// bound's threads rounded up to whole warpgroups (168 a thread at 2 + 1
// warpgroups, 128 at 3 + 1), and a consumer holds W / 2 accumulator
// registers for P.V besides 32 for the scores and 16 for P; fewer where
// their Q tiles would leave the ring under two slots.  The ring as deep
// as shared memory allows, up to kStreamMaxSlots.
template <int W>
cudaError_t launch_tc_stream(const void* q, const void* k, const void* v,
                             const long long* st, __nv_bfloat16* out,
                             Strides os, int batch, int heads, int nq,
                             int nk, int d, int chunks, float scale_log2,
                             bool pairs, cudaStream_t stream) {
  constexpr int kWgs = W <= kStreamWideW ? kStreamMaxWgs : 2;
  constexpr size_t kTile = TcTile<W>::kBytes;
  auto slots_for = [&](int wgs) {
    const size_t used = tc_stream_smem_bytes(W, wgs, chunks, 0);
    return used > kSmemLimit ? 0
                             : (int)std::min<size_t>(kStreamMaxSlots,
                                                     (kSmemLimit - used) /
                                                         kTile);
  };
  int wgs = std::min(kWgs, (nq + kTcWgRows - 1) / kTcWgRows);
  while (wgs > 1 && slots_for(wgs) < 2) --wgs;
  const int slots = slots_for(wgs);
  if (slots < 2) return cudaErrorInvalidValue;  // Q does not fit
  const size_t smem = tc_stream_smem_bytes(W, wgs, chunks, slots);
  CUtensorMap qm[2], km[2], vm[2];
  if (!tc_maps<W>(qm, q, st, batch, heads, nq, d) ||
      !tc_maps<W>(km, k, st + 3, batch, heads, nk, d) ||
      !tc_maps<W>(vm, v, st + 6, batch, heads, nk, d))
    return cudaErrorInvalidValue;
  auto kernel = attention_tc_stream_kernel<W, kWgs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned x = (unsigned)((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs));
  const unsigned threads = 128 * wgs + kStreamProducer;
  return over_pairs((long long)batch * heads, x, (unsigned)chunks,
                    [&](dim3 grid, long long bh0) {
                      kernel<<<grid, threads, smem, stream>>>(
                          qm[0], qm[1], km[0], km[1], vm[0], vm[1], out, os,
                          heads, nq, nk, d, chunks, slots, scale_log2, bh0,
                          pairs);
                    });
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                const long long* st, int batch, int heads, int nq, int nk,
                int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 ||
      reinterpret_cast<uintptr_t>(q) % 4)
    return (int)cudaErrorInvalidValue;
  for (int i : {0, 1, 2})  // 4-byte loads of q
    if (st[i] % 2) return (int)cudaErrorInvalidValue;
  // 4-byte stores of output pairs where its base and strides allow.
  bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0;
  for (int i : {9, 10, 11}) pairs = pairs && st[i] % 2 == 0;
  const Strides qs{st[0], st[1], st[2]}, os{st[9], st[10], st[11]};
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  // K resident wherever it fits, as the flagship's heads do.
  const int tiles = (nk + kTcKeys - 1) / kTcKeys;
  const int width = (d + 15) / 16 * 16;
  if (d <= kMaxD && tiles <= kTcMaxTiles &&
      tc_smem_bytes(width, tiles) <= kSmemLimit) {
    switch (width) {
#define MINT_CASE(D)                                                      \
  case D:                                                                 \
    return (int)launch_tc<D>(qp, qs, k, v, st, o, os, batch, heads, nq,   \
                             nk, d, scale_log2, pairs, s);
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
  // Else streamed, in chunks of at most kStreamMaxW columns, as even as
  // 16-column steps allow (D = 130 as 144: two 64-column slabs and one of
  // 16, faster on an H100 than whole 64-column slabs, 192).
  const int chunks = (d + kStreamMaxW - 1) / kStreamMaxW;
  switch (((d + chunks - 1) / chunks + 15) / 16 * 16) {
#define MINT_CASE(W)                                                        \
  case W:                                                                   \
    return (int)launch_tc_stream<W>(q, k, v, st, o, os, batch, heads, nq,   \
                                    nk, d, chunks, scale_log2, pairs, s);
    MINT_CASE(16)
    MINT_CASE(32)
    MINT_CASE(48)
    MINT_CASE(64)
    MINT_CASE(80)
    MINT_CASE(96)
    MINT_CASE(112)
    MINT_CASE(128)
    MINT_CASE(144)
    MINT_CASE(160)
    MINT_CASE(176)
    MINT_CASE(192)
    MINT_CASE(208)
    MINT_CASE(224)
    MINT_CASE(240)
    MINT_CASE(256)
#undef MINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, nq, d], k and v [B, H, nk, d] and out [B, H, nq, d], each a view
// with D contiguous and strides[12] = (b, h, n) strides in elements of q,
// k, v and out, in that order; any d, nq, nk and B * H.  bf16: q 4-byte
// aligned with even strides, and a zero at column d of each row where d
// is odd (the wrapper pads such heads); k and v 16-byte aligned with
// strides of whole 8-element steps (TMA).
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
