// Unmasked multi-head attention forward, f32: out = softmax(q k^T * scale) v
// (the bf16 kernels are in attention.cu).
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
//   a 256-thread block may take (ptxas: 238).  It takes heads up to 256
//   columns, one output chunk (z = 0).
// - f32, wider heads (attention_scores_f32_kernel,
//   attention_softmax_f32_kernel, attention_pv_f32_kernel): no width is
//   refused, and each score is computed once a call.  Past 256 columns a
//   block's output chunk and Q's rows no longer fit beside each other, so
//   the wide kernel's schedule would cut the output into chunks on the
//   grid's z axis, each block computing every score again (5 chunks at
//   D = 1032, 8 at 2048; an H100 ran that 2.1x as slow at D = 264, 8.3x
//   at 2048).  Instead three launches go through a workspace: kernel 1, a register-blocked SGEMM over (64 query rows,
//   64 keys) tiles (csrc/mlp.cu's gemm_nt_kernel schedule: 32-column
//   stages by cp.async, three in flight, 8 x 4 micro-tiles), writes the
//   scaled scores; kernel 2, a warp a row, finds each row's max and sum
//   and writes P = exp(s - max) / sum over them; kernel 3, an SGEMM over
//   (64 rows, 64 output columns) tiles, sums P v over the keys.  The work
//   is 4 Nq Nk D flops, 8.5 GFLOP at q[2,4,360,2048], 0.127 ms on the FMA
//   pipes: the workspace's round trip (4 Nq Nk bytes a head, 4.4 MB
//   there, in L2) is a few percent of it.  The workspace comes from
//   PyTorch's caching allocator (ops/attention.py's workspace_bytes), its
//   64-row units (a pair's query tile) taken in as many launch groups as
//   it takes.
//
// The kernels put the (batch, head) pairs on the grid's y axis, at most
// 65535 a launch; the C entry points launch as many times as B * H needs,
// each launch starting at pair bh0.

#include "attention.cuh"

namespace {

// ---- f32 on the FMA pipes ------------------------------------------------

constexpr int kWarpRows = 16;  // query rows per warp
constexpr int kMaxWarps = 4;   // warps per block
constexpr int kKTile = 32;     // keys per K and V tile
constexpr int kLdP = kKTile + 4;  // P row: (stride / 4) odd, as in tile_ld
constexpr int kWideMaxWarps = 8;  // warps a block of attention_wide_kernel
constexpr int kWideMaxD = 256;    // the widest head it takes

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

// The same for any d: warps over the rows, lanes over the columns, with no
// division; `copy` bytes a copy (16: d, the stride and the base multiples
// of 4 floats; 8: of 2; else 4).  Rows past n are zero-filled; columns d ..
// ld stay as they are.
__device__ __forceinline__ void load_cols(float* dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int rows, int n, int d,
                                          int copy) {
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += warps) {
    const bool ok = r0 + r < n;
    const float* s = ok ? src + (r0 + r) * stride : src;
    float* t = dst + r * ld;
    if (copy == 16) {
      for (int c = 4 * lane; c < d; c += 128) mint::cp_async16(t + c, s + c, ok);
    } else if (copy == 8) {
      for (int c = 2 * lane; c < d; c += 64) mint::cp_async8(t + c, s + c, ok);
    } else {
      for (int c = lane; c < d; c += 32) mint::cp_async4(t + c, s + c, ok);
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
// [0, d) of each (orow0: row row0's first output column), `copy` bytes a
// store where the output allows (as load_cols' copies).
template <int NQ>
__device__ __forceinline__ void write_rows(const float4 (&acc)[2][NQ],
                                           const float (&lsum)[4], float* l_s,
                                           float* orow0, long long ostride,
                                           int row0, int nq, int d, int copy,
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
      if (copy == 16) {
        *reinterpret_cast<float4*>(orow + c) = o;
      } else if (copy == 8) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(o.x, o.y);
        if (c + 2 < d)
          *reinterpret_cast<float2*>(orow + c + 2) = make_float2(o.z, o.w);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) orow[c + e] = get(o, e);
      }
    }
  }
}

// One block per (batch*head bh0 + blockIdx.y, 16 * warps query rows); each
// warp owns 16 rows.  Every loop over the head dim runs over W = 4 D4
// columns, unrolled.  NQ: float4 columns of the head dim per lane in P.V
// (W <= 16 NQ).  FACT's d = 80 has its own instance (!kPadded: d = W,
// 16-byte copies).  The others (kPadded) take any d <= W (W: d rounded up
// to 8): Q's and K's columns d .. W are zeros in shared memory, so the
// scores are exact, and V's reach only P.V columns that are never stored,
// as do the columns past W that P.V computes with no test (reading into
// the next row, or past the V tile into P); loads by load_cols, `copy`
// bytes a copy.  The kernels below run it.
template <int NQ, int D4, bool kPadded>
__device__ __forceinline__ void attention_rows(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, Strides qs_,
    Strides ks_, Strides vs_, Strides os_, int heads, int nq, int nk, int d,
    float scale, int copy, long long bh0) {
  extern __shared__ float4 smem4[];
  constexpr int kW = 4 * D4;
  const int ld = tile_ld(kW);
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
  // Rows r0 .. r0 + rows of a head into a tile.
  auto load = [&](float* dst, const float* src, long long stride, int r0,
                  int rows, int n) {
    if constexpr (kPadded)
      load_cols(dst, ld, src, stride, r0, rows, n, d, copy);
    else
      load_rows(dst, ld, src, stride, r0, rows, n, kW, true);
  };

  if (kPadded && d < kW) {  // zero the columns d .. W of Q, K and V
    const int pad = kW - d;
    const int rows = kWarpRows * warps + 2 * kKTile;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
      qs[(i / pad) * ld + d + i % pad] = 0.f;
  }
  load(qs, qh, qs_.n, q0, kWarpRows * warps, nq);
  load(ks, kh, ks_.n, 0, kKTile, nk);
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
    load(vs, vh, vs_.n, k0, kKTile, nk);  // overlaps the scores
    mint::cp_async_commit();

    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
    scores_fma<kJ>(s, qw, ks + sc * ld, ld, D4);
    const int valid = nk - k0;
    softmax_tile<kJ>(s, m, lsum, ps, alpha_s, sr, sc, valid, scale);

    // V(t) has landed, and every warp is done with K(t).
    mint::cp_async_wait<0>();
    __syncthreads();
    if (k0 + kKTile < nk) load(ks, kh, ks_.n, k0 + kKTile, kKTile, nk);
    mint::cp_async_commit();  // K(t+1) overlaps P.V

    pv_fma<NQ, !kPadded>(acc, ps, alpha_s, vs, ld, pr, pq,
                         (min(kKTile, valid) + 3) & ~3, D4);
  }

  const int row0 = q0 + warp * kWarpRows;
  write_rows<NQ>(acc, lsum, l_s, out + b * os_.b + h * os_.h + row0 * os_.n,
                 os_.n, row0, nq, d, copy, sr, sc, pr, pq);
}

template <int NQ, int D4, bool kPadded>
__global__ void __launch_bounds__(32 * kMaxWarps)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     int heads, int nq, int nk, int d, float scale,
                     int copy, long long bh0) {
  attention_rows<NQ, D4, kPadded>(q, k, v, out, qs_, ks_, vs_, os_, heads,
                                  nq, nk, d, scale, copy, bh0);
}

// The padded instances at W = 72 and 80, held to 128 registers a thread,
// four blocks an SM (ptxas gives them 144, three blocks: D = 67 1.13x as
// fast so on an H100; at W = 104, 1.06x as slow, so the wider ones keep
// theirs).
template <int NQ, int D4>
__global__ void __launch_bounds__(32 * kMaxWarps, 4)
    attention_kernel_4(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       Strides qs_, Strides ks_, Strides vs_, Strides os_,
                       int heads, int nq, int nk, int d, float scale,
                       int copy, long long bh0) {
  attention_rows<NQ, D4, true>(q, k, v, out, qs_, ks_, vs_, os_, heads, nq,
                               nk, d, scale, copy, bh0);
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
                 nq, dcz, vec ? 16 : 4, sr, sc, pr, pq);
}

// ---- f32, every score once: heads past one output chunk ------------------

constexpr int kOnceRows = 64;     // query rows a unit (a block of kernels 1-3)
constexpr int kOnceKeys = 64;     // keys a scores block
constexpr int kOnceCols = 64;     // output columns a P.V block
constexpr int kOnceK = 32;        // head-dim columns (or keys) a stage
constexpr int kOnceLd = kOnceK + 4;  // a staged row: 16-byte aligned, eight
                                     // rows at one column in 8 bank quads
constexpr int kOnceVLd = kOnceCols + 4;  // a staged V row
constexpr int kOnceStages = 3;    // cp.async ring depth
constexpr int kOnceThreads = 128;    // a block of kernel 3
constexpr int kOnceScoreTM = 8;      // kernel 1's micro-tile rows
constexpr int kOnceMinD = kWideMaxD + 1;  // the narrowest head they take

// A unit's workspace: its 64 rows of scores, then P in place, each nk
// rounded up to a stage of keys (ops/attention.py's workspace_bytes).
__host__ __device__ __forceinline__ int once_ld(int nk) {
  return (nk + kOnceK - 1) / kOnceK * kOnceK;
}
long long once_f32_unit_bytes(int nk) {
  return 4LL * kOnceRows * once_ld(nk);
}

// Copies the 4 floats at src (the first `cols` real, more than 0 whole
// with kVec) to dst, or zeros where !row_ok (src then unread; `any` a
// mapped address for the copy's operand).
template <bool kVec>
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* any, bool row_ok,
                                      int cols) {
  if constexpr (kVec) {
    const bool ok = row_ok && cols > 0;
    mint::cp_async16(dst, ok ? src : any, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row_ok && e < cols;
      mint::cp_async4(dst + e, ok ? src + e : any, ok);
    }
  }
}

// Kernel 1.  One block per (64-key tile blockIdx.x, pair bh0 + blockIdx.y,
// query tile qt0 + blockIdx.z: unit blockIdx.y nqt + blockIdx.z of the
// launch): the tile's scores q . k, summed over the head dim in stages of
// 32 columns of Q's 64 rows and K's 64 (cp.async, three in flight, one
// block barrier a stage: the schedule of csrc/mlp.cu's gemm_nt_kernel),
// each of 16 * 64 / TM threads a TM x 4 outer-product micro-tile (rows ty
// + 64 / TM i, keys tx + 16 j) fed by float4 reads along the head dim
// (TM + 4 loads a 16 TM FMAs).  TM = kOnceScoreTM = 8, 128 threads: 4,
// twice the warps an SM at q[2,4,360,D], ran 2-3% slower on an H100.
// Columns past d and rows past nq or nk stage as zeros, so each score is
// exact; the unit's rows get them scaled, keys below nk.  kVec: 16-byte
// copies (d, the strides and the bases multiples of 4 floats), else 4-byte
// ones.
template <bool kVec>
__global__ void __launch_bounds__(16 * kOnceRows / kOnceScoreTM)
    attention_scores_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k, Strides qs_,
                                Strides ks_, float* __restrict__ ws,
                                int heads, int nq, int nk, int d,
                                float scale, long long bh0, int qt0,
                                int nqt) {
  extern __shared__ float4 smem4[];
  constexpr int kTM = kOnceScoreTM, kRowStep = kOnceRows / kTM;
  constexpr int kThreads = 16 * kRowStep;
  constexpr int kTile = kOnceRows * kOnceLd;
  float* as = reinterpret_cast<float*>(smem4);  // [stages][64][kOnceLd]
  float* bs = as + kOnceStages * kTile;         // [stages][64][kOnceLd]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // A warp is 4 x 8 threads: its Q reads touch 4 rows, its K reads 8.
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int m0 = (qt0 + blockIdx.z) * kOnceRows, n0 = blockIdx.x * kOnceKeys;
  const float* qh = q + b * qs_.b + h * qs_.h;
  const float* kh = k + b * ks_.b + h * ks_.h;
  const int tiles = (d + kOnceK - 1) / kOnceK;
  // This thread copies columns cc .. cc + 3 of rows cr + kThreads / 8 p
  // of a stage.
  const int cr = tid / 8, cc = 4 * (tid % 8);
  auto load = [&](int t) {
    const int c = t * kOnceK + cc;
    float* ad = as + (t % kOnceStages) * kTile + cr * kOnceLd + cc;
    float* bd = bs + (t % kOnceStages) * kTile + cr * kOnceLd + cc;
#pragma unroll
    for (int r = 0; r < kOnceRows; r += kThreads / 8) {
      copy4<kVec>(ad + r * kOnceLd, qh + (m0 + r + cr) * qs_.n + c, q,
                  m0 + r + cr < nq, d - c);
      copy4<kVec>(bd + r * kOnceLd, kh + (n0 + r + cr) * ks_.n + c, q,
                  n0 + r + cr < nk, d - c);
    }
  };
#pragma unroll
  for (int t = 0; t < kOnceStages - 1; ++t) {
    if (t < tiles) load(t);
    mint::cp_async_commit();
  }
  float acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    // Stage t has landed (for every thread after the barrier), and every
    // thread is done with stage t - 1, whose slot the next copy reuses.
    mint::cp_async_wait<kOnceStages - 2>();
    __syncthreads();
    if (t + kOnceStages - 1 < tiles) load(t + kOnceStages - 1);
    mint::cp_async_commit();
    const float* at = as + (t % kOnceStages) * kTile + ty * kOnceLd;
    const float* bt = bs + (t % kOnceStages) * kTile + tx * kOnceLd;
#pragma unroll
    for (int kk = 0; kk < kOnceK; kk += 4) {
      float4 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(bt + 16 * j * kOnceLd + kk);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 av = ld4(at + kRowStep * i * kOnceLd + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
  }
  const int ld = once_ld(nk);
  float* su = ws + ((long long)blockIdx.y * nqt + blockIdx.z) * kOnceRows * ld;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = n0 + tx + 16 * j;
    if (key >= nk) continue;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      su[(ty + kRowStep * i) * ld + key] = acc[i][j] * scale;
  }
}

// Kernel 2.  One warp per query row below nq, 8 a block (rows 8
// (blockIdx.x % 8) .. of unit blockIdx.y nqt + blockIdx.x / 8): the row's
// max m over its nk scores, the sum l of exp(s - m), then P = exp(s - m)
// / l in place, exactly normalised as the TPU kernel's (a no-op cast in
// f32), and zeros from nk to the row's end.  Each pass's loads are
// independent of each other: a warp a row keeps enough of them in flight.
__global__ void __launch_bounds__(256)
    attention_softmax_f32_kernel(float* __restrict__ ws, int nq, int nk,
                                 int qt0, int nqt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = once_ld(nk);
  const int qt = blockIdx.x / 8, r = 8 * (blockIdx.x % 8) + warp;
  if ((qt0 + qt) * kOnceRows + r >= nq) return;
  float* p = ws + (((long long)blockIdx.y * nqt + qt) * kOnceRows + r) * ld;
  float m = -INFINITY;
  for (int c = lane; c < nk; c += 32) m = fmaxf(m, p[c]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float l = 0.f;
  for (int c = lane; c < nk; c += 32) l += expf(p[c] - m);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  for (int c = lane; c < ld; c += 32)
    p[c] = c < nk ? expf(p[c] - m) / l : 0.f;
}

// Kernel 3.  One block per (64-column chunk blockIdx.x of the output, pair
// bh0 + blockIdx.y, query tile qt0 + blockIdx.z: unit blockIdx.y nqt +
// blockIdx.z), 128 threads: the chunk of P v over the keys in stages of
// 32 (the unit's P, 64 x 32, and V's 32 x 64 tile; cp.async, three in
// flight), each thread 8 rows (ty + 8 i) by one float4 of columns (4 tx
// ..) fed by float4 reads of P along the keys and of V along the columns
// (12 loads a 128 FMAs).  P's rows past nq stage as zeros, and V's keys
// past nk and columns past d; the rows below nq and columns below d are
// stored, `copy` bytes a store where the output allows (16, 8 or 4).
template <bool kVec>
__global__ void __launch_bounds__(kOnceThreads)
    attention_pv_f32_kernel(const float* __restrict__ ws,
                            const float* __restrict__ v, Strides vs_,
                            float* __restrict__ out, Strides os_, int heads,
                            int nq, int nk, int d, int copy, long long bh0,
                            int qt0, int nqt) {
  extern __shared__ float4 smem4[];
  constexpr int kPTile = kOnceRows * kOnceLd;
  constexpr int kVTile = kOnceK * kOnceVLd;
  float* ps = reinterpret_cast<float*>(smem4);  // [stages][64][kOnceLd]
  float* vs = ps + kOnceStages * kPTile;        // [stages][32][kOnceVLd]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 16, ty = 2 * warp + lane / 16;
  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int row0 = (qt0 + blockIdx.z) * kOnceRows;
  const int c0 = blockIdx.x * kOnceCols;
  const int ld = once_ld(nk);
  const float* pu =
      ws + ((long long)blockIdx.y * nqt + blockIdx.z) * kOnceRows * ld;
  const float* vh = v + b * vs_.b + h * vs_.h + c0;
  const int tiles = ld / kOnceK;
  // This thread copies P's columns pc .. pc + 3 of rows pr + 16 p, and
  // V's columns vc .. vc + 3 of keys vr + 8 p.
  const int pr = tid / 8, pc = 4 * (tid % 8);
  const int vr = tid / 16, vc = 4 * (tid % 16);
  auto load = [&](int t) {
    const int k0 = t * kOnceK;
    float* pd = ps + (t % kOnceStages) * kPTile + pr * kOnceLd + pc;
    float* vd = vs + (t % kOnceStages) * kVTile + vr * kOnceVLd + vc;
#pragma unroll
    for (int r = 0; r < kOnceRows; r += kOnceThreads / 8)
      copy4<true>(pd + r * kOnceLd, pu + (r + pr) * ld + k0 + pc, ws,
                  row0 + r + pr < nq, 4);
#pragma unroll
    for (int r = 0; r < kOnceK; r += kOnceThreads / 16)
      copy4<kVec>(vd + r * kOnceVLd, vh + (k0 + r + vr) * vs_.n + vc, ws,
                  k0 + r + vr < nk, d - c0 - vc);
  };
#pragma unroll
  for (int t = 0; t < kOnceStages - 1; ++t) {
    if (t < tiles) load(t);
    mint::cp_async_commit();
  }
  float4 acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tiles; ++t) {
    mint::cp_async_wait<kOnceStages - 2>();
    __syncthreads();
    if (t + kOnceStages - 1 < tiles) load(t + kOnceStages - 1);
    mint::cp_async_commit();
    const float* pt = ps + (t % kOnceStages) * kPTile + ty * kOnceLd;
    const float* vt = vs + (t % kOnceStages) * kVTile + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < kOnceK; kk += 4) {
      float4 vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = ld4(vt + (kk + e) * kOnceVLd);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pv = ld4(pt + 8 * i * kOnceLd + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = get(pv, e);
          acc[i].x = fmaf(a, vv[e].x, acc[i].x);
          acc[i].y = fmaf(a, vv[e].y, acc[i].y);
          acc[i].z = fmaf(a, vv[e].z, acc[i].z);
          acc[i].w = fmaf(a, vv[e].w, acc[i].w);
        }
      }
    }
  }
  const int c = c0 + 4 * tx;
  if (c >= d) return;
  float* oh = out + b * os_.b + h * os_.h + c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ty + 8 * i;
    if (row >= nq) continue;
    float* o = oh + row * os_.n;
    const float4 x = acc[i];
    if (copy == 16) {
      *reinterpret_cast<float4*>(o) = x;
    } else if (copy == 8) {
      *reinterpret_cast<float2*>(o) = make_float2(x.x, x.y);
      if (c + 2 < d) *reinterpret_cast<float2*>(o + 2) = make_float2(x.z, x.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) o[e] = get(x, e);
    }
  }
}

// The three kernels over the (batch, head) pairs' query tiles, as many
// units a group as ws_bytes of workspace at ws hold.
template <bool kVec>
int launch_f32_once(const float* q, const float* k, const float* v,
                    float* out, Strides qs, Strides ks, Strides vs,
                    Strides os, void* ws, long long ws_bytes, int batch,
                    int heads, int nq, int nk, int d, float scale, int copy,
                    cudaStream_t stream) {
  const long long fit = ws_bytes / once_f32_unit_bytes(nk);
  if (ws == nullptr || fit < 1) return (int)cudaErrorInvalidValue;
  const size_t smem1 =
      sizeof(float) * kOnceStages * 2 * kOnceRows * kOnceLd;
  const size_t smem3 = sizeof(float) * kOnceStages *
                       (kOnceRows * kOnceLd + kOnceK * kOnceVLd);
  cudaError_t err = cudaFuncSetAttribute(
      attention_scores_f32_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_pv_f32_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const int qtiles = (nq + kOnceRows - 1) / kOnceRows;
  const unsigned ktiles = (unsigned)((nk + kOnceKeys - 1) / kOnceKeys);
  const unsigned chunks = (unsigned)((d + kOnceCols - 1) / kOnceCols);
  auto* w = static_cast<float*>(ws);
  return (int)over_groups(
      (long long)batch * heads, qtiles, fit, 65535, [&](const Group& grp) {
        const unsigned np = (unsigned)grp.np, nqt = (unsigned)grp.nqt;
        attention_scores_f32_kernel<kVec>
            <<<dim3(ktiles, np, nqt), 16 * kOnceRows / kOnceScoreTM, smem1,
               stream>>>(
                q, k, qs, ks, w, heads, nq, nk, d, scale, grp.bh0, grp.qt0,
                grp.nqt);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        attention_softmax_f32_kernel<<<dim3(8 * nqt, np), 256, 0, stream>>>(
            w, nq, nk, grp.qt0, grp.nqt);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        attention_pv_f32_kernel<kVec>
            <<<dim3(chunks, np, nqt), kOnceThreads, smem3, stream>>>(
                w, v, vs, out, os, heads, nq, nk, d, copy, grp.bh0, grp.qt0,
                grp.nqt);
        return cudaGetLastError();
      });
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               const long long* st, void* ws, long long ws_bytes, int batch,
               int heads, int nq, int nk, int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  // The widest copy every row allows: 16 bytes where d, every stride and
  // pointer are multiples of 4 floats, else 8 where they are even, else 4.
  auto every = [&](int n) {
    bool ok = d % n == 0;
    for (int i = 0; i < 12; ++i) ok = ok && st[i] % n == 0;
    for (const void* p : {q, k, v, (const void*)out})
      ok = ok && reinterpret_cast<uintptr_t>(p) % (4 * n) == 0;
    return ok;
  };
  const int copy = every(4) ? 16 : every(2) ? 8 : 4;
  const bool vec = copy == 16;
  // As many 16-row warps as the query rows need, up to kMaxWarps.
  int warps = min(kMaxWarps, (nq + kWarpRows - 1) / kWarpRows);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  // Past one output chunk, every score once through the workspace
  // (ops/attention.py's scores_once mirrors the choice).
  if (d >= kOnceMinD)
    return vec ? launch_f32_once<true>(qp, kp, vp, op, qs, ks, vs, os, ws,
                                       ws_bytes, batch, heads, nq, nk, d,
                                       scale, copy, s)
               : launch_f32_once<false>(qp, kp, vp, op, qs, ks, vs, os, ws,
                                        ws_bytes, batch, heads, nq, nk, d,
                                        scale, copy, s);
  if (d > kMaxD) {
    // One output chunk of the whole head; up to kWideMaxWarps warps (all
    // fit in shared memory up to kWideMaxD columns).
    const int dc = (d + 3) / 4 * 4;
    warps = min(kWideMaxWarps, (nq + kWarpRows - 1) / kWarpRows);
    const size_t smem = wide_smem_bytes(d, dc, warps);
    auto kernel = dc <= 144   ? attention_wide_kernel<9>
                  : dc <= 192 ? attention_wide_kernel<12>
                              : attention_wide_kernel<16>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int rows = kWarpRows * warps;
    return (int)over_pairs(
        bh, (unsigned)((nq + rows - 1) / rows), 1,
        [&](dim3 grid, long long bh0) {
          kernel<<<grid, 32 * warps, smem, s>>>(qp, kp, vp, op, qs, ks, vs,
                                               os, heads, nq, nk, d, dc,
                                               scale, vec, bh0);
        });
  }
  const int rows = kWarpRows * warps;
  const unsigned x = (unsigned)((nq + rows - 1) / rows);
  // FACT's head dim has its own instance; every other d <= 128 the one of
  // its width W rounded up to 8 (the same at d = 80 where 16-byte copies
  // cannot read it).  Every loop over the head dim is unrolled at W.
  using Kernel = decltype(&attention_kernel<5, 20, false>);
  Kernel kernel = nullptr;
  int width = 80;
  if (d == 80 && vec) {
    kernel = attention_kernel<5, 20, false>;
  } else {
    width = (d + 7) / 8 * 8;
    switch (width / 8) {
#define MINT_CASE(W8, KERNEL)                        \
  case W8:                                          \
    kernel = KERNEL<(W8 + 1) / 2, 2 * W8 MINT_PAD>; \
    break;
#define MINT_PAD , true
      MINT_CASE(1, attention_kernel)
      MINT_CASE(2, attention_kernel)
      MINT_CASE(3, attention_kernel)
      MINT_CASE(4, attention_kernel)
      MINT_CASE(5, attention_kernel)
      MINT_CASE(6, attention_kernel)
      MINT_CASE(7, attention_kernel)
      MINT_CASE(8, attention_kernel)
      MINT_CASE(11, attention_kernel)
      MINT_CASE(12, attention_kernel)
      MINT_CASE(13, attention_kernel)
      MINT_CASE(14, attention_kernel)
      MINT_CASE(15, attention_kernel)
      MINT_CASE(16, attention_kernel)
#undef MINT_PAD
#define MINT_PAD
      MINT_CASE(9, attention_kernel_4)
      MINT_CASE(10, attention_kernel_4)
#undef MINT_PAD
#undef MINT_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = smem_bytes(width, warps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)over_pairs(bh, x, 1, [&](dim3 grid, long long bh0) {
    kernel<<<grid, 32 * warps, smem, s>>>(qp, kp, vp, op, qs, ks, vs, os,
                                         heads, nq, nk, d, scale, copy, bh0);
  });
}

}  // namespace

// q [B, H, nq, d], k and v [B, H, nk, d] and out [B, H, nq, d], each a view
// with D contiguous and strides[12] = (b, h, n) strides in elements of q,
// k, v and out, in that order; any d, nq, nk and B * H.
extern "C" int mint_attention_f32(const void* q, const void* k,
                                  const void* v, void* out,
                                  const long long* strides, void* ws,
                                  long long ws_bytes, int batch, int heads,
                                  int nq, int nk, int d, float scale,
                                  void* stream) {
  return launch_f32(q, k, v, out, strides, ws, ws_bytes, batch, heads, nq, nk,
                    d, scale, stream);
}
