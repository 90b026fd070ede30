// What the bf16 attention sources share (csrc/attention.cu, the resident
// kernel and the C entry; csrc/attention_pairs.cu, the resident schedule
// over kTmaPairs views; csrc/attention_stream.cu, the streamed kernel):
// the tile layout, the routes a view is loaded by, the loads and copies
// into shared memory, the two passes' arithmetic, the resident schedule
// of the other routes (tc_resident), and the TMA maps.  Split so that
// nvcc builds them at once.
#pragma once

#include "attention.cuh"
#include "wgmma.cuh"

namespace {

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
// The narrowest frame the scores-once kernels take (attention_once.cu):
// past two of the streamed kernel's output chunks of 176 columns, the
// widest that ptxas compiles without spills.  An H100 ran the streamed
// kernel faster up to there (q[20,4,360,352]: 0.122 ms against 0.141) and
// the scores-once kernels past it (368: 0.145 against 0.154; PERF.md,
// PR 17).
constexpr int kOnceMinFrame = 2 * 176 + 1;

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

// The resident schedule: every K tile of width d and a ring of up to
// kTcVStages V tiles.
size_t tc_smem_bytes(int d, int tiles) {
  // 1 KB of slack to align the tiles to the swizzle's 1 KB atoms.
  return 2 * kTcBarBytes +
         (size_t)(tiles + std::min(tiles, kTcVStages)) * kTcKeys * 2 * d;
}

// kTmaPairs: the tiles of nk keys, even rows' (ceil of half) then odd.
int pair_tiles(int nk) {
  return ((nk + 1) / 2 + kTcKeys - 1) / kTcKeys +
         (nk / 2 + kTcKeys - 1) / kTcKeys;
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

// How a K, V or Q tile reaches shared memory (ops/attention.py's
// bf16_route picks it from the view's layout): TMA over the [B, H, N, D]
// view (base and every stride whole 16-byte steps; TMA's zeros past d);
// TMA over a token row's head columns, a [B, N, (H - 1) st_h + d] tensor
// (base and the B and N strides whole 16-byte steps, any head stride: the
// model's fused QKV views at head dims no multiple of 8); or copies by the
// block's threads into the layout TMA would write (any view; the resident
// kernel only).  TMA takes no box whose first column is off a 16-byte step
// (an illegal instruction on an H100), so a head's boxes start at the step
// at or before its first column h st_h: the head lies o = h st_h % 8
// columns into its tiles, in a frame up to 8 - gcd(st_h, 8) columns wider
// than d (col_shift); Q's fragments and the output's columns move by o
// too.  The columns around the head are the neighbouring heads': Q's are
// zeros (in registers, or zeroed once in shared memory), so K's add
// nothing to the scores (finite values, as a model's activations are;
// zeroing K's tiles instead cost a block barrier a tile: D = 50 1.3x as
// slow on an H100), and V's reach only output columns that are never
// stored.
//
// kTmaPairs (the resident schedule of attention_pairs.cu): a view whose
// token rows alternate between two 16-byte phases (a token stride of 8
// bytes past a 16-byte step: the model's fused QKV views at hidden 804,
// 4824-byte rows) is two TMA maps, its even rows and its odd rows, each
// over every other token (a 16-byte step).  The keys run even rows first,
// then odd ones (the softmax and P.V take them in any order, K's and V's
// alike).  Within a map a head starts o_p = (c_p + h st_h) % 8 columns
// into its tiles (c_p: 4 where that parity's rows start 8 bytes past a
// 16-byte step, the map then based 8 bytes early), and o_1 = o_0 +- 4:
// each parity's tiles land as TMA writes them, and the 4 columns between
// them are made up in registers (attention_tc_pairs_kernel).
enum Route { kTmaView = 0, kTmaColumns = 1, kCopies = 2, kTmaPairs = 3 };

// Byte offset in a TcTile<D> of element (row r, column c), swizzled as TMA
// writes it: in a 64-column slab the 16-byte chunk of a 128-byte row is
// XORed with r % 8, in a 16-column slab that of a 32-byte row with
// (r / 4) % 2 (every slab starts on its swizzle atom).
template <int D>
__device__ __forceinline__ int tile_byte(int r, int c) {
  using T = TcTile<D>;
  if (c < 64 * T::kWide) {
    const int x = 2 * (c % 64);
    return (c / 64) * T::kWideBytes + 128 * r +
           (((x >> 4) ^ (r & 7)) << 4) + (x & 15);
  }
  const int cn = c - 64 * T::kWide, x = 2 * (cn % 16);
  return T::kWide * T::kWideBytes + (cn / 16) * T::kNarrowBytes + 32 * r +
         (((x >> 4) ^ ((r >> 2) & 1)) << 4) + (x & 15);
}

// Zeros the columns outside [lo, hi) of the 64 rows of a TcTile<D>, the
// threads tid of `threads` sharing them.  The caller fences
// (fence_proxy_async) and syncs them before a product reads the tile.
template <int D>
__device__ __forceinline__ void zero_outside(uint8_t* tile, int lo, int hi,
                                             int tid, int threads) {
  lo = max(0, min(lo, D));
  hi = max(lo, min(hi, D));
  const int w = D - (hi - lo);  // columns to zero a row
  for (int i = tid; i < kTcKeys * w; i += threads) {
    const int r = i / w, j = i - r * w;
    *reinterpret_cast<uint16_t*>(
        tile + tile_byte<D>(r, j < lo ? j : hi + j - lo)) = 0;
  }
}

// Whether a head's rows (first at p, `stride` elements apart) all start on
// 4-byte boundaries.
__device__ __forceinline__ bool rows_aligned4(const __nv_bfloat16* p,
                                              long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && stride % 2 == 0;
}

__device__ __forceinline__ uint32_t ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Columns c and c + 1 (c >= -1) of a row at p as a bf16 pair, zeros
// outside [0, d): one 4-byte load where p + c is on a 4-byte boundary
// (`aligned`), else 2-byte ones.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int c,
                                            int d, bool aligned) {
  if (c >= 0 && c + 1 < d)
    return aligned ? ld32(p + c) : ld16(p + c) | ld16(p + c + 1) << 16;
  return (c >= 0 && c < d ? ld16(p + c) : 0u) |
         (c + 1 >= 0 && c + 1 < d ? ld16(p + c + 1) << 16 : 0u);
}

// The 16 bytes from byte sh (even, < 16) of the 32 little-endian bytes
// lo:hi, with bf16 columns cols .. 8 zeroed: each output word is the word
// sh / 4 further on, or (sh % 4 == 2) the two halves across it.
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi,
                                         int sh, int cols) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int k = sh / 4;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = k == 0 ? w[i] : k == 1 ? w[i + 1] : k == 2 ? w[i + 2] : w[i + 3];
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = sh % 4 ? __funnelshift_r(x[i], x[i + 1], 16) : x[i];
    out[i] = v & (2 * i + 1 < cols ? 0xffffffffu : 2 * i < cols ? 0xffffu : 0u);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The block's threads copy rows row0 .. row0 + 64 of a head (`src`, rows
// `stride` elements apart) into the TcTile<D> at dst, swizzled as TMA
// would, rows past n and columns past d as zeros; the tile completes on
// `bar`, one arrival a thread.  A unit is 8 columns of a row, 16 bytes in
// the tile: read as the one or two aligned 16-byte words around it (any
// head offset; a word that holds a column of the view lies in its
// allocation), shifted into place in registers, two units a thread in
// flight (8 registers each: ptxas spills more at three or four).
template <int D>
__device__ __forceinline__ void copy_tile(uint8_t* dst, uint64_t* bar,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int n,
                                          int d) {
  constexpr int kUnits = D / 8, kAll = kTcKeys * kUnits, kBatch = 2;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i0 = threadIdx.x; i0 < kAll; i0 += kBatch * blockDim.x) {
    uint4 lo[kBatch], hi[kBatch];
    int sh[kBatch], cols[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      const int r = i / kUnits, c = 8 * (i - r * kUnits);
      cols[j] = i < kAll && row0 + r < n ? min(8, d - c) : 0;
      const uintptr_t p =
          reinterpret_cast<uintptr_t>(src + (row0 + r) * stride + c);
      sh[j] = (int)(p % 16);
      const uint4* w = reinterpret_cast<const uint4*>(p - sh[j]);
      lo[j] = cols[j] > 0 ? w[0] : zero;
      hi[j] = cols[j] > 0 && sh[j] + 2 * cols[j] > 16 ? w[1] : zero;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i >= kAll) break;
      const int r = i / kUnits, c = 8 * (i - r * kUnits);
      *reinterpret_cast<uint4*>(dst + tile_byte<D>(r, c)) =
          realign(lo[j], hi[j], sh[j], cols[j]);
    }
  }
  mint::fence_proxy_async();
  mint::mbar_arrive(bar);
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
// of a head's output oh, those below nq and in [lo, dz) (a head that lies
// o columns into its tiles stores from col = -o; oh may be a chunk's
// first column, lo then the head's first: -W z); in pairs of 4 bytes
// where the output's strides and col's parity allow (`pairs`).
__device__ __forceinline__ void store_out(__nv_bfloat16* oh,
                                          long long stride, int row, int nq,
                                          int col, int dz, bool pairs,
                                          float v0, float v1, float v2,
                                          float v3, int lo = 0) {
  if (col >= dz || col + 1 < lo) return;
  if (pairs && col >= lo && col + 1 < dz) {
    if (row < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row * stride + col) =
          __floats2bfloat162_rn(v0, v1);
    if (row + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (row + 8) * stride + col) =
          __floats2bfloat162_rn(v2, v3);
    return;
  }
  const bool first = col >= lo, second = col + 1 < dz;
  if (row < nq) {
    if (first) oh[row * stride + col] = __float2bfloat16_rn(v0);
    if (second) oh[row * stride + col + 1] = __float2bfloat16_rn(v1);
  }
  if (row + 8 < nq) {
    if (first) oh[(row + 8) * stride + col] = __float2bfloat16_rn(v2);
    if (second) oh[(row + 8) * stride + col + 1] = __float2bfloat16_rn(v3);
  }
}

// Q's A fragments of rows `row` and `row + 8` of a head (qh, rows
// `stride` elements apart) straight from device memory: k-step kk holds
// the tiles' columns 16 kk + 2 t (a[0], a[1]) and + 8 (a[2], a[3]), the
// head's columns ko before them; zeros past nq and outside the head.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const __nv_bfloat16* qh,
                                             long long stride, int row,
                                             int nq, int d, int ko, int t4) {
  const bool qal = rows_aligned4(qh, stride) && ko % 2 == 0;
  const __nv_bfloat16* q0p = qh + row * stride;
  const __nv_bfloat16* q8p = q0p + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk + 2 * t4 - ko;
    qf[kk][0] = row < nq ? ld_pair(q0p, col, d, qal) : 0u;
    qf[kk][1] = row + 8 < nq ? ld_pair(q8p, col, d, qal) : 0u;
    qf[kk][2] = row < nq ? ld_pair(q0p, col + 8, d, qal) : 0u;
    qf[kk][3] = row + 8 < nq ? ld_pair(q8p, col + 8, d, qal) : 0u;
  }
}

// P.V of one V tile vt (a ring slot): one m64n64k16 per wide slab of V and
// one m64n16k16 per narrow one a 16-key step of P (a), the steps past
// `valid` keys skipped; the first product overwrites the accumulators
// unless `acc`.  Waits for the products.
template <int D>
__device__ __forceinline__ void tc_pv(
    float (&ow)[TcTile<D>::kWide ? TcTile<D>::kWide : 1][32],
    float (&on)[TcTile<D>::kNarrow ? TcTile<D>::kNarrow : 1][8],
    const uint32_t (&a)[kTcKeys / 16][4], const uint8_t* vt, int valid,
    bool acc) {
  using T = TcTile<D>;
  mint::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTcKeys / 16; ++j) {
    if (16 * j >= valid) break;  // the same for the whole warpgroup
    const int add = acc || j > 0;
#pragma unroll
    for (int w = 0; w < T::kWide; ++w)
      mint::wgmma_rs<64, 1>(
          ow[w], a[j],
          slab_desc(vt + w * T::kWideBytes + 16 * j * 128, 1024, 1), add);
#pragma unroll
    for (int w = 0; w < T::kNarrow; ++w)
      mint::wgmma_rs<16, 1>(
          on[w], a[j],
          slab_desc(vt + T::kWide * T::kWideBytes + w * T::kNarrowBytes +
                        16 * j * 32,
                    256, 3),
          add);
  }
  mint::wgmma_commit();
  mint::wgmma_wait<0>();
}

// Stores the P.V accumulators of rows `row` and `row + 8` into the head's
// output oh (rows `stride` apart): V's tile column c is the head's c - vo.
template <int D>
__device__ __forceinline__ void store_head(
    const float (&ow)[TcTile<D>::kWide ? TcTile<D>::kWide : 1][32],
    const float (&on)[TcTile<D>::kNarrow ? TcTile<D>::kNarrow : 1][8],
    __nv_bfloat16* oh, long long stride, int row, int nq, int d, int vo,
    bool pairs, int t4) {
  using T = TcTile<D>;
  const bool opairs = pairs && vo % 2 == 0;
#pragma unroll
  for (int w = 0; w < T::kWide; ++w)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store_out(oh, stride, row, nq, 64 * w + 8 * n + 2 * t4 - vo, d, opairs,
                ow[w][4 * n], ow[w][4 * n + 1], ow[w][4 * n + 2],
                ow[w][4 * n + 3]);
#pragma unroll
  for (int w = 0; w < T::kNarrow; ++w)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store_out(oh, stride, row, nq,
                64 * T::kWide + 16 * w + 8 * n + 2 * t4 - vo, d, opairs,
                on[w][4 * n], on[w][4 * n + 1], on[w][4 * n + 2],
                on[w][4 * n + 3]);
}

// TMA map of one [B, H, N, d] bf16 view (strides st: b, h, n), boxes of
// `box` columns x 64 rows with the given swizzle.  kTmaView: dims (d, N,
// H, B), columns past d (and rows past N) read as zeros.  kTmaColumns: the
// token rows' head columns, dims ((H - 1) st_h + d, N, 1, B), a head's box
// at column h st_h; only columns past the last head's read as zeros.
// Strides of size-1 dims are free; give them a legal value.
bool tc_map(CUtensorMap* map, const void* p, const long long* st, int route,
            int batch, int heads, int n, int d, int box,
            CUtensorMapSwizzle swizzle) {
  const bool columns = route == kTmaColumns;
  const long long cols = columns ? (long long)(heads - 1) * st[1] + d : d;
  if (route != kTmaView && (!columns || st[1] > INT_MAX || cols > INT_MAX))
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)n,
                              columns ? 1ull : (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t free = 16ull * ((cols + 7) / 8);  // 16-byte steps
  const cuuint64_t strides[3] = {n > 1 ? 2ull * st[2] : free,
                                 !columns && heads > 1 ? 2ull * st[1] : free,
                                 batch > 1 ? 2ull * st[0] : free};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, kTcKeys, 1, 1};
  return mint::make_map(map, p, 4, dims, strides, boxes, swizzle);
}

// The maps of a TcTile<D>'s wide and narrow slabs over one view; one that
// a head dim does not use is never read (it is encoded as a narrow one,
// always legal).
template <int D>
bool tc_maps(CUtensorMap (&maps)[2], const void* p, const long long* st,
             int route, int batch, int heads, int n, int d) {
  const bool wide = TcTile<D>::kWide > 0;
  return tc_map(&maps[0], p, st, route, batch, heads, n, d, wide ? 64 : 16,
                wide ? CU_TENSOR_MAP_SWIZZLE_128B
                     : CU_TENSOR_MAP_SWIZZLE_32B) &&
         tc_map(&maps[1], p, st, route, batch, heads, n, d, 16,
                CU_TENSOR_MAP_SWIZZLE_32B);
}

// The maps (wide and narrow slabs) of a kTmaPairs view's even rows
// (maps[0]) and odd rows (maps[1]) of a TcTile<D>, and `lag`, bit p set
// where parity p's rows start 8 bytes past a 16-byte step (its map based
// 8 bytes early, its columns 4 on).  false where TMA cannot take them.
template <int D>
bool tc_pair_maps(CUtensorMap (&maps)[2][2], int& lag, const void* p,
                  const long long* st, int batch, int heads, int n, int d) {
  lag = 0;
  if (st[1] > INT_MAX || (long long)(heads - 1) * st[1] + d + 4 > INT_MAX)
    return false;
  const bool wide = TcTile<D>::kWide > 0;
  for (int par = 0; par < 2; ++par) {
    const int rows = (n - par + 1) / 2;
    if (rows == 0) continue;  // one key: no odd rows
    const uintptr_t row0 = reinterpret_cast<uintptr_t>(p) + 2 * par * st[2];
    const int col0 = row0 % 16 ? 4 : 0;
    lag |= (col0 / 4) << par;
    const cuuint64_t cols = col0 + (heads - 1) * st[1] + d;
    const cuuint64_t free = 16ull * ((cols + 7) / 8);
    const cuuint64_t dims[4] = {cols, (cuuint64_t)rows, 1,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {rows > 1 ? 4ull * st[2] : free, free,
                                   batch > 1 ? 2ull * st[0] : free};
    for (int slab = 0; slab < 2; ++slab) {
      const bool w = slab == 0 && wide;
      const cuuint32_t boxes[4] = {w ? 64u : 16u, kTcKeys, 1, 1};
      if (!mint::make_map(&maps[par][slab],
                          reinterpret_cast<const void*>(row0 - 2 * col0), 4,
                          dims, strides, boxes,
                          w ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_32B))
        return false;
    }
  }
  return true;
}

// A head's column step in a kTmaColumns or kTmaPairs map (its h stride),
// else 0.
int column_step(int route, const long long* st) {
  return route == kTmaColumns || route == kTmaPairs ? (int)st[1] : 0;
}

// The most columns a head lies into its tiles (h st_h % 8 over the heads:
// 8 - gcd(st_h, 8) for kTmaColumns over several heads; at most 7 for
// kTmaPairs; else 0).
int col_shift(int route, const long long* st, int heads) {
  if (route == kTmaPairs) return 7;
  return route == kTmaColumns && heads > 1
             ? 8 - std::gcd((long long)8, st[1] % 8)
             : 0;
}

// The resident schedule.  One block per (64 * warpgroups query rows,
// batch*head bh0 + blockIdx.y); warpgroup w owns rows q0 + 64 w ..;
// within it warp j owns 16 rows, and a thread rows g and g + 8 of those
// (g = lane / 4, t = lane % 4).  D: the tiles' width, the head dim (and
// the most columns a head lies into them) rounded up to 16, at most 128.
// kLoad: how K and V arrive (Route; Q's A fragments come straight from
// device memory, any view, moved ko columns to meet K's head).  kTmaView:
// TMA over the views, one thread issuing every load up front.
// kTmaColumns: the same over the token rows' head columns (kstep / vstep:
// a head's column step), the head ko / vo columns into its tiles.
// kCopies: the block's copies (copy_tile; k, v and their strides), each
// while the tensor cores work on a tile's scores: K tile 0 first, then
// pass 1's tile t copies K tile t + 1, pass 2's tile t V tile t into the
// ring slot of tile t - 3, which every warpgroup is done with (it copied
// its share of tile t - 1, which this thread has waited for, after its
// P.V of tile t - 2).  (kTmaPairs has a schedule of its own,
// attention_pairs.cu.)
template <int D, int kLoad>
__device__ __forceinline__ void tc_resident(
    const __nv_bfloat16* __restrict__ q, Strides qs_,
    const __nv_bfloat16* __restrict__ k, Strides ks_,
    const __nv_bfloat16* __restrict__ v, Strides vs_,
    const CUtensorMap* kwide, const CUtensorMap* knarrow,
    const CUtensorMap* vwide, const CUtensorMap* vnarrow, int kstep,
    int vstep, __nv_bfloat16* __restrict__ out, Strides os_, int heads,
    int nq, int nk, int d, float scale_log2, long long bh0, bool pairs) {
  using bf16 = __nv_bfloat16;
  using T = TcTile<D>;
  constexpr bool kCopy = kLoad == kCopies;
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
  // Where the head lies in K's and V's tiles (boxes from the 16-byte step
  // at or before its first column).
  const int ko = kLoad == kTmaColumns ? h * kstep % 8 : 0;
  const int vo = kLoad == kTmaColumns ? h * vstep % 8 : 0;
  // One thread issues the TMA loads: a slab per box, a tile per mbarrier.
  auto load = [&](const CUtensorMap* wide, const CUtensorMap* narrow,
                  int step, uint8_t* dst, uint64_t* bar, int t) {
    mint::mbar_expect_tx(bar, T::kBytes);
    const int col = kLoad == kTmaColumns ? h * step / 8 * 8 : 0;
    const int hc = kLoad == kTmaColumns ? 0 : h;
    for (int i = 0; i < T::kWide; ++i)
      mint::tma_load_4d(dst + i * T::kWideBytes, wide, bar, col + 64 * i,
                        kTcKeys * t, hc, b);
    for (int i = 0; i < T::kNarrow; ++i)
      mint::tma_load_4d(dst + T::kWide * T::kWideBytes + i * T::kNarrowBytes,
                        narrow, bar, col + 64 * T::kWide + 16 * i,
                        kTcKeys * t, hc, b);
  };
  const bf16* kh = k + b * ks_.b + h * ks_.h;
  const bf16* vh = v + b * vs_.b + h * vs_.h;
  // kCopies: K tile t, V tile t (into its ring slot).
  auto copy_k = [&](int t) {
    copy_tile<D>(ks + t * T::kBytes, kbar + t, kh, ks_.n, kTcKeys * t, nk, d);
  };
  auto copy_v = [&](int t) {
    copy_tile<D>(vs + t % kTcVStages * T::kBytes, vbar + t, vh, vs_.n,
                 kTcKeys * t, nk, d);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * tiles; ++i)
      mint::mbar_init(bars + i, kCopy ? blockDim.x : 1);
    mint::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (kCopy) {
    copy_k(0);
  } else if (threadIdx.x == 0) {
    // Every K tile, then the first V tiles: pass 1 starts on key 0 while
    // the rest lands.
    for (int t = 0; t < tiles; ++t)
      load(kwide, knarrow, kstep, ks + t * T::kBytes, kbar + t, t);
    for (int t = 0; t < min(tiles, kTcVStages); ++t)
      load(vwide, vnarrow, vstep, vs + t * T::kBytes, vbar + t, t);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  const int row = q0 + kTcWgRows * wg + 16 * warp + g;

  // Q's A fragments straight from device memory: k-step kk holds K's
  // tile columns 16 kk + 2 t (a[0], a[1]) and + 8 (a[2], a[3]), the head's
  // columns ko before them; zeros past the rows and outside the head.
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, q + b * qs_.b + h * qs_.h, qs_.n, row, nq, d, ko, t4);
  float s[32];

  // Pass 1: max and sum of exp2(s - max) of rows g and g + 8 over this
  // thread's keys, then merged across the 4 threads of a row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  for (int t = 0; t < tiles; ++t) {
    mint::mbar_wait(kbar + t, 0);
    if (kCopy) mint::fence_proxy_async();
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    if constexpr (kCopy) {  // while the tensor cores work
      if (t + 1 < tiles) copy_k(t + 1);
    }
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    if (valid >= kTcKeys)
      tile_stats<true>(s, m, l, valid, t4, scale_log2);
    else
      tile_stats<false>(s, m, l, valid, t4, scale_log2);
  }
  row_stats(m, l, inv_l);

  // Pass 2: P, then P.V (tc_pv); the first product (tile 0, keys 0-15:
  // always valid) overwrites the accumulators.  By TMA, once every
  // warpgroup is done with V tile t, its ring slot takes tile
  // t + kTcVStages.
  float ow[T::kWide ? T::kWide : 1][32];
  float on[T::kNarrow ? T::kNarrow : 1][8];
  for (int t = 0; t < tiles; ++t) {
    tc_scores<D>(qf, ks + t * T::kBytes, s);
    if constexpr (kCopy) copy_v(t);
    mint::wgmma_wait<0>();
    const int valid = nk - kTcKeys * t;
    uint32_t a[kTcKeys / 16][4];
    if (valid >= kTcKeys)
      tile_probs<true>(s, a, m, inv_l, valid, t4, scale_log2);
    else
      tile_probs<false>(s, a, m, inv_l, valid, t4, scale_log2);
    mint::mbar_wait(vbar + t, 0);
    if (kCopy) mint::fence_proxy_async();
    tc_pv<D>(ow, on, a, vs + t % kTcVStages * T::kBytes, valid, t > 0);
    if (!kCopy && t + kTcVStages < tiles) {
      __syncthreads();  // every warpgroup's P.V of tile t is done
      if (threadIdx.x == 0)
        load(vwide, vnarrow, vstep, vs + (t % kTcVStages) * T::kBytes,
             vbar + t + kTcVStages, t + kTcVStages);
    }
  }
  store_head<D>(ow, on, out + b * os_.b + h * os_.h, os_.n, row, nq, d, vo,
                pairs, t4);
}

}  // namespace

// The resident kernel's kTmaPairs launch (attention_pairs.cu), `width`
// its tiles'.
int launch_bf16_pairs(const void* q, const void* k, const void* v,
                      void* out, const long long* st, int width, int batch,
                      int heads, int nq, int nk, int d, float scale_log2,
                      bool pairs, cudaStream_t stream);

// The streamed kernel's launch over the (batch, head) pairs, for views of
// which TMA addresses every one (attention_stream.cu; the arguments as the
// C entry's, the scale in log2 units).
int launch_bf16_stream(const void* q, const void* k, const void* v,
                       void* out, const long long* st, const int* routes,
                       int batch, int heads, int nq, int nk, int d,
                       float scale_log2, bool pairs, cudaStream_t stream);

// The scores-once kernels' launches (attention_once.cu), the same views,
// ws_bytes of workspace at ws.
int launch_bf16_once(const void* q, const void* k, const void* v, void* out,
                     const long long* st, const int* routes, void* ws,
                     long long ws_bytes, int batch, int heads, int nq, int nk,
                     int d, float scale_log2, bool pairs,
                     cudaStream_t stream);
