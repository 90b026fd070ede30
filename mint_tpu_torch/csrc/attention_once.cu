// The bf16 attention of heads whose frame (the head dim and the columns
// it lies into its tiles) is past two of the streamed kernel's output
// chunks of 176 columns (kOnceMinFrame): every score computed once a
// call, through a workspace (csrc/attention.cu's notes describe the other
// bf16 kernels).
//
// What bounds it on an H100: a head of D columns is 4 Nq Nk D flops
// against 2 (2 Nq + 2 Nk) D bytes; at q[2,4,360,2048] 8.5 GFLOP, 0.0086 ms
// on the tensor cores, and 24 MB, 0.0071 ms at 3.35 TB/s.  Q, K and V no
// longer fit a block's shared memory beside each other, so some operand
// is read again from L2 (50 MB), and L2's bandwidth sets the time.  The
// streamed kernel's schedule would cut the output into chunks on the
// grid's z axis and compute every score in every chunk's block, twice (a
// pass for the row max and sum, one for P.V): at 2048, 8 chunks, 16
// computations of each score, each reading Q and K again.
//
// Here each score is computed once, over the whole head, and P.V reads P
// from the workspace, in three launches over the (batch, head) pairs and
// their query tiles of 64 rows ("units") that the workspace holds at once
// (launch_bf16_once walks the units in as many groups as it takes):
// 1. attention_scores_tc_kernel: a block of two consumer warpgroups (two
//    query tiles) and a producer warp owns 128 rows by 64 keys of the
//    scores.  The producer streams the head's frame in 64-column chunks
//    through a ring of slots, each slot the chunk of both Q tiles and of
//    the K tile (TMA, 128-byte swizzle); each consumer sums its scores over
//    the chunks with m64n64k16 wgmma (A and B from shared memory), two
//    chunks' products in flight, and stores the f32 accumulators to the
//    workspace as they lie in its registers (a float4 a thread a store:
//    2 KB contiguous a warpgroup).
// 2. attention_probs_tc_kernel: a warpgroup a unit, each thread reading
//    back the scores its role holds in kernel 1 (the accumulator layout
//    is wgmma's A-fragment layout): the streamed kernel's two passes over
//    them (each row's max and sum of exp2, merged across the four threads
//    of a row; then P = exp2(s - max) / sum, exactly normalised, rounded
//    to bf16 as the TPU kernel casts it) with no product; P's A fragments
//    go back to the workspace, 16 bytes a thread a 16-key step.
// 3. attention_pv_tc_kernel<W>: a block of two consumer warpgroups (two
//    query tiles) and a producer warp owns their rows' output over a
//    W-column chunk of the frame (W <= 128: a warpgroup's accumulators
//    are 64 x W, half the registers that spilled the streamed kernel at
//    W >= 192).  Each slot of its ring holds V tile t's chunk (TMA) and
//    both units' P fragments of key tile t (bulk copies, 8 KB each); P.V
//    is one m64nWk16 a 16-key step with P from registers, V an N-major B.
//    The output is stored through its strides, the frame's shift
//    undone as the streamed kernel's store_out does.
// The workspace: the scores (f32, 16 KB a unit's key tile), then P (bf16,
// 8 KB a unit's key tile), 24 KB a unit's key tile in all (6.9 MB at
// q[2,4,360,2048]: it stays in L2 between the launches).  It comes from
// PyTorch's caching allocator on the call's stream (ops/attention.py's
// workspace_bytes mirrors once_unit_bytes and the grouping).
// Q, K and V come by TMA over the view or over the token rows' head
// columns (a head's column step there: the head lies h st_h % 8 columns
// into its tiles, Q's as far as K's); the columns around a head in a Q
// tile are zeroed at its arrival in the chunks that have any, so K's
// neighbouring columns add nothing, and V's reach only columns never
// stored.  Keys past Nk are TMA's zeros in K and V and masked out of the
// max and sum; P is 0 there.

#include "attention_tc.cuh"

namespace {

constexpr int kOnceChunk = 64;  // frame columns a scores stage
constexpr int kOnceWgs = 2;     // consumer warpgroups (query tiles) a block
constexpr int kOnceMaxW = 128;  // output columns a P.V block
constexpr int kOnceSlots = 6;   // ring slots of kernel 3 (1 block an SM)
constexpr int kScoreSlots = 4;  // of kernel 1 (96 KB: 2 blocks an SM)
// A ring's mbarriers: full[i] at i, empty[i] at kBarStride + i.
constexpr int kBarStride = 8;
static_assert(kOnceSlots <= kBarStride && kScoreSlots <= kBarStride,
              "the rings' mbarriers overlap");
// Bytes of a unit's key tile in the workspace: its scores (f32), then its
// P fragments (bf16).
constexpr int kScoreTile = kTcWgRows * kTcKeys * 4;
constexpr int kProbTile = kTcWgRows * kTcKeys * 2;

long long once_unit_bytes(int nk) {
  return (long long)((nk + kTcKeys - 1) / kTcKeys) * (kScoreTile + kProbTile);
}

// The ring's shared memory: its mbarriers and 1 KB of slack, then `slots`
// slots of `slot` bytes.
size_t once_smem_bytes(int slots, int slot) {
  return 2 * kTcBarBytes + (size_t)slots * slot;
}

// Kernel 1.  One block per (64-key tile blockIdx.x, pair bh0 + blockIdx.y,
// query tiles qt0 + 2 blockIdx.z ..); consumer warpgroup w owns query tile
// qt0 + 2 blockIdx.z + w, unit y nqt + 2 z + w of the launch, if that is
// below nqt (`live` of them).  Slot i of the ring, filled on full[i] and
// freed on empty[i] (a warp's arrival once its products on it retired),
// holds chunk c (load c, at its (c / slots)-th use) of the live
// consumers' Q tiles (tile w) and of the K tile (tile kOnceWgs).
__global__ void __launch_bounds__(128 * kOnceWgs + kStreamProducer, 2)
    attention_scores_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               float4* __restrict__ scores, int heads,
                               int nk, int d, int chunks, int slots,
                               int qstep, int kstep, long long bh0, int qt0,
                               int nqt) {
  using T = TcTile<kOnceChunk>;
  constexpr int kSlot = (kOnceWgs + 1) * T::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kBarStride;
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* ring = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int qz = kOnceWgs * blockIdx.z;  // the block's first tile, from qt0
  const int live = min(kOnceWgs, nqt - qz);
  const int kt = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mint::mbar_init(full + i, 1);
      mint::mbar_init(empty + i, 4 * live);
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kOnceWgs) {
    if (threadIdx.x != 128 * kOnceWgs) return;  // the producer's lane 0
    // The 64 x 64 box of a map at (col, row) of this head's frame.
    auto load = [&](const CUtensorMap* map, int step, uint8_t* dst,
                    uint64_t* bar, int row, int col) {
      mint::tma_load_4d(dst, map, bar, col + h * step / 8 * 8, row,
                        step ? 0 : h, b);
    };
    for (int c = 0; c < chunks; ++c) {
      const int i = c % slots, use = c / slots;
      if (use > 0) mint::mbar_wait_or_trap(empty + i, (use - 1) & 1);
      uint8_t* dst = ring + i * kSlot;
      mint::mbar_expect_tx(full + i, (live + 1) * T::kBytes);
      for (int w = 0; w < live; ++w)
        load(&qmap, qstep, dst + w * T::kBytes, full + i,
             kTcWgRows * (qt0 + qz + w), kOnceChunk * c);
      load(&kmap, kstep, dst + kOnceWgs * T::kBytes, full + i, kTcKeys * kt,
           kOnceChunk * c);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  if (wg >= live) return;  // no query tile: it takes no part in the ring
  const int tid = threadIdx.x % 128;
  const int ko = h * kstep % 8;  // the head in its tiles (Q's alike)
  float s[32];
  for (int c = 0; c < chunks; ++c) {
    const int i = c % slots;
    mint::mbar_wait_or_trap(full + i, (c / slots) & 1);
    uint8_t* qt = ring + i * kSlot + wg * T::kBytes;
    // Columns around the head in this chunk of Q: zeros (the same test
    // for the whole warpgroup; TMA's zeros past the view's d need none).
    if (qstep && (ko > kOnceChunk * c || ko + d < kOnceChunk * (c + 1))) {
      zero_outside<kOnceChunk>(qt, ko - kOnceChunk * c,
                               ko + d - kOnceChunk * c, tid, 128);
      mint::fence_proxy_async();
      mint::named_bar_sync(1 + wg, 128);
    }
    mint::wgmma_fence();
    tc_scores_ss<kOnceChunk>(qt, ring + i * kSlot + kOnceWgs * T::kBytes, s,
                             c > 0);
    mint::wgmma_commit();
    // Chunk c - 1's products have retired: its slot is free.
    mint::wgmma_wait<1>();
    if (c > 0 && tid % 32 == 0) mint::mbar_arrive(empty + (c - 1) % slots);
  }
  mint::wgmma_wait<0>();

  const int ktiles = (nk + kTcKeys - 1) / kTcKeys;
  const long long u = (long long)blockIdx.y * nqt + qz + wg;
  float4* dst = scores + (u * ktiles + kt) * (kScoreTile / 16) + tid;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[128 * j] =
        make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
}

// Kernel 2.  One warpgroup per unit: query tile qt0 + blockIdx.x of pair
// bh0 + blockIdx.y, unit blockIdx.y nqt + blockIdx.x of the launch.  Each
// thread reads back its scores of each key tile (kernel 1's registers),
// then runs the streamed kernel's pass-1 statistics and pass-2 P over
// them; P's A fragments of 16-key step j of tile t: uint4 (t 4 + j) 128 +
// tid of the unit's P.
__global__ void __launch_bounds__(128)
    attention_probs_tc_kernel(const float4* __restrict__ scores,
                              uint4* __restrict__ probs, int nk, int nqt,
                              float scale_log2) {
  const int tid = threadIdx.x, t4 = tid % 4;
  const int ktiles = (nk + kTcKeys - 1) / kTcKeys;
  const long long u = (long long)blockIdx.y * nqt + blockIdx.x;
  const float4* su = scores + u * ktiles * (kScoreTile / 16) + tid;
  float s[32];
  auto read = [&](int t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = su[(8 * t + j) * 128];
      s[4 * j] = x.x;
      s[4 * j + 1] = x.y;
      s[4 * j + 2] = x.z;
      s[4 * j + 3] = x.w;
    }
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  for (int t = 0; t < ktiles; ++t) {
    read(t);
    const int valid = nk - kTcKeys * t;
    if (valid >= kTcKeys)
      tile_stats<true>(s, m, l, valid, t4, scale_log2);
    else
      tile_stats<false>(s, m, l, valid, t4, scale_log2);
  }
  row_stats(m, l, inv_l);
  uint4* pu = probs + u * ktiles * (kProbTile / 16) + tid;
  for (int t = 0; t < ktiles; ++t) {
    read(t);
    const int valid = nk - kTcKeys * t;
    uint32_t a[kTcKeys / 16][4];
    if (valid >= kTcKeys)
      tile_probs<true>(s, a, m, inv_l, valid, t4, scale_log2);
    else
      tile_probs<false>(s, a, m, inv_l, valid, t4, scale_log2);
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j)
      pu[(4 * t + j) * 128] = make_uint4(a[j][0], a[j][1], a[j][2], a[j][3]);
  }
}

// Kernel 3.  One block per (output chunk blockIdx.x of W columns of the
// frame, pair bh0 + blockIdx.y, query tiles qt0 + 2 blockIdx.z ..), its
// consumers as kernel 1's.  Slot i holds load t (at its (t / slots)-th
// use): V tile t's chunk (TcTile<W>), then each live consumer's P
// fragments of key tile t.  Every 16-key step is multiplied, the last
// tile's past Nk too (P and V are zeros there): no branch stands among the
// products.
template <int W>
__global__ void __launch_bounds__(128 * kOnceWgs + kStreamProducer, 1)
    attention_pv_tc_kernel(const __grid_constant__ CUtensorMap vwide,
                           const __grid_constant__ CUtensorMap vnarrow,
                           const uint4* __restrict__ probs,
                           __nv_bfloat16* __restrict__ out, Strides os_,
                           int heads, int nq, int nk, int d, int slots,
                           int vstep, long long bh0, int qt0, int nqt,
                           bool pairs) {
  using T = TcTile<W>;
  constexpr int kSlot = T::kBytes + kOnceWgs * kProbTile;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kBarStride;
  const uint32_t base = mint::smem_addr(smem_raw) + kTcBarBytes;
  uint8_t* ring = smem_raw + kTcBarBytes + (1024 - base % 1024) % 1024;

  const long long bh = bh0 + blockIdx.y;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const int z = blockIdx.x;  // frame columns W z .. W z + W
  const int qz = kOnceWgs * blockIdx.z;
  const int live = min(kOnceWgs, nqt - qz);
  const int ktiles = (nk + kTcKeys - 1) / kTcKeys;
  const long long u0 = (long long)blockIdx.y * nqt + qz;  // unit of wg 0
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mint::mbar_init(full + i, 1);
      mint::mbar_init(empty + i, 4 * live);
    }
    mint::mbar_fence_init();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kOnceWgs) {
    if (threadIdx.x != 128 * kOnceWgs) return;  // the producer's lane 0
    const int c0 = W * z + h * vstep / 8 * 8, hc = vstep ? 0 : h;
    for (int t = 0; t < ktiles; ++t) {
      const int i = t % slots, use = t / slots;
      if (use > 0) mint::mbar_wait_or_trap(empty + i, (use - 1) & 1);
      uint8_t* dst = ring + i * kSlot;
      mint::mbar_expect_tx(full + i, T::kBytes + live * kProbTile);
      for (int s = 0; s < T::kWide; ++s)
        mint::tma_load_4d(dst + s * T::kWideBytes, &vwide, full + i,
                          c0 + 64 * s, kTcKeys * t, hc, b);
      for (int s = 0; s < T::kNarrow; ++s)
        mint::tma_load_4d(
            dst + T::kWide * T::kWideBytes + s * T::kNarrowBytes, &vnarrow,
            full + i, c0 + 64 * T::kWide + 16 * s, kTcKeys * t, hc, b);
      for (int w = 0; w < live; ++w)
        mint::bulk_load(dst + T::kBytes + w * kProbTile,
                        probs + ((u0 + w) * ktiles + t) * (kProbTile / 16),
                        kProbTile, full + i);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  if (wg >= live) return;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = kTcWgRows * (qt0 + qz + wg) + 16 * warp + g;
  const int vo = h * vstep % 8;  // the head in V's tiles
  constexpr int kNW = 64 * T::kWide, kNN = 16 * T::kNarrow;
  float ow[kNW ? kNW / 2 : 1];
  float on[kNN ? kNN / 2 : 1];
  for (int t = 0; t < ktiles; ++t) {
    const int i = t % slots;
    mint::mbar_wait_or_trap(full + i, (t / slots) & 1);
    const uint8_t* vt = ring + i * kSlot;
    const uint4* pf =
        reinterpret_cast<const uint4*>(vt + T::kBytes + wg * kProbTile) + tid;
    uint32_t a[kTcKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      const uint4 x = pf[128 * j];
      a[j][0] = x.x;
      a[j][1] = x.y;
      a[j][2] = x.z;
      a[j][3] = x.w;
    }
    mint::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
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
    if (lane == 0) mint::mbar_arrive(empty + i);
  }

  // The chunk's column c is the head's W z + c - vo: past the first
  // chunk, its first vo columns are the head's last before W z.
  __nv_bfloat16* oh = out + b * os_.b + h * os_.h + W * z;
  const int dz = d - W * z;  // this chunk's columns below d
  const bool opairs = pairs && vo % 2 == 0;
#pragma unroll
  for (int n = 0; n < kNW / 8; ++n)
    store_out(oh, os_.n, row, nq, 8 * n + 2 * t4 - vo, dz, opairs,
              ow[4 * n], ow[4 * n + 1], ow[4 * n + 2], ow[4 * n + 3], -W * z);
#pragma unroll
  for (int n = 0; n < kNN / 8; ++n)
    store_out(oh, os_.n, row, nq, kNW + 8 * n + 2 * t4 - vo, dz, opairs,
              on[4 * n], on[4 * n + 1], on[4 * n + 2], on[4 * n + 3],
              -W * z);
}

// Kernels 2 and 3 of one group; W: the output chunks' width.
template <int W>
cudaError_t launch_probs_pv(const CUtensorMap (&vm)[2], float4* scores,
                            uint4* probs, __nv_bfloat16* out, Strides os,
                            int heads, int nq, int nk, int d, int vstep,
                            int chunks, float scale_log2, bool pairs,
                            const Group& grp, cudaStream_t stream) {
  constexpr int kSlot = TcTile<W>::kBytes + kOnceWgs * kProbTile;
  const int slots =
      std::min<int>(kOnceSlots, (kSmemLimit - 2 * kTcBarBytes) / kSlot);
  const size_t smem = once_smem_bytes(slots, kSlot);
  cudaError_t err = cudaFuncSetAttribute(
      attention_pv_tc_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_probs_tc_kernel<<<dim3(grp.nqt, grp.np), 128, 0, stream>>>(
      scores, probs, nk, grp.nqt, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(chunks, grp.np, (grp.nqt + kOnceWgs - 1) / kOnceWgs);
  attention_pv_tc_kernel<W><<<grid, 128 * kOnceWgs + kStreamProducer, smem,
                              stream>>>(vm[0], vm[1], probs, out, os, heads,
                                        nq, nk, d, slots, vstep, grp.bh0,
                                        grp.qt0, grp.nqt, pairs);
  return cudaGetLastError();
}

template <int W>
int launch_once(const void* q, const void* k, const void* v, void* out,
                const long long* st, const int* routes, void* ws,
                long long ws_bytes, int batch, int heads, int nq, int nk,
                int d, int kchunks, int chunks, float scale_log2, bool pairs,
                cudaStream_t stream) {
  CUtensorMap qm[2], km[2], vm[2];
  if (!tc_maps<kOnceChunk>(qm, q, st, routes[0], batch, heads, nq, d) ||
      !tc_maps<kOnceChunk>(km, k, st + 3, routes[1], batch, heads, nk, d) ||
      !tc_maps<W>(vm, v, st + 6, routes[2], batch, heads, nk, d))
    return (int)cudaErrorInvalidValue;
  const int qstep = column_step(routes[0], st);
  const int kstep = column_step(routes[1], st + 3);
  const int vstep = column_step(routes[2], st + 6);
  if (heads > 1 && qstep % 8 != kstep % 8)  // Q's head where K's lies
    return (int)cudaErrorInvalidValue;
  const long long unit = once_unit_bytes(nk);
  const long long fit = ws_bytes / unit;
  if (ws == nullptr || fit < 1) return (int)cudaErrorInvalidValue;
  const int ktiles = (nk + kTcKeys - 1) / kTcKeys;
  const int qtiles = (nq + kTcWgRows - 1) / kTcWgRows;
  constexpr int kSlot = (kOnceWgs + 1) * TcTile<kOnceChunk>::kBytes;
  const int slots = kScoreSlots;
  const size_t smem = once_smem_bytes(slots, kSlot);
  cudaError_t err = cudaFuncSetAttribute(
      attention_scores_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides os{st[9], st[10], st[11]};
  auto* scores = static_cast<float4*>(ws);
  // At most 2 * 65535 query tiles a group: their blocks on the z axis.
  return (int)over_groups(
      (long long)batch * heads, qtiles, fit, kOnceWgs * 65535,
      [&](const Group& grp) {
        const long long units = (long long)grp.np * grp.nqt;
        auto* probs = reinterpret_cast<uint4*>(
            static_cast<uint8_t*>(ws) + units * ktiles * kScoreTile);
        const dim3 grid(ktiles, grp.np, (grp.nqt + kOnceWgs - 1) / kOnceWgs);
        attention_scores_tc_kernel<<<grid, 128 * kOnceWgs + kStreamProducer,
                                     smem, stream>>>(
            qm[0], km[0], scores, heads, nk, d, kchunks, slots, qstep, kstep,
            grp.bh0, grp.qt0, grp.nqt);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        return launch_probs_pv<W>(vm, scores, probs,
                                  static_cast<__nv_bfloat16*>(out), os, heads,
                                  nq, nk, d, vstep, chunks, scale_log2, pairs,
                                  grp, stream);
      });
}

}  // namespace

int launch_bf16_once(const void* q, const void* k, const void* v, void* out,
                     const long long* st, const int* routes, void* ws,
                     long long ws_bytes, int batch, int heads, int nq, int nk,
                     int d, float scale_log2, bool pairs,
                     cudaStream_t stream) {
  for (int i : {0, 1, 2})
    if (routes[i] == kCopies || routes[i] == kTmaPairs)
      return (int)cudaErrorInvalidValue;
  // The scores' chunks cover Q's and K's frame; the output's, V's, in
  // chunks of at most kOnceMaxW columns, as even as 16-column steps allow.
  const int kframe = d + std::max(col_shift(routes[0], st, heads),
                                  col_shift(routes[1], st + 3, heads));
  const int vframe = d + col_shift(routes[2], st + 6, heads);
  const int kchunks = (kframe + kOnceChunk - 1) / kOnceChunk;
  const int chunks = (vframe + kOnceMaxW - 1) / kOnceMaxW;
  switch (((vframe + chunks - 1) / chunks + 15) / 16 * 16) {
#define MINT_CASE(W)                                                        \
  case W:                                                                   \
    return launch_once<W>(q, k, v, out, st, routes, ws, ws_bytes, batch,    \
                          heads, nq, nk, d, kchunks, chunks, scale_log2,    \
                          pairs, stream);
    MINT_CASE(96)
    MINT_CASE(112)
    MINT_CASE(128)
#undef MINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
