// The streamed bf16 attention kernel (attention_tc_stream_kernel) and its
// launch: the head dims over 128 and the keys past the resident kernel's
// shared memory (csrc/attention.cu's notes describe both bf16 kernels).

#include "attention_tc.cuh"

namespace {

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
// loads ahead of the slowest warpgroup.  Q, K and V each come by TMA over
// the view or over the token rows' head columns (qstep, kstep, vstep: a
// head's column step there, else 0; Q's and K's steps alike modulo 8, so
// the head lies as many columns into Q's tiles as into K's): the chunks
// then cover the head's frame, and each consumer warpgroup zeroes the
// columns around the head in its Q tiles once.
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
                               int slots, int qstep, int kstep, int vstep,
                               float scale_log2, long long bh0, bool pairs) {
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
    // The 64-row box of a map at (col, row) of this head's frame, a slab
    // per box.
    auto load = [&](const CUtensorMap* wide, const CUtensorMap* narrow,
                    int step, uint8_t* dst, uint64_t* bar, int row,
                    int col) {
      const int c0 = col + h * step / 8 * 8, hc = step ? 0 : h;
      for (int i = 0; i < T::kWide; ++i)
        mint::tma_load_4d(dst + i * T::kWideBytes, wide, bar, c0 + 64 * i,
                          row, hc, b);
      for (int i = 0; i < T::kNarrow; ++i)
        mint::tma_load_4d(
            dst + T::kWide * T::kWideBytes + i * T::kNarrowBytes, narrow,
            bar, c0 + 64 * T::kWide + 16 * i, row, hc, b);
    };
    // Q's tiles of the consumers with rows below nq (the others' rows
    // are never stored, and their scores never read).
    const int live = min(wgs, (nq - q0 + kTcWgRows - 1) / kTcWgRows);
    mint::mbar_expect_tx(qbar, live * chunks * T::kBytes);
    for (int w = 0; w < live; ++w)
      for (int c = 0; c < chunks; ++c)
        load(&qwide, &qnarrow, qstep, qs + (w * chunks + c) * T::kBytes,
             qbar, q0 + kTcWgRows * w, W * c);
    for (int j = 0; j < total; ++j) {
      const int i = j % slots, use = j / slots;
      if (use > 0) mint::mbar_wait_or_trap(empty + i, (use - 1) & 1);
      mint::mbar_expect_tx(full + i, T::kBytes);
      uint8_t* dst = ring + i * T::kBytes;
      if (j < pass1) {
        load(&kwide, &knarrow, kstep, dst, full + i, kTcKeys * (j / chunks),
             W * (j % chunks));
      } else {
        const int t = (j - pass1) / (chunks + 1);
        const int r = (j - pass1) % (chunks + 1);
        if (r < chunks)
          load(&kwide, &knarrow, kstep, dst, full + i, kTcKeys * t, W * r);
        else
          load(&vwide, &vnarrow, vstep, dst, full + i, kTcKeys * t, W * z);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = q0 + kTcWgRows * wg + 16 * warp + g;
  uint8_t* qt = qs + wg * chunks * T::kBytes;
  const int ko = h * kstep % 8, vo = h * vstep % 8;  // the head in the tiles
  // Load `next` is the next to read; release() frees its slot once this
  // warp's products on it have retired.
  int next = 0;
  auto acquire = [&]() -> uint8_t* {
    mint::mbar_wait_or_trap(full + next % slots, (next / slots) & 1);
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
      const uint8_t* kt = acquire();
      mint::wgmma_fence();
      tc_scores_ss<W>(qt + c * T::kBytes, kt, s, c > 0);
      mint::wgmma_commit();
      mint::wgmma_wait<0>();
      release();
    }
  };
  mint::mbar_wait_or_trap(qbar, 0);
  if (qstep) {
    for (int c = 0; c < chunks; ++c)
      zero_outside<W>(qt + c * T::kBytes, ko - W * c, ko + d - W * c,
                      threadIdx.x % 128, 128);
    mint::fence_proxy_async();
    mint::named_bar_sync(1 + wg, 128);
  }

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
                             const long long* st, const int* routes,
                             __nv_bfloat16* out,
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
  if (!tc_maps<W>(qm, q, st, routes[0], batch, heads, nq, d) ||
      !tc_maps<W>(km, k, st + 3, routes[1], batch, heads, nk, d) ||
      !tc_maps<W>(vm, v, st + 6, routes[2], batch, heads, nk, d))
    return cudaErrorInvalidValue;
  const int qstep = column_step(routes[0], st);
  const int kstep = column_step(routes[1], st + 3);
  const int vstep = column_step(routes[2], st + 6);
  if (heads > 1 && qstep % 8 != kstep % 8)  // Q's head where K's lies
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
                          heads, nq, nk, d, chunks, slots, qstep, kstep,
                          vstep, scale_log2, bh0, pairs);
                    });
}

}  // namespace

int launch_bf16_stream(const void* q, const void* k, const void* v,
                       void* out, const long long* st, const int* routes,
                       int batch, int heads, int nq, int nk, int d,
                       float scale_log2, bool pairs, cudaStream_t stream) {
  const Strides os{st[9], st[10], st[11]};
  auto* o = static_cast<__nv_bfloat16*>(out);
  // Chunks of at most kStreamMaxW columns, as even as
  // 16-column steps allow (D = 130 as 144: two 64-column slabs and one of
  // 16, faster on an H100 than whole 64-column slabs, 192); q, k and v by
  // TMA over the view or its head columns only (the wrapper copies any
  // other view).
  for (int i : {0, 1, 2})
    if (routes[i] == kCopies || routes[i] == kTmaPairs)
      return (int)cudaErrorInvalidValue;
  int shift = 0;
  for (int i : {0, 1, 2})
    shift = std::max(shift, col_shift(routes[i], st + 3 * i, heads));
  const int chunks = (d + shift + kStreamMaxW - 1) / kStreamMaxW;
  switch (((d + shift + chunks - 1) / chunks + 15) / 16 * 16) {
#define MINT_CASE(W)                                                        \
  case W:                                                                   \
    return (int)launch_tc_stream<W>(q, k, v, st, routes, o, os, batch,      \
                                    heads, nq, nk, d, chunks, scale_log2,   \
                                    pairs, stream);
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
