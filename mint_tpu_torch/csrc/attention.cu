// Unmasked multi-head attention forward, bf16: out = softmax(q k^T * scale) v
// (the f32 kernels are in attention_f32.cu).  This file holds the resident
// kernel, its launch and the C entry; attention_pairs.cu the resident
// kernel's kTmaPairs instances; attention_stream.cu the streamed kernel;
// attention_once.cu the scores-once kernels; attention_tc.cuh what they
// share (several sources, so that nvcc builds them at once).
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
// a [B, N, 3, H, D] buffer, as they are, at any head dim (each view's
// Route, attention_tc.cuh, says how its tiles are loaded).  The output is
// written through strides too; the wrapper hands it [B, N, H, D] storage,
// so the model's merge of the heads is a view.  Neither side copies.
//
// What bounds it on an H100: the work is 4*Nq*Nk*D flops per head against
// (2*Nq + 2*Nk)*D elements of traffic.  At FACT's shapes (Nk <= 360,
// D = 80) exact f32 is compute-bound on the FMA pipes (67 TFLOP/s;
// 0.124 ms at q[20,10,360,80]); bf16 on the tensor cores (989 TFLOP/s)
// is bound by its bytes (46 MB, 0.0138 ms at 3.35 TB/s at that shape).
//
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
//   multiple of 16 and the keys past Nk, which are masked out of the max
//   and the sum.  A view TMA cannot address as [B, H, N, D] is read where
//   it lies: over the token rows' head columns, the head a few columns
//   into its tiles (kTmaColumns), or by the resident block's own copies
//   into the same swizzled layout (kCopies).
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
//   (ops/attention.py's bf16_max_keys mirrors tc_smem_bytes).  One
//   instance per tile width and route: the flagship's (kTmaView) carries
//   no code of the others.
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
//   Frames over 256 columns run two output chunks on the grid's z axis,
//   each block computing every score over the whole head (Q's chunks all
//   resident), up to two chunks of 176 columns (kOnceMinFrame).  Wider
//   frames take the scores-once kernels (attention_once.cu): each score
//   computed once a call into a workspace, normalised there, and P.V over
//   output chunks of at most 128 columns reading P.  No config reaches
//   them, but the JAX kernel takes such heads.
//   The rings' waits trap after ~2^24 polls instead of hanging the card.
//
// Both kernels put the (batch, head) pairs on the grid's y axis, at most
// 65535 a launch; the C entry points launch as many times as B * H needs,
// each launch starting at pair bh0.

#include "attention_tc.cuh"

namespace {

// The resident kernel of every route but kTmaPairs: four maps.
template <int D, int kLoad>
__global__ void __launch_bounds__(128 * kTcMaxWgs, 2)
    attention_tc_kernel(const __nv_bfloat16* __restrict__ q, Strides qs_,
                        const __nv_bfloat16* __restrict__ k, Strides ks_,
                        const __nv_bfloat16* __restrict__ v, Strides vs_,
                        const __grid_constant__ CUtensorMap kwide,
                        const __grid_constant__ CUtensorMap knarrow,
                        const __grid_constant__ CUtensorMap vwide,
                        const __grid_constant__ CUtensorMap vnarrow,
                        int kstep, int vstep,
                        __nv_bfloat16* __restrict__ out, Strides os_,
                        int heads, int nq, int nk, int d, float scale_log2,
                        long long bh0, bool pairs) {
  tc_resident<D, kLoad>(q, qs_, k, ks_, v, vs_, &kwide, &knarrow, &vwide,
                        &vnarrow, kstep, vstep, out, os_, heads, nq, nk, d,
                        scale_log2, bh0, pairs);
}

// The resident schedule but kTmaPairs' (attention_pairs.cu); D: the
// tiles' width; K and V both by `route` (load_route).
template <int D>
cudaError_t launch_tc(const __nv_bfloat16* q, Strides qs,
                      const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const long long* st, int route, __nv_bfloat16* out,
                      Strides os, int batch, int heads, int nq, int nk,
                      int d, float scale_log2, bool pairs,
                      cudaStream_t stream) {
  const int wgs = nq > kTcWgRows ? 2 : 1;
  const size_t smem = tc_smem_bytes(D, (nk + kTcKeys - 1) / kTcKeys);
  // Maps of K and V; the copying instance reads none.
  CUtensorMap km[2] = {}, vm[2] = {};
  if (route != kCopies &&
      (!tc_maps<D>(km, k, st + 3, route, batch, heads, nk, d) ||
       !tc_maps<D>(vm, v, st + 6, route, batch, heads, nk, d)))
    return cudaErrorInvalidValue;
  const Strides ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const int kstep = column_step(route, st + 3);
  const int vstep = column_step(route, st + 6);
  const unsigned x = (unsigned)((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs));
  auto kernel = route == kCopies       ? attention_tc_kernel<D, kCopies>
                : route == kTmaColumns ? attention_tc_kernel<D, kTmaColumns>
                                       : attention_tc_kernel<D, kTmaView>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return over_pairs((long long)batch * heads, x, 1,
                    [&](dim3 grid, long long bh0) {
                      kernel<<<grid, 128 * wgs, smem, stream>>>(
                          q, qs, k, ks, v, vs, km[0], km[1], vm[0], vm[1],
                          kstep, vstep, out, os, heads, nq, nk, d, scale_log2,
                          bh0, pairs);
                    });
}

// The one route the resident kernel loads K and V by (ops/attention.py's
// _resident_route mirrors it): copies where either needs them, or where
// only one of them is on kTmaPairs; else kTmaPairs where both are; else
// TMA over the head columns where either is on them (a view is on both).
int load_route(const int* routes) {
  const bool pairs1 = routes[1] == kTmaPairs, pairs2 = routes[2] == kTmaPairs;
  if (routes[1] == kCopies || routes[2] == kCopies || pairs1 != pairs2)
    return kCopies;
  if (pairs1) return kTmaPairs;
  return routes[1] == kTmaColumns || routes[2] == kTmaColumns ? kTmaColumns
                                                              : kTmaView;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                const long long* st, const int* routes, void* ws,
                long long ws_bytes, int batch, int heads, int nq, int nk,
                int d, float scale, void* stream) {
  const long long bh = (long long)batch * heads;
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  // 4-byte stores of output pairs where its base and strides allow.
  bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0;
  for (int i : {9, 10, 11}) pairs = pairs && st[i] % 2 == 0;
  const Strides qs{st[0], st[1], st[2]}, os{st[9], st[10], st[11]};
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  // K resident wherever it fits, as the flagship's heads do: the tiles as
  // wide as the heads' frame in them rounded up to 16 (ops/attention.py's
  // bf16_resident mirrors it).
  const int route = load_route(routes);
  const bool paired = route == kTmaPairs;
  const int tiles = paired ? pair_tiles(nk) : (nk + kTcKeys - 1) / kTcKeys;
  const int frame =
      d + (route == kCopies ? 0
                            : std::max(col_shift(routes[1], st + 3, heads),
                                       col_shift(routes[2], st + 6, heads)));
  const int width = (frame + 15) / 16 * 16;
  if (frame <= kMaxD && tiles <= kTcMaxTiles &&
      tc_smem_bytes(width, tiles) <= kSmemLimit) {
    if (paired)  // attention_pairs.cu
      return launch_bf16_pairs(q, k, v, out, st, width, batch, heads, nq, nk,
                               d, scale_log2, pairs, s);
    switch (width) {
#define MINT_CASE(D)                                                      \
  case D:                                                                 \
    return (int)launch_tc<D>(qp, qs, kp, vp, st, route, o, os, batch,     \
                             heads, nq, nk, d, scale_log2, pairs, s);
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
  // Else the streamed kernel (attention_stream.cu) where the heads' frame
  // in the tiles of q, k and v is one output chunk; past it, every score
  // once through the workspace (attention_once.cu).  ops/attention.py's
  // scores_once mirrors the choice.
  int shift = 0;
  for (int i : {0, 1, 2})
    shift = std::max(shift, col_shift(routes[i], st + 3 * i, heads));
  if (d + shift >= kOnceMinFrame)
    return launch_bf16_once(q, k, v, out, st, routes, ws, ws_bytes, batch,
                            heads, nq, nk, d, scale_log2, pairs, s);
  return launch_bf16_stream(q, k, v, out, st, routes, batch, heads, nq, nk, d,
                            scale_log2, pairs, s);
}

}  // namespace

// q [B, H, nq, d], k and v [B, H, nk, d] and out [B, H, nq, d], each a view
// with D contiguous and strides[12] = (b, h, n) strides in elements of q,
// k, v and out, in that order; any d, nq, nk and B * H.  routes[3]: how
// q, k and v are loaded (Route; ops/attention.py's bf16_route): any view
// on the resident schedule (q's route unread there), TMA's on the
// streamed one and the scores-once kernels.  ws: ws_bytes of device
// memory for the scores-once kernels (ops/attention.py's workspace_bytes;
// null where they do not run).
extern "C" int mint_attention_bf16(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides,
                                   const int* routes, void* ws,
                                   long long ws_bytes, int batch, int heads,
                                   int nq, int nk, int d, float scale,
                                   void* stream) {
  return launch_bf16(q, k, v, out, strides, routes, ws, ws_bytes, batch,
                     heads, nq, nk, d, scale, stream);
}

extern "C" const char* mint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
