// The resident bf16 attention kernel's kTmaPairs instances and their
// launch (attention_tc.cuh's Route; csrc/attention.cu's notes describe the
// kernel): a source of their own, so that nvcc builds them beside the
// others.

#include "attention_tc.cuh"

namespace {

// kTmaPairs: the even rows' maps, then the odd rows'.
template <int D>
__global__ void __launch_bounds__(128 * kTcMaxWgs, 2)
    attention_tc_pairs_kernel(
        const __nv_bfloat16* __restrict__ q, Strides qs_,
        const __grid_constant__ CUtensorMap kwide,
        const __grid_constant__ CUtensorMap knarrow,
        const __grid_constant__ CUtensorMap vwide,
        const __grid_constant__ CUtensorMap vnarrow,
        const __grid_constant__ CUtensorMap kwide1,
        const __grid_constant__ CUtensorMap knarrow1,
        const __grid_constant__ CUtensorMap vwide1,
        const __grid_constant__ CUtensorMap vnarrow1, int kstep, int vstep,
        int lag, __nv_bfloat16* __restrict__ out, Strides os_, int heads,
        int nq, int nk, int d, float scale_log2, long long bh0, bool pairs) {
  tc_resident<D, kTmaPairs>(q, qs_, nullptr, Strides{}, nullptr, Strides{},
                            &kwide, &knarrow, &vwide, &vnarrow, &kwide1,
                            &knarrow1, &vwide1, &vnarrow1, kstep, vstep, lag,
                            out, os_, heads, nq, nk, d, scale_log2, bh0,
                            pairs);
}

// The resident kernel's kTmaPairs launch; D: the tiles' width.
template <int D>
cudaError_t launch_tc_pairs(const __nv_bfloat16* q, Strides qs,
                            const void* k, const void* v, const long long* st,
                            __nv_bfloat16* out, Strides os, int batch,
                            int heads, int nq, int nk, int d,
                            float scale_log2, bool pairs,
                            cudaStream_t stream) {
  const int wgs = nq > kTcWgRows ? 2 : 1;
  const size_t smem = tc_smem_bytes(D, pair_tiles(nk), kTcStaged);
  // Maps of K's and V's even rows (the first of each pair), then odd.
  CUtensorMap km[2][2] = {}, vm[2][2] = {};
  int klag = 0, vlag = 0;
  if (!tc_pair_maps<D>(km, klag, k, st + 3, batch, heads, nk, d) ||
      !tc_pair_maps<D>(vm, vlag, v, st + 6, batch, heads, nk, d))
    return cudaErrorInvalidValue;
  auto kernel = attention_tc_pairs_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned x = (unsigned)((nq + kTcWgRows * wgs - 1) / (kTcWgRows * wgs));
  return over_pairs(
      (long long)batch * heads, x, 1, [&](dim3 grid, long long bh0) {
        kernel<<<grid, 128 * wgs, smem, stream>>>(
            q, qs, km[0][0], km[0][1], vm[0][0], vm[0][1], km[1][0],
            km[1][1], vm[1][0], vm[1][1], (int)st[4], (int)st[7],
            klag | vlag << 2, out, os, heads, nq, nk, d, scale_log2, bh0,
            pairs);
      });
}

}  // namespace

int launch_bf16_pairs(const void* q, const void* k, const void* v,
                      void* out, const long long* st, int width, int batch,
                      int heads, int nq, int nk, int d, float scale_log2,
                      bool pairs, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, os{st[9], st[10], st[11]};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (width) {
#define MINT_CASE(D)                                                        \
  case D:                                                                   \
    return (int)launch_tc_pairs<D>(qp, qs, k, v, st, o, os, batch, heads,   \
                                   nq, nk, d, scale_log2, pairs, stream);
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
