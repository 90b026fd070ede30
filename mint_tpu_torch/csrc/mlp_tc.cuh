// Shared by the bf16 fused MLP's sources: mlp.cu (the f32 passes, the
// flagship's bf16 kernel, the plan and the C entry), mlp_routes.cu (the
// bf16 kernels of the other layouts) and mlp_phases.cu (fc2 over W2^T's
// row phases), each a source of its own so that they compile at once: the
// tiles, the operand routes, the tanh-GELU, and what each source defines
// for the others.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mint_mlp {

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
  const float k = 0.7978845608028654f;
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

constexpr int kMaxSplit = 8;
constexpr int kTcBM = 128;      // rows of c per block: 2 consumer warpgroups
constexpr int kTcBK = 64;       // K per stage: one 128-byte swizzled row
constexpr int kTcStages = 4;    // TMA ring depth
constexpr int kTcThreads = 2 * 128 + 32;  // + one producer warp
constexpr int kTcBN1 = 192;     // fc1 columns per block (F = 3072: 16)
constexpr int kTcBN2 = 200;     // fc2 columns per block (O = 800: 4)

// How a GEMM input [rows, k] (k contiguous, rows `ld` elements apart)
// reaches the ring (ops/mlp.py's LOADS, picked by bf16_plan from its base
// and row stride): TMA (both whole 16-byte steps); tma_pairs (fc1 alone,
// gemm_tc_pairs_kernel in mlp_routes.cu); tma_phases (fc2's W2^T alone,
// its base on a step and its rows not: a TMA map a row phase,
// gemm_tc_phases_kernel in mlp_phases.cu); else staged: the 16-byte words
// around each row's k-tile are copied as they lie by cp.async (16 bytes,
// zero-filled past the row's last word) into a raw slot, and moved into
// the swizzled stage in shared memory, each row by its own byte phase
// (any element-aligned base and stride).  (8- and 4-byte cp.async straight
// into the stage ran hidden 804's fc1 at 0.298 ms against TMA's 0.1445 on
// padded rows: the LSU's small copies, not the bytes, set the pace;
// 2-byte loads realigned in registers, 0.352; staging with a thread a
// 16-byte unit and the realignment's run-time selects, 0.377: the
// producers' instructions.)
enum Load { kTma = 0, kStaged = 1, kTmaPairs = 2, kTmaPhases = 3 };

struct Operand {
  const __nv_bfloat16* p;
  long long ld;
  int load;
};

// Byte of a 128-byte-swizzled stage (rows of 64 columns) where byte x of
// row r lands, as TMA writes it: 16-byte chunk c at chunk c ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int x) {
  return 128 * r + ((((x >> 4) ^ (r & 7))) << 4) + (x & 15);
}

using bf16 = __nv_bfloat16;

// mlp.cu: the TMA map of a row-major [rows, cols] bf16 matrix whose rows
// are ld elements apart, boxes of 64 columns (128 bytes, swizzled) x
// box_rows rows, zeros past cols and rows; and the split sums of `part`
// added in order, then the bias (and GELU), into c [m, n], rows ldc apart.
bool tc_map(CUtensorMap* map, const void* p, int rows, int cols, long long ld,
            int box_rows);
cudaError_t reduce_tc(bool gelu, const float* part, const bf16* bias, bf16* c,
                      int m, int n, int ldc, int split, cudaStream_t stream);

// mlp_routes.cu: one pass c [m, n] = epilogue(a b^T + bias) at column tile
// bn on gemm_tc_any_kernel (any loads; fc1's epilogue when gelu), and fc1
// on tma_pairs (gemm_tc_pairs_kernel), each split `split` ways into
// `part`.  cudaErrorInvalidValue for an instance neither has.
cudaError_t tc_any_pass(bool gelu, int bn, const Operand& a, const Operand& b,
                        const bf16* bias, bf16* c, int ldc, float* part,
                        int m, int n, int k, int split, cudaStream_t stream);
cudaError_t tc_pairs_pass(int bn, const Operand& a, const Operand& b,
                          const bf16* bias, bf16* c, int ldc, float* part,
                          int m, int n, int k, int split,
                          cudaStream_t stream);

// mlp_phases.cu: fc2 c [m, n] = a [m, k] w [n, k]^T + bias with w on
// tma_phases (gemm_tc_phases_kernel; bn its activation rows a block, 200),
// split `split` ways into `part`; and the split its tiles take on `sms`
// SMs (tc_split's rule).
cudaError_t tc_phases_pass(int bn, const Operand& a, const Operand& w,
                           const bf16* bias, bf16* c, int ldc, float* part,
                           int m, int n, int k, int split,
                           cudaStream_t stream);
int tc_phases_split(int m, int n, int k, int sms);

}  // namespace mint_mlp
