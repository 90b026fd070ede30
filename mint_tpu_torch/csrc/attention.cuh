// What the two attention sources share (csrc/attention_f32.cu, the f32
// kernels; csrc/attention.cu, the bf16 ones): the head dim up to which a
// head's kernels take it whole, a view's strides, the shared memory a
// block may take, and the launch over the (batch, head) pairs.
#pragma once

#include <limits.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>
#include <numeric>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block can use on an H100

// Strides, in elements, of a [B, H, N, D] view (D contiguous).
struct Strides {
  long long b, h, n;
};

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

}  // namespace
