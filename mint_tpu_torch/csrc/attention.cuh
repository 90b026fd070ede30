// What the two attention sources share (csrc/attention_f32.cu, the f32
// kernels; csrc/attention.cu, the bf16 ones): the head dim up to which a
// head's kernels take it whole, a view's strides, the shared memory a
// block may take, the launch over the (batch, head) pairs, and the
// scores-once kernels' launch groups.
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

// The scores-once kernels (attention_f32.cu, attention_once.cu) run over
// units, a (batch, head) pair's query tile each, as many a launch group as
// their workspace holds: every query tile of `np` pairs from bh0 on, or
// `nqt` query tiles of one pair from qt0 on.
struct Group {
  long long bh0;
  int np, qt0, nqt;
};

// Calls `launch` (a Group) over every query tile of `pairs` pairs of
// `qtiles` tiles each, groups of at most `fit` units (>= 1), 65535 pairs
// and `most_qt` query tiles (the grid's y axis, and what its z axis holds).
template <typename Launch>
cudaError_t over_groups(long long pairs, int qtiles, long long fit,
                        int most_qt, Launch launch) {
  for (long long bh0 = 0; bh0 < pairs;) {
    if (fit >= qtiles && qtiles <= most_qt) {
      const int np = (int)std::min<long long>(
          {fit / qtiles, 65535, pairs - bh0});
      const cudaError_t err = launch(Group{bh0, np, 0, qtiles});
      if (err != cudaSuccess) return err;
      bh0 += np;
      continue;
    }
    const int nqt = (int)std::min<long long>(fit, most_qt);
    for (int qt0 = 0; qt0 < qtiles; qt0 += nqt) {
      const cudaError_t err =
          launch(Group{bh0, 1, qt0, std::min(nqt, qtiles - qt0)});
      if (err != cudaSuccess) return err;
    }
    ++bh0;
  }
  return cudaSuccess;
}

}  // namespace
