// Phase stamps: a mark on the card that a CUDA graph captures with the
// work around it, so that a replay, which runs no Python between its
// kernels, can still be cut into phases (utils/profiling.py's stamp; the
// training step's body stamps begin, forward, backward, exchange over a
// mesh, and update).  It replaces no TPU kernel: the JAX package's
// compiled step has no counterpart.
//
// One thread writes the device's %globaltimer (ns) into its phase's slot
// once the work queued before it on the stream has run.  Each phase is a
// kernel of its own name, stamp_kernel<phase>, so a profiler's trace tells
// the phases apart by name, and the slots hold the last run's times for a
// reader with no profiler (Trainer.phase_ms).  Bound by nothing but its
// launch: about 2 us of a step's stream, a few a step.

#include <cuda_runtime.h>

namespace mint_trace {

constexpr int kPhases = 5;  // utils/profiling.py's PHASES

template <int kPhase>
__global__ void stamp_kernel(long long* slots) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  slots[kPhase] = now;
}

template <int kPhase>
int launch(long long* slots, int phase, cudaStream_t s) {
  if constexpr (kPhase < kPhases) {
    if (phase != kPhase) return launch<kPhase + 1>(slots, phase, s);
    stamp_kernel<kPhase><<<1, 1, 0, s>>>(slots);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mint_trace

// slots: kPhases int64 on the card; phase in [0, kPhases).
extern "C" int mint_trace_stamp(void* slots, int phase, void* stream) {
  if (slots == nullptr || phase < 0) return (int)cudaErrorInvalidValue;
  return mint_trace::launch<0>(static_cast<long long*>(slots), phase,
                               (cudaStream_t)stream);
}
