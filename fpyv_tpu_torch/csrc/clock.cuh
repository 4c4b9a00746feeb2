// Per-phase clocks of an instrumented kernel instantiation (kTimed): thread
// 0 of each block reads %globaltimer at each phase boundary, sums the
// nanoseconds of each of the kN phases in registers and adds them into a
// device array (kN entries) at the end of the launch. Empty, and free, on
// every main path (kTimed false). Used by K6 (csrc/vision_kernels.cu) and by
// the actor of K7 and K8 (csrc/actor.cuh), each with its own phases.
#pragma once

#include <cuda_runtime.h>

namespace fpyv {

template <bool kTimed, int kN>
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <int kN>
struct PhaseClock<true, kN> {
  unsigned long long last = 0, ns[kN] = {};
  __device__ __forceinline__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ __forceinline__ void start() { last = now(); }
  __device__ __forceinline__ void mark(int ph) {
    if (threadIdx.x == 0) {
      const unsigned long long t = now();
#pragma unroll
      for (int i = 0; i < kN; ++i) ns[i] += i == ph ? t - last : 0ull;
      last = t;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (threadIdx.x == 0)
      for (int i = 0; i < kN; ++i) atomicAdd(out + i, ns[i]);
  }
};

}  // namespace fpyv
