// K2 and K3: the fused physics step, one step or K steps per launch.
//
// K2 replaces fpyv_tpu/ops/pallas_step.py:_kernel_single (pallas_drone_step);
// K3 replaces fpyv_tpu/ops/pallas_step.py:_kernel_rollout (pallas_rollout).
//
// Layout: the state is an SoA (15, N) float32 matrix and the action (4, N);
// thread n owns env n, so a warp's load of one row is one coalesced 128-byte
// transaction. The sphere (5, S) and cylinder (6, C) rows are copied into
// shared memory once per block, and the loops run over the real counts.
//
// Bound on the H100: K2 moves 152 bytes per env for ~450 float32 operations
// (one-sphere world), K3 the same bytes for K times the operations, so both
// are bound by operations — in practice by latency, since N = 4096 envs at
// one thread each is 128 warps, fewer than the card's 132 SMs x 4
// schedulers. Blocks of 32 threads spread those warps over 128 SMs; K3
// keeps the state in registers for all K steps so it never waits on memory.
#include "physics.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvPhysics;
using fpyv::kStateRows;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

constexpr int kBlock = 32;

__device__ __forceinline__ void run_steps(const StepConsts& k, const float* __restrict__ state,
                                          const float* __restrict__ action,
                                          const float* __restrict__ spheres, int S,
                                          const float* __restrict__ cyl, int C,
                                          float* __restrict__ out, int n, int n_steps) {
  extern __shared__ float sh[];
  float* sw = sh;          // (5, S) sphere rows
  float* sc = sh + 5 * S;  // (6, C) cylinder rows
  fpyv::load_shared(sw, spheres, 5 * S);
  fpyv::load_shared(sc, cyl, 6 * C);
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s[kStateRows];
#pragma unroll
  for (int r = 0; r < kStateRows; ++r) s[r] = state[r * n + e];
  float a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = action[r * n + e];
  const Spheres sp{sw, sw + S, sw + 2 * S, sw + 3 * S, sw + 4 * S, S};
  const Cylinders cv{sc, C};
  const EnvPhysics none{};
  for (int i = 0; i < n_steps; ++i) fpyv::step_components<false, false>(k, sp, cv, s, a, none);
#pragma unroll
  for (int r = 0; r < kStateRows; ++r) out[r * n + e] = s[r];
}

__global__ void drone_step_kernel(StepConsts k, const float* __restrict__ state,
                                  const float* __restrict__ action,
                                  const float* __restrict__ spheres, int S,
                                  const float* __restrict__ cyl, int C,
                                  float* __restrict__ out, int n) {
  run_steps(k, state, action, spheres, S, cyl, C, out, n, 1);
}

__global__ void rollout_kernel(StepConsts k, const float* __restrict__ state,
                               const float* __restrict__ action,
                               const float* __restrict__ spheres, int S,
                               const float* __restrict__ cyl, int C,
                               float* __restrict__ out, int n, int n_steps) {
  run_steps(k, state, action, spheres, S, cyl, C, out, n, n_steps);
}

bool read_consts(const float* host, int count, StepConsts* k) {
  if (count != static_cast<int>(sizeof(StepConsts) / sizeof(float))) return false;
  std::memcpy(k, host, sizeof(StepConsts));
  return true;
}

}  // namespace

extern "C" {

const char* fpyv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the cudaError_t of the launch (0 on success).
int fpyv_drone_step(const float* consts, int n_consts, const float* state, const float* action,
                    const float* spheres, int S, const float* cyl, int C, float* out, int n,
                    void* stream) {
  StepConsts k;
  if (!read_consts(consts, n_consts, &k)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = sizeof(float) * (5 * S + 6 * C);
  drone_step_kernel<<<(n + kBlock - 1) / kBlock, kBlock, shmem,
                      static_cast<cudaStream_t>(stream)>>>(k, state, action, spheres, S, cyl,
                                                           C, out, n);
  return static_cast<int>(cudaGetLastError());
}

int fpyv_rollout(const float* consts, int n_consts, const float* state, const float* action,
                 const float* spheres, int S, const float* cyl, int C, float* out, int n,
                 int n_steps, void* stream) {
  StepConsts k;
  if (!read_consts(consts, n_consts, &k)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = sizeof(float) * (5 * S + 6 * C);
  rollout_kernel<<<(n + kBlock - 1) / kBlock, kBlock, shmem,
                   static_cast<cudaStream_t>(stream)>>>(k, state, action, spheres, S, cyl, C,
                                                        out, n, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
