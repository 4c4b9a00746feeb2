// K2 and K3: the fused physics step, one step or K steps per launch.
//
// K2 replaces fpyv_tpu/ops/pallas_step.py:_kernel_single (pallas_drone_step);
// K3 replaces fpyv_tpu/ops/pallas_step.py:_kernel_rollout (pallas_rollout).
// K2 is K3 at K = 1 (the same signature and physics), so both launch the
// one rollout kernel below.
//
// Layout: the state is an SoA (15, N) float32 matrix and the action (4, N).
// kLanes adjacent lanes own env n (lanes.cuh) below kOneThreadEnvs envs
// (when the staged terms fit a block), one thread from there, each with the
// env's 15 rows in registers for all K steps and the contact terms of its
// motor points, summed in K1's order from shared memory; a block holds 32
// envs. The quad (4 motors) and the generic motor count are two
// instantiations of the one kernel (physics.cuh). The sphere (5, S) and cylinder
// (6, C) rows are copied into shared memory once per block, and the loops
// run over the real counts.
//
// Bound on the H100: a step moves 152 bytes per env for ~450 float32
// operations (one-sphere world), K steps the same bytes for K times the
// operations, so both are bound by operations — in practice by latency: K3
// at N = 4096 is one env's chain of K dependent steps, which the lanes
// shorten and spread over 4x the warps. K2's one step is paced by its
// wrapper on the host.
#include "lanes.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvPhysics;
using fpyv::kEnvsPerBlock;
using fpyv::kStateRows;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

template <int L, int kMotors>
__global__ void __launch_bounds__(L * kEnvsPerBlock)
    rollout_kernel(StepConsts k, const float* __restrict__ state,
                   const float* __restrict__ action, const float* __restrict__ spheres, int S,
                   const float* __restrict__ cyl, int C, float* __restrict__ out, int n,
                   int n_steps) {
  extern __shared__ float4 sh4[];
  const int slot = threadIdx.x / L, sub = threadIdx.x % L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int M = fpyv::motor_count<kMotors>(k);
  float4* stage = sh4 + slot * fpyv::stage_slots(M, S, C);  // this env's contact terms
  float* sw = reinterpret_cast<float*>(sh4 + fpyv::block_stage<L>(M, S, C));
  float* sc = sw + 5 * S;  // (6, C) cylinder rows
  fpyv::load_shared(sw, spheres, 5 * S);  // (5, S) sphere rows
  fpyv::load_shared(sc, cyl, 6 * C);
  __syncthreads();
  const int e_first = blockIdx.x * kEnvsPerBlock;
  if (e_first + warp * (32 / L) >= n) return;  // a warp past the last env
  const int e_own = e_first + slot;
  const int e = e_own < n ? e_own : n - 1;  // lanes past the last env repeat it, write nothing
  float s[kStateRows];
#pragma unroll
  for (int r = 0; r < kStateRows; ++r) s[r] = state[r * n + e];
  float a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = action[r * n + e];
  const Spheres sp{sw, sw + S, sw + 2 * S, sw + 3 * S, sw + 4 * S, S};
  const Cylinders cv{sc, C};
  const EnvPhysics none{};
  for (int i = 0; i < n_steps; ++i) {
    const fpyv::StepHead h = fpyv::step_head<false, false>(k, s, a, none);
    float cf[3], crashed;
    fpyv::env_contacts<L, kMotors>(k, h, sp, cv, stage, lane, cf, &crashed);
    fpyv::env_tail<L, false>(k, h, cf, crashed, none, s, lane);
  }
  if (e_own < n) {
#pragma unroll
    for (int r = 0; r < kStateRows; ++r)
      if (r % L == sub) out[r * n + e] = s[r];
  }
}

template <int L, int kMotors>
int launch_rollout(const StepConsts& k, const float* state, const float* action,
                   const float* spheres, int S, const float* cyl, int C, float* out, int n,
                   int n_steps, cudaStream_t stream) {
  const size_t shmem = sizeof(float4) * fpyv::block_stage<L>(static_cast<int>(k.n_motors), S, C) +
                       sizeof(float) * (5 * S + 6 * C);
  auto kernel = rollout_kernel<L, kMotors>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n + kEnvsPerBlock - 1) / kEnvsPerBlock, L * kEnvsPerBlock, shmem, stream>>>(
      k, state, action, spheres, S, cyl, C, out, n, n_steps);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_motors(const StepConsts& k, const float* state, const float* action,
                  const float* spheres, int S, const float* cyl, int C, float* out, int n,
                  int n_steps, cudaStream_t st) {
  if (fpyv::quad_frame(k))
    return launch_rollout<L, 4>(k, state, action, spheres, S, cyl, C, out, n, n_steps, st);
  return launch_rollout<L, 0>(k, state, action, spheres, S, cyl, C, out, n, n_steps, st);
}

bool read_consts(const float* host, int count, StepConsts* k) {
  if (count != static_cast<int>(sizeof(StepConsts) / sizeof(float))) return false;
  std::memcpy(k, host, sizeof(StepConsts));
  return fpyv::motors_in_range(*k);
}

// K3's lanes an env at n envs (lanes.cuh::lanes_for).
int rollout_lanes(const StepConsts& k, int S, int C, int n) {
  return fpyv::lanes_for(n, static_cast<int>(k.n_motors), S, C, 5 * S + 6 * C);
}

}  // namespace

extern "C" {

const char* fpyv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The lanes an env that fpyv_rollout takes at n envs (kLanes or 1), or -1
// for constants it refuses.
int fpyv_rollout_lanes(const float* consts, int n_consts, int S, int C, int n) {
  StepConsts k;
  if (!read_consts(consts, n_consts, &k)) return -1;
  return rollout_lanes(k, S, C, n);
}

// Returns the cudaError_t of the launch (0 on success). kLanes lanes own an
// env below kOneThreadEnvs envs when the staged terms fit a block, else one
// thread (fpyv_rollout_lanes).
int fpyv_rollout(const float* consts, int n_consts, const float* state, const float* action,
                 const float* spheres, int S, const float* cyl, int C, float* out, int n,
                 int n_steps, void* stream) {
  StepConsts k;
  if (!read_consts(consts, n_consts, &k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rollout_lanes(k, S, C, n) == fpyv::kLanes)
    return launch_motors<fpyv::kLanes>(k, state, action, spheres, S, cyl, C, out, n, n_steps,
                                       st);
  return launch_motors<1>(k, state, action, spheres, S, cyl, C, out, n, n_steps, st);
}

// K2: the rollout kernel for one step.
int fpyv_drone_step(const float* consts, int n_consts, const float* state, const float* action,
                    const float* spheres, int S, const float* cyl, int C, float* out, int n,
                    void* stream) {
  return fpyv_rollout(consts, n_consts, state, action, spheres, S, cyl, C, out, n, 1, stream);
}

}  // extern "C"
