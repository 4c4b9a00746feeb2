// K4: the full-env megaloop, K AcroEnv steps per launch.
//
// Replaces fpyv_tpu/ops/pallas_env.py:_env_kernel (pallas_env_rollout),
// which runs _env_loop_math: physics (K1), CircularPath target motion,
// reward, the t / prev_dist / episode_return rows and auto-reset with the
// murmur3 counter RNG, DomainRand resampling and wind gusts.
//
// Layout: state (24, N) and action (4, N) float32, thread n owns env n and
// keeps its 24 rows in registers for all K steps; the reward sum is one
// register. The world (12, S) and cylinder (6, C) rows sit in shared memory.
// Target centers move every step and are the same for every env, so the
// block computes them once per step into a double-buffered shared array
// (one __syncthreads per step; a block is one warp). The reward, the
// auto-reset and its counter RNG are env.cuh's, shared with K6.
//
// Bound on the H100: ~500 float32 and integer operations per env-step on the
// default world (more on a reset), 404 bytes per env per launch — bound by
// operations, and at N = 4096 by latency: 128 warps cannot fill 132 SMs x 4
// schedulers. DomainRand and wind are template flags, so the nominal path
// carries none of their multiplies.
#include "env.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvConsts;
using fpyv::EnvPhysics;
using fpyv::kEnvRows;
using fpyv::kStateRows;
using fpyv::kWorldRows;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

constexpr int kBlock = 32;

template <bool kDR, bool kWind>
__global__ void env_rollout_kernel(StepConsts k, EnvConsts c, int seed,
                                   const float* __restrict__ state,
                                   const float* __restrict__ action,
                                   const float* __restrict__ world, int S,
                                   const float* __restrict__ cyl, int C,
                                   float* __restrict__ out, float* __restrict__ rsum_out, int n,
                                   int n_steps) {
  extern __shared__ float sh[];
  float* wm = sh;                        // (12, S) world rows
  float* cm = wm + kWorldRows * S;       // (6, C) cylinder rows
  float* centers = cm + 6 * C;           // 2 x (3, S) target centers
  fpyv::load_shared(wm, world, kWorldRows * S);
  fpyv::load_shared(cm, cyl, 6 * C);
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live_thread = e < n;  // idle threads still join every __syncthreads
  float s[kEnvRows];
  float a[4];
  if (live_thread) {
#pragma unroll
    for (int r = 0; r < kEnvRows; ++r) s[r] = state[r * n + e];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = action[r * n + e];
  }
  const uint32_t lane = fpyv::env_lane(e, seed);
  const Cylinders cv{cm, C};
  const float rates_pen = live_thread ? a[0] * a[0] + a[1] * a[1] + a[2] * a[2] : 0.0f;
  float rsum = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    float* cen = centers + (i & 1) * 3 * S;
    fpyv::target_centers(wm, S, i, cen, threadIdx.x, blockDim.x);
    __syncthreads();
    if (!live_thread) continue;

    const Spheres sp{cen, cen + S, cen + 2 * S, wm + 3 * S, wm + 4 * S, S};
    const EnvPhysics ep{s[18], s[19], s[20], s[21], s[22], s[23]};
    float phys[kStateRows];
#pragma unroll
    for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
    fpyv::step_components<kDR, kWind>(k, sp, cv, phys, a, ep);

    const float tx = cen[0], ty = cen[S], tz = cen[2 * S];  // chased target: sphere 0
    float dist;
    bool reset;
    rsum = rsum + fpyv::env_advance<kDR, kWind>(c, lane, i, s, phys, tx, ty, tz, rates_pen,
                                                &dist, &reset);
  }

  if (live_thread) {
#pragma unroll
    for (int r = 0; r < kEnvRows; ++r) out[r * n + e] = s[r];
    rsum_out[e] = rsum;
  }
}

template <bool kDR, bool kWind>
void launch(const StepConsts& k, const EnvConsts& c, int seed, const float* state,
            const float* action, const float* world, int S, const float* cyl, int C,
            float* out, float* rsum, int n, int n_steps, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * (kWorldRows * S + 6 * C + 6 * S);
  env_rollout_kernel<kDR, kWind><<<(n + kBlock - 1) / kBlock, kBlock, shmem, stream>>>(
      k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int fpyv_env_rollout(const float* step_consts, int n_step_consts, const float* env_consts,
                     int n_env_consts, int seed, const float* state, const float* action,
                     const float* world, int S, const float* cyl, int C, float* out, float* rsum,
                     int n, int n_steps, int randomize, int use_wind, void* stream) {
  if (n_step_consts != static_cast<int>(sizeof(StepConsts) / sizeof(float)) ||
      n_env_consts != static_cast<int>(sizeof(EnvConsts) / sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  StepConsts k;
  EnvConsts c;
  std::memcpy(&k, step_consts, sizeof k);
  std::memcpy(&c, env_consts, sizeof c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (randomize && use_wind)
    launch<true, true>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps, st);
  else if (randomize)
    launch<true, false>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps, st);
  else if (use_wind)
    launch<false, true>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps, st);
  else
    launch<false, false>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
