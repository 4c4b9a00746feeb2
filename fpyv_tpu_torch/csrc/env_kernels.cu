// K4: the full-env megaloop, K AcroEnv steps per launch.
//
// Replaces fpyv_tpu/ops/pallas_env.py:_env_kernel (pallas_env_rollout),
// which runs _env_loop_math: physics (K1), CircularPath target motion,
// reward, the t / prev_dist / episode_return rows and auto-reset with the
// murmur3 counter RNG, DomainRand resampling and wind gusts.
//
// Layout: state (24, N) and action (4, N) float32. kLanes adjacent lanes of
// a warp own env n below kOneThreadEnvs envs when the staged terms fit a
// block (lanes.cuh), else one thread: each keeps the env's 24 rows in registers
// for all K steps and computes the contact terms of its motor points; the
// force sums are formed in K1's order from shared memory. A block holds 32
// envs, so 4096 envs make 128 blocks of kLanes warps. The world (12, S) and
// cylinder (6, C) rows sit in shared memory. Target centres move every step
// and are the same for every env: each warp computes 32 steps' centres at
// once, one step a lane, into its own shared rows, so no step waits on a
// block barrier. The reward and the auto-reset are env.cuh's (the reset's
// draws spread over the env's lanes), the counter RNG shared with K6.
//
// Bound on the H100: ~500 float32 and integer operations per env-step on the
// default world (more on a reset), 404 bytes per env per launch — bound by
// operations, and at N = 4096 by the latency of one env's chain of
// dependent operations. DomainRand and wind are template flags, so the
// nominal path carries none of their multiplies; the motor count is one too
// (the quad's 4, or the generic count; the instrumented instantiation
// exists for the quad only).
#include "clock.cuh"
#include "lanes.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvConsts;
using fpyv::EnvPhysics;
using fpyv::kEnvRows;
using fpyv::kEnvsPerBlock;
using fpyv::kStateRows;
using fpyv::kWorldRows;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

// Phases of the instrumented instantiation (kTimed): the order of
// ENV_PHASES in ops/env_kernel.py; the probe's next slot counts the
// env-steps that reset.
enum EnvPhase { kCentres, kHead, kContacts, kTail, kEnvStep, kEnvPhases };

template <int L, int kMotors, bool kDR, bool kWind, bool kTimed>
__global__ void __launch_bounds__(L * kEnvsPerBlock)
    env_rollout_kernel(StepConsts k, EnvConsts c, int seed, const float* __restrict__ state,
                       const float* __restrict__ action, const float* __restrict__ world, int S,
                       const float* __restrict__ cyl, int C, float* __restrict__ out,
                       float* __restrict__ rsum_out, int n, int n_steps,
                       unsigned long long* __restrict__ probe) {
  extern __shared__ float4 sh4[];
  const int slot = threadIdx.x / L, sub = threadIdx.x % L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int M = fpyv::motor_count<kMotors>(k);
  float4* stage = sh4 + slot * fpyv::stage_slots(M, S, C);  // this env's contact terms
  float* wm = reinterpret_cast<float*>(sh4 + fpyv::block_stage<L>(M, S, C));
  float* cm = wm + kWorldRows * S;                      // (6, C) cylinder rows
  float* cen = cm + 6 * C + warp * 32 * 3 * S;          // this warp's (32 steps, 3, S)
  fpyv::load_shared(wm, world, kWorldRows * S);         // (12, S) world rows
  fpyv::load_shared(cm, cyl, 6 * C);
  __syncthreads();

  const int e_first = blockIdx.x * kEnvsPerBlock;
  if (e_first + warp * (32 / L) >= n) return;  // a warp past the last env
  const int e_own = e_first + slot;
  const bool live = e_own < n;
  const int e = live ? e_own : n - 1;  // lanes past the last env repeat it, write nothing
  float s[kEnvRows];
#pragma unroll
  for (int r = 0; r < kEnvRows; ++r) s[r] = state[r * n + e];
  float a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = action[r * n + e];
  const uint32_t lane_id = fpyv::env_lane(e, seed);
  const Cylinders cv{cm, C};
  const float rates_pen = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  float rsum = 0.0f;
  fpyv::PhaseClock<kTimed, kEnvPhases> clk;
  unsigned long long resets = 0;
  clk.start();

  for (int i = 0; i < n_steps; ++i) {
    const int q = i & 31;
    if (q == 0) {  // the centres of steps i .. i + 31, step i + lane on this lane
      __syncwarp();  // the last chunk's rows are read
      fpyv::target_centers(wm, S, i + lane, cen + lane * 3 * S, 0, 1);
      __syncwarp();
    }
    const float* ci = cen + q * 3 * S;
    clk.mark(kCentres);

    const Spheres sp{ci, ci + S, ci + 2 * S, wm + 3 * S, wm + 4 * S, S};
    const EnvPhysics ep{s[18], s[19], s[20], s[21], s[22], s[23]};
    float phys[kStateRows];
#pragma unroll
    for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
    const fpyv::StepHead h = fpyv::step_head<kDR, kWind>(k, phys, a, ep);
    clk.mark(kHead);
    float cf[3], crashed;
    fpyv::env_contacts<L, kMotors>(k, h, sp, cv, stage, lane, cf, &crashed);
    clk.mark(kContacts);
    fpyv::env_tail<L, kDR>(k, h, cf, crashed, ep, phys, lane);
    clk.mark(kTail);

    const float tx = ci[0], ty = ci[S], tz = ci[2 * S];  // chased target: sphere 0
    const fpyv::EnvOutcome o = fpyv::env_outcome(c, s, phys, tx, ty, tz, rates_pen);
    if (o.reset)
      fpyv::env_reset_lanes<L, kDR, kWind>(c, lane_id, i, tx, ty, tz, s, lane);
    else
      fpyv::env_continue(s, phys, o);
    rsum = rsum + o.reward;
    if (kTimed) resets += o.reset && live && sub == 0 ? 1 : 0;
    clk.mark(kEnvStep);
  }
  clk.flush(probe);
  if (kTimed && resets > 0) atomicAdd(probe + kEnvPhases, resets);

  if (live) {
#pragma unroll
    for (int r = 0; r < kEnvRows; ++r)
      if (r % L == sub) out[r * n + e] = s[r];
    if (sub == 0) rsum_out[e] = rsum;
  }
}

// Shared floats of a block besides the staged terms: the world and
// cylinder rows and each warp's target centres.
size_t env_floats(int L, int S, int C) { return kWorldRows * S + 6 * C + L * 32 * 3 * S; }

template <int L, int kMotors, bool kDR, bool kWind, bool kTimed>
int launch(const StepConsts& k, const EnvConsts& c, int seed, const float* state,
           const float* action, const float* world, int S, const float* cyl, int C, float* out,
           float* rsum, int n, int n_steps, unsigned long long* probe, cudaStream_t stream) {
  const size_t shmem =
      sizeof(float4) * fpyv::block_stage<L>(static_cast<int>(k.n_motors), S, C) +
      sizeof(float) * env_floats(L, S, C);
  auto kernel = env_rollout_kernel<L, kMotors, kDR, kWind, kTimed>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n + kEnvsPerBlock - 1) / kEnvsPerBlock, L * kEnvsPerBlock, shmem, stream>>>(
      k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps, probe);
  return static_cast<int>(cudaGetLastError());
}

// K4 at L lanes an env with the template flags of the env's DomainRand and
// wind; the instrumented instantiation exists for the quad's lane design only.
template <int L, int kMotors>
int launch_env(const StepConsts& k, const EnvConsts& c, int seed, const float* state,
               const float* action, const float* world, int S, const float* cyl, int C,
               float* out, float* rsum, int n, int n_steps, int randomize, int use_wind,
               unsigned long long* pr, cudaStream_t st) {
  constexpr bool kProbe = L > 1 && kMotors == 4;
  if (!kProbe && pr != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define FPYV_K4(DR, WIND)                                                                     \
  (pr != nullptr ? launch<L, kMotors, DR, WIND, kProbe>(k, c, seed, state, action, world, S,  \
                                                        cyl, C, out, rsum, n, n_steps, pr, st) \
                 : launch<L, kMotors, DR, WIND, false>(k, c, seed, state, action, world, S,   \
                                                       cyl, C, out, rsum, n, n_steps, pr, st))
  if (randomize && use_wind) return FPYV_K4(true, true);
  if (randomize) return FPYV_K4(true, false);
  if (use_wind) return FPYV_K4(false, true);
  return FPYV_K4(false, false);
#undef FPYV_K4
}

template <int L>
int launch_motors(const StepConsts& k, const EnvConsts& c, int seed, const float* state,
                  const float* action, const float* world, int S, const float* cyl, int C,
                  float* out, float* rsum, int n, int n_steps, int randomize, int use_wind,
                  unsigned long long* pr, cudaStream_t st) {
  if (fpyv::quad_frame(k))
    return launch_env<L, 4>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps,
                            randomize, use_wind, pr, st);
  return launch_env<L, 0>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps,
                          randomize, use_wind, pr, st);
}

bool read_step_consts(const float* host, int count, StepConsts* k) {
  if (count != static_cast<int>(sizeof(StepConsts) / sizeof(float))) return false;
  std::memcpy(k, host, sizeof(StepConsts));
  return fpyv::motors_in_range(*k);
}

// K4's lanes an env at n envs (lanes.cuh::lanes_for).
int env_lanes(const StepConsts& k, int S, int C, int n) {
  return fpyv::lanes_for(n, static_cast<int>(k.n_motors), S, C, env_floats(fpyv::kLanes, S, C));
}

}  // namespace

extern "C" {

// The lanes an env that fpyv_env_rollout takes at n envs (kLanes or 1), or
// -1 for constants it refuses.
int fpyv_env_rollout_lanes(const float* step_consts, int n_step_consts, int S, int C, int n) {
  StepConsts k;
  if (!read_step_consts(step_consts, n_step_consts, &k)) return -1;
  return env_lanes(k, S, C, n);
}

// Returns the cudaError_t of the launch (0 on success). kLanes lanes own an
// env below kOneThreadEnvs envs when the staged terms fit a block, else one
// thread (fpyv_env_rollout_lanes). A non-null probe (kEnvPhases + 1 int64)
// runs the instrumented instantiation of the quad's lane design.
int fpyv_env_rollout(const float* step_consts, int n_step_consts, const float* env_consts,
                     int n_env_consts, int seed, const float* state, const float* action,
                     const float* world, int S, const float* cyl, int C, float* out, float* rsum,
                     int n, int n_steps, int randomize, int use_wind, void* probe_ptr,
                     void* stream) {
  StepConsts k;
  EnvConsts c;
  if (!read_step_consts(step_consts, n_step_consts, &k) ||
      n_env_consts != static_cast<int>(sizeof(EnvConsts) / sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&c, env_consts, sizeof c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pr = static_cast<unsigned long long*>(probe_ptr);
  if (env_lanes(k, S, C, n) == fpyv::kLanes)
    return launch_motors<fpyv::kLanes>(k, c, seed, state, action, world, S, cyl, C, out, rsum,
                                       n, n_steps, randomize, use_wind, pr, st);
  return launch_motors<1>(k, c, seed, state, action, world, S, cyl, C, out, rsum, n, n_steps,
                          randomize, use_wind, pr, st);
}

}  // extern "C"
