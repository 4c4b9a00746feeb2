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
// (one __syncthreads per step; a block is one warp).
//
// RNG (pallas_env.py:87-111): exact uint32 arithmetic, so draws equal the
// JAX kernel's bit for bit. A draw depends only on (env, step, draw, seed):
// the reset branch computes its draws on resetting lanes only, where the
// Pallas kernel computes them on every lane every step.
//
// Bound on the H100: ~500 float32 and integer operations per env-step on the
// default world (more on a reset), 404 bytes per env per launch — bound by
// operations, and at N = 4096 by latency: 128 warps cannot fill 132 SMs x 4
// schedulers. DomainRand and wind are template flags, so the nominal path
// carries none of their multiplies.
#include "physics.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvPhysics;
using fpyv::kStateRows;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

constexpr int kBlock = 32;
constexpr int kEnvRows = 24;
constexpr int kWorldRows = 12;
constexpr float kTwoPi = 6.28318530717958647692f;

// Field order must match EnvConstants.as_array() in ops/env_kernel.py.
struct EnvConsts {
  float pos_low[3], pos_span[3];
  float vel_scale, half_ypr, max_steps;
  float w_progress, w_alive, w_crash, w_rates;
  float mass_lo, mass_span, drag_lo, drag_span, thrust_lo, thrust_span;
  float wind[3], wind_scale;
  float gust;
};

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x = x ^ (x >> 16);
  x = x * 0x85EBCA6Bu;
  x = x ^ (x >> 13);
  x = x * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t lane, uint32_t ctr) {
  const uint32_t bits = fmix(lane ^ (ctr * 0x9E3779B9u));
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void normal_pair(uint32_t lane, uint32_t ca, uint32_t cb, float* z0,
                                            float* z1) {
  const float u1 = fmaxf(uniform01(lane, ca), 1e-12f);
  const float u2 = uniform01(lane, cb);
  const float r = sqrtf(-2.0f * logf(u1));
  const float a = kTwoPi * u2;
  *z0 = r * cosf(a);
  *z1 = r * sinf(a);
}

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
  const uint32_t lane = fmix(static_cast<uint32_t>(e) ^ fmix(static_cast<uint32_t>(seed)));
  const Cylinders cv{cm, C};
  const float rates_pen = live_thread ? a[0] * a[0] + a[1] * a[1] + a[2] * a[2] : 0.0f;
  float rsum = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    // iteration i sees count0 + i (update_targets runs before each step)
    float* cen = centers + (i & 1) * 3 * S;
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      const float cnt = wm[11 * S + j] + static_cast<float>(i);
      const float res = fmaxf(wm[9 * S + j], 1.0f);
      const float frac = cnt - floorf(cnt / res) * res;
      const float theta = kTwoPi * frac / res;
      const bool has = wm[10 * S + j] > 0.5f;
      cen[j] = has ? wm[5 * S + j] + wm[8 * S + j] * cosf(theta) : wm[j];
      cen[S + j] = has ? wm[6 * S + j] + wm[8 * S + j] * sinf(theta) : wm[S + j];
      cen[2 * S + j] = has ? wm[7 * S + j] : wm[2 * S + j];
    }
    __syncthreads();
    if (!live_thread) continue;

    const Spheres sp{cen, cen + S, cen + 2 * S, wm + 3 * S, wm + 4 * S, S};
    const EnvPhysics ep{s[18], s[19], s[20], s[21], s[22], s[23]};
    float phys[kStateRows];
#pragma unroll
    for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
    fpyv::step_components<kDR, kWind>(k, sp, cv, phys, a, ep);

    const float crashed = phys[14];
    const float tx = cen[0], ty = cen[S], tz = cen[2 * S];  // chased target: sphere 0
    const float ddx = phys[0] - tx, ddy = phys[1] - ty, ddz = phys[2] - tz;
    const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    const float reward = c.w_progress * (s[16] - dist) + c.w_alive - c.w_crash * crashed -
                         c.w_rates * rates_pen;
    const float t = s[15] + 1.0f;
    const float truncated = t >= c.max_steps ? 1.0f : 0.0f;
    const float done = fmaxf(crashed, truncated);
    rsum = rsum + reward;

    if (done > 0.5f) {
      // ---- auto-reset (AcroEnv._sample_drone distributions), draws 0..16
      const uint32_t base = (static_cast<uint32_t>(i) + 1u) * 32u;
      const float rpx = c.pos_low[0] + uniform01(lane, base + 0u) * c.pos_span[0];
      const float rpy = c.pos_low[1] + uniform01(lane, base + 1u) * c.pos_span[1];
      const float rpz = c.pos_low[2] + uniform01(lane, base + 2u) * c.pos_span[2];
      float z0, z1, z2, unused;
      normal_pair(lane, base + 3u, base + 4u, &z0, &z1);
      normal_pair(lane, base + 5u, base + 6u, &z2, &unused);
      const float h0 = (2.0f * uniform01(lane, base + 7u) - 1.0f) * c.half_ypr;
      const float h1 = (2.0f * uniform01(lane, base + 8u) - 1.0f) * c.half_ypr;
      const float h2 = (2.0f * uniform01(lane, base + 9u) - 1.0f) * c.half_ypr;
      const float cr = cosf(h0), sr = sinf(h0);
      const float cp = cosf(h1), sp_ = sinf(h1);
      const float cyw = cosf(h2), syw = sinf(h2);
      s[0] = rpx;
      s[1] = rpy;
      s[2] = rpz;
      s[3] = c.vel_scale * z0;
      s[4] = c.vel_scale * z1;
      s[5] = c.vel_scale * z2;
      s[6] = cyw * cp * cr + syw * sp_ * sr;  // rot.euler_to_quat
      s[7] = cyw * cp * sr - syw * sp_ * cr;
      s[8] = cyw * sp_ * cr + syw * cp * sr;
      s[9] = syw * cp * cr - cyw * sp_ * sr;
      s[10] = s[11] = s[12] = 0.0f;  // rates
      s[13] = 0.0f;                  // thrust
      s[14] = 0.0f;                  // done
      s[15] = 0.0f;                  // t
      const float rdx = rpx - tx, rdy = rpy - ty, rdz = rpz - tz;
      s[16] = sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
      s[17] = 0.0f;  // episode_return
      if (kDR) {
        s[18] = c.mass_lo + uniform01(lane, base + 10u) * c.mass_span;
        s[19] = c.drag_lo + uniform01(lane, base + 11u) * c.drag_span;
        s[20] = c.thrust_lo + uniform01(lane, base + 12u) * c.thrust_span;
      } else {
        s[18] = s[19] = s[20] = 1.0f;
      }
      if (kWind && c.gust > 0.5f) {
        float g0, g1, g2;
        normal_pair(lane, base + 13u, base + 14u, &g0, &g1);
        normal_pair(lane, base + 15u, base + 16u, &g2, &unused);
        s[21] = c.wind[0] + c.wind_scale * g0;
        s[22] = c.wind[1] + c.wind_scale * g1;
        s[23] = c.wind[2] + c.wind_scale * g2;
      } else {
        s[21] = c.wind[0];
        s[22] = c.wind[1];
        s[23] = c.wind[2];
      }
    } else {
      // next-state done row is always 0 (AcroEnv.step's tree_where); DR and
      // wind rows persist
#pragma unroll
      for (int r = 0; r < 14; ++r) s[r] = phys[r];
      s[14] = 0.0f;
      s[15] = t;
      s[16] = dist;
      s[17] = s[17] + reward;
    }
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
