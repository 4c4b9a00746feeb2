// The AcroEnv step around the physics, shared by K4 and K6.
//
// Follows fpyv_tpu/ops/pallas_env.py:_env_loop_math: CircularPath target
// motion, the chase reward, the t / prev_dist / episode_return rows and the
// auto-reset on crash or truncation, with the murmur3 counter RNG,
// DomainRand resampling and wind gusts.
//
// RNG (pallas_env.py:87-111): exact uint32 arithmetic, so draws equal the
// JAX kernel's bit for bit. A draw depends only on (env, step, draw, seed):
// the reset branch computes its draws on resetting envs only, where the
// Pallas kernel computes them on every lane every step.
#pragma once

#include "physics.cuh"

namespace fpyv {

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

// Env e's stream id: fmix(e ^ fmix(seed)) (the Pallas lane id of env e is e).
__device__ __forceinline__ uint32_t env_lane(int e, int seed) {
  return fmix(static_cast<uint32_t>(e) ^ fmix(static_cast<uint32_t>(seed)));
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

// Target centers of iteration i into cen (3, S), strided over [first, S):
// iteration i sees count0 + i (update_targets runs before each step).
__device__ __forceinline__ void target_centers(const float* wm, int S, int i, float* cen,
                                               int first, int stride) {
  for (int j = first; j < S; j += stride) {
    const float cnt = wm[11 * S + j] + static_cast<float>(i);
    const float res = fmaxf(wm[9 * S + j], 1.0f);
    const float frac = cnt - floorf(cnt / res) * res;
    const float theta = kTwoPi * frac / res;
    const bool has = wm[10 * S + j] > 0.5f;
    cen[j] = has ? wm[5 * S + j] + wm[8 * S + j] * cosf(theta) : wm[j];
    cen[S + j] = has ? wm[6 * S + j] + wm[8 * S + j] * sinf(theta) : wm[S + j];
    cen[2 * S + j] = has ? wm[7 * S + j] : wm[2 * S + j];
  }
}

// The auto-reset pose of iteration i (AcroEnv._sample_drone distributions,
// draws 0..9) into s[0..9]: position, velocity, attitude quaternion.
// Returns the distance from the fresh position to (tx, ty, tz).
__device__ __forceinline__ float reset_pose(const EnvConsts& c, uint32_t lane, int i, float tx,
                                            float ty, float tz, float s[]) {
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
  const float rdx = rpx - tx, rdy = rpy - ty, rdz = rpz - tz;
  return sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
}

// What a step's physics means for the env: the distance to the chased
// target (tx, ty, tz), the reward, the next t and whether the env restarts.
struct EnvOutcome {
  float dist, reward, t;
  bool reset;
};

__device__ __forceinline__ EnvOutcome env_outcome(const EnvConsts& c, const float s[kEnvRows],
                                                  const float phys[kStateRows], float tx,
                                                  float ty, float tz, float rates_pen) {
  EnvOutcome o;
  const float crashed = phys[14];
  const float ddx = phys[0] - tx, ddy = phys[1] - ty, ddz = phys[2] - tz;
  o.dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  o.reward = c.w_progress * (s[16] - o.dist) + c.w_alive - c.w_crash * crashed -
             c.w_rates * rates_pen;
  o.t = s[15] + 1.0f;
  const float truncated = o.t >= c.max_steps ? 1.0f : 0.0f;
  const float done = fmaxf(crashed, truncated);
  o.reset = done > 0.5f;
  return o;
}

// The next rows of an env that goes on: the physics rows, done 0 (the
// next-state done row is always 0, AcroEnv.step's tree_where), t, the
// distance and the return; DR and wind rows persist.
__device__ __forceinline__ void env_continue(float s[kEnvRows], const float phys[kStateRows],
                                             const EnvOutcome& o) {
#pragma unroll
  for (int r = 0; r < 14; ++r) s[r] = phys[r];
  s[14] = 0.0f;
  s[15] = o.t;
  s[16] = o.dist;
  s[17] = s[17] + o.reward;
}

// The rows of an env that restarts at iteration i: the pose (draws 0..9),
// zero rates, thrust, done, t and return, then DR and gusts (10..16).
template <bool kDR, bool kWind>
__device__ __forceinline__ void env_reset(const EnvConsts& c, uint32_t lane, int i, float tx,
                                          float ty, float tz, float s[kEnvRows]) {
  const uint32_t base = (static_cast<uint32_t>(i) + 1u) * 32u;
  s[16] = reset_pose(c, lane, i, tx, ty, tz, s);
  s[10] = s[11] = s[12] = 0.0f;  // rates
  s[13] = 0.0f;                  // thrust
  s[14] = 0.0f;                  // done
  s[15] = 0.0f;                  // t
  s[17] = 0.0f;                  // episode_return
  float unused;
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
}

// Everything of an env step after the physics, one thread an env: s holds
// the 24 env rows of the step's start and receives the next ones, phys the
// physics rows after the step, (tx, ty, tz) the chased target. Returns the
// reward; *dist gets the distance to the target and *reset whether the env
// restarted.
template <bool kDR, bool kWind>
__device__ __forceinline__ float env_advance(const EnvConsts& c, uint32_t lane, int i,
                                             float s[kEnvRows], const float phys[kStateRows],
                                             float tx, float ty, float tz, float rates_pen,
                                             float* dist, bool* reset) {
  const EnvOutcome o = env_outcome(c, s, phys, tx, ty, tz, rates_pen);
  *dist = o.dist;
  *reset = o.reset;
  if (o.reset)
    env_reset<kDR, kWind>(c, lane, i, tx, ty, tz, s);
  else
    env_continue(s, phys, o);
  return o.reward;
}

}  // namespace fpyv
