// The step of K3 and K4 with 4 lanes of a warp on one env.
//
// At 4096 envs one thread an env fills 128 warps, one scheduler in four of
// the H100's 132 SMs x 4, and a step lasts as long as one thread's chain of
// dependent operations. Here 4 adjacent lanes own an env: each holds the
// env's state and runs the step's head and tail (one copy of K1's code in
// physics.cuh); lane m computes the contact terms of motor points m, m + 4,
// m + 8, ... (one point a lane on the quad) and the sine and cosine of one
// of the attitude's three half-angles. The force sums must come out as
// K1's: float addition is not associative, so the terms go to shared memory
// and every lane of the env adds them in K1's order (motor by motor: the
// ground, each sphere, each cylinder). The crash flag is a max and is formed
// in the same pass. K4's auto-reset spreads its draws and sin/cos over the
// env's lanes and gathers them with warp shuffles.
#pragma once

#include "env.cuh"

namespace fpyv {

constexpr int kEnvsPerBlock = 32;  // K3's and K4's block: 32 envs
// Lanes an env, chosen by a sweep over 2, 4 and 8 at 4096 envs (PERF.md
// §6): 4, one motor point a lane, fills the H100's 528 schedulers with one
// warp each.
constexpr int kLanes = 4;
// From this many envs on, one thread an env: the card's schedulers are full
// and the lanes' repeated head and tail would only cost instruction slots
// (the sweep over N: 4 lanes win at 16384 envs, one thread from 32768 on).
constexpr int kOneThreadEnvs = 32768;
constexpr size_t kSharedLimit = 232448;  // opt-in shared memory of one H100 block

// float4 slots of one env's staged contact terms: (x, y, z, crash) for each
// of the M motor points and each of its 1 + S + C terms (the ground, the
// spheres, the cylinders)
__host__ __device__ __forceinline__ int stage_slots(int M, int S, int C) {
  return M * (1 + S + C);
}

// float4s of a block's staged terms at L lanes an env (one thread an env
// sums in registers)
template <int L>
__host__ __device__ __forceinline__ int block_stage(int M, int S, int C) {
  return L > 1 ? kEnvsPerBlock * stage_slots(M, S, C) : 0;
}

// Lanes an env for a launch of n envs: kLanes below kOneThreadEnvs when the
// block's shared memory (its staged terms and `floats` more) fits a block,
// else one thread (the same hand-written kernel, instantiated at L = 1).
// The wrappers in ops/ call it before a launch to log the choice.
__host__ __forceinline__ int lanes_for(int n, int M, int S, int C, size_t floats) {
  const size_t shmem = sizeof(float4) * block_stage<kLanes>(M, S, C) + sizeof(float) * floats;
  return n < kOneThreadEnvs && shmem <= kSharedLimit ? kLanes : 1;
}

// The terms of motor point p into its row of the env's slots; true when one
// is not +-0 (or is NaN), or crashes.
__device__ __forceinline__ bool stage_point(const StepConsts& k, const StepHead& h,
                                            const Spheres& sph, const Cylinders& cyl,
                                            float4* stage, int p) {
  const int S = sph.n, C = cyl.n, T = 1 + S + C;
  float mx, my, mz, f[3], hit;
  motor_point(k, h, p, &mx, &my, &mz);
  float4* row = stage + p * T;
  ground_term(k, mz, &f[2], &hit);
  row[0] = make_float4(0.0f, 0.0f, f[2], hit);
  bool some = f[2] != 0.0f || hit != 0.0f;
  for (int i = 0; i < S; ++i) {
    sphere_term(k, sph, i, mx, my, mz, f, &hit);
    row[1 + i] = make_float4(f[0], f[1], f[2], hit);
    some = some || f[0] != 0.0f || f[1] != 0.0f || f[2] != 0.0f || hit != 0.0f;
  }
  for (int i = 0; i < C; ++i) {
    cylinder_term(k, cyl, i, mx, my, mz, f, &hit);
    row[1 + S + i] = make_float4(f[0], f[1], f[2], hit);
    some = some || f[0] != 0.0f || f[1] != 0.0f || f[2] != 0.0f || hit != 0.0f;
  }
  return some;
}

// The contact force sums cf and the crash flag of the env whose 4 lanes call
// this together (every lane of the warp must: it synchronises the warp).
// m is the lane's index in its env, stage the env's slots. When no term of
// the warp's envs is non-zero (no contact: the common step), K1's sums are
// +0 and its flag 0, and the staged terms are not read.
template <int kMotors>
__device__ __forceinline__ void contacts_lanes(const StepConsts& k, const StepHead& h,
                                               const Spheres& sph, const Cylinders& cyl,
                                               float4* stage, int m, float cf[3],
                                               float* crashed) {
  const int nm = motor_count<kMotors>(k), T = 1 + sph.n + cyl.n;
  bool some;
  if constexpr (kMotors == kLanes) {  // the quad: motor point m
    some = stage_point(k, h, sph, cyl, stage, m);
  } else {  // motor points m, m + kLanes, ...
    some = false;
    for (int p = m; p < nm; p += kLanes) some = stage_point(k, h, sph, cyl, stage, p) || some;
  }
  float cfx = 0.0f, cfy = 0.0f, cfz = 0.0f, cr = 0.0f;
  if (__ballot_sync(0xffffffffu, some) != 0u) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < nm; ++j) {
      const float4* mrow = stage + j * T;
      const float4 g = mrow[0];  // the ground adds to z only
      cfz = cfz + g.z;
      cr = fmaxf(cr, g.w);
      for (int t = 1; t < T; ++t) {
        const float4 v = mrow[t];
        cfx = cfx + v.x;
        cfy = cfy + v.y;
        cfz = cfz + v.z;
        cr = fmaxf(cr, v.w);
      }
    }
    __syncwarp();  // every lane has read the slots before the next step writes them
  }
  cf[0] = cfx;
  cf[1] = cfy;
  cf[2] = cfz;
  *crashed = cr;
}

// step_tail with the three half-angles' sine and cosine on lanes 0-2 of the
// env (lane 3 repeats the yaw), gathered by shuffles (every lane of the warp
// calls this together).
template <bool kDR>
__device__ __forceinline__ void step_tail_lanes(const StepConsts& k, const StepHead& h,
                                                const float cf[3], float crashed,
                                                const EnvPhysics& ep, float s[kStateRows],
                                                int lane) {
  step_tail_with<kDR>(k, h, cf, crashed, ep, s, [&k, lane](const StepHead& hh, float cs[6]) {
    const int m = lane % kLanes, src0 = lane - m;
    const float ang = (m == 0 ? hh.n0 : (m == 1 ? hh.n1 : hh.n2)) * k.half_rate;
    const float c = cosf(ang), sn = sinf(ang);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cs[2 * j] = __shfl_sync(0xffffffffu, c, src0 + j);
      cs[2 * j + 1] = __shfl_sync(0xffffffffu, sn, src0 + j);
    }
  });
}

// The contacts and the tail of a step at L lanes an env (kLanes, or one
// thread, which runs K1's own loop).
template <int L, int kMotors>
__device__ __forceinline__ void env_contacts(const StepConsts& k, const StepHead& h,
                                             const Spheres& sph, const Cylinders& cyl,
                                             float4* stage, int lane, float cf[3],
                                             float* crashed) {
  static_assert(L == 1 || L == kLanes, "one thread or kLanes lanes an env");
  if constexpr (L == 1)
    contacts<kMotors>(k, h, sph, cyl, cf, crashed);
  else
    contacts_lanes<kMotors>(k, h, sph, cyl, stage, lane % kLanes, cf, crashed);
}

template <int L, bool kDR>
__device__ __forceinline__ void env_tail(const StepConsts& k, const StepHead& h,
                                         const float cf[3], float crashed, const EnvPhysics& ep,
                                         float s[kStateRows], int lane) {
  if constexpr (L == 1)
    step_tail<kDR>(k, h, cf, crashed, ep, s);
  else
    step_tail_lanes<kDR>(k, h, cf, crashed, ep, s, lane);
}

__device__ __forceinline__ float pick3(int t, float a, float b, float c) {
  return t == 0 ? a : (t == 1 ? b : c);
}

// env_reset at L lanes an env (called by all L of them together, inside
// the branch that the env's reset takes). With 4 lanes, lane t computes
// position draw t, the sin and cos of pose angle t, normal pair t (draws
// 3-4, 5-6, 13-14, 15-16) and DomainRand draw t (lane 3's position, angle
// and DR repeat lane 2's, unused); then every lane gathers them and forms
// the rows as env_reset does, each value by the same expression, so the
// draws stay bit-equal.
template <int L, bool kDR, bool kWind>
__device__ __forceinline__ void env_reset_lanes(const EnvConsts& c, uint32_t lane_id, int i,
                                                float tx, float ty, float tz, float s[kEnvRows],
                                                int lane) {
  if constexpr (L == 1) {
    env_reset<kDR, kWind>(c, lane_id, i, tx, ty, tz, s);
  } else {
    const uint32_t base = (static_cast<uint32_t>(i) + 1u) * 32u;
    const int t = lane % kLanes;
    const uint32_t tt = static_cast<uint32_t>(t < 3 ? t : 2);
    const float pos = pick3(t, c.pos_low[0], c.pos_low[1], c.pos_low[2]) +
                      uniform01(lane_id, base + tt) *
                          pick3(t, c.pos_span[0], c.pos_span[1], c.pos_span[2]);
    const float ang = (2.0f * uniform01(lane_id, base + 7u + tt) - 1.0f) * c.half_ypr;
    const float cs = cosf(ang), sn = sinf(ang);
    const uint32_t ca = t < 2 ? 3u + 2u * t : 13u + 2u * (t - 2);
    float za, zb, dr = 1.0f;
    normal_pair(lane_id, base + ca, base + ca + 1u, &za, &zb);
    if (kDR)
      dr = pick3(t, c.mass_lo, c.drag_lo, c.thrust_lo) +
           uniform01(lane_id, base + 10u + tt) * pick3(t, c.mass_span, c.drag_span,
                                                       c.thrust_span);
    const unsigned mask = 0xfu << (lane & ~(kLanes - 1));  // the env's lanes
    const int src0 = lane & ~(kLanes - 1);
    auto item = [&](float v, int from) { return __shfl_sync(mask, v, src0 + from); };
    const float rpx = item(pos, 0), rpy = item(pos, 1), rpz = item(pos, 2);
    const float cr = item(cs, 0), sr = item(sn, 0);
    const float cp = item(cs, 1), sp_ = item(sn, 1);
    const float cyw = item(cs, 2), syw = item(sn, 2);
    const float z0 = item(za, 0), z1 = item(zb, 0), z2 = item(za, 1);
    s[0] = rpx;
    s[1] = rpy;
    s[2] = rpz;
    s[3] = c.vel_scale * z0;
    s[4] = c.vel_scale * z1;
    s[5] = c.vel_scale * z2;
    s[6] = cyw * cp * cr + syw * sp_ * sr;  // rot.euler_to_quat, as reset_pose
    s[7] = cyw * cp * sr - syw * sp_ * cr;
    s[8] = cyw * sp_ * cr + syw * cp * sr;
    s[9] = syw * cp * cr - cyw * sp_ * sr;
    const float rdx = rpx - tx, rdy = rpy - ty, rdz = rpz - tz;
    s[16] = sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
    s[10] = s[11] = s[12] = 0.0f;  // rates
    s[13] = 0.0f;                  // thrust
    s[14] = 0.0f;                  // done
    s[15] = 0.0f;                  // t
    s[17] = 0.0f;                  // episode_return
    if (kDR) {
      s[18] = item(dr, 0);
      s[19] = item(dr, 1);
      s[20] = item(dr, 2);
    } else {
      s[18] = s[19] = s[20] = 1.0f;
    }
    if (kWind && c.gust > 0.5f) {
      s[21] = c.wind[0] + c.wind_scale * item(za, 2);
      s[22] = c.wind[1] + c.wind_scale * item(zb, 2);
      s[23] = c.wind[2] + c.wind_scale * item(za, 3);
    } else {
      s[21] = c.wind[0];
      s[22] = c.wind[1];
      s[23] = c.wind[2];
    }
  }
}

}  // namespace fpyv
