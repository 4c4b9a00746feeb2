// K1: the drone physics step shared by every fused kernel of the port.
//
// Replaces fpyv_tpu/ops/pallas_step.py:_step_components (the physics core
// that the Pallas kernels _kernel_single, _kernel_rollout and _env_kernel
// call). Its parts: the head (action, rotation, drag), the contact terms of
// one motor point and one primitive, and the tail (acceleration,
// integration, attitude). step_components runs them for one thread's env
// (K2, K5-K8); K3 and K4 run the same parts on 4 lanes an env (lanes.cuh).
// The 15 state values live in registers. The motor count is the template
// parameter kMotors of the contact loop: 4, the quad's X frame, unrolled as
// a constant, or 0, the generic instantiation that reads StepConsts'
// n_motors (2 to kMaxMotors); each kernel's launch picks one of the two.
//
// The operation order follows _step_components line by line. Constants that
// JAX folds from Python floats arrive pre-folded in float64 and rounded once
// to float32 (StepConsts, built by fpyv_tpu_torch.ops.step_kernel). Every
// literal here carries an f suffix: one double literal would promote its
// expression. Built with --fmad=false and without --use_fast_math, so each
// operation rounds as the plain PyTorch version's does.
//
// Bound on the H100: per-env scalar float32 arithmetic (about 450 operations
// per env-step on a one-sphere world, 6 sin/cos and a few sqrt), no matrix
// product and a few bytes per env per launch — operations, not bytes. The
// design keeps the state in registers across a kernel's step loop and the
// world rows in shared memory, so a step touches device memory not at all.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fpyv {

constexpr int kStateRows = 15;
constexpr int kMaxMotors = 16;  // the motor arrays' capacity (MAX_MOTORS in ops/step_kernel.py)

// Field order must match StepConstants.as_array() in ops/step_kernel.py.
struct StepConsts {
  float dt, max_rates, rate_a, rate_keep, thrust_b, thrust_keep;
  float c3, c2, c1, c0;
  float drag_x, drag_y, drag_z;
  float gz, mass, inv_m, half_rate;
  float motor_radius, neg_spring;
  float n_motors;                                   // motor points, 2 to kMaxMotors
  float motor_x[kMaxMotors], motor_y[kMaxMotors];  // zero past n_motors
  float reps;
};

// The motor count of an instantiation: kMotors, or the runtime count at 0.
template <int kMotors>
__host__ __device__ __forceinline__ int motor_count(const StepConsts& k) {
  if constexpr (kMotors > 0) {
    return kMotors;
  } else {
    return static_cast<int>(k.n_motors);
  }
}

// The instantiation a launch takes: 4 for the quad's X frame, else 0.
__host__ __forceinline__ bool quad_frame(const StepConsts& k) { return k.n_motors == 4.0f; }

// A motor count the kernels take: 2 to kMaxMotors.
__host__ __forceinline__ bool motors_in_range(const StepConsts& k) {
  return k.n_motors >= 2.0f && k.n_motors <= static_cast<float>(kMaxMotors);
}

// Sphere centers may move per step (the env kernel); radius/active are rows
// of the world matrix. All pointers are into shared memory.
struct Spheres {
  const float* cx;
  const float* cy;
  const float* cz;
  const float* r;
  const float* active;
  int n;
};

// Cylinder matrix rows (6, C): center xyz, radius, height, active.
struct Cylinders {
  const float* rows;
  int n;
};

// Per-env DomainRand scales and wind, used when the template flags say so.
struct EnvPhysics {
  float mass_scale, drag_scale, thrust_scale;
  float wx, wy, wz;
};

__device__ __forceinline__ float lt0(float x) { return x < 0.0f ? 1.0f : 0.0f; }

// The step's values before the contacts (action2force, the rotation
// matrix, thrust, drag, gravity) that the contact terms and the tail read.
struct StepHead {
  float px, py, pz, vx, vy, vz;
  float qw, qx, qy, qz;  // after the override
  float n0, n1, n2, thrust, done;
  float R00, R01, R10, R11, R20, R21;  // columns 0 and 1 place the motor points
  float tx, ty, tz, dx, dy, dz, gz;
};

// kOverride: the guidance override of pallas_step.py:172-177. ov holds
// (qw, qx, qy, qz, |F|): the attitude quaternion is replaced before any use
// and |F| is the applied thrust, while the rates and thrust memories still
// update from act. Without it (K2-K4) the code is what it was.
template <bool kDR, bool kWind, bool kOverride = false>
__device__ __forceinline__ StepHead step_head(const StepConsts& k, const float s[kStateRows],
                                              const float act[4], const EnvPhysics& ep,
                                              const float* ov = nullptr) {
  StepHead h;
  h.px = s[0];
  h.py = s[1];
  h.pz = s[2];
  h.vx = s[3];
  h.vy = s[4];
  h.vz = s[5];
  float qw = s[6], qx = s[7], qy = s[8], qz = s[9];
  const float r0 = s[10], r1 = s[11], r2 = s[12];
  const float thrust_prev = s[13];
  h.done = s[14];

  // --- action2force (components.py:179-196)
  const float mr = k.max_rates;
  const float rc0 = fminf(fmaxf(-act[0] * mr, -mr), mr);
  const float rc1 = fminf(fmaxf(-act[1] * mr, -mr), mr);
  const float rc2 = fminf(fmaxf(-act[2] * mr, -mr), mr);
  h.n0 = rc0 * k.rate_a + r0 * k.rate_keep;
  h.n1 = rc1 * k.rate_a + r1 * k.rate_keep;
  h.n2 = rc2 * k.rate_a + r2 * k.rate_keep;
  const float xpct = 100.0f * (fminf(fmaxf(act[3], -1.0f), 1.0f) + 1.0f) * 0.5f;
  const float poly = ((k.c3 * xpct + k.c2) * xpct + k.c1) * xpct + k.c0;
  float thrust = poly * k.thrust_b + thrust_prev * k.thrust_keep;
  if (kDR) thrust = thrust * ep.thrust_scale;
  h.thrust = thrust;
  float applied = thrust;
  if (kOverride) {
    qw = ov[0];
    qx = ov[1];
    qy = ov[2];
    qz = ov[3];
    applied = ov[4];
  }
  h.qw = qw;
  h.qx = qx;
  h.qy = qy;
  h.qz = qz;

  // --- rotation matrix from the quaternion
  const float R00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float R01 = 2.0f * (qx * qy - qz * qw);
  const float R02 = 2.0f * (qx * qz + qy * qw);
  const float R10 = 2.0f * (qx * qy + qz * qw);
  const float R11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float R12 = 2.0f * (qy * qz - qx * qw);
  const float R20 = 2.0f * (qx * qz - qy * qw);
  const float R21 = 2.0f * (qy * qz + qx * qw);
  const float R22 = 1.0f - 2.0f * (qx * qx + qy * qy);
  h.R00 = R00;
  h.R01 = R01;
  h.R10 = R10;
  h.R11 = R11;
  h.R20 = R20;
  h.R21 = R21;
  h.tx = R02 * applied;
  h.ty = R12 * applied;
  h.tz = R22 * applied;

  // --- drag (kinematics.py:33-38) on velocity + wind
  float wx_ = h.vx, wy_ = h.vy, wz_ = h.vz;
  if (kWind) {
    wx_ = h.vx + ep.wx;
    wy_ = h.vy + ep.wy;
    wz_ = h.vz + ep.wz;
  }
  const float vnorm = sqrtf(wx_ * wx_ + wy_ * wy_ + wz_ * wz_);
  const float bx = R00 * wx_ + R10 * wy_ + R20 * wz_;
  const float by = R01 * wx_ + R11 * wy_ + R21 * wz_;
  const float bz = R02 * wx_ + R12 * wy_ + R22 * wz_;
  const float fbx = k.drag_x * bx * vnorm;
  const float fby = k.drag_y * by * vnorm;
  const float fbz = k.drag_z * bz * vnorm;
  h.dx = R00 * fbx + R01 * fby + R02 * fbz;
  h.dy = R10 * fbx + R11 * fby + R12 * fbz;
  h.dz = R20 * fbx + R21 * fby + R22 * fbz;
  if (kDR) {
    h.dx = h.dx * ep.drag_scale;
    h.dy = h.dy * ep.drag_scale;
    h.dz = h.dz * ep.drag_scale;
  }
  h.gz = k.gz;
  if (kDR) h.gz = h.gz * ep.mass_scale;
  return h;
}

// --- the contact terms of one motor point. Each returns the force term
// that the step adds to its sums (f, xyz) and the crash flag it maxes in;
// the step adds them motor by motor: the ground, each sphere, each cylinder.

// Motor point m in the world frame.
__device__ __forceinline__ void motor_point(const StepConsts& k, const StepHead& h, int m,
                                            float* mx, float* my, float* mz) {
  const float m0 = k.motor_x[m], m1 = k.motor_y[m];
  *mx = h.px + h.R00 * m0 + h.R01 * m1;
  *my = h.py + h.R10 * m0 + h.R11 * m1;
  *mz = h.pz + h.R20 * m0 + h.R21 * m1;
}

// The ground: a z force only.
__device__ __forceinline__ void ground_term(const StepConsts& k, float mz, float* fz,
                                            float* crash) {
  const float pen = mz - k.motor_radius;
  *fz = lt0(pen) * (k.neg_spring * pen);
  *crash = lt0(mz);
}

// Sphere i of sph.
__device__ __forceinline__ void sphere_term(const StepConsts& k, const Spheres& sph, int i,
                                            float mx, float my, float mz, float f[3],
                                            float* crash) {
  const float rm = k.motor_radius;
  const float ddx = mx - sph.cx[i], ddy = my - sph.cy[i], ddz = mz - sph.cz[i];
  const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  const float sd = dist - sph.r[i];
  const float inv = 1.0f / fmaxf(dist, 1e-12f);
  const float pen_s = sd - rm;
  const float hit_s = lt0(pen_s) * sph.active[i];
  const float mag = k.neg_spring * pen_s;
  f[0] = hit_s * mag * ddx * inv;
  f[1] = hit_s * mag * ddy * inv;
  f[2] = hit_s * mag * ddz * inv;
  *crash = lt0(sd) * sph.active[i];
}

// Cylinder i of cyl.
__device__ __forceinline__ void cylinder_term(const StepConsts& k, const Cylinders& cyl, int i,
                                              float mx, float my, float mz, float f[3],
                                              float* crash) {
  const int C = cyl.n;
  const float ccx = cyl.rows[i], ccy = cyl.rows[C + i], ccz = cyl.rows[2 * C + i];
  const float cr_ = cyl.rows[3 * C + i], ch_ = cyl.rows[4 * C + i];
  const float act_c = cyl.rows[5 * C + i];
  const float ddx = mx - ccx, ddy = my - ccy;
  const float r2d = sqrtf(ddx * ddx + ddy * ddy);
  const float d2d = r2d - cr_;
  const float z0 = ccz, z1 = ccz + ch_;
  const float in_band = (z0 < mz && mz < z1) ? 1.0f : 0.0f;
  const float dh = fminf(fabsf(mz - z0), fabsf(mz - z1));
  const float d = in_band * d2d + (1.0f - in_band) * sqrtf(d2d * d2d + dh * dh);
  // normal: RELATIVE z against the ABSOLUTE band (components.py:719-720)
  const float relz = mz - ccz;
  const float band_n = (z0 < relz && relz < z1) ? 1.0f : 0.0f;
  const float inv2d = 1.0f / fmaxf(r2d, 1e-12f);
  const float cap_sign = fabsf(relz - z0) < fabsf(relz - z1) ? -1.0f : 1.0f;
  const float nx_ = band_n * ddx * inv2d;
  const float ny_ = band_n * ddy * inv2d;
  const float nz_ = (1.0f - band_n) * cap_sign;
  const float pen_c = d - k.motor_radius;
  const float hit_c = lt0(pen_c) * act_c;
  const float mag = k.neg_spring * pen_c;
  f[0] = hit_c * mag * nx_;
  f[1] = hit_c * mag * ny_;
  f[2] = hit_c * mag * nz_;
  *crash = lt0(d) * act_c;
}

// The contact force sums and the crash flag of one thread's env: the motor
// points in order, each adding its ground, sphere and cylinder terms in that
// order.
template <int kMotors>
__device__ __forceinline__ void contacts(const StepConsts& k, const StepHead& h,
                                         const Spheres& sph, const Cylinders& cyl, float cf[3],
                                         float* crashed) {
  const int nm = motor_count<kMotors>(k);
  float cfx = 0.0f, cfy = 0.0f, cfz = 0.0f, cr = 0.0f;
#pragma unroll
  for (int m = 0; m < nm; ++m) {
    float mx, my, mz, f[3], hit;
    motor_point(k, h, m, &mx, &my, &mz);
    ground_term(k, mz, &f[2], &hit);
    cfz = cfz + f[2];
    cr = fmaxf(cr, hit);
    for (int i = 0; i < sph.n; ++i) {
      sphere_term(k, sph, i, mx, my, mz, f, &hit);
      cfx = cfx + f[0];
      cfy = cfy + f[1];
      cfz = cfz + f[2];
      cr = fmaxf(cr, hit);
    }
    for (int i = 0; i < cyl.n; ++i) {
      cylinder_term(k, cyl, i, mx, my, mz, f, &hit);
      cfx = cfx + f[0];
      cfy = cfy + f[1];
      cfz = cfz + f[2];
      cr = fmaxf(cr, hit);
    }
  }
  cf[0] = cfx;
  cf[1] = cfy;
  cf[2] = cfz;
  *crashed = cr;
}

// Everything after the contacts: acceleration, the integration (position
// first, kinematics.py:21-22) and the attitude update; writes the 15 next
// state rows into s. trig(h, cs) puts the cosine and sine of the step's
// roll, pitch and yaw half-angles (n * half_rate) into cs[6], in that
// order. accel_z, when given, receives the world-z acceleration of the step
// (_step_components' with_accel_z, which K7 keeps as a state column).
template <bool kDR, class Trig>
__device__ __forceinline__ void step_tail_with(const StepConsts& k, const StepHead& h,
                                               const float cf[3], float crashed,
                                               const EnvPhysics& ep, float s[kStateRows],
                                               Trig trig, float* accel_z = nullptr) {
  float inv_m = k.inv_m;
  if (kDR) inv_m = 1.0f / (k.mass * ep.mass_scale);
  const float acx = (h.tx + h.dx + cf[0]) * inv_m;
  const float acy = (h.ty + h.dy + cf[1]) * inv_m;
  const float acz = (h.tz + h.dz + h.gz + cf[2]) * inv_m;
  if (accel_z != nullptr) *accel_z = acz;

  s[0] = h.px + h.vx * k.dt;
  s[1] = h.py + h.vy * k.dt;
  s[2] = h.pz + h.vz * k.dt;
  s[3] = h.vx + acx * k.dt;
  s[4] = h.vy + acy * k.dt;
  s[5] = h.vz + acz * k.dt;

  // --- attitude: q <- q ⊗ conj(qE), applied reps times (the 2x quirk)
  float qw = h.qw, qx = h.qx, qy = h.qy, qz = h.qz;
  float cs[6];
  trig(h, cs);
  const float cr = cs[0], sr = cs[1], cp = cs[2], sp = cs[3], cyw = cs[4], syw = cs[5];
  const float ew = cyw * cp * cr + syw * sp * sr;
  const float ex = cyw * cp * sr - syw * sp * cr;
  const float ey = cyw * sp * cr + syw * cp * sr;
  const float ez = syw * cp * cr - cyw * sp * sr;
  const int reps = static_cast<int>(k.reps);
  for (int r = 0; r < reps; ++r) {
    const float nw = qw * ew + qx * ex + qy * ey + qz * ez;
    const float nx = -qw * ex + qx * ew - qy * ez + qz * ey;
    const float ny = -qw * ey + qx * ez + qy * ew - qz * ex;
    const float nz = -qw * ez - qx * ey + qy * ex + qz * ew;
    qw = nw;
    qx = nx;
    qy = ny;
    qz = nz;
  }
  const float qn = 1.0f / sqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
  s[6] = qw * qn;
  s[7] = qx * qn;
  s[8] = qy * qn;
  s[9] = qz * qn;
  s[10] = h.n0;
  s[11] = h.n1;
  s[12] = h.n2;
  s[13] = h.thrust;
  s[14] = fmaxf(h.done, crashed);
}

// step_tail_with, one thread computing the three sines and cosines.
template <bool kDR>
__device__ __forceinline__ void step_tail(const StepConsts& k, const StepHead& h,
                                          const float cf[3], float crashed,
                                          const EnvPhysics& ep, float s[kStateRows],
                                          float* accel_z = nullptr) {
  step_tail_with<kDR>(
      k, h, cf, crashed, ep, s,
      [&k](const StepHead& hh, float cs[6]) {
        const float h0 = hh.n0 * k.half_rate, h1 = hh.n1 * k.half_rate;
        const float h2 = hh.n2 * k.half_rate;
        cs[0] = cosf(h0);
        cs[1] = sinf(h0);
        cs[2] = cosf(h1);
        cs[3] = sinf(h1);
        cs[4] = cosf(h2);
        cs[5] = sinf(h2);
      },
      accel_z);
}

// One step of one thread's env (K1): head, contacts, tail.
template <int kMotors, bool kDR, bool kWind, bool kOverride = false>
__device__ __forceinline__ void step_components(const StepConsts& k, const Spheres& sph,
                                                const Cylinders& cyl, float s[kStateRows],
                                                const float act[4], const EnvPhysics& ep,
                                                const float* ov = nullptr,
                                                float* accel_z = nullptr) {
  const StepHead h = step_head<kDR, kWind, kOverride>(k, s, act, ep, ov);
  float cf[3], crashed;
  contacts<kMotors>(k, h, sph, cyl, cf, &crashed);
  step_tail<kDR>(k, h, cf, crashed, ep, s, accel_z);
}

// Copy `count` floats from device memory into shared memory, block-strided.
__device__ __forceinline__ void load_shared(float* dst, const float* src, int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) dst[j] = src[j];
}

}  // namespace fpyv
