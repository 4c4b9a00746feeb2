// K5 and K6: the batched raycast depth render and the FPV chase megaloop.
//
// K5 replaces fpyv_tpu/ops/pallas_vision.py:_render_kernel
// (pallas_render_depth): nearest-hit depth over spheres, cylinders, the
// ground and shaped gates, quantised to floor(255 (1 - t / max)) / 255.
// A (ceil(HW / 1024), N) grid of 256-thread blocks, 4 pixels a thread
// (kRenderPerThread: the fastest of 1, 2 and 4 on the H100, PERF.md). Each
// block copies its env's camera and builds the env's invariant table
// (render.cuh::render_invariant: a sphere's o = cam - c and |o|^2 - r^2, a
// cylinder's ox, oy and c, a gate's ndot0) in one prologue with two
// barriers, then each thread reads its P rays from the grid dcam (3, HW) in
// coalesced rows and renders them through K7 and K8's per-pixel render
// (render.cuh::render_levels): a primitive that none of the P rays can hit
// stops at its discriminant (or a gate at its plane), before the square
// root and the divisions. Same operations in the same order as the plain
// version (vision_kernel.render_tiles), so the levels are equal. The frame
// is written once, each level / 255. Bound on the H100: at 96x72 and 1024
// envs the frame is 28.3 MB written against ~9 float32 operations per
// primitive and pixel that misses and 30-60 per hit, so a world with a few
// primitives is bound by operations, an empty one by the write. Nothing but
// the frame touches device memory.
//
// K6 replaces pallas_vision.py:_chase_kernel (pallas_vision_env_rollout):
// per step, render the chased target (sphere 0) alone, take the mask
// centroid, run the guidance pilot (_make_chase_action_fn: distance PID on
// the UWB-clamped range, virtual drag, ground lift, hover-scan while the
// target is out of frame, 'level' force basis, quaternion of the desired
// attitude), step the physics with the attitude / |F| override, then the
// K4 reward and auto-reset (env.cuh).
// One block of 128 threads per env. Thread 0 holds the env's 28 state rows
// in registers for all K steps, computes the camera pose and the target's
// pixel box (render.cuh::target_pixel_box), runs the serial pilot and
// physics and publishes the next pose through shared memory. The render
// tests only the pixels of the box: the threads walk its rows, (u, v)
// stepped by the block's stride with a carry, and each tested pixel runs
// world_ray and hit_sphere as the plain version does, so it decides alike.
// Why the box loses no pixel: where the target's centre c in the camera
// frame has c.z - r > 0.05 m, the whole sphere lies in front of the camera,
// every ray (X, Y, 1) that meets it lies in its tangent cone, and the
// cone's X and Y limits map through K to a pixel rectangle, padded by 2
// pixels against float32 rounding and clipped to the frame. A sphere wholly
// behind the camera (c.z + r < -0.05 m) can only be met at t < 0: no pixel.
// One across the camera plane (the camera inside it, or NaN) gets the full
// frame, unless it stays outside the cone that holds the frame's rays (its
// points with z > 0 lie at least rho - r off the optical axis and at
// z <= c.z + r; 5 % margin): then no pixel. tests/test_torch_chase_box.py
// holds the box against the plain and the JAX render over seeded poses.
// The mask count and pixel sums are of half-integers below 2^22 at 96x72,
// exact in float32 in any order, so with every lit pixel inside the box the
// centroid equals the full-frame one, and the Pallas one, bit for bit. (At
// 640x480 the sums can pass 2^23 and then round by their order, in the
// plain version too.)
// A warp-shuffle and shared-memory reduction combines the sums. The
// block's last thread, which the box seldom gives a pixel, computes the
// next step's target centres and scan force during the render.
// Bound on the H100: per env-step ~54 counted operations per tested pixel
// (PERF.md counts the box's pixels) against ~900 for the pilot, physics and
// reward on one thread; the serial part idles 127 threads, and blocks
// resident side by side on each SM overlap one block's pilot with others'
// renders. __launch_bounds__ asks for 8 resident blocks
// per SM (at most 64 registers a thread): 1056 slots hold a 1024-env bank
// in one wave. The instrumented instantiation (kTimed) clocks the phases of
// a step and counts the pixels tested and lit (chip_smoke.py --phases). The
// motor count is a template parameter of K1's contact loop: the quad's 4 or
// the generic count (physics.cuh); the instrumented one is the quad's.
#include "clock.cuh"
#include "env.cuh"
#include "render.cuh"

#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvConsts;
using fpyv::EnvPhysics;
using fpyv::kEnvRows;
using fpyv::kStateRows;
using fpyv::kWorldRows;
using fpyv::RenderConsts;
using fpyv::Spheres;
using fpyv::StepConsts;
using fpyv::WorldRay;

namespace {

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

constexpr int kRenderBlock = 256;
constexpr int kRenderPerThread = 4;
constexpr int kCamCols = 16;

// P pixels a thread: pixel j of thread x of block b is b * 256P + 256j + x,
// so each of the P rows of reads and writes stays coalesced.
__global__ void __launch_bounds__(kRenderBlock)
    render_depth_kernel(RenderConsts rc, const float* __restrict__ dcam, int hw,
                        const float* __restrict__ cam, const float* __restrict__ wcol,
                        int wstride, float* __restrict__ out, int n) {
  constexpr int P = kRenderPerThread;
  extern __shared__ float sh[];
  float* cs = sh;             // (12,) camera of the env
  float* pre = sh + kCamCols; // (pre_cols,) the env's invariants
  const int S = static_cast<int>(rc.n_spheres);
  const int C = static_cast<int>(rc.n_cylinders);
  const int G = static_cast<int>(rc.n_gates);
  const int items = S + C + G + 1;
  const int base = blockIdx.x * (kRenderBlock * P) + threadIdx.x;
  float dx[P], dy[P], dz[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = base + j * kRenderBlock;
    dx[j] = p < hw ? dcam[p] : 0.0f;
    dy[j] = p < hw ? dcam[hw + p] : 0.0f;
    dz[j] = p < hw ? dcam[2 * hw + p] : 0.0f;
  }
  for (int e = blockIdx.y; e < n; e += gridDim.y) {
    const float* ce = cam + static_cast<size_t>(e) * kCamCols;
    const float* we = wcol + static_cast<size_t>(e) * wstride;
    __syncthreads();  // the previous env's table is no longer read
    if (threadIdx.x < 12) cs[threadIdx.x] = ce[threadIdx.x];
    for (int k = threadIdx.x; k < items; k += kRenderBlock)
      fpyv::render_invariant(k, S, C, G, ce[0], ce[1], ce[2], we, pre);
    __syncthreads();
    uint32_t lev[P];  // a lane past hw renders a zero ray, never stored
    fpyv::render_levels<P>(rc, S, C, G, cs, pre, dx, dy, dz, lev);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = base + j * kRenderBlock;
      if (p < hw)
        out[static_cast<size_t>(e) * hw + p] = static_cast<float>(lev[j]) * (1.0f / 255.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

constexpr int kChaseBlock = 128;
constexpr int kChaseBlocksPerSM = 8;
constexpr int kPilotRows = 4;  // PID integral, derivative, previous error, started
constexpr int kChaseRows = kEnvRows + kPilotRows;

// The phases of a step that the instrumented instantiation (kTimed) times:
// camera pose and target centres, the render and its block reduction, the
// pilot, then K1 and env_advance. Its probe array holds their nanoseconds
// (summed over the blocks), then the pixels tested, the steps that rendered
// the full frame, the steps whose box held no pixel and the pixels lit,
// summed over the envs and steps.
enum ChasePhase { kChPose = 0, kChRender, kChPilot, kChStep, kChPhases };

// Field order must match ChaseConstants.as_array() in ops/vision_kernel.py.
struct ChaseConsts {
  float mount[9];  // camera mount rotation, row major
  float rel[3];    // camera position on the frame
  float k00, k02, k11, k12;  // K^-1 entries
  float gz, scan_s, scan_w;
  float drag, lift, tof, keep, uwb;
  float kP, kI, kD, iclip, rate, rate_keep, leak, dt, min_force, max_force;
  float ku, ks, kcu, kv, kcv;  // K entries K00, K01, K02, K11, K12: the target's pixel box
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float ssqrt(float x) { return sqrtf(fmaxf(x, 1e-12f)); }

// Shepperd's method over the row-major entries m[9], as
// pallas_vision.py:_quat_cols_from_R: same candidates, same dominant-diagonal
// selection, w >= 0.
__device__ __forceinline__ void quat_from_R(const float m[9], float q[4]) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = m00 + m11 + m22;
  const bool sel_w = tr >= m00 && tr >= m11 && tr >= m22;
  const bool sel_x = m00 >= m11 && m00 >= m22;
  const bool sel_y = m11 >= m22;
  if (sel_w) {
    const float sw = ssqrt(1.0f + tr);
    const float iw = 0.5f / sw;
    q[0] = 0.5f * sw;
    q[1] = (m21 - m12) * iw;
    q[2] = (m02 - m20) * iw;
    q[3] = (m10 - m01) * iw;
  } else if (sel_x) {
    const float sx = ssqrt(1.0f + m00 - m11 - m22);
    const float ix = 0.5f / sx;
    q[0] = (m21 - m12) * ix;
    q[1] = 0.5f * sx;
    q[2] = (m01 + m10) * ix;
    q[3] = (m02 + m20) * ix;
  } else if (sel_y) {
    const float sy = ssqrt(1.0f - m00 + m11 - m22);
    const float iy = 0.5f / sy;
    q[0] = (m02 - m20) * iy;
    q[1] = (m01 + m10) * iy;
    q[2] = 0.5f * sy;
    q[3] = (m12 + m21) * iy;
  } else {
    const float sz = ssqrt(1.0f - m00 - m11 + m22);
    const float iz = 0.5f / sz;
    q[0] = (m10 - m01) * iz;
    q[1] = (m02 + m20) * iz;
    q[2] = (m12 + m21) * iz;
    q[3] = 0.5f * sz;
  }
  const float sign = q[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = q[j] * sign;
}

// The hover-scan force (x, y) of step i: hover thrust tilted by scan_s, its
// azimuth turning by scan_w a step.
__device__ __forceinline__ void scan_force(const ChaseConsts& p, int i, float f[2]) {
  const float theta = p.scan_w * static_cast<float>(i);
  f[0] = p.scan_s * cosf(theta);
  f[1] = p.scan_s * sinf(theta);
}

// The guidance pilot of one step (pallas_vision.py:554-631). s: the state
// rows at the step's start, cam: its camera pose, (tx, ty, tz, tr): the
// target, (cnt, su, sv): the mask count and pixel sums, (scan_fx, scan_fy):
// the step's scan_force. Writes the override ov = (qw, qx, qy, qz, |F|) and
// the next PID memory rows pid[4].
__device__ __forceinline__ void chase_pilot(const ChaseConsts& p, const float s[],
                                            const float cam[12], float tx, float ty, float tz,
                                            float tr, float cnt, float su, float sv,
                                            float scan_fx, float scan_fy, float ov[5],
                                            float pid[4]) {
  const float px = s[0], py = s[1], pz = s[2];
  const float vx = s[3], vy = s[4], vz = s[5];
  const float safe = fmaxf(cnt, 1.0f);
  const float ucen = su / safe, vcen = sv / safe;
  const bool visible = cnt > 0.5f;

  // ray through the centroid pixel, world frame, normalised
  const float* R = cam + 3;
  const float dcx = p.k00 * ucen + p.k02;
  const float dcy = p.k11 * vcen + p.k12;
  float dwx = R[0] * dcx + R[1] * dcy + R[2];
  float dwy = R[3] * dcx + R[4] * dcy + R[5];
  float dwz = R[6] * dcx + R[7] * dcy + R[8];
  const float dn = fmaxf(sqrtf(dwx * dwx + dwy * dwy + dwz * dwz), 1e-12f);
  dwx = dwx / dn;
  dwy = dwy / dn;
  dwz = dwz / dn;
  // UWB-clamped SDF range (components.py:287)
  const float ddx = px - tx, ddy = py - ty, ddz = pz - tz;
  const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz) - tr;
  const float measured = fminf(dist, p.uwb);
  // PID on the distance; memory rows after the env rows
  const float p_i = s[kEnvRows + 0], p_d = s[kEnvRows + 1];
  const float p_e = s[kEnvRows + 2], p_s = s[kEnvRows + 3];
  const float err = measured - p.keep;
  const float integ = clampf(p.leak * p_i + err * p.dt, -p.iclip, p.iclip);
  const float raw_d = clampf(p_s > 0.5f ? (err - p_e) / p.dt : 0.0f, -1.0f, 1.0f);
  const float deriv = p.rate_keep * p_d + p.rate * raw_d;
  const float mult = clampf(p.kP * err + p.kI * integ + p.kD * deriv, p.min_force, p.max_force);
  // virtual drag (components.py:271-285)
  const float vnorm = sqrtf(vx * vx + vy * vy + vz * vz);
  const float inv_v = 1.0f / fmaxf(vnorm, 1e-12f);
  const float cosang = (vx * dwx + vy * dwy + vz * dwz) * inv_v;
  const float vc = p.drag * (-(cosang - 1.0f) / 2.0f) * vnorm;
  const float vdx = -vc * vx, vdy = -vc * vy, vdz = -vc * vz;
  // virtual ground-effect lift (components.py:286)
  const float below = pz < p.tof ? 1.0f : 0.0f;
  const float vlift = below * -(p.tof - pz) * p.lift * p.gz * (1.0f + fabsf(vz));
  // F = mult dir + vdrag + vlift - gravity (components.py:292), else hover-scan
  const float fx = visible ? mult * dwx + vdx : scan_fx;
  const float fy = visible ? mult * dwy + vdy : scan_fy;
  const float fz = visible ? mult * dwz + vdz + vlift - p.gz : -p.gz;
  // the PID memory freezes while the target is out of frame
  pid[0] = visible ? integ : p_i;
  pid[1] = visible ? deriv : p_d;
  pid[2] = visible ? err : p_e;
  pid[3] = visible ? 1.0f : p_s;
  // 'level' force basis (components.py:294-303): y = F x g, x = y x F
  const float yx = fy * p.gz;
  const float yy = -fx * p.gz;
  const float xx = yy * fz;
  const float xy = -yx * fz;
  const float xz = yx * fy - yy * fx;
  const float xn = fmaxf(sqrtf(xx * xx + xy * xy + xz * xz), 1e-12f);
  const float yn = fmaxf(sqrtf(yx * yx + yy * yy), 1e-12f);
  const float fn = fmaxf(sqrtf(fx * fx + fy * fy + fz * fz), 1e-12f);
  const float Rd[9] = {xx / xn, yx / yn, fx / fn,
                       xy / xn, yy / yn, fy / fn,
                       xz / xn, 0.0f * xz, fz / fn};
  quat_from_R(Rd, ov);
  ov[4] = sqrtf(fx * fx + fy * fy + fz * fz);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <int kMotors, bool kDR, bool kWind, bool kTimed>
__global__ void __launch_bounds__(kChaseBlock, kChaseBlocksPerSM)
    chase_kernel(StepConsts k, EnvConsts c, ChaseConsts p, int seed,
                 const float* __restrict__ state, const float* __restrict__ world, int S,
                 const float* __restrict__ cyl, int C, const float* __restrict__ dcam, int hw,
                 int width, float* __restrict__ out, float* __restrict__ rsum_out,
                 float* __restrict__ crash_out, float* __restrict__ contact_out, int n,
                 int n_steps, unsigned long long* __restrict__ probe) {
  extern __shared__ float sh[];
  float* wm = sh;                   // (12, S) world rows
  float* cm = wm + kWorldRows * S;  // (6, C) cylinder rows
  float* cen = cm + 6 * C;          // (2, 3, S) target centres of steps i and i + 1
  __shared__ float cam[12];         // camera pose of the step
  __shared__ float scan[2][2];      // scan_force of steps i and i + 1
  __shared__ float tgt[4];          // chased target: center, radius
  __shared__ int box[4];            // its pixel box: u0, u1, v0, v1
  __shared__ float part[3][kChaseBlock / 32];
  fpyv::load_shared(wm, world, kWorldRows * S);
  fpyv::load_shared(cm, cyl, 6 * C);

  const int e = blockIdx.x;
  const int height = hw / width;
  const float cone = fpyv::frame_cone(p.ku, p.ks, p.kcu, p.kv, p.kcv, width, height);
  const bool lead = threadIdx.x == 0;
  // step i + 1's target centres and scan force, computed during step i's
  // render (so the render's barrier orders them before step i + 1 reads
  // them) by the block's last thread, which the box seldom gives a pixel
  const bool ahead = threadIdx.x == kChaseBlock - 1;
  const int warp = threadIdx.x >> 5, lane_in_warp = threadIdx.x & 31;
  float s[kChaseRows];
  if (lead) {
#pragma unroll
    for (int r = 0; r < kChaseRows; ++r) s[r] = state[r * n + e];
  }
  const uint32_t lane = fpyv::env_lane(e, seed);
  const Cylinders cv{cm, C};
  const float zero_act[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float rsum = 0.0f, crashes = 0.0f, contacts = 0.0f;
  fpyv::PhaseClock<kTimed, kChPhases> clk;
  unsigned long long tested = 0, full = 0, none = 0, lit = 0;
  __syncthreads();  // the world rows are in shared memory
  if (ahead) {
    fpyv::target_centers(wm, S, 0, cen, 0, 1);
    scan_force(p, 0, scan[0]);
  }
  __syncthreads();
  clk.start();

  for (int i = 0; i < n_steps; ++i) {
    const float* ci = cen + (i & 1) * 3 * S;
    if (lead) {
      fpyv::camera_pose(p.mount, p.rel, s, cam);
      tgt[0] = ci[0];
      tgt[1] = ci[S];
      tgt[2] = ci[2 * S];
      tgt[3] = wm[3 * S];  // sphere 0, active whatever its mask says
      const fpyv::PixelBox b = fpyv::target_pixel_box(cam, tgt[0], tgt[1], tgt[2], tgt[3], p.ku,
                                                      p.ks, p.kcu, p.kv, p.kcv, cone, width,
                                                      height);
      box[0] = b.u0;
      box[1] = b.u1;
      box[2] = b.v0;
      box[3] = b.v1;
      if constexpr (kTimed) {
        const bool some = b.u0 <= b.u1 && b.v0 <= b.v1;
        tested += some ? (b.u1 - b.u0 + 1) * (b.v1 - b.v0 + 1) : 0;
        full += b.full ? 1 : 0;
        none += some ? 0 : 1;
      }
    }
    __syncthreads();
    clk.mark(kChPose);
    if (ahead && i + 1 < n_steps) {  // the other buffer: read after this step's render barrier
      fpyv::target_centers(wm, S, i + 1, cen + ((i + 1) & 1) * 3 * S, 0, 1);
      scan_force(p, i + 1, scan[(i + 1) & 1]);
    }

    // ---- target-only render over the box: mask count and pixel sums. The
    // threads walk the box's pixels in row order, (u, v) advanced by the
    // block's stride with a carry, so no pixel index is divided by width.
    float cnt = 0.0f, su = 0.0f, sv = 0.0f;
    const int u0 = box[0], u1 = box[1], v0 = box[2];
    const int bw = u1 - u0 + 1;
    const int area = bw > 0 && box[3] >= v0 ? bw * (box[3] - v0 + 1) : 0;
    if (threadIdx.x < area) {
      const int du = kChaseBlock % bw, dv = kChaseBlock / bw;
      int u = u0 + threadIdx.x % bw, v = v0 + threadIdx.x / bw;
      for (int q = threadIdx.x; q < area; q += kChaseBlock) {
        const int pix = v * width + u;
        const WorldRay r = fpyv::world_ray(cam, dcam[pix], dcam[hw + pix], dcam[2 * hw + pix]);
        const float t =
            fpyv::hit_sphere(r, fpyv::ray_a(r), tgt[0], tgt[1], tgt[2], tgt[3], true);
        if (t < 1e30f) {
          cnt += 1.0f;
          su += static_cast<float>(u) + 0.5f;
          sv += static_cast<float>(v) + 0.5f;
        }
        u += du;
        v += dv;
        if (u > u1) {
          u -= bw;
          v += 1;
        }
      }
    }
    cnt = warp_sum(cnt);
    su = warp_sum(su);
    sv = warp_sum(sv);
    if (lane_in_warp == 0) {
      part[0][warp] = cnt;
      part[1][warp] = su;
      part[2][warp] = sv;
    }
    __syncthreads();
    clk.mark(kChRender);
    if (!lead) continue;

    cnt = su = sv = 0.0f;
#pragma unroll
    for (int w = 0; w < kChaseBlock / 32; ++w) {
      cnt += part[0][w];
      su += part[1][w];
      sv += part[2][w];
    }
    if constexpr (kTimed) lit += static_cast<unsigned long long>(cnt);
    float ov[5], pid[4];
    chase_pilot(p, s, cam, tgt[0], tgt[1], tgt[2], tgt[3], cnt, su, sv, scan[i & 1][0],
                scan[i & 1][1], ov, pid);
    clk.mark(kChPilot);

    const Spheres sp{ci, ci + S, ci + 2 * S, wm + 3 * S, wm + 4 * S, S};
    const EnvPhysics ep{s[18], s[19], s[20], s[21], s[22], s[23]};
    float phys[kStateRows];
#pragma unroll
    for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
    fpyv::step_components<kMotors, kDR, kWind, true>(k, sp, cv, phys, zero_act, ep, ov);

    float dist;
    bool reset;
    rsum = rsum + fpyv::env_advance<kDR, kWind>(c, lane, i, s, phys, tgt[0], tgt[1], tgt[2],
                                                0.0f, &dist, &reset);
#pragma unroll
    for (int r = 0; r < kPilotRows; ++r) s[kEnvRows + r] = reset ? 0.0f : pid[r];
    const float crashed = phys[14];
    crashes = crashes + crashed;
    // contact: a crash within the target's collision shell (motor arm 0.127 m
    // + motor radius; 0.3 m covers both)
    contacts = contacts + crashed * (dist <= tgt[3] + 0.3f ? 1.0f : 0.0f);
    clk.mark(kChStep);
  }
  clk.flush(probe);
  if (kTimed && lead) {
    atomicAdd(probe + kChPhases, tested);
    atomicAdd(probe + kChPhases + 1, full);
    atomicAdd(probe + kChPhases + 2, none);
    atomicAdd(probe + kChPhases + 3, lit);
  }

  if (lead) {
#pragma unroll
    for (int r = 0; r < kChaseRows; ++r) out[r * n + e] = s[r];
    rsum_out[e] = rsum;
    crash_out[e] = crashes;
    contact_out[e] = contacts;
  }
}

template <int kMotors, bool kDR, bool kWind, bool kTimed>
void launch_chase(const StepConsts& k, const EnvConsts& c, const ChaseConsts& p, int seed,
                  const float* state, const float* world, int S, const float* cyl, int C,
                  const float* dcam, int hw, int width, float* out, float* rsum, float* crashes,
                  float* contacts, int n, int n_steps, unsigned long long* probe,
                  cudaStream_t stream) {
  const size_t shmem = sizeof(float) * (kWorldRows * S + 6 * C + 6 * S);
  chase_kernel<kMotors, kDR, kWind, kTimed><<<n, kChaseBlock, shmem, stream>>>(
      k, c, p, seed, state, world, S, cyl, C, dcam, hw, width, out, rsum, crashes, contacts, n,
      n_steps, probe);
}

template <typename T>
bool read_consts(const float* host, int count, T* out) {
  if (count != static_cast<int>(sizeof(T) / sizeof(float))) return false;
  std::memcpy(out, host, sizeof(T));
  return true;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int fpyv_render_depth(const float* consts, int n_consts, const float* dcam, int hw,
                      const float* cam, const float* wcol, int wcols, int wstride, float* out,
                      int n, void* stream) {
  RenderConsts rc;
  if (!read_consts(consts, n_consts, &rc) || n < 1 || hw < 1 ||
      wcols != 5 * static_cast<int>(rc.n_spheres) + 6 * static_cast<int>(rc.n_cylinders) +
                   15 * static_cast<int>(rc.n_gates) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = kRenderBlock * kRenderPerThread;
  const dim3 grid((hw + tile - 1) / tile, n < 65535 ? n : 65535);
  const int cols = fpyv::pre_cols(static_cast<int>(rc.n_spheres), static_cast<int>(rc.n_cylinders),
                                  static_cast<int>(rc.n_gates));
  render_depth_kernel<<<grid, kRenderBlock, sizeof(float) * (kCamCols + cols),
                        static_cast<cudaStream_t>(stream)>>>(rc, dcam, hw, cam, wcol, wstride,
                                                             out, n);
  return static_cast<int>(cudaGetLastError());
}

int fpyv_vision_env_rollout(const float* step_consts, int n_step_consts, const float* env_consts,
                            int n_env_consts, const float* chase_consts, int n_chase_consts,
                            int seed, const float* state, const float* world, int S,
                            const float* cyl, int C, const float* dcam, int hw, int width,
                            float* out, float* rsum, float* crashes, float* contacts, int n,
                            int n_steps, int randomize, int use_wind, void* probe,
                            void* stream) {
  StepConsts k;
  EnvConsts c;
  ChaseConsts p;
  if (!read_consts(step_consts, n_step_consts, &k) || !read_consts(env_consts, n_env_consts, &c) ||
      !read_consts(chase_consts, n_chase_consts, &p) || n < 1 || !fpyv::motors_in_range(k) ||
      (probe && (randomize || use_wind || !fpyv::quad_frame(k))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FPYV_CHASE(M, DR, WIND, TIMED)                                                       \
  launch_chase<M, DR, WIND, TIMED>(k, c, p, seed, state, world, S, cyl, C, dcam, hw, width,   \
                                   out, rsum, crashes, contacts, n, n_steps,                 \
                                   static_cast<unsigned long long*>(probe), st)
#define FPYV_CHASE_FLAGS(M)                 \
  if (randomize && use_wind)                \
    FPYV_CHASE(M, true, true, false);       \
  else if (randomize)                       \
    FPYV_CHASE(M, true, false, false);      \
  else if (use_wind)                        \
    FPYV_CHASE(M, false, true, false);      \
  else                                      \
    FPYV_CHASE(M, false, false, false)
  if (probe) {
    FPYV_CHASE(4, false, false, true);
  } else if (fpyv::quad_frame(k)) {
    FPYV_CHASE_FLAGS(4);
  } else {
    FPYV_CHASE_FLAGS(0);
  }
#undef FPYV_CHASE_FLAGS
#undef FPYV_CHASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
