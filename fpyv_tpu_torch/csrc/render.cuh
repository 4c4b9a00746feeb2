// Nearest-hit ray math of the depth renderers: one pixel's ray against
// spheres, vertical cylinders, the ground plane and shaped gate frames.
//
// Follows fpyv_tpu/ops/pallas_vision.py:_render_tiles and _encode_levels
// operation by operation (built with --fmad=false, no fast math), so a
// kernel's levels equal the plain PyTorch version's
// (ops/vision_kernel.py::render_tiles). Each env's invariants are hoisted
// into a table (render_invariant) that its pixels read through one
// per-pixel render, render_levels, several pixels a thread: K5 (the batched
// render) stores the levels / 255, K7 and K8 (the policy rollouts, which
// render the full world inside their step) the uint8 levels
// (render_frames). K6 (the chase render of the target alone, over the
// target's pixel box) runs hit_sphere.
//
// Camera: cam[0..2] position, cam[3..11] the camera-to-world rotation, row
// major. The pixel's camera-frame direction (dx, dy, dz) comes from the
// rig's ray grid (z = 1), so the hit's camera depth is t.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fpyv {

constexpr float kBig = 3.0e38f;  // "no hit", below float inf so min stays finite

struct WorldRay {
  float px, py, pz;  // camera position
  float dx, dy, dz;  // world-frame direction, unnormalised
};

__device__ __forceinline__ WorldRay world_ray(const float* cam, float dx, float dy, float dz) {
  return WorldRay{cam[0], cam[1], cam[2],
                  cam[3] * dx + cam[4] * dy + cam[5] * dz,
                  cam[6] * dx + cam[7] * dy + cam[8] * dz,
                  cam[9] * dx + cam[10] * dy + cam[11] * dz};
}

// |d|^2, the sphere quadratic's a (hoisted: the same for every sphere).
__device__ __forceinline__ float ray_a(const WorldRay& r) {
  return r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
}

// Sphere (center, radius): near root, the far root when the camera is inside.
__device__ __forceinline__ float hit_sphere(const WorldRay& r, float a, float cx, float cy,
                                            float cz, float rad, bool active) {
  const float ox = r.px - cx, oy = r.py - cy, oz = r.pz - cz;
  const float b = ox * r.dx + oy * r.dy + oz * r.dz;
  const float c = ox * ox + oy * oy + oz * oz - rad * rad;
  const float disc = b * b - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-b - sq) / a;
  t = t > 0.0f ? t : (-b + sq) / a;
  return (disc >= 0.0f && t > 0.0f && active) ? t : kBig;
}

// The uint8 depth level floor(255 (1 - t / max)), clipped to [0, 255], as
// an integer-valued float (pallas_policy.py:267-269).
__device__ __forceinline__ float depth_level(float t, float max_depth) {
  const float tc = fminf(t, max_depth);
  const float lev = floorf(255.0f * (1.0f - tc / max_depth));
  return fminf(fmaxf(lev, 0.0f), 255.0f);
}

// Field order must match RenderConfig.as_array() in ops/vision_kernel.py.
struct RenderConsts {
  float n_spheres, n_cylinders, n_gates;
  float spheres, cylinders, ground, gates;  // 1.0 where included
  float max_depth;
  float clip_ground, ground_extent;
  float frame_width;
};

// ---------------------------------------------------------------------------
// Each env's invariants, hoisted: computed once per env, what the plain
// version recomputes at every pixel, into a per-env table (render_invariant)
// that each of the env's pixels reads (render_levels). The hoisted values
// are the same operations in the same order as the plain version's sphere,
// cylinder and gate tests.
// ---------------------------------------------------------------------------

constexpr int kPreSphere = 5;    // ox, oy, oz, |o|^2 - r^2, active
constexpr int kPreCylinder = 6;  // ox, oy, ox^2 + oy^2 - r^2, z0, z0 + h, active
constexpr int kPreGate = 16;     // the gate's 15 columns, then ndot0

__host__ __device__ constexpr int pre_cols(int S, int C, int G) {
  return kPreSphere * S + kPreCylinder * C + kPreGate * G + 1;  // + has_ground
}

// Item k of an env's invariant table (spheres, cylinders, gates, ground),
// from its camera position (px, py, pz) and world columns w; a block strides
// k over pre_cols' S + C + G + 1 items.
__device__ __forceinline__ void render_invariant(int k, int S, int C, int G, float px, float py,
                                                 float pz, const float* w, float* pre) {
  if (k < S) {
    const float* q = w + 5 * k;
    float* o = pre + kPreSphere * k;
    const float ox = px - q[0], oy = py - q[1], oz = pz - q[2];
    o[0] = ox;
    o[1] = oy;
    o[2] = oz;
    o[3] = ox * ox + oy * oy + oz * oz - q[3] * q[3];
    o[4] = q[4];
    return;
  }
  k -= S;
  if (k < C) {
    const float* q = w + 5 * S + 6 * k;
    float* o = pre + kPreSphere * S + kPreCylinder * k;
    const float ox = px - q[0], oy = py - q[1];
    o[0] = ox;
    o[1] = oy;
    o[2] = ox * ox + oy * oy - q[3] * q[3];
    o[3] = q[2];
    o[4] = q[2] + q[4];
    o[5] = q[5];
    return;
  }
  k -= C;
  const float* gates = w + 5 * S + 6 * C;
  float* o = pre + kPreSphere * S + kPreCylinder * C;
  if (k < G) {
    const float* g = gates + 15 * k;
    o += kPreGate * k;
    for (int j = 0; j < 15; ++j) o[j] = g[j];
    o[15] = g[3] * (g[0] - px) + g[4] * (g[1] - py) + g[5] * (g[2] - pz);
  } else if (k == G) {
    o[kPreGate * G] = gates[15 * G];
  }
}

// ---------------------------------------------------------------------------
// The per-pixel render (render_levels) of K5 and of the policy rollouts'
// render phase (K7, K8), designed for the H100.
//
// What bounds it: a pixel's test is a chain of dependent IEEE divisions and
// square roots (--fmad=false, no fast math), and the SM idles on their
// latency unless many pixels are in flight. So a thread renders P pixels of
// one env at a time: each primitive's cheap test (discriminant, plane side)
// for all P pixels in one straight-line block, and the rest only where one
// of the P can hit, so P independent chains are in flight. There a sphere's
// or a cylinder's root runs for each pixel whose discriminant allows it,
// the far root only where the near one misses (computing both for all P,
// then selecting, made K5 1.25x slower on the H100, PERF.md), and a gate's
// frame test for all P at once. The ground's and a gate's division run
// only where the plane can lie ahead (the sign test that t > 0 needs), the
// level's division only below max_depth (the level is 0 at and past it). A
// pixel's arithmetic is the plain version's, in the same order, and where
// it is skipped its result would be discarded, so the levels equal the
// plain version's bit for bit.
//
// In K7 and K8 a block owns 8 envs (their fc weight stream sets that,
// csrc/actor.cuh), so at the trainers' 1024 envs the bank is one block an
// SM. A port with one pixel a thread on the actor's 8 warps, whose
// per-pixel test repeated each env's invariants and took every primitive to
// its root before its mask discarded it, spent 11.6 ms of K7's 15.8 ms
// launch there (counted operations set its bound, ~0.9 ms). So the block
// has 512 threads (kRolloutThreads: the actor's 256 and 256 that only
// render), 16 warps an SM for the render. At each step it builds its envs'
// invariant tables (render_invariants_block: render_invariant items strided
// over the threads, as K5's prologue), then each thread renders P
// neighbouring pixels of one env at a time (render_frames): their rays read
// as one vector load a component, their P levels stored as one word.
// ---------------------------------------------------------------------------

// The invariant tables of a block's ne envs: env e's at pre_s + e *
// pre_cols(S, C, G), from its camera (cam_s + e * cam_stride) and world
// columns (ws + e * wstride). Items stride over the block's threads; the
// caller synchronises before and after.
__device__ __forceinline__ void render_invariants_block(int S, int C, int G, int ne,
                                                        const float* cam_s, int cam_stride,
                                                        const float* ws, int wstride,
                                                        float* pre_s) {
  const int items = S + C + G + 1;
  for (int k = threadIdx.x; k < ne * items; k += blockDim.x) {
    const int e = k / items;
    const float* c = cam_s + e * cam_stride;
    render_invariant(k - e * items, S, C, G, c[0], c[1], c[2], ws + e * wstride,
                     pre_s + e * pre_cols(S, C, G));
  }
}

// P consecutive floats from d (16-byte aligned where P is a multiple of 4).
template <int P>
__device__ __forceinline__ void load_row(const float* __restrict__ d, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int j = 0; j < P; j += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(d + j));
      v[j] = w.x;
      v[j + 1] = w.y;
      v[j + 2] = w.z;
      v[j + 3] = w.w;
    }
  } else if constexpr (P == 2) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(d));
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = __ldg(d + j);
  }
}

// The depth levels of P pixels of one env: camera-frame rays (cx, cy, cz)
// from its camera cam and invariant table pre. The nearest hit's
// depth_level, pixel for pixel; see the note above for what is skipped.
template <int P>
__device__ __forceinline__ void render_levels(const RenderConsts& rc, int S, int C, int G,
                                              const float* cam, const float* pre,
                                              const float (&cx)[P], const float (&cy)[P],
                                              const float (&cz)[P], uint32_t (&lev)[P]) {
  const float px = cam[0], py = cam[1], pz = cam[2];
  float dx[P], dy[P], dz[P], tm[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const WorldRay r = world_ray(cam, cx[j], cy[j], cz[j]);
    dx[j] = r.dx;
    dy[j] = r.dy;
    dz[j] = r.dz;
    tm[j] = kBig;
  }
  if (rc.spheres > 0.5f) {
    float a[P];
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = dx[j] * dx[j] + dy[j] * dy[j] + dz[j] * dz[j];
    for (int s = 0; s < S; ++s) {
      const float* q = pre + kPreSphere * s;
      if (!(q[4] > 0.5f)) continue;
      float b[P], disc[P];
      bool any = false;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        b[j] = q[0] * dx[j] + q[1] * dy[j] + q[2] * dz[j];
        disc[j] = b[j] * b[j] - a[j] * q[3];
        any = any || disc[j] >= 0.0f;
      }
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (!(disc[j] >= 0.0f)) continue;
        const float sq = sqrtf(fmaxf(disc[j], 0.0f));
        float t = (-b[j] - sq) / a[j];
        if (!(t > 0.0f)) t = (-b[j] + sq) / a[j];
        if (t > 0.0f) tm[j] = fminf(tm[j], t);
      }
    }
  }
  const float* cyl = pre + kPreSphere * S;
  if (rc.cylinders > 0.5f) {
    float a2[P], sa[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      a2[j] = dx[j] * dx[j] + dy[j] * dy[j];
      sa[j] = fabsf(a2[j]) > 1e-20f ? a2[j] : 1e-20f;
    }
    for (int c = 0; c < C; ++c) {
      const float* q = cyl + kPreCylinder * c;
      if (!(q[5] > 0.5f)) continue;
      float b[P], disc[P];
      bool any = false;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        b[j] = q[0] * dx[j] + q[1] * dy[j];
        disc[j] = b[j] * b[j] - a2[j] * q[2];
        any = any || disc[j] >= 0.0f;
      }
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (!(disc[j] >= 0.0f)) continue;
        const float sq = sqrtf(fmaxf(disc[j], 0.0f));
        float t = (-b[j] + -sq) / sa[j];  // the near wall, else the far wall
        float z = pz + t * dz[j];
        if (!(t > 0.0f && z >= q[3] && z <= q[4])) {
          t = (-b[j] + sq) / sa[j];
          z = pz + t * dz[j];
        }
        if (t > 0.0f && z >= q[3] && z <= q[4]) tm[j] = fminf(tm[j], t);
      }
    }
  }
  const float* gates = cyl + kPreCylinder * C;
  if (rc.ground > 0.5f && gates[kPreGate * G] > 0.5f) {
    // t = -pz / dz > 0 needs dz on the ground's side of the camera
    const float mz = -pz;
    bool any = false;
#pragma unroll
    for (int j = 0; j < P; ++j)
      any = any || (mz > 0.0f && dz[j] > 1e-20f) || (mz < 0.0f && dz[j] < -1e-20f);
    if (any) {
      const bool clip = rc.clip_ground > 0.5f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float safe = fabsf(dz[j]) > 1e-20f ? dz[j] : 1e-20f;
        const float t = mz / safe;
        bool ok = t > 0.0f && fabsf(dz[j]) > 1e-20f;
        if (clip) {
          const float hx = px + t * dx[j];
          const float hy = py + t * dy[j];
          ok = ok && fabsf(hx) <= rc.ground_extent && fabsf(hy) <= rc.ground_extent;
        }
        if (ok) tm[j] = fminf(tm[j], t);
      }
    }
  }
  if (rc.gates > 0.5f) {
    const float fw = rc.frame_width;
    for (int g = 0; g < G; ++g) {
      const float* q = gates + kPreGate * g;
      if (!(q[13] > 0.5f)) continue;
      // t = ndot0 / ndotd > 0 needs the plane ahead along the ray
      const float n0 = q[15];
      float nd[P];
      bool ahead[P];
      bool any = false;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        nd[j] = q[3] * dx[j] + q[4] * dy[j] + q[5] * dz[j];
        ahead[j] = (n0 > 0.0f && nd[j] > 1e-20f) || (n0 < 0.0f && nd[j] < -1e-20f);
        any = any || ahead[j];
      }
      if (!any) continue;
      const float s = q[12];
      const float half = s * 0.5f;
      const float shape = q[14];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float t = n0 / nd[j];
        const float hx = px + t * dx[j] - q[0];
        const float hy = py + t * dy[j] - q[1];
        const float hz = pz + t * dz[j] - q[2];
        const float ly = q[6] * hx + q[7] * hy + q[8] * hz;
        const float lz = q[9] * hx + q[10] * hy + q[11] * hz;
        // the gate's own shape only (0 square band, 1 ring, 2 upper arc +
        // chord): the Pallas kernel's one-hot sum over the three equals it
        bool hit;
        if (shape == 1.0f) {
          hit = fabsf(sqrtf(ly * ly + lz * lz) - half) <= fw;
        } else if (shape == 2.0f) {
          const float cz = lz + half;
          hit = (fabsf(sqrtf(ly * ly + cz * cz) - s) <= fw && cz >= -fw) ||
                (fabsf(cz) <= fw && fabsf(ly) <= s + fw);
        } else {
          hit = fabsf(fmaxf(fabsf(ly), fabsf(lz)) - half) <= fw;
        }
        if (ahead[j] && t > 0.0f && hit) tm[j] = fminf(tm[j], t);
      }
    }
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < P; ++j) any = any || tm[j] < rc.max_depth;
#pragma unroll
  for (int j = 0; j < P; ++j)  // at and past max_depth the level is 0
    lev[j] = any ? static_cast<uint32_t>(depth_level(tm[j], rc.max_depth)) : 0u;
}

// P levels (each < 256) to dst as one little-endian word (P bytes, aligned
// to P).
template <int P>
__device__ __forceinline__ void store_levels(uint8_t* dst, const uint32_t (&lev)[P]) {
  if constexpr (P == 1) {
    *dst = static_cast<uint8_t>(lev[0]);
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(lev[0] | (lev[1] << 8));
  } else {
    uint32_t w[P / 4];
#pragma unroll
    for (int i = 0; i < P / 4; ++i)
      w[i] = lev[4 * i] | (lev[4 * i + 1] << 8) | (lev[4 * i + 2] << 16) | (lev[4 * i + 3] << 24);
    if constexpr (P == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else if constexpr (P == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < P / 4; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
    }
  }
}

// The render phase of K7 and K8: the frames of a block's ne envs, hw
// pixels each in patch-major order (the rig's ray grid dcam (3, hw) in that
// order), from their cameras (cam_s + e * cam_stride) and invariant tables
// (render_invariants_block), P pixels a thread at a time, into frame_s (ne,
// hw) in shared memory and, where out is not null, into out (ne, hw) in
// device memory. hw is a multiple of 64; frame_s and out are 8-byte
// aligned, dcam's rows 16-byte aligned.
template <int P>
__device__ __forceinline__ void render_frames(const RenderConsts& rc, int S, int C, int G, int ne,
                                              const float* cam_s, int cam_stride,
                                              const float* pre_s, const float* __restrict__ dcam,
                                              int hw, uint8_t* frame_s, uint8_t* out) {
  static_assert(P >= 1 && 64 % P == 0, "a thread's pixels stay inside one patch");
  const int pcols = pre_cols(S, C, G);
  for (int i = threadIdx.x; i < ne * hw / P; i += blockDim.x) {
    const int p = i * P, e = p / hw, q = p - e * hw;
    float cx[P], cy[P], cz[P];
    load_row<P>(dcam + q, cx);
    load_row<P>(dcam + hw + q, cy);
    load_row<P>(dcam + 2 * hw + q, cz);
    uint32_t lev[P];
    render_levels<P>(rc, S, C, G, cam_s + e * cam_stride, pre_s + e * pcols, cx, cy, cz, lev);
    store_levels<P>(frame_s + p, lev);
    if (out) store_levels<P>(out + p, lev);
  }
}

// Camera pose from the drone state s (position s[0..2], quaternion s[6..9];
// components.py:501-503): cam_R = R mount, cam_pos = p + R rel, into
// cam[0..11]. mount is the row-major mount rotation, rel the camera
// position on the frame.
__device__ __forceinline__ void camera_pose(const float mount[9], const float rel[3],
                                            const float s[], float cam[12]) {
  const float qw = s[6], qx = s[7], qy = s[8], qz = s[9];
  float B[9];  // the body rotation R, row major
  B[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  B[1] = 2.0f * (qx * qy - qz * qw);
  B[2] = 2.0f * (qx * qz + qy * qw);
  B[3] = 2.0f * (qx * qy + qz * qw);
  B[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  B[5] = 2.0f * (qy * qz - qx * qw);
  B[6] = 2.0f * (qx * qz - qy * qw);
  B[7] = 2.0f * (qy * qz + qx * qw);
  B[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cam[3 + 3 * r + c] =
          B[3 * r] * mount[c] + B[3 * r + 1] * mount[3 + c] + B[3 * r + 2] * mount[6 + c];
    cam[r] = s[r] + B[3 * r] * rel[0] + B[3 * r + 1] * rel[1] + B[3 * r + 2] * rel[2];
  }
}

// The pixel rectangle [u0, u1] x [v0, v1] (inclusive; empty where u0 > u1
// or v0 > v1) that holds every pixel a sphere (t, r) can light in a frame
// of width x height rendered from cam (empty for a sphere wholly behind
// the camera, or across its plane and outside the frame's cone), and
// whether it is the full-frame fallback (a sphere across the camera plane
// that reaches into the cone). cone is frame_cone's; (ku, ks, kcu, kv, kcv)
// are the rig's K entries K00, K01, K02, K11, K12: pixel (u, v) =
// K (X, Y, 1) for the camera-frame ray (X, Y, 1).
// ops/vision_kernel.py::target_pixel_box is its plain version, operation
// for operation, and states the geometry.
struct PixelBox {
  int u0, u1, v0, v1;
  bool full;
};

constexpr float kBoxZEps = 0.05f;     // m: a sphere this near the camera plane, no tangent cone
constexpr float kBoxPad = 2.0f;       // pixels on each side, against float32 rounding
constexpr float kConeMargin = 1.05f;  // on the frame's cone, against float32 rounding

// tan of the half-angle of a cone about the optical axis that holds every
// pixel ray (X, Y, 1) of the frame [0, width] x [0, height] through K.
__device__ __forceinline__ float frame_cone(float ku, float ks, float kcu, float kv, float kcv,
                                            int width, int height) {
  const float ym = fmaxf(kcv, static_cast<float>(height) - kcv) / kv;
  const float xm = (fmaxf(kcu, static_cast<float>(width) - kcu) + fabsf(ks) * ym) / ku;
  return sqrtf(xm * xm + ym * ym);
}

__device__ __forceinline__ int box_index(float x, int edge, bool lo) {
  x = lo ? floorf(x - 0.5f) - kBoxPad : ceilf(x - 0.5f) + kBoxPad;
  return static_cast<int>(fminf(fmaxf(x, -1.0f), static_cast<float>(edge)));
}

__device__ __forceinline__ PixelBox target_pixel_box(const float cam[12], float tx, float ty,
                                                     float tz, float r, float ku, float ks,
                                                     float kcu, float kv, float kcv, float cone,
                                                     int width, int height) {
  const float ex = tx - cam[0], ey = ty - cam[1], ez = tz - cam[2];
  const float* R = cam + 3;
  const float cx = R[0] * ex + R[3] * ey + R[6] * ez;
  const float cy = R[1] * ex + R[4] * ey + R[7] * ez;
  const float cz = R[2] * ex + R[5] * ey + R[8] * ez;
  const float zm = cz - r;
  if (cz + r < -kBoxZEps) return PixelBox{0, -1, 0, -1, false};  // wholly behind: no pixel
  if (!(zm > kBoxZEps)) {
    // across the camera plane: no pixel where the sphere stays outside the
    // frame's cone (its points with z > 0 lie >= rho - r off the axis and
    // at z <= c.z + r), else the full frame
    const float reach = r + kConeMargin * cone * (cz + r + kBoxZEps);
    if (cx * cx + cy * cy > reach * reach) return PixelBox{0, -1, 0, -1, false};
    return PixelBox{0, width - 1, 0, height - 1, true};
  }
  const float den = zm * (cz + r);
  const float inv = 1.0f / den;
  const float qx = sqrtf(cx * cx + den);
  const float qy = sqrtf(cy * cy + den);
  const float xlo = (cx * cz - r * qx) * inv, xhi = (cx * cz + r * qx) * inv;
  const float ylo = (cy * cz - r * qy) * inv, yhi = (cy * cz + r * qy) * inv;
  const float slo = fminf(ks * ylo, ks * yhi), shi = fmaxf(ks * ylo, ks * yhi);
  return PixelBox{max(box_index(ku * xlo + slo + kcu, width, true), 0),
                  min(box_index(ku * xhi + shi + kcu, width, false), width - 1),
                  max(box_index(kv * ylo + kcv, height, true), 0),
                  min(box_index(kv * yhi + kcv, height, false), height - 1), false};
}

}  // namespace fpyv
