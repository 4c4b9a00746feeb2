// Nearest-hit ray math of the depth renderers: one pixel's ray against
// spheres, vertical cylinders, the ground plane and shaped gate frames.
//
// Follows fpyv_tpu/ops/pallas_vision.py:_render_tiles and _encode_levels
// operation by operation (built with --fmad=false, no fast math), so a
// kernel's levels equal the plain PyTorch version's. Shared by K5 (the
// batched render), K6 (the chase render of the target alone) and K7 (the
// policy rollout, which renders the full world inside its step).
//
// Camera: cam[0..2] position, cam[3..11] the camera-to-world rotation, row
// major. The pixel's camera-frame direction (dx, dy, dz) comes from the
// rig's ray grid (z = 1), so the hit's camera depth is t.
#pragma once

#include <cuda_runtime.h>

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

// Open vertical tube with base z0 and height h: the near wall, else the far
// wall where the near one misses the band (pallas_vision.py:215-220).
__device__ __forceinline__ float hit_cylinder(const WorldRay& r, float cx, float cy, float z0,
                                              float rad, float h, bool active) {
  const float a2 = r.dx * r.dx + r.dy * r.dy;
  const float safe_a = fabsf(a2) > 1e-20f ? a2 : 1e-20f;
  const float ox = r.px - cx, oy = r.py - cy;
  const float b = ox * r.dx + oy * r.dy;
  const float c = ox * ox + oy * oy - rad * rad;
  const float disc = b * b - a2 * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  bool hit_any = false;
  float t_cyl = kBig;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float t = (-b + (k == 0 ? -sq : sq)) / safe_a;
    const float zhit = r.pz + t * r.dz;
    const bool ok = disc >= 0.0f && t > 0.0f && zhit >= z0 && zhit <= z0 + h;
    if (ok && !hit_any) t_cyl = t;
    hit_any = hit_any || ok;
  }
  return (hit_any && active) ? t_cyl : kBig;
}

// Ground plane z = 0, optionally clipped to |x|, |y| <= extent.
__device__ __forceinline__ float hit_ground(const WorldRay& r, bool has_ground, bool clip,
                                            float extent) {
  const float safe = fabsf(r.dz) > 1e-20f ? r.dz : 1e-20f;
  const float t = -r.pz / safe;
  bool ok = t > 0.0f && fabsf(r.dz) > 1e-20f && has_ground;
  if (clip) {
    const float hx = r.px + t * r.dx;
    const float hy = r.py + t * r.dy;
    ok = ok && fabsf(hx) <= extent && fabsf(hy) <= extent;
  }
  return ok ? t : kBig;
}

__device__ __forceinline__ float mask(bool b) { return b ? 1.0f : 0.0f; }

// Gate frame: g = [pos(3) normal(3) ey(3) ez(3) size active shape]. The
// shape dispatch stays the Pallas kernel's one-hot arithmetic
// (pallas_vision.py:257-274): 0 square band, 1 ring, 2 upper arc + chord.
__device__ __forceinline__ float hit_gate(const WorldRay& r, const float* g, float fw) {
  const float gx = g[0], gy = g[1], gz = g[2];
  const float ndotd = g[3] * r.dx + g[4] * r.dy + g[5] * r.dz;
  const float ndot0 = g[3] * (gx - r.px) + g[4] * (gy - r.py) + g[5] * (gz - r.pz);
  const float safe = fabsf(ndotd) > 1e-20f ? ndotd : 1e-20f;
  const float t = ndot0 / safe;
  const float hx = r.px + t * r.dx - gx;
  const float hy = r.py + t * r.dy - gy;
  const float hz = r.pz + t * r.dz - gz;
  const float ly = g[6] * hx + g[7] * hy + g[8] * hz;
  const float lz = g[9] * hx + g[10] * hy + g[11] * hz;
  const float s = g[12];
  const float half = s * 0.5f;
  const float m_rect = mask(fabsf(fmaxf(fabsf(ly), fabsf(lz)) - half) <= fw);
  const float rr = sqrtf(ly * ly + lz * lz);
  const float m_circ = mask(fabsf(rr - half) <= fw);
  const float cz = lz + half;
  const float ra = sqrtf(ly * ly + cz * cz);
  const float m_arc = mask(fabsf(ra - s) <= fw && cz >= -fw);
  const float m_chord = mask(fabsf(cz) <= fw && fabsf(ly) <= s + fw);
  const float m_half = fmaxf(m_arc, m_chord);
  const float sel_circ = mask(g[14] == 1.0f);
  const float sel_half = mask(g[14] == 2.0f);
  const float m_frame =
      sel_circ * m_circ + sel_half * m_half + (1.0f - sel_circ - sel_half) * m_rect;
  const bool ok = t > 0.0f && m_frame > 0.5f && fabsf(ndotd) > 1e-20f && g[13] > 0.5f;
  return ok ? t : kBig;
}

// The uint8 depth level floor(255 (1 - t / max)), clipped to [0, 255], as
// an integer-valued float (pallas_policy.py:267-269).
__device__ __forceinline__ float depth_level(float t, float max_depth) {
  const float tc = fminf(t, max_depth);
  const float lev = floorf(255.0f * (1.0f - tc / max_depth));
  return fminf(fmaxf(lev, 0.0f), 255.0f);
}

// Depth level as a float in [0, 1]: floor(255 (1 - t / max)) / 255, with the
// clip of _encode_levels.
__device__ __forceinline__ float encode_level(float t, float max_depth) {
  return depth_level(t, max_depth) * (1.0f / 255.0f);
}

// Field order must match RenderConfig.as_array() in ops/vision_kernel.py.
struct RenderConsts {
  float n_spheres, n_cylinders, n_gates;
  float spheres, cylinders, ground, gates;  // 1.0 where included
  float max_depth;
  float clip_ground, ground_extent;
  float frame_width;
};

// Nearest t over the world columns w of one env (layout of
// pallas_vision.py:_world_cols): spheres s*5 + [cx cy cz r active],
// cylinders 5S + c*6 + [cx cy cz r h active], gates 5S + 6C + g*15 + [...],
// ground last.
__device__ __forceinline__ float render_t(const RenderConsts& rc, int S, int C, int G,
                                          const WorldRay& r, const float* w) {
  float t_min = kBig;
  if (rc.spheres > 0.5f) {
    const float a = ray_a(r);
    for (int s = 0; s < S; ++s) {
      const float* q = w + 5 * s;
      t_min = fminf(t_min, hit_sphere(r, a, q[0], q[1], q[2], q[3], q[4] > 0.5f));
    }
  }
  if (rc.cylinders > 0.5f) {
    for (int c = 0; c < C; ++c) {
      const float* q = w + 5 * S + 6 * c;
      t_min = fminf(t_min, hit_cylinder(r, q[0], q[1], q[2], q[3], q[4], q[5] > 0.5f));
    }
  }
  const float* gates = w + 5 * S + 6 * C;
  if (rc.ground > 0.5f) {
    t_min = fminf(t_min, hit_ground(r, gates[15 * G] > 0.5f, rc.clip_ground > 0.5f,
                                    rc.ground_extent));
  }
  if (rc.gates > 0.5f) {
    for (int g = 0; g < G; ++g) t_min = fminf(t_min, hit_gate(r, gates + 15 * g, rc.frame_width));
  }
  return t_min;
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

}  // namespace fpyv
