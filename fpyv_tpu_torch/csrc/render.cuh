// Nearest-hit ray math of the depth renderers: one pixel's ray against
// spheres, vertical cylinders, the ground plane and shaped gate frames.
//
// Follows fpyv_tpu/ops/pallas_vision.py:_render_tiles and _encode_levels
// operation by operation (built with --fmad=false, no fast math), so a
// kernel's levels equal the plain PyTorch version's. render_t and the hit
// functions are shared by K6 (the chase render of the target alone, over
// the target's pixel box), K7 and K8 (the policy rollouts, which render the
// full world inside their step); K5 (the batched render) runs render_t_pre
// over a per-env table of the same invariants.
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

// ---------------------------------------------------------------------------
// The batched render (K5) with each env's invariants hoisted: a block
// computes, once per env, what render_t recomputes at every pixel, into a
// per-env table (render_invariants), and each pixel reads it (render_t_pre).
// The hoisted values are the same operations in the same order as in
// hit_sphere, hit_cylinder and hit_gate, and a primitive that cannot hit
// skips only arithmetic whose result its mask would discard, so the levels
// equal render_t's bit for bit.
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

// hit_sphere over a hoisted (ox, oy, oz, c, active): a miss (disc < 0) or
// an inactive sphere returns before the root and its divisions.
__device__ __forceinline__ float hit_sphere_pre(const WorldRay& r, float a, const float* q) {
  if (!(q[4] > 0.5f)) return kBig;
  const float b = q[0] * r.dx + q[1] * r.dy + q[2] * r.dz;
  const float disc = b * b - a * q[3];
  if (!(disc >= 0.0f)) return kBig;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-b - sq) / a;
  if (!(t > 0.0f)) t = (-b + sq) / a;
  return t > 0.0f ? t : kBig;
}

// hit_cylinder over a hoisted (ox, oy, c, z0, z0 + h, active), with the
// pixel's a2 and safe_a: the far wall only where the near one misses.
__device__ __forceinline__ float hit_cylinder_pre(const WorldRay& r, float a2, float safe_a,
                                                  const float* q) {
  if (!(q[5] > 0.5f)) return kBig;
  const float b = q[0] * r.dx + q[1] * r.dy;
  const float disc = b * b - a2 * q[2];
  if (!(disc >= 0.0f)) return kBig;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float t = (-b + (k == 0 ? -sq : sq)) / safe_a;
    const float zhit = r.pz + t * r.dz;
    if (t > 0.0f && zhit >= q[3] && zhit <= q[4]) return t;
  }
  return kBig;
}

// hit_gate over its columns and hoisted ndot0: an inactive gate, a ray
// parallel to its plane or a plane behind the camera returns before the
// frame test, and only the gate's own shape is tested (the one-hot sum of
// hit_gate equals the selected 0/1 mask).
__device__ __forceinline__ float hit_gate_pre(const WorldRay& r, const float* g, float fw) {
  if (!(g[13] > 0.5f)) return kBig;
  const float ndotd = g[3] * r.dx + g[4] * r.dy + g[5] * r.dz;
  if (!(fabsf(ndotd) > 1e-20f)) return kBig;
  const float t = g[15] / ndotd;
  if (!(t > 0.0f)) return kBig;
  const float hx = r.px + t * r.dx - g[0];
  const float hy = r.py + t * r.dy - g[1];
  const float hz = r.pz + t * r.dz - g[2];
  const float ly = g[6] * hx + g[7] * hy + g[8] * hz;
  const float lz = g[9] * hx + g[10] * hy + g[11] * hz;
  const float s = g[12];
  const float half = s * 0.5f;
  bool hit;
  if (g[14] == 1.0f) {
    hit = fabsf(sqrtf(ly * ly + lz * lz) - half) <= fw;
  } else if (g[14] == 2.0f) {
    const float cz = lz + half;
    hit = (fabsf(sqrtf(ly * ly + cz * cz) - s) <= fw && cz >= -fw) ||
          (fabsf(cz) <= fw && fabsf(ly) <= s + fw);
  } else {
    hit = fabsf(fmaxf(fabsf(ly), fabsf(lz)) - half) <= fw;
  }
  return hit ? t : kBig;
}

// render_t over an env's invariant table pre (render_invariant).
__device__ __forceinline__ float render_t_pre(const RenderConsts& rc, int S, int C, int G,
                                              const WorldRay& r, const float* pre) {
  float t_min = kBig;
  if (rc.spheres > 0.5f) {
    const float a = ray_a(r);
    for (int s = 0; s < S; ++s) t_min = fminf(t_min, hit_sphere_pre(r, a, pre + kPreSphere * s));
  }
  const float* cyl = pre + kPreSphere * S;
  if (rc.cylinders > 0.5f) {
    const float a2 = r.dx * r.dx + r.dy * r.dy;
    const float safe_a = fabsf(a2) > 1e-20f ? a2 : 1e-20f;
    for (int c = 0; c < C; ++c)
      t_min = fminf(t_min, hit_cylinder_pre(r, a2, safe_a, cyl + kPreCylinder * c));
  }
  const float* gates = cyl + kPreCylinder * C;
  if (rc.ground > 0.5f) {
    t_min = fminf(t_min, hit_ground(r, gates[kPreGate * G] > 0.5f, rc.clip_ground > 0.5f,
                                    rc.ground_extent));
  }
  if (rc.gates > 0.5f) {
    for (int g = 0; g < G; ++g)
      t_min = fminf(t_min, hit_gate_pre(r, gates + kPreGate * g, rc.frame_width));
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
