// The patch actor of the policy-in-kernel rollouts (K7, K8), written by hand:
// patch embed (kp levels -> 128) + ReLU, the optional pooled mixer
// (pool*128 -> 128) + ReLU, fc (NP/pool*128 + proprio -> hidden) + ReLU, and
// the float32 mean and value heads. Two versions: the bf16 instantiations
// run the embed and the fc on the tensor cores (the second half of this
// file); the float32 instantiations run the CUDA-core actor below, summed in
// the plain version's order, as the exact check.
//
// The CUDA-core actor: the 256 actor threads of a block (which owns E envs)
// run one patch group (pool consecutive patches) at a time: the group's
// embeddings of the E envs go to shared memory and thread h adds the
// group's 128 fc rows into its E float32 accumulators of hidden unit h, so
// the (E, NP*128) fc input never exists and the fc weights stream from L2 once a block and step.
// Any fc width: thread h also owns units h + 256, h + 512, ..., whose
// accumulators live in h_s (E, hidden), which is free until the heads
// (fc_group_wide, heads_wide; the kWide instantiations only). Its
// products accumulate in row order by multiply then add (built with
// --fmad=false), as ops/policy_kernel.py::policy_forward_reference does, so
// kernel and plain version agree bit for bit.
//
// Rounding in bf16 (the tensor-core actor, and the heads' fc epilogue, which
// both versions share) follows Flax's Dense(dtype=bf16) and the Pallas
// kernels: float32 sums rounded to bf16, the bias added in bf16, ReLU; the
// input is bf16(level / 255.0f) by true division (a 256-entry table). A bf16
// product is exact in float32, so a bf16 accumulation on the CUDA cores uses
// an explicit fma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "clock.cuh"

namespace fpyv {

constexpr int kActorThreads = 256;
// Threads of a K7 or K8 block: the actor's kActorThreads (warps 0-7) and as
// many more that only render (csrc/render.cuh), 16 warps an SM for the
// render; they wait at the block's barrier while the actor runs.
constexpr int kRolloutThreads = 2 * kActorThreads;

// The barrier of the actor's threads, named barrier 1 of kActorThreads:
// the actor syncs without the render-only warps (a block of kActorThreads
// threads syncs whole).
__device__ __forceinline__ void actor_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kActorThreads) : "memory");
}

constexpr int kPatch = 64;  // levels of an 8x8 patch
constexpr int kEmbed = 128;

__device__ __forceinline__ float wload(const float* p) { return __ldg(p); }

__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Rounding to the compute type (identity in float32).
template <bool kBF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// acc + x w. In bf16 both factors carry 8 significant bits, so the product
// is exact and one fma rounds as multiply-then-add does.
template <bool kBF16>
__device__ __forceinline__ float madd(float acc, float x, float w) {
  if constexpr (kBF16) {
    return __fmaf_rn(x, w, acc);
  } else {
    return acc + x * w;
  }
}

// The phases of a step that the instrumented instantiations time.
enum Phase { kPhRender = 0, kPhStack, kPhEmbed, kPhFc, kPhHeads, kPhStep, kPhases };

// The actor's clock (csrc/clock.cuh) over these phases.
template <bool kTimed>
using ActorClock = PhaseClock<kTimed, kPhases>;

// The level table: lut[j] = rnd(j / 255.0f), filled block-strided.
template <bool kBF16>
__device__ __forceinline__ void fill_level_table(float* lut) {
  for (int j = threadIdx.x; j < 256; j += blockDim.x) lut[j] = rnd<kBF16>(static_cast<float>(j) / 255.0f);
}

// The units a block's threads do not cover (hidden > 256) are the wide
// path: thread t also owns units t + 256, t + 512, ..., whose E sums wait in
// h_s (E, hidden) between groups. Only the kWide instantiations compile it
// (the kernels' generic one), so the quad's 256-wide actor keeps the code
// and registers it had.

// Group g's 128 fc rows into the wide units' sums in h_s (zero at g = 0),
// in the order of a thread's own unit.
template <int E>
__device__ __forceinline__ void fc_group_wide(const float* wf, int hidden, int g,
                                           const float* fcin_s, float* h_s) {
  for (int u = threadIdx.x + kActorThreads; u < hidden; u += kActorThreads) {
    const float* wrow = wf + static_cast<size_t>(g) * kEmbed * hidden + u;
    float a[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = g == 0 ? 0.0f : h_s[e * hidden + u];
    for (int i = 0; i < kEmbed; ++i) {
      const float w = wload(wrow + static_cast<size_t>(i) * hidden);
      const float* x = fcin_s + i * E;
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = a[e] + x[e] * w;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) h_s[e * hidden + u] = a[e];
  }
}

// The wide units' proprio rows, bias and ReLU, from their sums in h_s to
// their outputs there (actor_heads' epilogue).
template <typename W, bool kBF16, int E>
__device__ __forceinline__ void heads_wide(const W* wf, const W* bfc, int hidden, int row0,
                                        const float* prop_s, int prop_stride, int n_prop,
                                        float* h_s) {
  for (int u = threadIdx.x + kActorThreads; u < hidden; u += kActorThreads) {
    const W* wrow = wf + static_cast<size_t>(row0) * hidden + u;
    float a[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = h_s[e * hidden + u];
    for (int i = 0; i < n_prop; ++i) {
      const float w = wload(wrow + static_cast<size_t>(i) * hidden);
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = madd<kBF16>(a[e], rnd<kBF16>(prop_s[e * prop_stride + i]), w);
    }
    const float b = wload(bfc + u);
#pragma unroll
    for (int e = 0; e < E; ++e) h_s[e * hidden + u] = fmaxf(rnd<kBF16>(rnd<kBF16>(a[e]) + b), 0.0f);
  }
}

// Patch group g of the float32 actor for E envs. The levels of patch j of
// the group for env e are px + e * env_stride + j * patch_stride (kp of them,
// the embed's contraction, a multiple of 64; strides multiples of 4 bytes).
// fcin_s (128, E) receives the group's fc input, emb_s (E * pool, 128) holds
// the embeddings when pool > 1; thread tid < hidden adds the group's fc rows
// into acc, and those of its units tid + 256 j (j >= 1) into h_s (E,
// hidden). Every actor thread calls it; it ends synchronised.
//
// The embed: thread tid computes output o = tid % 128 of four rows (row r =
// e * pool + j) at a time, r0, r0 + 2, r0 + 4, r0 + 6, so each weight it
// loads serves four rows, and reads the levels four at a time as 32-bit
// words; each row still sums its products in row order.
template <int E, bool kWide, class Clock>
__device__ __forceinline__ void actor_group(const float* lut, const uint8_t* px, int env_stride,
                                            int patch_stride, int kp, const float* we,
                                            const float* be, const float* wp, const float* bp,
                                            const float* wf, int hidden, int g, int pool,
                                            float* fcin_s, float* emb_s, float acc[E],
                                            float* h_s, Clock& clk) {
  static_assert(kActorThreads == 2 * kEmbed && E % 4 == 0, "two rows per output a pass");
  const int tid = threadIdx.x;
  const int o = tid & (kEmbed - 1);
  for (int r0 = tid >> 7; r0 < E * pool; r0 += 8) {
    const uint8_t* x[4];
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 2 * i, e = r / pool, j = r - e * pool;
      x[i] = px + e * env_stride + j * patch_stride;
      a[i] = 0.0f;
    }
    for (int k0 = 0; k0 < kp; k0 += kPatch) {  // a frame's 64 levels at a time
      const float* w0 = we + k0 * kEmbed + o;
#pragma unroll
      for (int k4 = 0; k4 < kPatch; k4 += 4) {
        uint32_t q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const uint32_t*>(x[i] + k0 + k4);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float w = wload(w0 + (k4 + b) * kEmbed);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = a[i] + lut[(q[i] >> (8 * b)) & 255u] * w;
        }
      }
    }
    const float bias = wload(be + o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 2 * i;
      const float v = fmaxf(a[i] + bias, 0.0f);
      if (pool == 1) {
        fcin_s[o * E + r] = v;
      } else {
        emb_s[r * kEmbed + o] = v;
      }
    }
  }
  actor_sync();
  clk.mark(kPhEmbed);
  if (pool > 1) {  // pooled mixer over the group's concatenated embeddings
    for (int idx = tid; idx < E * kEmbed; idx += kActorThreads) {
      const int o = idx & (kEmbed - 1), e = idx >> 7;
      const float* x = emb_s + e * pool * kEmbed;
      float a = 0.0f;
      for (int i = 0; i < pool * kEmbed; ++i) a = a + x[i] * wload(wp + i * kEmbed + o);
      fcin_s[o * E + e] = fmaxf(a + wload(bp + o), 0.0f);
    }
    actor_sync();
    clk.mark(kPhEmbed);
  }
  if (tid < hidden) {  // the group's 128 fc rows into hidden unit tid
    const float* wrow = wf + static_cast<size_t>(g) * kEmbed * hidden + tid;
    for (int i = 0; i < kEmbed; ++i) {
      const float w = wload(wrow + static_cast<size_t>(i) * hidden);
      const float* x = fcin_s + i * E;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] + x[e] * w;
    }
  }
  if constexpr (kWide) fc_group_wide<E>(wf, hidden, g, fcin_s, h_s);
  actor_sync();
  clk.mark(kPhFc);
}

// After the last group: the n_prop proprio rows (fc rows from row0 on; env
// e's values at prop_s + e * prop_stride), the bias and ReLU into h_s (E,
// hidden), then the float32 heads into mm_s (E, 8): cols 0:4 the mean, 4
// the value. Units tid + 256 j (j >= 1) take their sums from h_s and leave
// their outputs there. Every actor thread calls it; it ends synchronised.
template <typename W, bool kBF16, int E, bool kWide, class Clock>
__device__ __forceinline__ void actor_heads(const W* wf, const W* bfc, int hidden, int row0,
                                            const float* prop_s, int prop_stride, int n_prop,
                                            float acc[E], float* h_s, const float* wm,
                                            const float* bm, float* mm_s, Clock& clk) {
  const int tid = threadIdx.x;
  if (tid < hidden) {
    const W* wrow = wf + static_cast<size_t>(row0) * hidden + tid;
    for (int i = 0; i < n_prop; ++i) {
      const float w = wload(wrow + static_cast<size_t>(i) * hidden);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = madd<kBF16>(acc[e], rnd<kBF16>(prop_s[e * prop_stride + i]), w);
    }
    const float b = wload(bfc + tid);
#pragma unroll
    for (int e = 0; e < E; ++e) h_s[e * hidden + tid] = fmaxf(rnd<kBF16>(rnd<kBF16>(acc[e]) + b), 0.0f);
  }
  if constexpr (kWide)
    heads_wide<W, kBF16, E>(wf, bfc, hidden, row0, prop_s, prop_stride, n_prop, h_s);
  actor_sync();
  if (tid < E * 5) {
    const int e = tid / 5, col = tid - 5 * (tid / 5);
    const float* h = h_s + e * hidden;
    float a = 0.0f;
    for (int j = 0; j < hidden; ++j) a = a + h[j] * wm[j * 8 + col];
    mm_s[e * 8 + col] = a + bm[col];
  }
  actor_sync();
  clk.mark(kPhHeads);
}

// ---------------------------------------------------------------------------
// The bf16 actor on the tensor cores (the bf16 instantiations of K7 and K8,
// the trainers' path; the float32 instantiations keep the CUDA-core actor
// above as the exact check).
//
// mma.sync.m16n8k16 (bf16 in, float32 sums), not wgmma: a block owns 8 envs,
// which is exactly mma.sync's N = 8, while wgmma's 64-row tiles and its
// shared-memory descriptors would buy nothing at these sizes (the products
// are 0.3-0.5 ms of a launch at the tensor-core rate; feeding them is what
// costs). Both products are computed transposed, so that N is the envs and
// each warp owns 16 output rows:
//
// - embed, per patch p: D(o, env) = weT(o, kp) . levels(kp, env), warp w the
//   16 channels o = 16w..16w+15. weT lives in shared memory for the whole
//   launch (128 x (kp + 8) bf16, loaded once), the levels of a batch of PB
//   patches are a bf16 tile (PB, 8 envs, kp + 8) filled through the level
//   table; both reach the fragments by ldmatrix. Epilogue as Flax's
//   Dense(dtype=bf16): round the sum to bf16, add the bias in bf16, ReLU,
//   store bf16 into the fc input tile (E, PB/pool*128 + 8).
// - fc, per batch: D(hidden, env) += wfT(hidden, PB/pool*128) . X(., env),
//   warp w the hidden tiles w and w + 8 (16 rows each) in registers, and at
//   hidden > 256 (kWide) the tiles w + 16, w + 24, ... too, two at a time,
//   whose sums wait in h_s between batches. Its A fragments come
//   straight from device memory (L2) in the fragment order that
//   ops/policy_kernel.py::fragment_order_fc lays out once per rollout: one
//   16-byte load a lane per mma, the warp's 512 bytes contiguous, four
//   k-tiles of the next loads in flight while four are multiplied. The fc
//   weights (7.1 MB) cannot stay on the SM, so every block still streams
//   them from L2 once a step; the 8 envs a block keep that stream at 7.1 MB
//   a block and step.
// - the pooled mixer (pool > 1) stays on the CUDA cores, reading the bf16
//   embeddings (E, PB*128 + 8).
//
// A batch of PB patches costs two barriers (three with the mixer): fill the
// levels tile | embed | fc, with the next batch's fill after the fc.
// Padding every row by 8 bf16 (16 bytes) puts the 8 rows that one ldmatrix
// reads in 8 different 16-byte bank groups.
// ---------------------------------------------------------------------------

constexpr int kRowPad = 8;  // bf16 elements of padding a tile row

// The tiles of the tensor-core actor in shared memory (see above).
struct TcTiles {
  __nv_bfloat16* we;  // (128, kp + 8) the embed weights, transposed
  __nv_bfloat16* xe;  // (pb, E, kp + 8) a batch's levels
  __nv_bfloat16* xf;  // (E, pb / pool * 128 + 8) a batch's fc input
  __nv_bfloat16* xm;  // (E, pb * 128 + 8) a batch's embeddings when pool > 1
  int kp, pb, pool;
};

// bf16 elements of the tiles (the launchers size shared memory with it).
__host__ __device__ inline size_t tc_tile_elems(int E, int kp, int pb, int pool) {
  const size_t xs = static_cast<size_t>(kp + kRowPad);
  return kEmbed * xs + static_cast<size_t>(pb) * E * xs +
         static_cast<size_t>(E) * (pb / pool * kEmbed + kRowPad) +
         (pool > 1 ? static_cast<size_t>(E) * (pb * kEmbed + kRowPad) : 0);
}

// Carves the tiles out of shared memory from base (16-byte aligned).
template <int E>
__device__ __forceinline__ TcTiles tc_tiles(void* base, int kp, int pb, int pool) {
  TcTiles t;
  t.kp = kp;
  t.pb = pb;
  t.pool = pool;
  t.we = static_cast<__nv_bfloat16*>(base);
  t.xe = t.we + kEmbed * (kp + kRowPad);
  t.xf = t.xe + pb * E * (kp + kRowPad);
  t.xm = pool > 1 ? t.xf + E * (pb / pool * kEmbed + kRowPad) : t.xf;
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += A (16x16 bf16, row) . B (16x8 bf16, col), float32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {  // x already a bf16 value
  return __float_as_uint(x) >> 16;
}

// 16 levels (one 16-byte word) -> 16 bf16 policy inputs at dst (16-byte
// aligned), through the table lut[j] = bf16(j / 255.0f).
__device__ __forceinline__ void levels_to_bf16(const float* lut, uint4 v, __nv_bfloat16* dst) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lo = (w[i] >> (16 * h)) & 255u, hi = (w[i] >> (16 * h + 8)) & 255u;
      o[2 * i + h] = bf16_bits(lut[lo]) | (__float_as_uint(lut[hi]) & 0xffff0000u);
    }
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// we (kp, 128) bf16 in device memory -> t.we (128, kp + 8), once a launch.
// Every thread calls it; the caller synchronises.
__device__ __forceinline__ void tc_load_we(const __nv_bfloat16* we, const TcTiles& t) {
  for (int idx = threadIdx.x; idx < t.kp * kEmbed; idx += blockDim.x) {
    const int k = idx >> 7, o = idx & (kEmbed - 1);
    t.we[o * (t.kp + kRowPad) + k] = we[idx];
  }
}

// The embed of a batch (levels in t.xe) into the fc input t.xf, through the
// pooled mixer when pool > 1. Every actor thread calls it; it ends synchronised.
template <int E>
__device__ __forceinline__ void tc_embed(const TcTiles& t, const __nv_bfloat16* be,
                                         const __nv_bfloat16* wp, const __nv_bfloat16* bp) {
  static_assert(E == 8, "the envs of a block are the mma's N = 8");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int o0 = warp * 16;  // 8 warps x 16 channels
  const int xs = t.kp + kRowPad;
  const uint32_t a_base = smem_u32(t.we + (o0 + (lane & 15)) * xs + (lane >> 4) * 8);
  const uint32_t b_base = smem_u32(t.xe + (lane & 7) * xs + (lane >> 3) * 8);
  const float bias_lo = wload(be + o0 + g), bias_hi = wload(be + o0 + g + 8);
  const int ds = t.pool > 1 ? t.pb * kEmbed + kRowPad : t.pb / t.pool * kEmbed + kRowPad;
  __nv_bfloat16* dst = t.pool > 1 ? t.xm : t.xf;
  for (int p = 0; p < t.pb; ++p) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint32_t bpatch = b_base + static_cast<uint32_t>(p * E * xs * 2);
    for (int k = 0; k < t.kp; k += 32) {
      uint32_t a[8], b[4];
      ldsm_x4(a_base + k * 2, a[0], a[1], a[2], a[3]);
      ldsm_x4(a_base + (k + 16) * 2, a[4], a[5], a[6], a[7]);
      ldsm_x4(bpatch + k * 2, b[0], b[1], b[2], b[3]);
      mma_bf16(d, a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(d, a[4], a[5], a[6], a[7], b[2], b[3]);
    }
    // d: (o0 + g, env 2tq), (o0 + g, 2tq + 1), (o0 + g + 8, 2tq), (o0 + g + 8, 2tq + 1)
    __nv_bfloat16* out = dst + (2 * tq) * ds + p * kEmbed + o0 + g;
    out[0] = __float2bfloat16_rn(fmaxf(rnd<true>(rnd<true>(d[0]) + bias_lo), 0.0f));
    out[ds] = __float2bfloat16_rn(fmaxf(rnd<true>(rnd<true>(d[1]) + bias_lo), 0.0f));
    out[8] = __float2bfloat16_rn(fmaxf(rnd<true>(rnd<true>(d[2]) + bias_hi), 0.0f));
    out[ds + 8] = __float2bfloat16_rn(fmaxf(rnd<true>(rnd<true>(d[3]) + bias_hi), 0.0f));
  }
  actor_sync();
  if (t.pool > 1) {  // pooled mixer over each group's concatenated embeddings (CUDA cores)
    const int ngb = t.pb / t.pool, gk = t.pool * kEmbed;
    const int xfs = ngb * kEmbed + kRowPad;
    for (int idx = threadIdx.x; idx < E * ngb * kEmbed; idx += kActorThreads) {
      const int o = idx & (kEmbed - 1), r = idx >> 7, gl = r % ngb, e = r / ngb;
      const __nv_bfloat16* x = t.xm + e * ds + gl * gk;
      float a = 0.0f;
      for (int i = 0; i < gk; ++i)
        a = madd<true>(a, __bfloat162float(x[i]), wload(wp + i * kEmbed + o));
      t.xf[e * xfs + gl * kEmbed + o] =
          __float2bfloat16_rn(fmaxf(rnd<true>(rnd<true>(a) + wload(bp + o)), 0.0f));
    }
    actor_sync();
  }
}

// The nk k-tiles of a batch (B fragments at b_base) for hidden tiles mt and,
// when two, mt + 8 (A fragments from wft, k-tile kt0 on) into acc[0] and
// acc[1].
__device__ __forceinline__ void tc_fc_tiles(const uint4* __restrict__ wft, int mt, bool two,
                                            int kt0, int KT, int nk, uint32_t b_base,
                                            float acc[2][4]) {
  const int lane = threadIdx.x & 31;
  const uint4* p0 = wft + (static_cast<size_t>(mt) * KT + kt0) * 32 + lane;
  const uint4* p1 = wft + (static_cast<size_t>(two ? mt + 8 : mt) * KT + kt0) * 32 + lane;
  uint4 c0[4], c1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] = __ldg(p0 + i * 32);
    c1[i] = two ? __ldg(p1 + i * 32) : c0[i];
  }
  for (int j = 0; j < nk; j += 4) {
    uint4 n0[4], n1[4];
    const bool more = j + 4 < nk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the next four k-tiles in flight
      n0[i] = more ? __ldg(p0 + (j + 4 + i) * 32) : c0[i];
      n1[i] = (more && two) ? __ldg(p1 + (j + 4 + i) * 32) : c1[i];
    }
    uint32_t b[8];
    ldsm_x4(b_base + j * 32, b[0], b[1], b[2], b[3]);
    ldsm_x4(b_base + (j + 2) * 32, b[4], b[5], b[6], b[7]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mma_bf16(acc[0], c0[i].x, c0[i].y, c0[i].z, c0[i].w, b[2 * i], b[2 * i + 1]);
      if (two) mma_bf16(acc[1], c1[i].x, c1[i].y, c1[i].z, c1[i].w, b[2 * i], b[2 * i + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c0[i] = n0[i];
      c1[i] = n1[i];
    }
  }
}

// The fragment's sums of hidden tile mt in h_s (E, hidden): d[0] (row mt *
// 16 + g, env 2tq), d[1] (that row, env 2tq + 1), d[2], d[3] 8 rows down.
__device__ __forceinline__ float* tile_sums(float* h_s, int hidden, int mt, int lane, int i) {
  const int g = lane >> 2, tq = lane & 3;
  return h_s + (2 * tq + (i & 1)) * hidden + mt * 16 + g + (i >> 1) * 8;
}

// The wide path of tc_fc (hidden > 256): this warp's tiles warp + 16,
// warp + 24, ..., two at a time, their sums in h_s between batches (zero at
// kt0 = 0).
__device__ __forceinline__ void tc_fc_wide(const uint4* __restrict__ wft, int kt0, int KT,
                                           int n_mt, int nk, uint32_t b_base, float* h_s,
                                           int hidden) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int mt = warp + 16; mt < n_mt; mt += 16) {
    const bool two = mt + 8 < n_mt;
    float a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[m][i] = kt0 == 0 || (m == 1 && !two) ? 0.0f
                                               : *tile_sums(h_s, hidden, mt + 8 * m, lane, i);
    tc_fc_tiles(wft, mt, two, kt0, KT, nk, b_base, a);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m == 0 || two) *tile_sums(h_s, hidden, mt + 8 * m, lane, i) = a[m][i];
  }
}

// The fc rows of a batch (its fc input in t.xf; global k-tiles kt0 ..
// kt0 + pb / pool * 8 of KT) into acc: acc[m] is hidden tile warp + 8m of
// n_mt; tiles warp + 16, warp + 24, ... sum into h_s (E, hidden) (zero at
// kt0 = 0), where tc_fc_gather finds them. wft is the fragment-order copy
// of the fc's patch rows: (n_mt, KT, 32 lanes, 8) bf16, lane l's 8 values
// its A fragment {a0, a1, a2, a3}. Only kWide takes hidden > 256.
template <bool kWide>
__device__ __forceinline__ void tc_fc(const TcTiles& t, const uint4* __restrict__ wft, int kt0,
                                      int KT, int n_mt, float acc[2][4], float* h_s,
                                      int hidden) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= n_mt) return;
  const int nk = t.pb / t.pool * 8;  // a multiple of 8
  const int xfs = t.pb / t.pool * kEmbed + kRowPad;
  const uint32_t b_base = smem_u32(t.xf + (lane & 7) * xfs + (lane >> 3) * 8);
  tc_fc_tiles(wft, warp, warp + 8 < n_mt, kt0, KT, nk, b_base, acc);  // warp-uniform two
  if constexpr (kWide) tc_fc_wide(wft, kt0, KT, n_mt, nk, b_base, h_s, hidden);
}

// After the last batch: the fc sums into h_s (E, hidden) float32 (tiles
// past the registers' are there already), then each thread tid < hidden
// takes its hidden unit's E sums back into acc (for actor_heads). Every
// actor thread calls it; it ends synchronised.
template <int E>
__device__ __forceinline__ void tc_fc_gather(float acc2[2][4], int n_mt, int hidden,
                                             float* h_s, float acc[E]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = warp + 8 * m;
    if (mt < n_mt) {
      const int h = mt * 16 + g;
      h_s[(2 * tq) * hidden + h] = acc2[m][0];
      h_s[(2 * tq + 1) * hidden + h] = acc2[m][1];
      h_s[(2 * tq) * hidden + h + 8] = acc2[m][2];
      h_s[(2 * tq + 1) * hidden + h + 8] = acc2[m][3];
    }
  }
  actor_sync();
  if (static_cast<int>(threadIdx.x) < hidden) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = h_s[e * hidden + threadIdx.x];
  }
  actor_sync();
}

}  // namespace fpyv
