// The patch actor of the policy-in-kernel rollouts (K7, K8), written by hand
// on the CUDA cores: patch embed (kp levels -> 128) + ReLU, the optional
// pooled mixer (pool*128 -> 128) + ReLU, fc (NP/pool*128 + proprio ->
// hidden) + ReLU, and the float32 mean and value heads.
//
// A block of 256 threads owns E envs. The actor runs one patch group (pool
// consecutive patches) at a time: the group's embeddings of the E envs go to
// shared memory and thread h adds the group's 128 fc rows into its E float32
// accumulators of hidden unit h, so the (E, NP*128) fc input never exists
// and the fc weights stream from L2 once a block and step.
//
// Rounding follows Flax's Dense(dtype=bf16) and the Pallas kernels: float32
// accumulation in row order, rounded to bf16, the bias added in bf16, ReLU;
// the input is bf16(level / 255.0f) by true division (a 256-entry table). A
// bf16 product is exact in float32, so its accumulation uses an explicit
// fma; float32 weights accumulate by multiply then add (built with
// --fmad=false), as ops/policy_kernel.py::policy_forward_reference does, so
// kernel and plain version agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fpyv {

constexpr int kActorThreads = 256;
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

// The level table: lut[j] = rnd(j / 255.0f), filled block-strided.
template <bool kBF16>
__device__ __forceinline__ void fill_level_table(float* lut) {
  for (int j = threadIdx.x; j < 256; j += blockDim.x) lut[j] = rnd<kBF16>(static_cast<float>(j) / 255.0f);
}

// Patch group g of the actor for E envs. The levels of patch j of the group
// for env e are px + e * env_stride + j * patch_stride (kp of them, the
// embed's contraction, a multiple of 64; strides multiples of 4 bytes).
// fcin_s (128, E) receives the group's fc input, emb_s (E * pool, 128) holds
// the embeddings when pool > 1; thread tid < hidden adds the group's fc rows
// into acc. Every thread calls it; it ends synchronised.
//
// The embed: thread tid computes output o = tid % 128 of four rows (row r =
// e * pool + j) at a time, r0, r0 + 2, r0 + 4, r0 + 6, so each weight it
// loads serves four rows, and reads the levels four at a time as 32-bit
// words; each row still sums its products in row order.
template <typename W, bool kBF16, int E>
__device__ __forceinline__ void actor_group(const float* lut, const uint8_t* px, int env_stride,
                                            int patch_stride, int kp, const W* we, const W* be,
                                            const W* wp, const W* bp, const W* wf, int hidden,
                                            int g, int pool, float* fcin_s, float* emb_s,
                                            float acc[E]) {
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
      const W* w0 = we + k0 * kEmbed + o;
#pragma unroll
      for (int k4 = 0; k4 < kPatch; k4 += 4) {
        uint32_t q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const uint32_t*>(x[i] + k0 + k4);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float w = wload(w0 + (k4 + b) * kEmbed);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = madd<kBF16>(a[i], lut[(q[i] >> (8 * b)) & 255u], w);
        }
      }
    }
    const float bias = wload(be + o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 2 * i;
      const float v = fmaxf(rnd<kBF16>(rnd<kBF16>(a[i]) + bias), 0.0f);
      if (pool == 1) {
        fcin_s[o * E + r] = v;
      } else {
        emb_s[r * kEmbed + o] = v;
      }
    }
  }
  __syncthreads();
  if (pool > 1) {  // pooled mixer over the group's concatenated embeddings
    for (int idx = tid; idx < E * kEmbed; idx += kActorThreads) {
      const int o = idx & (kEmbed - 1), e = idx >> 7;
      const float* x = emb_s + e * pool * kEmbed;
      float a = 0.0f;
      for (int i = 0; i < pool * kEmbed; ++i) a = madd<kBF16>(a, x[i], wload(wp + i * kEmbed + o));
      fcin_s[o * E + e] = fmaxf(rnd<kBF16>(rnd<kBF16>(a) + wload(bp + o)), 0.0f);
    }
    __syncthreads();
  }
  if (tid < hidden) {  // the group's 128 fc rows into hidden unit tid
    const W* wrow = wf + static_cast<size_t>(g) * kEmbed * hidden + tid;
    for (int i = 0; i < kEmbed; ++i) {
      const float w = wload(wrow + static_cast<size_t>(i) * hidden);
      const float* x = fcin_s + i * E;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = madd<kBF16>(acc[e], x[e], w);
    }
  }
  __syncthreads();
}

// After the last group: the n_prop proprio rows (fc rows from row0 on; env
// e's values at prop_s + e * prop_stride), the bias and ReLU into h_s (E,
// hidden), then the float32 heads into mm_s (E, 8): cols 0:4 the mean, 4
// the value. Every thread calls it; it ends synchronised.
template <typename W, bool kBF16, int E>
__device__ __forceinline__ void actor_heads(const W* wf, const W* bfc, int hidden, int row0,
                                            const float* prop_s, int prop_stride, int n_prop,
                                            float acc[E], float* h_s, const float* wm,
                                            const float* bm, float* mm_s) {
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
  __syncthreads();
  if (tid < E * 5) {
    const int e = tid / 5, col = tid - 5 * (tid / 5);
    const float* h = h_s + e * hidden;
    float a = 0.0f;
    for (int j = 0; j < hidden; ++j) a = a + h[j] * wm[j * 8 + col];
    mm_s[e * 8 + col] = a + bm[col];
  }
  __syncthreads();
}

}  // namespace fpyv
