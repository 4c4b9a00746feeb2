// levels_lut: uint8 depth levels into the pixel net's input dtype through a
// 256-entry table, dtype(float32(u) / 255), in one pass.
//
// Replaces no TPU kernel: on the TPU, XLA fused the net's input chain
// (u8 -> float32, / 255, -> bf16) into its consumer. PyTorch runs the same
// chain as three passes over every minibatch (a u8 -> float32 copy, a
// float32 true division, a float32 -> bf16 cast), ~2.15 GB a forward at the
// PPO learner's 4096 x 108 x 256 levels. A level has 256 values, so the
// result is a table lookup: the wrapper (ops/levels_kernel.py::levels_as)
// makes the table on the device with the chain itself, and the bits are the
// chain's by construction.
//
// Bound on the H100: bytes, n read plus n * out_bytes written, over 3.35
// TB/s (113.2 MB + 226.5 MB into bf16 at the learner's shape: ~0.10 ms).
// The design reads each level once and writes each value once: every block
// stages the table in shared memory, then each thread reads the levels of
// one 16-byte store in one load (8 levels into a 2-byte dtype, 4 into
// float32) and writes their values in that one store, two such pairs in
// flight a turn of a grid-stride loop with 64-bit indices, so a warp's
// loads and its stores each cover one contiguous span. (16 levels a thread
// in one 16-byte load, written as out_bytes 16-byte stores, left each of a
// warp's stores strided: 63 % of the bound into bf16, 36 % into float32.)
// The ragged tail, and an input or output off those boundaries (a view into
// a larger tensor), take one level a thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLevelsBlock = 256;
constexpr long long kLevelsMaxBlocks = 4096;  // a grid-stride loop past this

// A 16-byte store of kOutBytes-wide values holds 16 / kOutBytes of them: In
// loads their levels in one read.
template <int kOutBytes>
struct LevelWords;
template <>
struct LevelWords<2> {  // bf16, fp16: 8 levels a store
  using T = uint16_t;
  using In = uint2;
};
template <>
struct LevelWords<4> {  // float32: 4 levels a store
  using T = uint32_t;
  using In = uint32_t;
};

__device__ __forceinline__ uint32_t level_at(uint32_t word, int j) {
  return (word >> (8 * j)) & 0xffu;
}

// The values of one In's levels, packed little-endian into a 16-byte store.
template <typename T>
__device__ __forceinline__ uint4 lookup(const T* lut, uint2 v) {
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // two 16-bit values a word, the lower level in the low half
    const uint32_t w = k < 2 ? v.x : v.y;
    const int j = 2 * (k & 1);
    o[k] = static_cast<uint32_t>(lut[level_at(w, j)]) |
           (static_cast<uint32_t>(lut[level_at(w, j + 1)]) << 16);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <typename T>
__device__ __forceinline__ uint4 lookup(const T* lut, uint32_t v) {
  return make_uint4(lut[level_at(v, 0)], lut[level_at(v, 1)], lut[level_at(v, 2)],
                    lut[level_at(v, 3)]);
}

// kVector: a thread reads the levels of one 16-byte store in one load and
// writes them in one store, two such pairs in flight an iteration; a warp's
// loads and its stores each cover one contiguous span. Otherwise (and for
// the tail) one level a thread.
template <int kOutBytes, bool kVector>
__global__ void __launch_bounds__(kLevelsBlock)
    levels_lut_kernel(const uint8_t* __restrict__ in,
                      const typename LevelWords<kOutBytes>::T* table,
                      typename LevelWords<kOutBytes>::T* __restrict__ out, long long n) {
  using T = typename LevelWords<kOutBytes>::T;
  using In = typename LevelWords<kOutBytes>::In;
  constexpr int kPer = 16 / kOutBytes;
  __shared__ T lut[256];
  for (int i = threadIdx.x; i < 256; i += kLevelsBlock) lut[i] = table[i];
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kLevelsBlock + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kLevelsBlock;
  long long head = 0;  // levels the vector loop wrote
  if (kVector) {
    const long long vecs = n / kPer;
    const In* inv = reinterpret_cast<const In*>(in);
    uint4* outv = reinterpret_cast<uint4*>(out);
    long long c = first;
    for (; c + stride < vecs; c += 2 * stride) {
      const In a = __ldg(inv + c);
      const In b = __ldg(inv + c + stride);
      outv[c] = lookup(lut, a);
      outv[c + stride] = lookup(lut, b);
    }
    if (c < vecs) outv[c] = lookup(lut, __ldg(inv + c));
    head = vecs * kPer;
  }
  for (long long i = head + first; i < n; i += stride) out[i] = lut[in[i]];
}

template <int kOutBytes>
void launch_levels(const uint8_t* in, const void* table, void* out, long long n,
                   cudaStream_t stream) {
  using T = typename LevelWords<kOutBytes>::T;
  constexpr int kPer = 16 / kOutBytes;
  const bool vec = reinterpret_cast<uintptr_t>(in) % kPer == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long work = vec ? (n / kPer + 1) / 2 : n;  // two stores a thread an iteration
  long long blocks = (work + kLevelsBlock - 1) / kLevelsBlock;
  blocks = blocks < 1 ? 1 : (blocks > kLevelsMaxBlocks ? kLevelsMaxBlocks : blocks);
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (vec)
    levels_lut_kernel<kOutBytes, true>
        <<<static_cast<unsigned>(blocks), kLevelsBlock, 0, stream>>>(in, t, o, n);
  else
    levels_lut_kernel<kOutBytes, false>
        <<<static_cast<unsigned>(blocks), kLevelsBlock, 0, stream>>>(in, t, o, n);
}

}  // namespace

extern "C" {

// out[i] = table[in[i]] for i < n, table and out of out_bytes (2 or 4) a
// value. Returns the cudaError_t of the launch (0 on success).
int fpyv_levels_lut(const uint8_t* in, const void* table, void* out, long long n, int out_bytes,
                    void* stream) {
  if (n < 1 || (out_bytes != 2 && out_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2)
    launch_levels<2>(in, table, out, n, st);
  else
    launch_levels<4>(in, table, out, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
