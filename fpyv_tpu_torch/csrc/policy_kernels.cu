// K7: the policy-in-kernel vision rollout of the pixel PPO trainer.
//
// Replaces fpyv_tpu/ops/pallas_policy.py:_kernel (pallas_policy_vision_rollout).
// Per step and env: render the full-world depth view in patch-major pixel
// order (render.cuh), run the patch actor (patch embed (64 -> 128) + ReLU,
// optional pooled mixer (pool*128 -> 128) + ReLU, fc (NP/pool*128 + 5 ->
// hidden) + ReLU, float32 mean and value heads), sample the Gaussian action
// with the counter RNG (draws 20..23) with its log-prob, then the AcroEnv
// step of the in-kernel trainer: K1 against the env's own world, static
// targets, the reward to sphere 0, truncation at t + 1 >= max_steps and the
// auto-reset (draws 0..9, env.cuh). Frames leave as uint8 levels, proprio
// and [a0..a3, reward, crashed, value, log_prob] as float32 rows per step.
//
// Layout: one block owns kEnvs = 8 envs for all K steps (the TPU's (env
// block, step) grid with its VMEM carry becomes a loop over steps); the
// last block may hold fewer. Thread e < 8 holds env e's 18 state columns in
// registers and runs its camera, sampling and env step. The block has 512
// threads (kBlockThreads), and all of them render: at each step they build
// the envs' invariant tables, then each renders kPolicyPixels neighbouring
// pixels at once and stores them as one word, to shared memory and to
// frames (render.cuh::render_frames, where the layout is explained). Then
// the actor's 256 threads (warps 0-7, on their own named barrier) run the
// actor while the other 256 wait for the next step. The actor runs patch
// group by patch group: the group's
// embeddings of the 8 envs go to shared memory and thread h adds the
// group's 128 rows of the fc weights into its 8 float32 accumulators of
// hidden unit h, so the (8, 13952) fc input never exists. Two
// instantiations of each weight type: the quad's (4 motor points, at most
// 256 hidden units), and the generic one (any motor count; hidden units h +
// 256, ... and tensor-core tiles past a warp's two sum in shared memory),
// picked at the launch.
// The fc weights (7.1 MB in bf16) do not fit in shared memory; every block
// streams them from L2 once per step. Per-env worlds: each env's world
// columns sit in shared memory for the render, and a copy in the row layout
// of physics.cuh for K1, so K1 itself is unchanged.
//
// Products are written by hand, no library (actor.cuh): in bf16 (the
// trainer's path) the embed and the fc run on the tensor cores (mma.sync,
// float32 sums in the hardware's order), a batch of pb patches a barrier
// pass; in float32 the CUDA-core actor sums in row order, as the plain
// version in ops/policy_kernel.py does, so the two agree bit for bit.
// Rounding follows Flax's Dense(dtype=bf16) and the Pallas kernel: float32
// sums, rounded to bf16, the bias added in bf16, ReLU; the policy input is
// bf16(level / 255.0f) by true division. The RNG lane is the global env
// index.
//
// Bound on the H100 at 1024 envs, 96x72, K = 32, per-env worlds of 1 sphere
// and 4 cylinders: the render's ~270 counted float32 operations a pixel
// (6.1e10 a launch, 0.92 ms at 67 TFLOP/s) set it; the products, 2 (NP*64*128
// + (NP*128 + 5)*256 + 256*5) = 8.9e6 flops an env-step, take 0.29 ms on the
// bf16 tensor cores. The render took 11.5 of a 15.8 ms launch in the first
// port; laid out for this card (render.cuh) it takes ~2.5 of ~7.0 ms, below
// K5's per-pixel rate on the same scene, and the actor's fc L2 stream is
// most of the rest (PERF.md). Shared memory, bf16: the tensor-core tiles
// take 56,960 bytes (12 patches a pass), the frames 55,296, the invariant
// tables 8 x pre_cols floats, of the 232,448 a block may use; ptxas'
// registers (128 at 512 threads, none spilled) are printed by
// chip_smoke.py.
#include "actor.cuh"
#include "env.cuh"
#include "render.cuh"

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

using fpyv::Cylinders;
using fpyv::EnvConsts;
using fpyv::EnvPhysics;
using fpyv::kEmbed;
using fpyv::kPatch;
using fpyv::kStateRows;
using fpyv::RenderConsts;
using fpyv::Spheres;
using fpyv::StepConsts;

namespace {

constexpr int kThreads = fpyv::kActorThreads;  // the actor's threads
constexpr int kEnvs = 8;    // envs a block owns
constexpr int kRows = 18;   // 0:3 pos, 3:6 vel, 6:10 quat, 10:13 rates, 13 thrust,
                            // 14 done, 15 t, 16 prev_dist, 17 accel_z
constexpr int kOut = 8;     // extra and aux columns
constexpr int kCam = 16;
constexpr int kSharedLimit = 232448;
// Threads of a block: fpyv::kRolloutThreads (the actor's 256 and 256 that
// only render), but the actor's alone in the bf16 generic instantiation,
// whose wide tensor-core fc and generic contact loop need more than the 128
// registers a thread that 512 threads leave (ptxas spills there).
template <bool kBF16, int kMotors>
constexpr int kBlockThreads =
    kBF16 && kMotors == 0 ? fpyv::kActorThreads : fpyv::kRolloutThreads;
constexpr int kPolicyPixels = 4;  // pixels a thread renders at once (render.cuh)

// Field order must match PolicyConstants.as_array() in ops/policy_kernel.py.
struct PolicyConsts {
  EnvConsts env;  // K4's reward and reset scalars (no DR, no wind here)
  float inv_max_rates, inv_30, inv_max_force;
  float log_2pi2;  // 2 log(2 pi): the four action dims' normaliser
  float mount[9], rel[3];
};

template <typename W, bool kBF16, bool kTimed, int kMotors>
__global__ void __launch_bounds__(kBlockThreads<kBF16, kMotors>)
    policy_vision_rollout_kernel(StepConsts k, PolicyConsts c, RenderConsts rc, int seed,
                                 const float* __restrict__ state_in,
                                 const float* __restrict__ wcol, int wcols,
                                 const float* __restrict__ dcam, int hw,
                                 const W* __restrict__ we, const W* __restrict__ be,
                                 const W* __restrict__ wp, const W* __restrict__ bp,
                                 const W* __restrict__ wf, const W* __restrict__ bfc, int hidden,
                                 const uint4* __restrict__ wft, int pb,
                                 const float* __restrict__ wm, const float* __restrict__ bm,
                                 const float* __restrict__ stdv, int pool,
                                 uint8_t* __restrict__ frames, float* __restrict__ extra,
                                 float* __restrict__ aux, float* __restrict__ state_out, int n,
                                 int n_steps, unsigned long long* __restrict__ phase_ns) {
  const int S = static_cast<int>(rc.n_spheres);
  const int C = static_cast<int>(rc.n_cylinders);
  const int G = static_cast<int>(rc.n_gates);
  const int NPG = hw / kPatch / pool;  // patch groups the fc sees
  const int prow = 5 * S + 6 * C;      // one env's physics rows
  constexpr int E = kEnvs;
  // the generic instantiation takes any motor count and any fc width
  constexpr bool kWide = kMotors == 0;
  constexpr int kBlock = kBlockThreads<kBF16, kMotors>;

  extern __shared__ __align__(16) float sh[];
  float* lut = sh;                     // (256,) bf16(level / 255)
  float* cam_s = lut + 256;            // (E, 16)
  float* prop_s = cam_s + E * kCam;    // (E, 8) proprio
  float* mm_s = prop_s + E * kOut;     // (E, 8) heads
  float* ws = mm_s + E * kOut;         // (E, wcols) world columns
  float* phys_s = ws + E * wcols;      // (E, 5S + 6C) physics rows
  float* pre_s = phys_s + E * prow;    // (E, pre_cols) the render's invariant tables
  // float32: fcin_s (128, E) one group's fc input, h_s (E, hidden), emb_s
  // (E * pool, 128) when pool > 1, frame_s (E, hw). bf16: h_s, the
  // tensor-core tiles (16-byte aligned), frame_s.
  float* fcin_s = pre_s + E * fpyv::pre_cols(S, C, G);
  float* h_s = kBF16 ? fcin_s : fcin_s + kEmbed * E;
  float* emb_s = h_s + E * hidden;
  fpyv::TcTiles tt{};
  uint8_t* frame_s;
  if constexpr (kBF16) {
    const int used = static_cast<int>(emb_s - sh);
    tt = fpyv::tc_tiles<E>(sh + (used + 3) / 4 * 4, kPatch, pb, pool);
    frame_s = reinterpret_cast<uint8_t*>(tt.we + fpyv::tc_tile_elems(E, kPatch, pb, pool));
  } else {
    frame_s = reinterpret_cast<uint8_t*>(emb_s + (pool > 1 ? E * pool * kEmbed : 0));
  }

  const int tid = threadIdx.x;
  const int env0 = blockIdx.x * E;
  const int ne = min(E, n - env0);  // envs of this block (the last may hold fewer)
  const bool owner = tid < ne;      // thread e owns env env0 + e
  fpyv::fill_level_table<kBF16>(lut);
  // rows of absent envs stay zero: the actor runs all E, their outputs go nowhere
  for (int j = tid; j < E * kOut; j += kBlock) prop_s[j] = 0.0f;
  for (int j = ne * hw + tid; j < E * hw; j += kBlock) frame_s[j] = 0;
  fpyv::load_shared(ws, wcol + static_cast<size_t>(env0) * wcols, ne * wcols);
  if constexpr (kBF16) fpyv::tc_load_we(we, tt);
  __syncthreads();

  float s[kRows];
  uint32_t lane = 0u;
  if (owner) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = state_in[static_cast<size_t>(env0 + tid) * kRows + r];
    lane = fpyv::env_lane(env0 + tid, seed);
    const float* w = ws + tid * wcols;
    float* pr = phys_s + tid * prow;
    for (int i = 0; i < S; ++i)
      for (int f = 0; f < 5; ++f) pr[f * S + i] = w[5 * i + f];
    for (int i = 0; i < C; ++i)
      for (int f = 0; f < 6; ++f) pr[5 * S + f * C + i] = w[5 * S + 6 * i + f];
  }

  fpyv::ActorClock<kTimed> clk;
  clk.start();
  for (int step = 0; step < n_steps; ++step) {
    const size_t row0 = static_cast<size_t>(step) * n + env0;  // (step, env0) output row
    if (owner) {
      fpyv::camera_pose(c.mount, c.rel, s, cam_s + tid * kCam);
      float* pp = prop_s + tid * kOut;
      pp[0] = s[10] * c.inv_max_rates;
      pp[1] = s[11] * c.inv_max_rates;
      pp[2] = s[12] * c.inv_max_rates;
      pp[3] = s[17] * c.inv_30;
      pp[4] = s[13] * c.inv_max_force;
      pp[5] = pp[6] = pp[7] = 0.0f;
      float* ex = extra + (row0 + tid) * kOut;
#pragma unroll
      for (int j = 0; j < kOut; ++j) ex[j] = pp[j];
    }
    __syncthreads();

    // ---- render the block's frames, patch-major pixel order (render.cuh):
    // the envs' invariant tables, then kPolicyPixels pixels a thread, stored
    // as words to frame_s and frames
    fpyv::render_invariants_block(S, C, G, ne, cam_s, kCam, ws, wcols, pre_s);
    __syncthreads();
    fpyv::render_frames<kPolicyPixels>(rc, S, C, G, ne, cam_s, kCam, pre_s, dcam, hw, frame_s,
                                       frames + row0 * hw);
    __syncthreads();
    clk.mark(fpyv::kPhRender);

    // ---- the actor's threads: actor, sample, env step (the rest wait below)
    if (tid < fpyv::kActorThreads) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
      if constexpr (kBF16) {
        // ---- actor on the tensor cores (actor.cuh), a batch of pb patches a
        // pass: the batch's levels into the bf16 tile in 16-byte words; embed; fc
        float acc2[2][4] = {};
        const int n_mt = hidden / 16, KT = NPG * 8, xs = kPatch + fpyv::kRowPad;
        for (int p0 = 0; p0 < hw / kPatch; p0 += pb) {
          for (int idx = tid; idx < E * pb * 4; idx += kThreads) {
            const int w = idx & 3, r = idx >> 2, pl = r % pb, e = r / pb;
            const uint4 v =
                *reinterpret_cast<const uint4*>(frame_s + e * hw + (p0 + pl) * kPatch + w * 16);
            fpyv::levels_to_bf16(lut, v, tt.xe + (pl * E + e) * xs + w * 16);
          }
          fpyv::actor_sync();
          clk.mark(fpyv::kPhStack);
          fpyv::tc_embed<E>(tt, be, wp, bp);
          clk.mark(fpyv::kPhEmbed);
          fpyv::tc_fc<kWide>(tt, wft, p0 / pool * 8, KT, n_mt, acc2, h_s, hidden);
          if constexpr (kTimed) fpyv::actor_sync();
          clk.mark(fpyv::kPhFc);
        }
        fpyv::tc_fc_gather<E>(acc2, n_mt, hidden, h_s, acc);
      } else {  // ---- actor, one patch group at a time (actor.cuh)
        for (int g = 0; g < NPG; ++g)
          fpyv::actor_group<E, kWide>(lut, frame_s + g * pool * kPatch, hw, kPatch, kPatch, we,
                                      be, wp, bp, wf, hidden, g, pool, fcin_s, emb_s, acc, h_s,
                                      clk);
      }
      fpyv::actor_heads<W, kBF16, E, kWide>(wf, bfc, hidden, NPG * kEmbed, prop_s, kOut, 5, acc,
                                            h_s, wm, bm, mm_s, clk);

      // ---- sample, env step, auto-reset
      if (owner) {
        const float* mm = mm_s + tid * kOut;
        const uint32_t base = (static_cast<uint32_t>(step) + 1u) * 32u;
        float z0, z1, z2, z3;
        fpyv::normal_pair(lane, base + 20u, base + 21u, &z0, &z1);
        fpyv::normal_pair(lane, base + 22u, base + 23u, &z2, &z3);
        const float act[4] = {mm[0] + stdv[0] * z0, mm[1] + stdv[1] * z1, mm[2] + stdv[2] * z2,
                              mm[3] + stdv[3] * z3};
        // the z draws are the normalised residuals of the sample
        const float log_prob = -0.5f * (z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3) -
                               (stdv[4] + stdv[5] + stdv[6] + stdv[7]) - c.log_2pi2;

        const float* pr = phys_s + tid * prow;
        const Spheres sp{pr, pr + S, pr + 2 * S, pr + 3 * S, pr + 4 * S, S};
        const Cylinders cv{pr + 5 * S, C};
        float phys[kStateRows];
#pragma unroll
        for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
        float az;
        fpyv::step_components<kMotors, false, false>(k, sp, cv, phys, act, EnvPhysics{}, nullptr,
                                                     &az);

        const float* tgt = ws + tid * wcols;  // sphere 0 of the env's own world
        const float crashed = phys[14];
        const float ddx = phys[0] - tgt[0], ddy = phys[1] - tgt[1], ddz = phys[2] - tgt[2];
        const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
        const float rates_pen = act[0] * act[0] + act[1] * act[1] + act[2] * act[2];
        const float reward = c.env.w_progress * (s[16] - dist) + c.env.w_alive -
                             c.env.w_crash * crashed - c.env.w_rates * rates_pen;
        const float t_next = s[15] + 1.0f;
        const float truncated = t_next >= c.env.max_steps ? 1.0f : 0.0f;
        const float done = fmaxf(crashed, truncated);
        float* ax = aux + (row0 + tid) * kOut;
        ax[0] = act[0];
        ax[1] = act[1];
        ax[2] = act[2];
        ax[3] = act[3];
        ax[4] = reward;
        ax[5] = crashed;
        ax[6] = mm[4];
        ax[7] = log_prob;
        if (done > 0.5f) {
          s[16] = fpyv::reset_pose(c.env, lane, step, tgt[0], tgt[1], tgt[2], s);
#pragma unroll
          for (int r = 10; r < 16; ++r) s[r] = 0.0f;
          s[17] = 0.0f;
        } else {
#pragma unroll
          for (int r = 0; r < 14; ++r) s[r] = phys[r];
          s[14] = 0.0f;
          s[15] = t_next;
          s[16] = dist;
          s[17] = az;
        }
      }
    }
    if constexpr (kTimed) __syncthreads();
    clk.mark(fpyv::kPhStep);
  }
  clk.flush(phase_ns);
  if (owner) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) state_out[static_cast<size_t>(env0 + tid) * kRows + r] = s[r];
  }
}

template <typename T>
bool read_consts(const float* host, int count, T* out) {
  if (count != static_cast<int>(sizeof(T) / sizeof(float))) return false;
  std::memcpy(out, host, sizeof(T));
  return true;
}

template <typename W, bool kBF16, bool kTimed, int kMotors>
int launch(const StepConsts& k, const PolicyConsts& c, const RenderConsts& rc, int seed,
           const float* state, const float* wcol, int wcols, const float* dcam, int hw,
           const void* we, const void* be, const void* wp, const void* bp, const void* wf,
           const void* bfc, int hidden, const void* wft, int pb, const float* wm,
           const float* bm, const float* stdv, int pool, uint8_t* frames, float* extra,
           float* aux, float* state_out, int n, int n_steps, unsigned long long* phase_ns,
           cudaStream_t stream) {
  const int S = static_cast<int>(rc.n_spheres), C = static_cast<int>(rc.n_cylinders);
  const int G = static_cast<int>(rc.n_gates);
  // mirrored by ops/policy_kernel.py::policy_shared_bytes
  const size_t head = kCam + 2 * kOut + wcols + 5 * S + 6 * C + fpyv::pre_cols(S, C, G);
  size_t shmem;
  if (kBF16) {
    const size_t floats = (256 + kEnvs * (head + hidden) + 3) / 4 * 4;  // 16-byte aligned tiles
    shmem = floats * sizeof(float) + fpyv::tc_tile_elems(kEnvs, kPatch, pb, pool) * 2 +
            static_cast<size_t>(kEnvs) * hw;
  } else {
    const size_t floats =
        256 + kEnvs * (head + kEmbed + hidden + (pool > 1 ? pool * kEmbed : 0));
    shmem = floats * sizeof(float) + static_cast<size_t>(kEnvs) * hw;
  }
  if (shmem > static_cast<size_t>(kSharedLimit)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = policy_vision_rollout_kernel<W, kBF16, kTimed, kMotors>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + kEnvs - 1) / kEnvs, kBlockThreads<kBF16, kMotors>, shmem, stream>>>(
      k, c, rc, seed, state, wcol, wcols, dcam, hw, static_cast<const W*>(we),
      static_cast<const W*>(be), static_cast<const W*>(wp), static_cast<const W*>(bp),
      static_cast<const W*>(wf), static_cast<const W*>(bfc), hidden,
      static_cast<const uint4*>(wft), pb, wm, bm, stdv, pool, frames, extra, aux, state_out, n,
      n_steps, phase_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int fpyv_policy_vision_rollout(const float* step_consts, int n_step_consts,
                               const float* policy_consts, int n_policy_consts,
                               const float* render_consts, int n_render_consts, int seed,
                               const float* state, const float* wcol, int wcols,
                               const float* dcam, int hw, const void* we, const void* be,
                               const void* wp, const void* bp, const void* wf, const void* bfc,
                               int hidden, const void* wft, int pb, const float* wm,
                               const float* bm, const float* stdv, int pool, int bf16,
                               uint8_t* frames, float* extra, float* aux, float* state_out,
                               int n, int n_steps, unsigned long long* phase_ns,
                               void* stream) {
  StepConsts k;
  PolicyConsts c;
  RenderConsts rc;
  if (!read_consts(step_consts, n_step_consts, &k) ||
      !read_consts(policy_consts, n_policy_consts, &c) ||
      !read_consts(render_consts, n_render_consts, &rc) || n < 1 || hw % kPatch || pool < 1 ||
      (hw / kPatch) % pool || hidden < 1 || rc.n_spheres < 1.0f || n_steps < 1 ||
      !fpyv::motors_in_range(k) ||
      (phase_ns && (!bf16 || !fpyv::quad_frame(k) || hidden > kThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16: the tensor-core actor's batch of pb patches (a multiple of pool
  // dividing the patches), 16-row hidden tiles, the fragment-order fc rows
  if (bf16 && (pb < pool || pb % pool || (hw / kPatch) % pb || hidden % 16 || !wft))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FPYV_K7(W, BF16, TIMED, M)                                                              \
  launch<W, BF16, TIMED, M>(k, c, rc, seed, state, wcol, wcols, dcam, hw, we, be, wp, bp, wf,    \
                            bfc, hidden, wft, pb, wm, bm, stdv, pool, frames, extra, aux,        \
                            state_out, n, n_steps, phase_ns, st)
  // the quad's instantiation takes 4 motors and at most kThreads hidden units
  const bool quad = fpyv::quad_frame(k) && hidden <= kThreads;
  int err;
  if (phase_ns)
    err = FPYV_K7(__nv_bfloat16, true, true, 4);
  else if (bf16)
    err = quad ? FPYV_K7(__nv_bfloat16, true, false, 4) : FPYV_K7(__nv_bfloat16, true, false, 0);
  else
    err = quad ? FPYV_K7(float, false, false, 4) : FPYV_K7(float, false, false, 0);
#undef FPYV_K7
  return err;
}

}  // extern "C"
