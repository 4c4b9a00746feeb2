// K8: the policy-in-kernel vision race rollout of the pixel race trainer.
//
// Replaces fpyv_tpu/ops/pallas_race.py:_kernel (pallas_race_vision_rollout).
// Per step and env: render the gate track, the ground and the orbiting
// obstacle spheres (centres at episode time t) in patch-major pixel order
// (render.cuh); push the frame onto the K-frame stack in patch-stack-major
// order (per patch, K frames of 64 levels, oldest first; the flush flag of
// the step after a reset fills every older slot with the current frame);
// run the patch actor (actor.cuh) with a K*64-wide embed and the proprio
// [rates / max (3), accel_z / 30, thrust / max, next-gate one-hot (G)];
// sample the Gaussian action (draws 20..23) with its log-prob; then the
// single-agent MultiRace step: K1 against the obstacles at t + 1, gate
// passing (the plane crossed inside the gate), the centre-progress reward,
// termination on a crash or at max_steps, and the respawn on the ring behind
// gate 0 (draws 0..3). Frames leave as uint8 levels, the proprio (16 wide)
// and [a0..a3, reward, env_done, value, log_prob] as float32 rows per step.
//
// Layout: K7's. One block owns kEnvs = 8 envs for all T steps (the last
// block may hold fewer); thread e < 8 holds env e's 22 state columns in
// registers. Its 512 threads render (render.cuh::render_frames: the envs'
// invariant tables from this step's obstacle columns, then kRacePixels
// neighbouring pixels a thread, stored as one word), and the actor's 256
// assemble the stacks and run the actor. Shared memory holds only the
// CURRENT frames (8 x H*W bytes): the whole stack, 8 x K x H*W bytes
// (221,184 at K = 4, 96x72), would not fit beside the rest of the scratch
// in the 232,448 bytes a block may use. The K-1 older frames of a patch are read where they already are
// in device memory: the history at step 0, the kernel's own previous
// `frames` row after that (written by this block one step before, so still
// in L2). bf16 (the trainer's path): the actor (actor.cuh, tensor cores)
// takes a batch of pb patches a pass; their stacks are assembled in 16-byte
// words (64 contiguous bytes a patch and slot), streamed out to `frames` in
// 16-byte stores and converted straight into the bf16 levels tile of the
// embed (pb x 8 x (K*64 + 8)). float32 (the exact check): the CUDA-core
// actor, one patch group's stacks (8 x pool x K*64 bytes) at a time, byte by
// byte. Fewer envs a block would have fit the stack instead, but every block
// reads the 7.1 MB of fc weights from L2 once a step, so halving the envs
// doubles that stream. The world is the shared track; each env's copy of it
// in shared memory gets its obstacle columns rewritten every step (the
// render reads them), and the obstacles at t + 1 go to K1's row layout.
//
// Obstacle centres follow the Pallas kernel's float formula
// (2 pi mod(count0 + t, res)) / res with res >= 1; the next gate is indexed
// where the Pallas kernel sums one-hot masks over the gates (the same float32
// result: the other terms are exact zeros).
//
// Bound on the H100 at 1024 envs, 96x72, T = 32, K = 4, 6 gates and ground:
// the render's counted float32 operations (chip_smoke.py::render_ops, ~1.9
// ms) set it; the products, 2 (NP*256*128 + (NP*128 + 11)*256) = 1.42e7
// flops an env-step, 4.6e11 a launch, take 0.47 ms on the bf16 tensor cores.
// The bf16 actor runs them there; what it still pays is the fc's 7.1 MB L2
// stream a block and step. The render took ~13 of a 21.2 ms launch in the
// first port, ~3.3 of ~11.7 ms laid out for this card (render.cuh,
// PERF.md). Registers: 128 a thread at 512 threads in ptxas' report
// (printed by chip_smoke.py), none spilled; the bf16 generic instantiation
// keeps 256 threads (172). Shared memory at K = 4 without obstacles:
// 214,816 bytes of the 232,448 (the tiles 142,976, the invariant tables
// 3,104).
#include "actor.cuh"
#include "env.cuh"
#include "render.cuh"

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

using fpyv::Cylinders;
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
constexpr int kRows = 22;   // 0:3 pos, 3:6 vel, 6:10 quat, 10:13 rates, 13 thrust, 14 crashed,
                            // 15 t, 16 next_gate, 17 prev_center_dist, 18 accel_z,
                            // 19 gates_passed, 20 prev_gate_dist, 21 flush
constexpr int kProp = 16;   // extra columns: the proprio block and its zero pad
constexpr int kOut = 8;     // aux columns
constexpr int kCam = 16;
constexpr int kOcols = 8;   // per obstacle: path centre (3), path radius, res, count0, radius, 0
constexpr int kSharedLimit = 232448;
// Threads of a block: fpyv::kRolloutThreads (the actor's 256 and 256 that
// only render), but the actor's alone in the bf16 generic instantiation,
// whose wide tensor-core fc and generic contact loop need more than the 128
// registers a thread that 512 threads leave (ptxas spills there).
template <bool kBF16, int kMotors>
constexpr int kBlockThreads =
    kBF16 && kMotors == 0 ? fpyv::kActorThreads : fpyv::kRolloutThreads;
constexpr int kRacePixels = 8;  // pixels a thread renders at once (render.cuh)

// Field order must match RaceConstants.as_array() in ops/race_kernel.py.
struct RaceConsts {
  float max_steps;
  float spawn_x, spawn_y, spawn_z;  // the spawn ring's centre behind gate 0
  float jitter;                     // the spawn jitter's std
  float w_gate, w_progress, w_alive, w_crash;
  float inv_max_rates, inv_30, inv_max_force;
  float log_2pi2;  // 2 log(2 pi): the four action dims' normaliser
  float sq2h;      // cos and sin of the 90 deg spawn yaw's half-angle
  float onehot;    // 1 where the next-gate one-hot feeds the policy
  float mount[9], rel[3];
};

// Obstacle o (kOcols columns) at episode time t.
__device__ __forceinline__ void obstacle_at(const float* o, float t, float* cx, float* cy) {
  const float res = fmaxf(o[4], 1.0f);
  const float theta = (fpyv::kTwoPi * fmodf(o[5] + t, res)) / res;
  *cx = o[0] + o[3] * cosf(theta);
  *cy = o[1] + o[3] * sinf(theta);
}

// Shared bytes of a block; pb = 0: the float32 layout (CUDA-core actor,
// one group's stacks), else the bf16 layout (tensor-core tiles for batches
// of pb patches). Mirrored by ops/race_kernel.py::race_shared_bytes.
size_t shared_bytes(int hw, int K, int S, int G, int hidden, int pool, int pb) {
  const int wcols = 5 * S + 15 * G + 1;
  const size_t head = kCam + kProp + kOut + 1 + wcols + 5 * S + fpyv::pre_cols(S, 0, G);
  if (pb == 0) {
    const size_t floats = 256 + kEnvs * (head + kEmbed + hidden + (pool > 1 ? pool * kEmbed : 0));
    return floats * sizeof(float) + static_cast<size_t>(kEnvs) * hw +
           static_cast<size_t>(kEnvs) * pool * K * kPatch;
  }
  const size_t floats = (256 + kEnvs * (head + hidden) + 3) / 4 * 4;  // 16-byte aligned tiles
  return floats * sizeof(float) + fpyv::tc_tile_elems(kEnvs, K * kPatch, pb, pool) * 2 +
         static_cast<size_t>(kEnvs) * hw;
}

template <typename W, bool kBF16, bool kTimed, int kMotors>
__global__ void __launch_bounds__(kBlockThreads<kBF16, kMotors>)
    race_vision_rollout_kernel(StepConsts k, RaceConsts c, RenderConsts rc, int seed, int K,
                               const float* __restrict__ state_in,
                               const float* __restrict__ wcol, const float* __restrict__ ocol,
                               const uint8_t* __restrict__ hist, const float* __restrict__ dcam,
                               int hw, const W* __restrict__ we, const W* __restrict__ be,
                               const W* __restrict__ wp, const W* __restrict__ bp,
                               const W* __restrict__ wf, const W* __restrict__ bfc, int hidden,
                               const uint4* __restrict__ wft, int pb,
                               const float* __restrict__ wm, const float* __restrict__ bm,
                               const float* __restrict__ stdv, int pool, uint8_t* frames,
                               float* __restrict__ extra, float* __restrict__ aux,
                               float* __restrict__ state_out, int n, int n_steps,
                               unsigned long long* __restrict__ phase_ns) {
  const int S = static_cast<int>(rc.n_spheres);
  const int G = static_cast<int>(rc.n_gates);
  const int NP = hw / kPatch;
  const int NPG = NP / pool;            // patch groups the fc sees
  const int KP = K * kPatch;            // a patch's stacked levels
  const size_t row = static_cast<size_t>(NP) * KP;  // one env's stacked frame
  const int wcols = 5 * S + 15 * G + 1;  // spheres, gates, ground
  const int hrow = NP * (K - 1) * kPatch;  // one env's history
  constexpr int E = kEnvs;
  // the generic instantiation takes any motor count and any fc width
  constexpr bool kWide = kMotors == 0;
  constexpr int kBlock = kBlockThreads<kBF16, kMotors>;

  extern __shared__ __align__(16) float sh[];
  float* lut = sh;                      // (256,) bf16(level / 255)
  float* cam_s = lut + 256;             // (E, 16)
  float* prop_s = cam_s + E * kCam;     // (E, 16) proprio
  float* mm_s = prop_s + E * kProp;     // (E, 8) heads
  float* flush_s = mm_s + E * kOut;     // (E,) the flush flags of this step
  float* ws = flush_s + E;              // (E, wcols) world columns, obstacles at t
  float* phys_s = ws + E * wcols;       // (E, 5S) K1's sphere rows, obstacles at t + 1
  float* pre_s = phys_s + E * 5 * S;    // (E, pre_cols) the render's invariant tables
  // float32: fcin_s (128, E) one group's fc input, h_s (E, hidden), emb_s
  // (E * pool, 128) when pool > 1, cur_s (E, hw) the current frames, stk_s
  // (E, pool, K*64) one group's stacks. bf16: h_s, the tensor-core tiles
  // (16-byte aligned), cur_s.
  float* fcin_s = pre_s + E * fpyv::pre_cols(S, 0, G);
  float* h_s = kBF16 ? fcin_s : fcin_s + kEmbed * E;
  float* emb_s = h_s + E * hidden;
  fpyv::TcTiles tt{};
  uint8_t* cur_s;
  if constexpr (kBF16) {
    const int used = static_cast<int>(emb_s - sh);
    tt = fpyv::tc_tiles<E>(sh + (used + 3) / 4 * 4, KP, pb, pool);
    cur_s = reinterpret_cast<uint8_t*>(tt.we + fpyv::tc_tile_elems(E, KP, pb, pool));
  } else {
    cur_s = reinterpret_cast<uint8_t*>(emb_s + (pool > 1 ? E * pool * kEmbed : 0));
  }
  uint8_t* stk_s = cur_s + E * hw;

  const int tid = threadIdx.x;
  const int env0 = blockIdx.x * E;
  const int ne = min(E, n - env0);  // envs of this block (the last may hold fewer)
  const bool owner = tid < ne;      // thread e owns env env0 + e
  fpyv::fill_level_table<kBF16>(lut);
  // rows of absent envs stay zero: the actor runs all E, their outputs go nowhere
  for (int j = tid; j < E * kProp; j += kBlock) prop_s[j] = 0.0f;
  for (int j = ne * hw + tid; j < E * hw; j += kBlock) cur_s[j] = 0;
  if constexpr (kBF16) {
    fpyv::tc_load_we(we, tt);
  } else {
    for (int j = tid; j < E * pool * KP; j += kBlock) stk_s[j] = 0;
  }
  for (int j = tid; j < E * wcols; j += kBlock) {
    const int e = j / wcols, q = j - e * wcols;
    ws[j] = q < 5 * S ? 0.0f : wcol[q - 5 * S];
  }
  __syncthreads();

  float s[kRows];
  uint32_t lane = 0u;
  if (owner) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = state_in[static_cast<size_t>(env0 + tid) * kRows + r];
    lane = fpyv::env_lane(env0 + tid, seed);
  }

  fpyv::ActorClock<kTimed> clk;
  clk.start();
  for (int step = 0; step < n_steps; ++step) {
    const size_t orow = static_cast<size_t>(step) * n + env0;  // (step, env0) output row
    if (owner) {
      fpyv::camera_pose(c.mount, c.rel, s, cam_s + tid * kCam);
      flush_s[tid] = s[21];
      // obstacles at t into the env's sphere columns (render), at t + 1
      // into its K1 rows (the reference's target.update() -> drone.step())
      float* w = ws + tid * wcols;
      float* pr = phys_s + tid * 5 * S;
      for (int i = 0; i < S; ++i) {
        const float* o = ocol + kOcols * i;
        float cx, cy;
        obstacle_at(o, s[15], &cx, &cy);
        w[5 * i] = cx;
        w[5 * i + 1] = cy;
        w[5 * i + 2] = o[2];
        w[5 * i + 3] = o[6];
        w[5 * i + 4] = 1.0f;
        obstacle_at(o, s[15] + 1.0f, &cx, &cy);
        pr[i] = cx;
        pr[S + i] = cy;
        pr[2 * S + i] = o[2];
        pr[3 * S + i] = o[6];
        pr[4 * S + i] = 1.0f;
      }
      float* pp = prop_s + tid * kProp;
      pp[0] = s[10] * c.inv_max_rates;
      pp[1] = s[11] * c.inv_max_rates;
      pp[2] = s[12] * c.inv_max_rates;
      pp[3] = s[18] * c.inv_30;
      pp[4] = s[13] * c.inv_max_force;
      for (int g = 0; g < G; ++g) pp[5 + g] = (fabsf(s[16] - static_cast<float>(g)) < 0.5f ? 1.0f : 0.0f) * c.onehot;
      for (int j = 5 + G; j < kProp; ++j) pp[j] = 0.0f;
      float* ex = extra + (orow + tid) * kProp;
#pragma unroll
      for (int j = 0; j < kProp; ++j) ex[j] = pp[j];
    }
    __syncthreads();

    // ---- render the block's current frames, patch-major pixel order
    // (render.cuh): the envs' invariant tables from this step's obstacle
    // columns, then kRacePixels pixels a thread, stored as words to cur_s
    fpyv::render_invariants_block(S, 0, G, ne, cam_s, kCam, ws, wcols, pre_s);
    __syncthreads();
    fpyv::render_frames<kRacePixels>(rc, S, 0, G, ne, cam_s, kCam, pre_s, dcam, hw, cur_s,
                                     nullptr);
    __syncthreads();
    clk.mark(fpyv::kPhRender);

    // ---- the actor's threads: stack, actor, sample, race step (the rest wait below)
    if (tid < fpyv::kActorThreads) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
      if constexpr (kBF16) {
        // ---- actor on the tensor cores, a batch of pb patches a pass:
        // assemble the batch's stacks in 16-byte words (older slots from the
        // history or the previous frames row, the newest from shared memory),
        // stream them out, convert them into the bf16 levels tile; embed; fc
        float acc2[2][4] = {};
        const int n_mt = hidden / 16, KT = NPG * 8, xs = KP + fpyv::kRowPad;
        const int words = KP / 16;  // 16-byte words of a patch's stack
        for (int p0 = 0; p0 < NP; p0 += pb) {
          for (int idx = tid; idx < E * pb * words; idx += kThreads) {
            const int w = idx % words, r = idx / words, pl = r % pb, e = r / pb;
            const int slot = w >> 2, x = (w & 3) * 16, p = p0 + pl;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);  // absent envs: level 0
            if (e < ne) {
              if (slot == K - 1 || flush_s[e] > 0.5f) {
                v = *reinterpret_cast<const uint4*>(cur_s + e * hw + p * kPatch + x);
              } else if (step == 0) {
                const size_t at = static_cast<size_t>(env0 + e) * hrow +
                                  (p * (K - 1) + slot) * kPatch + x;
                v = __ldg(reinterpret_cast<const uint4*>(hist + at));
              } else {  // written by this block one step before
                v = *reinterpret_cast<const uint4*>(frames + (orow - n + e) * row + p * KP +
                                                    (slot + 1) * kPatch + x);
              }
              *reinterpret_cast<uint4*>(frames + (orow + e) * row + p * KP + w * 16) = v;
            }
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
      } else {
        // ---- actor, one patch group at a time: assemble the group's stacks
        // (older slots from the history or the previous frames row, the newest
        // from shared memory), stream them out, embed them
        const int gstride = pool * KP;
        for (int g = 0; g < NPG; ++g) {
          for (int idx = tid; idx < ne * gstride; idx += kThreads) {
            const int e = idx / gstride, rem = idx - e * gstride;
            const int p = g * pool + rem / KP, q = rem - (rem / KP) * KP;
            const int slot = q / kPatch, x = q - slot * kPatch;
            uint8_t v;
            if (slot == K - 1 || flush_s[e] > 0.5f) {
              v = cur_s[e * hw + p * kPatch + x];
            } else if (step == 0) {
              v = hist[static_cast<size_t>(env0 + e) * hrow + (p * (K - 1) + slot) * kPatch + x];
            } else {
              v = frames[(orow - n + e) * row + p * KP + (slot + 1) * kPatch + x];
            }
            stk_s[idx] = v;
            frames[(orow + e) * row + p * KP + q] = v;
          }
          fpyv::actor_sync();
          clk.mark(fpyv::kPhStack);
          fpyv::actor_group<E, kWide>(lut, stk_s, gstride, KP, KP, we, be, wp, bp, wf, hidden, g,
                                      pool, fcin_s, emb_s, acc, h_s, clk);
        }
      }
      fpyv::actor_heads<W, kBF16, E, kWide>(wf, bfc, hidden, NPG * kEmbed, prop_s, kProp, 5 + G,
                                            acc, h_s, wm, bm, mm_s, clk);

      // ---- sample, race step, respawn
      if (owner) {
        const float* mm = mm_s + tid * kOut;
        const uint32_t base = (static_cast<uint32_t>(step) + 1u) * 32u;
        float z0, z1, z2, z3;
        fpyv::normal_pair(lane, base + 20u, base + 21u, &z0, &z1);
        fpyv::normal_pair(lane, base + 22u, base + 23u, &z2, &z3);
        const float act[4] = {mm[0] + stdv[0] * z0, mm[1] + stdv[1] * z1, mm[2] + stdv[2] * z2,
                              mm[3] + stdv[3] * z3};
        const float log_prob = -0.5f * (z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3) -
                               (stdv[4] + stdv[5] + stdv[6] + stdv[7]) - c.log_2pi2;

        const float* pr = phys_s + tid * 5 * S;
        const Spheres sp{pr, pr + S, pr + 2 * S, pr + 3 * S, pr + 4 * S, S};
        const Cylinders cv{nullptr, 0};
        float phys[kStateRows];
#pragma unroll
        for (int r = 0; r < kStateRows; ++r) phys[r] = s[r];
        float az;
        fpyv::step_components<kMotors, false, false>(k, sp, cv, phys, act, EnvPhysics{}, nullptr,
                                                     &az);
        const float crashed = phys[14];

        // gate passing and reward (multi_race.step at A == 1)
        const float* gates = ws + tid * wcols + 5 * S;
        const float* g1 = gates + 15 * static_cast<int>(s[16]);
        const float relx = phys[0] - g1[0], rely = phys[1] - g1[1], relz = phys[2] - g1[2];
        const float plane_d = relx * g1[3] + rely * g1[4] + relz * g1[5];
        const float lat2 = (relx * relx + rely * rely + relz * relz) - plane_d * plane_d;
        const float lateral = sqrtf(fmaxf(lat2, 0.0f));
        const float center_d = sqrtf(relx * relx + rely * rely + relz * relz);
        const float newly_crashed = crashed * (1.0f - s[14]);
        const float passed = (s[20] < 0.0f ? 1.0f : 0.0f) * (plane_d >= 0.0f ? 1.0f : 0.0f) *
                             (lateral < g1[12] * 0.5f ? 1.0f : 0.0f) * (1.0f - crashed);
        const float ng2 = fmodf(s[16] + passed, static_cast<float>(G));
        const float gates2 = s[19] + passed;
        const float* g2 = gates + 15 * static_cast<int>(ng2);
        const float r2x = phys[0] - g2[0], r2y = phys[1] - g2[1], r2z = phys[2] - g2[2];
        const float plane_d_new = r2x * g2[3] + r2y * g2[4] + r2z * g2[5];
        const float center_d_new = sqrtf(r2x * r2x + r2y * r2y + r2z * r2z);
        const float progress = (1.0f - passed) * (s[17] - center_d);
        const float reward = c.w_gate * passed + c.w_progress * progress +
                             c.w_alive * (1.0f - crashed) - c.w_crash * newly_crashed;
        const float t_next = s[15] + 1.0f;
        const float env_done = fmaxf(crashed, t_next >= c.max_steps ? 1.0f : 0.0f);
        float* ax = aux + (orow + tid) * kOut;
        ax[0] = act[0];
        ax[1] = act[1];
        ax[2] = act[2];
        ax[3] = act[3];
        ax[4] = reward;
        ax[5] = env_done;
        ax[6] = mm[4];
        ax[7] = log_prob;
        if (env_done > 0.5f) {
          // respawn (multi_race._sample_drones at A == 1): the ring's centre
          // plus jitter, facing +y, gate 0 next
          float j0, j1, j2, unused;
          fpyv::normal_pair(lane, base + 0u, base + 1u, &j0, &j1);
          fpyv::normal_pair(lane, base + 2u, base + 3u, &j2, &unused);
          const float sx = c.spawn_x + c.jitter * j0;
          const float sy = c.spawn_y + c.jitter * j1;
          const float sz = c.spawn_z + c.jitter * j2;
          const float d0x = sx - gates[0], d0y = sy - gates[1], d0z = sz - gates[2];
          s[0] = sx;
          s[1] = sy;
          s[2] = sz;
          s[3] = s[4] = s[5] = 0.0f;
          s[6] = c.sq2h;
          s[7] = s[8] = 0.0f;
          s[9] = c.sq2h;
#pragma unroll
          for (int r = 10; r < 17; ++r) s[r] = 0.0f;
          s[17] = sqrtf(d0x * d0x + d0y * d0y + d0z * d0z);
          s[18] = s[19] = 0.0f;
          s[20] = d0x * gates[3] + d0y * gates[4] + d0z * gates[5];
          s[21] = 1.0f;
        } else {
#pragma unroll
          for (int r = 0; r < kStateRows; ++r) s[r] = phys[r];
          s[15] = t_next;
          s[16] = ng2;
          s[17] = center_d_new;
          s[18] = az;
          s[19] = gates2;
          s[20] = plane_d_new;
          s[21] = 0.0f;
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
int launch(const StepConsts& k, const RaceConsts& c, const RenderConsts& rc, int seed, int K,
           const float* state, const float* wcol, const float* ocol, const uint8_t* hist,
           const float* dcam, int hw, const void* we, const void* be, const void* wp,
           const void* bp, const void* wf, const void* bfc, int hidden, const void* wft, int pb,
           const float* wm, const float* bm, const float* stdv, int pool, uint8_t* frames,
           float* extra, float* aux, float* state_out, int n, int n_steps,
           unsigned long long* phase_ns, size_t shmem, cudaStream_t stream) {
  auto kernel = race_vision_rollout_kernel<W, kBF16, kTimed, kMotors>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + kEnvs - 1) / kEnvs, kBlockThreads<kBF16, kMotors>, shmem, stream>>>(
      k, c, rc, seed, K, state, wcol, ocol, hist, dcam, hw, static_cast<const W*>(we),
      static_cast<const W*>(be), static_cast<const W*>(wp), static_cast<const W*>(bp),
      static_cast<const W*>(wf), static_cast<const W*>(bfc), hidden,
      static_cast<const uint4*>(wft), pb, wm, bm, stdv, pool, frames, extra, aux, state_out, n,
      n_steps, phase_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int fpyv_race_vision_rollout(const float* step_consts, int n_step_consts,
                             const float* race_consts, int n_race_consts,
                             const float* render_consts, int n_render_consts, int seed, int K,
                             const float* state, const float* wcol, const float* ocol,
                             const uint8_t* hist, const float* dcam, int hw, const void* we,
                             const void* be, const void* wp, const void* bp, const void* wf,
                             const void* bfc, int hidden, const void* wft, int pb,
                             const float* wm, const float* bm, const float* stdv, int pool,
                             int bf16, uint8_t* frames, float* extra, float* aux,
                             float* state_out, int n, int n_steps,
                             unsigned long long* phase_ns, void* stream) {
  StepConsts k;
  RaceConsts c;
  RenderConsts rc;
  if (!read_consts(step_consts, n_step_consts, &k) ||
      !read_consts(race_consts, n_race_consts, &c) ||
      !read_consts(render_consts, n_render_consts, &rc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>(rc.n_spheres), G = static_cast<int>(rc.n_gates);
  if (n < 1 || n_steps < 1 || K < 1 || hw % kPatch || pool < 1 || (hw / kPatch) % pool ||
      hidden < 1 || rc.n_cylinders != 0.0f || G < 1 || 5 + G > kProp ||
      !fpyv::motors_in_range(k) ||
      (phase_ns && (!bf16 || !fpyv::quad_frame(k) || hidden > kThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16: the tensor-core actor's batch of pb patches (a multiple of pool
  // dividing the patches), 16-row hidden tiles, the fragment-order fc rows
  if (bf16 && (pb < pool || pb % pool || (hw / kPatch) % pb || hidden % 16 || !wft))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16) pb = 0;
  const size_t shmem = shared_bytes(hw, K, S, G, hidden, pool, pb);
  if (shmem > static_cast<size_t>(kSharedLimit)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FPYV_K8(W, BF16, TIMED, M)                                                               \
  launch<W, BF16, TIMED, M>(k, c, rc, seed, K, state, wcol, ocol, hist, dcam, hw, we, be, wp, bp, \
                            wf, bfc, hidden, wft, pb, wm, bm, stdv, pool, frames, extra, aux,     \
                            state_out, n, n_steps, phase_ns, shmem, st)
  // the quad's instantiation takes 4 motors and at most kThreads hidden units
  const bool quad = fpyv::quad_frame(k) && hidden <= kThreads;
  int err;
  if (phase_ns)
    err = FPYV_K8(__nv_bfloat16, true, true, 4);
  else if (bf16)
    err = quad ? FPYV_K8(__nv_bfloat16, true, false, 4) : FPYV_K8(__nv_bfloat16, true, false, 0);
  else
    err = quad ? FPYV_K8(float, false, false, 4) : FPYV_K8(float, false, false, 0);
#undef FPYV_K8
  return err;
}

}  // extern "C"
