"""Smoke run and measurement of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fpyv_tpu_torch/csrc`` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, drives the
port's main paths at the benched shapes, and times them. Phases, one line
each:

1. device: the card's name and power limit (nvidia-smi) and the build time;
2. K2 (one fused physics step) on the params.yaml world against
   ``drone_step_reference``;
3. K3 (K = 256 fused steps) against ``rollout_reference`` on the params.yaml
   world, and K = 64 from a contact-heavy start (``contact_world``, 2
   spheres and 8 cylinders 0.15-0.25 m apart, the drones in the gaps:
   several motor points on a sphere and a cylinder in one step, where the
   order of the force sums decides equality): equal bit for bit;
4. K4 (the env megaloop) against ``env_rollout_reference``: the default world
   with K = 256 and 50-step episodes (every env resets several times), the
   params.yaml world with DomainRand and wind gusts, K = 64, and the
   contact-heavy start, K = 64: equal bit for bit;
5. K5 (the raycast render) against ``render_depth_reference``, levels equal:
   1024 envs at 96x72 on the params.yaml world and on per-env
   ``sample_worlds``, 8 envs at 640x480 on a world with a gate of each
   shape, and 64 envs at 33x17 (not a multiple of K5's tile);
6. K6 (the chase megaloop) against ``vision_env_rollout_reference``, 64 envs,
   K = 64: the default world with 20-step episodes (every env resets) and
   the params.yaml world with DomainRand and gusts; then the edges of K6's
   pixel box: the camera inside the target and the target across the
   camera plane (the full-frame fallback, which the instrumented launch
   counts), a target clipped by the frame's edge, one behind the camera
   and one beside it outside the frame's cone (empty boxes); t, crash and
   contact counts equal;
7. the acro main path with its launch counters at 0: one fused step, one
   fused rollout and the env megaloop on both worlds, K sized from a
   warm-up so a timed run takes about 8 s; env-steps/s beside the card and
   its limit, the plain env version's rate at K = 64 as a reference
   figure, and K4's rate as the bank grows from 4096 to 1M envs (lanes on
   an env below ``ek.ONE_THREAD_ENVS``, one thread an env from there);
8. the vision env main path with its counters at 0:
   ``VisionAcroEnv(renderer="raycast_pallas", target_only=False)``,
   ``reset_batched`` and 8 ``step_batched`` at 1024 envs on the params.yaml
   world, a warm-up and three timed runs; frames/s, and one run under
   ``torch.profiler``: the device's busy share and its top kernels;
9. the chase main path with its counters at 0: ``fused_vision_env_rollout``
   at 1024 envs on the default world and rig, K sized so a launch takes
   about 10 s; env-steps/s, and ``bench.py``'s K-slope rate (K = 512 ->
   2048); then the JAX package's station-keeping check (300 steps from a
   reset: mean |distance - keep_distance| < 1.5 m; here at most 1 % of the
   envs may crash in the last 200 steps, where the JAX test's 16 envs allow
   none);
10. the ``kernels`` JSON line: per kernel its launches on its main path, its
   largest error against the plain version, its time and the plain
   version's at the main path's shapes, and the least time the card could
   take for the same work. K4's row is taken at K = 64 on the bank the acro
   main path left on the default world (the resets in its window depend on
   that state), held against its plain version there, with its
   instrumented instantiation's split (target centres, head, contacts,
   tail, env step) and the env-steps that reset, beside its time from a
   fresh reset. K6's row is taken on the bank the chase main
   path's launches left (its steady state: targets near, far, behind and
   across the camera plane), 1024 envs, K = 64: held against its plain
   version once more there at phase 6's tolerances, and its instrumented
   instantiation splits a step there into pose, render, pilot and K1 + env
   and counts the pixels its box tested and the pixels lit, with the
   env-steps that tested the full frame and none. The bounds of K5 and K6
   count the work this run's data needs (K5's misses end at the
   discriminant; K6 the hit test on the lit pixels), printed beside the
   counts of the pixels K6's box tested and of the full frame;
11. K7 (the policy rollout) against ``policy_vision_rollout_reference``:
   (a) float32 weights, 64 envs, 96x72, ``sample_worlds`` with 1 sphere and
   4 cylinders, K = 16, 8-step episodes (every env resets): frames, crash
   flags and t equal, the rest at the CPU tests' tolerances; (b) bf16 at
   the timed shape, 1024 envs and K = 32, teacher-forced: the plain policy
   on the kernel's own frames and proprio gives its mean and value within
   ``TOL_BF16_HEADS`` (the tensor cores sum in their own order), the plain
   env on the kernel's own actions its proprio, rewards, crash flags and
   final state (that plain run, timed, is K7's plain_ms);
12. the trainer main path with its counters at 0: ``train_vision`` at the
   default recipe and ``bench.py::measure_vision_trainer``'s shape (1024
   envs, 30 iterations, ``scan_chunk=10``): one K7 launch an iteration, K5
   for the bootstrap frames, finite losses and rewards, trained env-steps/s
   (first chunk left out); one iteration split with CUDA events into the
   rollout (K7 + the bootstrap frame) and the learner, and traced under
   ``torch.profiler``: the device's busy share and its top kernels. K7's
   row joins the ``kernels`` line: its time at 1024 envs and K = 32;
13. K8 (the race rollout) against ``race_vision_rollout_reference``: (a)
   float32 weights, 64 envs, 96x72, K = 3 frames, 3 obstacles, T = 16,
   8-step episodes (every env ends): frames (the stacks), env ends, t, next
   gate, gates passed and the flush flag equal, the rest at the CPU tests'
   tolerances; (b) bf16 at the race trainer's shape, 1024 envs, K = 4,
   T = 32, no obstacles, teacher-forced as K7's check (that plain run, timed,
   is K8's plain_ms);
14. the race trainer main path with its counters at 0: ``train_vision_race``
   at ``bench.py::measure_vision_race_trainer``'s recipe (1024 envs,
   ``frame_stack=4``, ``gate_size=5.0``, 30 iterations, ``scan_chunk=10``):
   one K8 launch an iteration, K5 for the bootstrap frames, finite losses,
   trained env-steps/s, mean gates passed, the rollout/learner split and a
   trace as in phase 12. K8's row joins the ``kernels`` line (K2-K8): its
   time at 1024 envs, T = 32, K = 4, beside its time at K = 1 and 2;
15. inside K7 and K8: their instrumented bf16 instantiations at the timed
   shapes (K7; K8 at 1 and 4 frames), the step split into render, stack
   (K8's stack assembly, K7's level conversion), embed, fc, heads and the
   sample and env step (thread 0 of each block reads ``%globaltimer`` at each
   phase boundary; ms a launch, mean over the blocks), each beside one
   cuBLAS bf16 ``torch.matmul`` of the same products as a yardstick the port
   never calls;
16. ``ActorCritic`` on the card against the CPU (float32, TF32 off,
   1e-5), then the state learner with its counters at 0: ``train_acro`` at
   ``bench.py``'s trainer shape (4096 envs, T = 32, 30 iterations,
   ``scan_chunk=10``, the first chunk left out): the eager ``AcroEnv.step``
   once a step, no kernel of K2-K8 (the counters stay 0, printed); finite
   losses and rewards, trained env-steps/s, the rollout/learner split and a
   trace as in phase 12;
17. the state race learner with its counters at 0: ``train_race`` at the
   JAX function's defaults (1024 races of 4 agents, 4096 learner rows,
   T = 32), as phase 16, with the mean gates passed;
18. the flagship eval with its counters at 0: ``play_policy`` on the
   shipped racer (``runs/flagship_torch``, ``load_flagship``) with its
   meta.json play kwargs at ``bench.py::measure_flagship_gates``'s shape (32
   envs, 2000 steps, chunks of 500, the deterministic mean action, the bf16
   patch net) for seeds 7, 8 and 9: each seed's ``final_gates_passed_mean``,
   their mean and spread beside the JAX package's 51.72 gates on the TPU
   (``BENCH_r05.json``; a count of gates, not a speed), eval env-steps/s,
   the K5 launches (the env's render, one a step) and the device's busy
   share over 100 eval steps. Fails if the mean falls below 85 % of 51.72;
19. the conv net and the GRU-128 net on the card against the CPU (256
   frames of 96x72 levels), inside the nets' ``flax_reductions`` scope
   (cuBLAS's bf16 reduced-precision reductions and cuDNN's TF32 off):
   float32 within 1e-5; bf16 teacher-forced, every bf16 layer fed the CPU's
   input within one bf16 step of its largest output of the CPU's, with at
   most 1 % of its outputs off (the libraries' sum order; cuDNN's bf16
   convolutions are not all correctly rounded), the float32 GRU and heads
   fed the CPU's features within 1e-5, the end-to-end error printed; beside
   each, what the library defaults would move;
20. K5 on the 4-agent race's frames (256 races x 4 agents, the others as
   per-camera spheres, with and without 3 obstacles) against
   ``render_depth_reference``: levels equal, and its time;
21. the conv scan trainer with its counters at 0: ``train_vision(rollout=
   "scan", torso="conv", pixel_store="f32", update_epochs=4)`` (the JAX
   package's round-2 recipe) at 1024 envs, T = 32, 6 iterations in chunks
   of 2: K5 at least once an env step and no K7 or K8, finite losses,
   trained env-steps/s (first chunk left out), the split and a trace as in
   phase 12;
22. the curriculum with its counters at 0: ``train_vision(curriculum_iters=4)``
   (auto -> the scan rollout, patch torso) at 1024 envs, a chunk an
   iteration: the worlds drawn before each chunk differ and ramp the active
   cylinders with the difficulty, finite losses;
23. the GRU race trainer with its counters at 0: ``train_vision_race(
   num_envs=256, n_agents=4, permute_spawns=True, gru=128, gate_size=7.0)``
   (``tools/experiments_r5.py:580``, 1024 learner rows), 6 iterations: K5 a
   step, the rate, the split, a trace, the mean gates passed, and a finite,
   non-zero hidden in the final checkpoint;
24. SAC's actor and twin critic, and one train step with one update
   (batch 2048 from a replay of 66 560), on the card against the same
   weights, replay and draws on the CPU (the draws fed through the
   learner's seams; float32, TF32 off): forward within 1e-5, losses,
   alpha and entropy within 1e-6 + 1e-5 relative, every parameter within
   1e-6 + 1e-4 relative;
25. the SAC main path with its counters at 0 (they must stay 0):
   ``train_sac``'s defaults (1024 envs, buffer 500 000, batch 2048, 8
   updates a step, 50 warm-up steps), 300 iterations in chunks of 100, the
   first left out: trained env-steps/s (transitions stored a second), the
   reward, alpha and entropy, the replay's fill (a spy on its insert), the
   split of an iteration (the env step and its insert, the updates) and a
   trace;
26. the ES main path with its counters at 0: ``train_es(env_name="acro")``'s
   defaults (256 candidates x 256 envs x 60 steps), 6 generations in
   chunks of 2, the first left out: fitness-rollout env-steps/s and the
   generation-best fitness; one generation split with CUDA events into
   the candidates' batched forward, the eager env step and the rest, and
   a trace; then 2 generations on ``env_name="rotate"``, finite fitness;
27. multi-process training (``distributed=True``): (a) ``train_acro`` at
   world size 1 (no process group; 4096 envs, 3 iterations) equal to
   ``distributed=False`` bit for bit (parameters, Adam, infos); then one
   ``parallel.launch`` of two gloo ranks sharing the card (the machine has
   one GPU, and NCCL takes one rank a GPU), each running: (b) fixed-action
   rollouts of the 4096-env acro bank (64 steps, episodes of 16) and of
   1024 races x 4 agents (20 steps), equal to one process bit for bit;
   (c) one averaged update of ``ActorCritic(128, 128)`` on fixed
   trajectories (1 epoch, 1 minibatch) within 1e-6 of a one-process
   reference (both halves' gradients averaged, clipped, one Adam step),
   the replicas equal; (d) ``train_acro(distributed=True)`` at its defaults
   (4096 envs in all), 6 iterations, the first chunk left out: the
   aggregate rate beside phase 16's one process, the all-reduce's share
   of an iteration, the replicas equal; (e) ``train_vision(distributed=
   True)`` on the scan rollout (1024 envs in all, per-env random worlds, 3
   iterations): K5 launches a rank, finite losses, equal replicas; (f)
   ``train_es(distributed=True)`` at its defaults, 2 generations: the rate,
   and theta and the generation-best fitness within 1e-6 of world size 1;
28. the front door, with the launch counters at 0 before each path: (a)
   ``run_simulator(steps=600)`` headless on the card and on the CPU (same
   steps and crash, the final state within tests/test_torch_simulator.py's
   ``TOL_CRASH``; no kernel launched) and its sim steps/s; (b)
   ``render="2d"`` on seed 4's world (600 steps flown): a frame every other
   step, (480, 640) uint8, the first against the CPU's, frames/s; (c) the
   per-step path (a virtual target held by a scripted drag, 300 steps), its
   steps/s beside the reference's 60/s; (d) play's video on the flagship
   (``vision_race``, 16 envs, 120 steps): K5 renders each frame at 640x480
   (one camera; two K5 launches a step with the env's), frame 0 equal to
   K5's plain version on the same camera, K5's time and bound at that shape,
   video frames/s beside the same eval without it; the frames go to a list
   through play's frame path, and where cv2 imports ``save_video`` also
   writes ``build/chip_smoke/play_video.mp4`` (its frame count printed); (e)
   ``python -m fpyv_tpu_torch.cli`` as subprocesses: ``train --num-envs
   4096 --iterations 3``, ``train --vision --iterations 2`` (K7) and
   ``parity --steps 300`` (float64 on the card, ``"pass": true``), each
   exiting 0 with its JSON line.
29. the secondary paths, no kernel on any (every launch counter stays 0
   across the phase; TF32 off for their float32 products), each held
   against the CPU on the same CPU generator's draws: (a) ``SensorAcroEnv``
   at 4096 envs, 256 steps at throttle -0.6 (obs (4096, 21), finite, mass
   scales that vary, every env's obs changing at every step; 64 envs x 8
   steps against the CPU within 1e-4), its env-steps/s beside the eager
   ``AcroEnv(randomize=True)`` step's in the same call and its busy share;
   (b) ``HoverEnv`` + ``HoverPilot``, 4096 envs x 600 closed-loop steps on
   the card and on the CPU: the bank's mean error (last 50 below 2 m, and
   falling; its ratio printed beside JAX's single-env 0.3), the same envs
   crashed, the share of envs that meet both of JAX's conditions, 64 envs
   x 60 steps within 1e-4 m; (c) ANGLE and HORIZON from tilts up to 40
   degrees, 240 steps through ``drone_step`` at 4096 envs: roll and pitch
   below 2 degrees, no crash, 64 envs within 1e-4 of the CPU, HORIZON at
   full stick equal to acro's action; (d) the racer at 4096 envs, 1500
   steps: its rates within 5 % of (80, 10) deg/s, 64 envs against the CPU;
   (e) ``is_peak_altitude`` on (4096, 64) series (flags equal to the
   CPU's, both fits), the geometry algorithms at tests/test_geometry_es.py's
   sizes and tolerances, the terrain at 100x100 and ``attention`` within
   1e-5 of the CPU relative to the largest value, ``GymAdapter(AcroEnv(),
   16)``, ``evaluate_policy`` at 4096 envs x 50 steps, ``finite_mask`` and
   ``assert_finite`` on a bank with three poisoned envs;
30. the configurations the Pallas kernels take past the quad and the
   256-wide fc (``any_config_checks``, budget 60 s), each kernel equal to
   its plain version on the card (bf16 teacher-forced within
   ``TOL_BF16_HEADS``), its time beside the quad's or the 256-wide one's
   from the same call and its bound (``step_ops``, ``policy_ops`` and
   ``race_ops`` count the motor points and the fc width): (a) the acro
   megaloop of a hexacopter (``DroneParams(n_motors=6)``) at 4096 envs on
   the params.yaml world with DR and wind (K4 at K = 64, and one
   ``fused_env_rollout`` launch); (b) the contact-heavy bank at 3, 6 and 8
   motors through K3 and K4 (the share of envs that feel a contact at the
   first step printed, at least half); (c) the chase (K6) of a hexacopter
   at 1024 envs, 20-step episodes; (d) K7 and K8 at the trainers' shapes
   with an fc of 384 units in float32 and bf16 and of 200 in bf16 (padded
   to 208), each width held against its plain version on a hexacopter's
   bank (1024 envs, 4 steps of 3-step episodes: every env resets).

Phase 1 also counts the tensor-core instructions (``HMMA``, ``HGMMA``) of
each K7 and K8 instantiation in the built library (``cuobjdump -sass``) and
fails if a bf16 one has none, and prints ptxas' registers and spills and
the SASS instruction, MUFU and shuffle counts and trigonometric range
reductions of each K3, K4, K5 and K6 instantiation.
``python3 chip_smoke.py --phases`` runs the build, those counts, K3's time
and K4's split (default world from a fresh reset and on the bank the acro
main path leaves, params.yaml world with DR and wind), K6's split (on a
bank 8192 chase steps from a reset), phase 15 and phase 31 alone.

Phase 31 (``levels_lut_check``): levels_lut at the race learner's minibatch
(4096 x 108 x 256 uint8) into bf16 and float32, and into bf16 from an input
off a 16-byte boundary, each bit-equal to the plain three-pass chain and
timed beside it and its bound (bytes over 3.35 TB/s).

Any failed check raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Needs the repository beside it and CUDA;
without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fpyv_tpu_torch.apps.train import (
    make_vision_race_trainer,
    make_vision_trainer,
    train_vision,
    train_vision_race,
)
from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.envs.acro import AcroEnv, vector_reset
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv, default_vision_rig
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import env_kernel as ek
from fpyv_tpu_torch.models.policy import PixelActorCritic
from fpyv_tpu_torch.ops import policy_kernel as pk
from fpyv_tpu_torch.ops import race_kernel as rk
from fpyv_tpu_torch.ops import step_kernel as sk
from fpyv_tpu_torch.ops import vision_kernel as vk
from fpyv_tpu_torch.physics.drone import DroneParams, drone_reset
from fpyv_tpu_torch.physics.world import update_targets
from fpyv_tpu_torch.vision.camera import CameraRig
from fpyv_tpu_torch.world.generators import WorldSpec, build_world
from fpyv_tpu_torch.world.randomize import sample_worlds

N_ENVS = 4096
THROTTLE = -0.6
RUN_SECONDS = 8.0
N_VISION = 1024  # bench.py's vision lane: 1024 envs, the default 96x72 rig
CHASE_SECONDS = 10.0
PROBE_ENVS = (4096, 16384, 65536, 262144, 1048576)
PROBE_K = 1000

TRAIN_ITERS = 30  # bench.py::measure_vision_trainer: 1024 envs, 30 iterations, chunks of 10
TRAIN_CHUNK = 10
K7_STEPS = 32  # the trainer's T
RACE_STACK = 4  # bench.py::measure_vision_race_trainer: frame_stack=4, gate_size=5.0
STATE_ENVS = 4096  # bench.py's trainer shape for train_acro: 4096 envs, T = 32
RACE_RACES, RACE_AGENTS = 1024, 4  # train_race's defaults: 4096 learner rows
FLAGSHIP_ENVS, FLAGSHIP_STEPS, FLAGSHIP_CHUNK = 32, 2000, 500  # measure_flagship_gates
FLAGSHIP_SEEDS = (7, 8, 9)
FLAGSHIP_TPU_GATES = 51.72  # the JAX package's eval on the TPU (BENCH_r05.json)
SCAN_ITERS, SCAN_CHUNK = 6, 2  # the scan trainers: 6 iterations, the first chunk of 2 left out
CURRICULUM_ITERS = 4
GRU_RACES, GRU_AGENTS, GRU_WIDTH = 256, 4, 128  # tools/experiments_r5.py:580's recipe
SAC_ENVS, SAC_BATCH, SAC_BUFFER = 1024, 2048, 500_000  # train_sac's defaults (8 updates a step)
SAC_WARMUP, SAC_ITERS, SAC_CHUNK = 50, 300, 100  # the first chunk of 100 left out
SAC_PREFILL = 65536  # phase 24's replay before its one step
ES_ITERS, ES_CHUNK = 6, 2  # train_es's defaults: 256 candidates x 256 envs x 60 steps
SIM_STEPS = 600  # phase 28: the simulator's scripted flight (params.yaml, the default seed
#   0 crashes at step 84 inside the first 512-step chunk; seed 4's world flies all 600)
SIM_2D_SEED = 4
VT_STEPS, VT_PIXEL = 300, (320.0, 80.0)  # the per-step path: a drag held at this pixel
REFERENCE_FPS = 60.0  # config/params.yaml:7: the reference flies a human at 60 steps/s
VIDEO_STEPS, VIDEO_ENVS = 120, 16  # play's video: one chunk of 120 at the CLI's 16 envs
# the simulator on the card against the CPU: tests/test_torch_simulator.py::TOL_CRASH (a run
# that crashes at step 84); a frame after a step may differ on at most 0.5 % of its pixels
# (tests/test_torch_vision.py: an ulp of pose can move a point across a pixel's edge)
TOL_SIM = {"final_position": 1e-4, "final_velocity": 1e-3}
FRAME_SHARE = 0.005
CLI_CALLS = (("train", "--num-envs", "4096", "--iterations", "3"),  # README's width
             ("train", "--vision", "--iterations", "2"),  # K7
             ("parity", "--steps", "300"))
TRAIN_KEYS = {"iterations", "mean_reward_first", "mean_reward_last", "env_steps_per_second"}

# H100 SXM published peaks (NVIDIA data sheet), dense, at the 700 W limit
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# float32 step tolerances as the port's CPU tests state them: one step
# pos 1e-5, velocity 1e-4 (spring contacts), attitude 1e-6; K chained steps
# pos/vel/prev_dist 2e-4, attitude/rates 1e-4, reward sums 2e-3; t and done equal
TOL_STEP = {"pos": 1e-5, "vel": 1e-4, "att": 1e-6, "rates": 1e-4, "thrust": 1e-4, "done": 0.0}
TOL_ROLL = {"pos": 2e-4, "vel": 2e-4, "att": 1e-4, "rates": 1e-4, "thrust": 1e-3, "done": 0.0}
TOL_ENV = dict(TOL_ROLL, t=0.0, prev_dist=2e-4, episode_return=2e-3, dr=1e-5, wind=1e-4)
ROWS = {"pos": slice(0, 3), "vel": slice(3, 6), "att": slice(6, 10), "rates": slice(10, 13),
        "thrust": slice(13, 14), "done": slice(14, 15), "t": slice(15, 16),
        "prev_dist": slice(16, 17), "episode_return": slice(17, 18), "dr": slice(18, 21),
        "wind": slice(21, 24)}

# the chase (tests/test_pallas_vision.py:287-294): pos 1e-4, vel/att 1e-3
TOL_CHASE = dict(TOL_ENV, pos=1e-4, vel=1e-3, att=1e-3)

# K7 and K8 against their plain versions (tests/test_torch_policy_kernel.py):
# float32 weights across resets, summed in the plain version's order; bf16
# teacher-forced, summed on the tensor cores in the hardware's order, so the
# mean and value within TOL_BF16_HEADS = 4e-3: a sum an ulp across a bf16
# boundary moves a hidden unit by a bf16 step, and the order alone moved the
# value by up to 1.2e-3 over 1024 rows at K8's widths
# (tests/test_torch_actor_order.py); about 3x that for the 32x more rows here
TOL_K7 = {"extra": 1e-6, "action": 5e-5, "reward": 1e-5, "value": 5e-5, "log_prob": 1e-4,
          "state": 1e-3}
TOL_K7_BF16 = {"action": pk.TOL_BF16_HEADS, "value": pk.TOL_BF16_HEADS, "reward": 1e-5,
               "state": 1e-4}

SOURCES = {"drone_step": "fpyv_tpu_torch/csrc/step_kernels.cu",
           "rollout": "fpyv_tpu_torch/csrc/step_kernels.cu",
           "env_rollout": "fpyv_tpu_torch/csrc/env_kernels.cu",
           "render_depth": "fpyv_tpu_torch/csrc/vision_kernels.cu",
           "vision_env_rollout": "fpyv_tpu_torch/csrc/vision_kernels.cu",
           "policy_vision_rollout": "fpyv_tpu_torch/csrc/policy_kernels.cu",
           "race_vision_rollout": "fpyv_tpu_torch/csrc/race_kernels.cu"}
REPLACES = {"drone_step": "fpyv_tpu/ops/pallas_step.py:313",
            "rollout": "fpyv_tpu/ops/pallas_step.py:326",
            "env_rollout": "fpyv_tpu/ops/pallas_env.py:325",
            "render_depth": "fpyv_tpu/ops/pallas_vision.py:297",
            "vision_env_rollout": "fpyv_tpu/ops/pallas_vision.py:661",
           "policy_vision_rollout": "fpyv_tpu/ops/pallas_policy.py:194",
           "race_vision_rollout": "fpyv_tpu/ops/pallas_race.py:133"}


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name: str, out: torch.Tensor, ref: torch.Tensor, tol: dict) -> float:
    """Max abs error per field of a state matrix; raise past the tolerance."""
    worst = 0.0
    errs = {}
    for field, atol in tol.items():
        rows = ROWS[field]
        if rows.start >= out.shape[0]:
            continue
        e = (out[rows] - ref[rows]).abs().max().item()
        errs[field] = e
        if not e <= atol:
            raise AssertionError(f"{name}: {field} max abs err {e} > {atol}")
        worst = max(worst, e)
    log(f"{name}: max abs err per field {json.dumps(errs)}")
    return worst


def reward_err(name: str, rsum: torch.Tensor, ref: torch.Tensor) -> float:
    e = (rsum - ref).abs().max().item()
    if not e <= TOL_ENV["episode_return"]:
        raise AssertionError(f"{name}: reward sum max abs err {e}")
    return e


def equal_bits(name: str, pairs) -> None:
    """K3 and K4 equal their plain versions bit for bit: each (kernel,
    plain) pair of tensors equal."""
    for out, ref in pairs:
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: not equal to its plain version, max abs err "
                                 f"{(out - ref).abs().max().item()}")


def contact_bank(env, gen, n: int, dev):
    """A contact-heavy start: ``contact_world`` (2 spheres, 8 cylinders
    0.15-0.25 m apart) with n drones at its gaps (``contact_start``), so
    several motor points touch a sphere and a cylinder in one step."""
    from fpyv_tpu_torch.world.generators import contact_start, contact_world

    w = contact_world(device=dev)
    st, _ = vector_reset(env, gen, n, w)
    pos, vel, ypr = (torch.from_numpy(a).to(dev) for a in contact_start(n, 17))
    return w, st.replace(drone=drone_reset(env.params, pos, vel, ypr))


def check_state(name: str, mat: torch.Tensor, n: int, max_t=None) -> None:
    """The repo's own sanity checks: finite, shaped, unit quaternions."""
    if mat.shape[1] != n or not torch.isfinite(mat).all():
        raise AssertionError(f"{name}: non-finite or misshaped state {tuple(mat.shape)}")
    qn = mat[6:10].norm(dim=0)
    if (qn - 1).abs().max().item() > 1e-4:
        raise AssertionError(f"{name}: quaternion norms off by {(qn - 1).abs().max().item()}")
    if max_t is not None and not ((mat[15] >= 0) & (mat[15] < max_t)).all():
        raise AssertionError(f"{name}: episode counter out of [0, {max_t})")


def check_chase(label: str, env, out, ref, rsum, ref_rsum, crashes, ref_crashes, contacts,
                ref_contacts, n: int, resets: int) -> float:
    """K6 against its plain version: crash and contact counts equal, t equal,
    pos 1e-4, vel and attitude (up to sign) 1e-3, reward sums 2e-3; returns
    the largest error."""
    check_state("K6", out, n, max_t=env.max_episode_steps)
    if not (torch.equal(crashes, ref_crashes) and torch.equal(contacts, ref_contacts)):
        raise AssertionError(f"K6 ({label}): crash or contact counts differ")
    qd = torch.minimum((out[6:10] - ref[6:10]).abs().amax(0),
                       (out[6:10] + ref[6:10]).abs().amax(0)).max().item()
    tol = {k: v for k, v in TOL_CHASE.items() if k != "att"}
    err = max(compare(f"K6 vision_env_rollout ({label}, {resets} resets, "
                      f"{int(ref_crashes.sum().item())} crashes, "
                      f"{int(ref_contacts.sum().item())} contacts)", out, ref, tol),
              reward_err("K6", rsum, ref_rsum), qd)
    if qd > TOL_CHASE["att"]:
        raise AssertionError(f"K6 ({label}): attitude err {qd}")
    return err


def read_counts(label: str, names, launches: dict) -> None:
    """Read a main path's launch counters (reset just before it) into
    ``launches``; fail if one of its kernels never launched."""
    got = {k: _build.launch_counts[k] for k in names}
    missing = [k for k, v in got.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")
    launches.update(got)
    log(f"{label} launches: {json.dumps(got)}")


def device_busy(fn, top: int = 5):
    """Run fn under torch.profiler: (summed device time of the kernels /
    wall time, the ``top`` kernels by device time in ms). Only device-side
    events count (an ``aten::`` op's row repeats its kernels' time), and no
    user annotation (``Optimizer.step#Adam.step`` is a device-side range
    around Adam's kernels, which would count them twice); the sum
    over-counts where kernels overlap; 0.0 where the trace shows no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    by_name = {}  # names cut to 60 characters; kernels that share a cut name add up
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + ev.device_time_total
    busy = sum(by_name.values()) * 1e-6 / wall
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, {k: round(us * 1e-3, 6) for k, us in ranked}


def cuda_ms(fn, reps: int) -> float:
    """ms a call of fn: CUDA events around ``reps`` calls after a warm-up.
    The device first sleeps for longer than one call took, device included,
    times ``reps``, so the host has enqueued the calls before the device
    reaches them and the events time the device's work, not the host's
    pace (a call that waits on the host inside, as a blocking copy does,
    still shows that wait)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(one * reps, 2.0) * 2.5e9))  # clock cycles: at most ~2.5 s
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# Least time for the work: operations counted from csrc/physics.cuh and
# csrc/env_kernels.cu, one per add/mul/compare/select/min/max/abs/div/sqrt/
# sin/cos/log/floor and per integer op of the hash (a lower bound: libm
# calls are many instructions), against the float32 peak; bytes are each
# input read once and each output written once.
# ---------------------------------------------------------------------------


def step_ops(S: int, C: int, reps: int = 2, dr: bool = False, wind: bool = False,
             n_motors: int = 4) -> int:
    base = 12 + 9 + 5 + 6 + 3 + 39 + 3 + 6 + 15 + 6 + 15  # action, R, thrust, drag
    motors = n_motors * (19 + 31 * S + 58 * C)  # motor points, ground, spheres, cylinders
    tail = 10 + 12 + 42 + 31 * reps + 1  # accel, integrate, attitude, done
    return base + motors + tail + (7 if dr else 0) + (3 if wind else 0)


def reset_ops(dr: bool, gust: bool) -> int:
    draw = 13  # counter, xor, fmix (8), shift, convert, scale
    ops = 10 * draw + 6 + 18 + 3 + 9 + 6 + 20 + 9
    return ops + (3 * draw + 6 if dr else 0) + (4 * draw + 24 if gust else 0)


def render_ops(cfg: "vk.RenderConfig", live_gates: int) -> int:
    """Counted operations per pixel of csrc/render.cuh for one config: the
    world ray, each included primitive, the level encoding. Only the
    ``live_gates`` gate slots active in some env count: an inactive slot
    cannot change the frame, so the least work leaves it out (the kernel
    still runs its masked arithmetic)."""
    ops = 15 + 8
    ops += (5 + 33 * cfg.n_spheres) if cfg.spheres else 0
    ops += 50 * cfg.n_cylinders if cfg.cylinders else 0
    ops += (11 + (8 if cfg.ground_extent is not None else 0)) if cfg.ground else 0
    return ops + (89 * live_gates if cfg.gates else 0)


def chase_step_ops(hw: int, S: int, C: int, dr: bool, wind: bool, n_motors: int = 4) -> int:
    """Counted operations per env-step of K6: the target-only render (world
    ray, |d|^2, sphere, compare: 54 per pixel; the accumulation of lit pixels
    is left out), the block reduction, the camera pose, the target centres,
    the pilot, then the K4 physics and env rows."""
    return (hw * 54 + 130 + 102 + 15 * S + 182 + step_ops(S, C, dr=dr, wind=wind, n_motors=n_motors)
            + 24)


def bound(ops: float, nbytes: float, tensor_flops: float = 0.0):
    """(least ms, what sets it): float32 operations over the float32 peak,
    bf16 tensor-core flops over the tensor-core peak, bytes over HBM's rate."""
    t_ops = max(ops / PEAK_F32_OPS, tensor_flops / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def policy_setup(dev, gen, n: int, max_steps: int, bf16: bool, hidden: int = 256):
    """The trainer's env (quat, no DR or wind) in per-env sample_worlds with
    1 sphere and 4 cylinders, a reset bank as the (N, 18) matrix, and a
    Flax-initialised net (fc width ``hidden``) whose std samples and whose
    mean head steers."""
    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=max_steps)
    worlds = sample_worlds(gen, n, n_spheres=1, n_cylinders=4, device=dev)
    st, _ = vector_reset(env, gen, n, worlds)
    net = PixelActorCritic(action_dim=4, n_patches=108, torso="patch", prepatched=True,
                           compute_dtype=torch.bfloat16 if bf16 else None, hidden=(hidden,),
                           device=dev).init_params(gen)
    with torch.no_grad():
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    cfg = vk.RenderConfig.for_world(worlds, 25.0)
    return env, worlds, pk.acro_state_to_cols(st), w, cfg, pk.policy_world_cols(worlds, n)


def max_err(name: str, a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    e = (a - b).abs().max().item()
    if not e <= tol:
        raise AssertionError(f"K7: {name} max abs err {e} > {tol}")
    return e


def policy_ops(hw: int, cfg, n_patches: int, S: int, C: int, hidden: int = 256,
               n_motors: int = 4):
    """(float32 operations, bf16 flops) per env-step of K7: the render
    (render_ops per pixel), physics, sampling and env; the actor's products
    as tensor-core work: patch embed, fc over its real rows and the net's
    ``hidden`` units, heads."""
    ops = hw * render_ops(cfg, 0) + step_ops(S, C, n_motors=n_motors) + 2 * 13 + 20 + 30 + 41
    flops = 2 * (n_patches * 64 * 128 + (n_patches * 128 + 5) * hidden + hidden * 5)
    return ops, flops


def race_setup(dev, gen, n: int, K: int, S: int, max_steps: int, bf16: bool, hidden: int = 256,
               n_motors: int = 4):
    """The race trainer's single-agent env (96x72, the 6-gate track of gate
    size 5, S obstacles) on its track, n fresh races as the (N, 22) matrix, a
    random history of levels and a Flax-initialised frame-stacked net (fc
    width ``hidden``) whose std samples and whose mean head steers."""
    venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=1, gate_size=5.0, max_episode_steps=max_steps,
                                           n_obstacles=S,
                                           params=DroneParams(att_mode="quat", n_motors=n_motors)),
                         frame_stack=K)
    world = venv.default_world(dev)
    st, _ = venv.race.reset(gen, world, (n,))
    hist = torch.randint(0, 256, (n, 108 * (K - 1) * 64), generator=gen, dtype=torch.uint8)
    net = PixelActorCritic(action_dim=4, n_patches=108, proprio_dim=5 + venv.n_gates,
                           torso="patch", prepatched=True,
                           compute_dtype=torch.bfloat16 if bf16 else None, frame_stack=K,
                           hidden=(hidden,), device=dev).init_params(gen)
    with torch.no_grad():
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    return (venv, rk.race_state_to_cols(st), hist.to(dev), w, rk.race_world_cols(world),
            rk.obstacle_cols(world, S))


def race_ops(hw: int, cfg, n_patches: int, K: int, G: int, hidden: int = 256,
             n_motors: int = 4):
    """(float32 operations, bf16 flops) per env-step of K8: the render
    (render_ops per pixel, every gate live), the camera, obstacle centres,
    proprio, sampling, physics and the race step; the actor's products as
    tensor-core work: the K*64-wide embed, fc over its real rows and the
    net's ``hidden`` units, heads."""
    S = cfg.n_spheres
    ops = (hw * render_ops(cfg, G) + 60 + 16 * S + 5 + 3 * G + 2 * 13 + 20 + 30
           + step_ops(S, 0, n_motors=n_motors) + 60)
    flops = 2 * (n_patches * K * 64 * 128 + (n_patches * 128 + 5 + G) * hidden + hidden * 5)
    return ops, flops


RACE_RESET_OPS = 4 * 13 + 2 * 8 + 6 + 20  # 4 draws, 2 Box-Muller pairs, jitter, gate-0 distances


def edge_weights(dev, bf16: bool, proprio: int, K: int):
    """A Flax-initialised patch net (108 patches, K frames) whose std samples
    and whose mean head steers, as the kernels' weights."""
    net = PixelActorCritic(action_dim=4, n_patches=108, proprio_dim=proprio, torso="patch",
                           prepatched=True, compute_dtype=torch.bfloat16 if bf16 else None,
                           frame_stack=K, device=dev)
    net.init_params(torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    return pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)


def rollout_err(label: str, out, ref, bf16: bool, exact_cols) -> float:
    """A K7 or K8 launch against its plain version (teacher-forced in bf16):
    frames, env ends and the state's ``exact_cols`` equal, the rest within
    TOL_K7 (float32) or TOL_K7_BF16; the largest error."""
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[2][..., 5], ref[2][..., 5])
            and all(torch.equal(out[3][:, c], ref[3][:, c]) for c in exact_cols)):
        raise AssertionError(f"{label}: frames, env ends or state columns {exact_cols} differ")
    tol = TOL_K7_BF16 if bf16 else TOL_K7
    return max(max_err(f"{label} extra", out[1], ref[1], TOL_K7["extra"]),
               max_err(f"{label} action", out[2][..., :4], ref[2][..., :4], tol["action"]),
               max_err(f"{label} reward", out[2][..., 4], ref[2][..., 4], tol["reward"]),
               max_err(f"{label} value", out[2][..., 6], ref[2][..., 6], tol["value"]),
               max_err(f"{label} state", out[3], ref[3], TOL_K7["state"]))


def edge_world_checks(dev, rig) -> dict:
    """K7 and K8 against their plain versions on the render's edge worlds
    (``world.generators.render_edge_bank``: a camera inside a sphere or an
    open tube, on the ground plane, in a gate's plane, looking down a tube;
    inactive primitives; a gate behind the camera; ``race_edge_start``: a
    camera inside an obstacle and on its orbit, an edge-on gate, a gate
    behind), 8 steps of 3-step episodes: K7 at 64 envs with the ground
    clipped (float32) and at 13 (a last block of 5) with the ground left
    out (bf16, teacher-forced); K8 at 64 envs, 2 frames, 3 obstacles
    (float32) and at 13, 4 frames, the ground off (bf16). The largest error
    of each kernel."""
    from fpyv_tpu_torch.world.generators import race_edge_start, render_edge_bank

    errs = {}
    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=3)
    for n, extent, include, bf16 in ((64, 4.0, pk.INCLUDE, False),
                                     (13, None, ("spheres", "cylinders", "gates"), True)):
        worlds, pos, quat = render_edge_bank(n, rig, device=dev)
        cols = torch.zeros(n, pk.ROWS, device=dev)
        cols[:, 0:3] = torch.from_numpy(pos).to(dev)
        cols[:, 6:10] = torch.from_numpy(quat).to(dev)
        w = edge_weights(dev, bf16, 5, 1)
        cfg = vk.RenderConfig.for_world(worlds, 25.0, include, extent)
        wcol = pk.policy_world_cols(worlds, n)
        out = pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w, 8, 5)
        torch.cuda.synchronize()
        ref = pk.policy_vision_rollout_reference(env, rig, cols, wcol, cfg, w, 8, 5,
                                                 forced_actions=out[2][..., :4] if bf16 else None)
        label = f"K7 edge worlds (N={n}, {'bf16' if bf16 else 'float32'}, ground " + (
            "left out" if "ground" not in include else f"clipped at {extent}") + ")"
        e = rollout_err(label, out, ref, bf16, (14, 15))
        errs["policy_vision_rollout"] = max(errs.get("policy_vision_rollout", 0.0), e)
        log(f"{label}: frames, crash flags and t equal, max abs err {e}")
    gen = torch.Generator().manual_seed(4)
    for n, K, ground, bf16 in ((64, 2, True, False), (13, RACE_STACK, False, True)):
        venv, cols, hist, _, _, _ = race_setup(dev, gen, n, K, 3, 3, bf16=False)
        world, pos = race_edge_start(venv.default_world(dev), n, venv.rig,
                                     venv.race.obstacle_period)
        world = world.replace(has_ground=torch.tensor(ground, device=dev))
        cols[:, 0:3] = torch.from_numpy(pos).to(dev)
        cols[:, 3:6] = 0.0
        cols[:, 10:13] = 0.0
        cols[:, 6:10] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        w = edge_weights(dev, bf16, 5 + venv.n_gates, K)
        wcol, ocol = rk.race_world_cols(world), rk.obstacle_cols(world, 3)
        out = rk.launch_race_vision_rollout(venv, cols, hist, wcol, ocol, w, 8, 5)
        torch.cuda.synchronize()
        ref = rk.race_vision_rollout_reference(venv, cols, hist, wcol, ocol, w, 8, 5,
                                               forced_actions=out[2][..., :4] if bf16 else None)
        label = (f"K8 edge worlds (N={n}, K={K} frames, 3 obstacles, "
                 f"{'bf16' if bf16 else 'float32'}, ground {'on' if ground else 'off'})")
        e = rollout_err(label, out, ref, bf16, (14, 15, 16, 19, 21))
        errs["race_vision_rollout"] = max(errs.get("race_vision_rollout", 0.0), e)
        log(f"{label}: frames, env ends and gate counters equal, max abs err {e}")
    return errs


def trainer_split(label: str, trainer, rollout: str = "kernel + bootstrap frame") -> None:
    """One trainer iteration split with CUDA events into the rollout (one
    kernel launch and the bootstrap frame, or T eager env steps) and the
    rest (the learner), best of 3 after a warm-up, then one iteration
    traced under torch.profiler."""
    tstate, _ = trainer.train_iteration(trainer.state)  # warm-up
    split = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        trainer.rollout_fn(tstate)
        ev[1].record()
        ev[2].record()
        tstate, _ = trainer.train_iteration(tstate)
        ev[3].record()
        torch.cuda.synchronize()
        split.append((ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])))
    roll_ms, iter_ms = min(r for r, _ in split), min(i for _, i in split)
    log(f"{label} iteration split (CUDA events, best of 3): rollout ({rollout}) "
        f"{roll_ms:.6f} ms, whole iteration {iter_ms:.6f} ms, learner {iter_ms - roll_ms:.6f} "
        f"ms; all {[[round(a, 6), round(b, 6)] for a, b in split]}")

    def one_iteration():
        nonlocal tstate
        tstate, _ = trainer.train_iteration(tstate)
        torch.cuda.synchronize()

    busy, top = device_busy(one_iteration, top=8)
    log(f"{label} trace: device busy {busy:.6f} of one iteration's wall time; top kernels by "
        f"device time (ms): {json.dumps(top)}")


def sass_sections() -> dict:
    """Kernel name -> its SASS lines in the built library (``cuobjdump -sass``)."""
    exe = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {sec.split("\n", 1)[0].strip(): sec.splitlines()
            for sec in sass.split("Function : ")[1:]}


def sass_mma_counts(sections: dict) -> dict:
    """Tensor-core instructions in each K7 and K8 instantiation of the built
    library: ``HMMA`` (mma.sync) and ``HGMMA`` (wgmma) per kernel. Raises if
    a bf16 instantiation has none."""
    counts = {}
    for name, lines in sections.items():
        for kern in ("policy_vision_rollout", "race_vision_rollout"):
            if f"{kern}_kernel" in name:
                label = (kern + (" bf16" if "bfloat16" in name else " float32")
                         + (" instrumented" if "Lb1ELb1E" in name else "")
                         + (" generic motors" if "Li0E" in name else ""))
                counts[label] = {"HMMA": sum("HMMA" in ln for ln in lines),
                                 "HGMMA": sum("HGMMA" in ln for ln in lines)}
    log(f"tensor-core instructions in the built kernels (cuobjdump -sass): {json.dumps(counts)}")
    bf16 = {k: v for k, v in counts.items() if "bf16" in k}
    if len(bf16) != 6 or any(v["HMMA"] + v["HGMMA"] == 0 for v in bf16.values()):
        raise AssertionError(f"a bf16 instantiation of K7 or K8 runs no tensor-core "
                             f"instruction: {counts}")
    return counts


SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")  # an instruction
REPORTED_KERNELS = re.compile(r"(env_rollout_kernel|rollout_kernel|chase_kernel|render_depth_kernel)"
                              r"(?:I((?:L[bi]\d+E)+)E)?E")
ACTOR_KERNELS = re.compile(r"(policy_vision_rollout_kernel|race_vision_rollout_kernel)"
                           r"I(f|13__nv_bfloat16)((?:L[bi]\d+E)+)E")


def kernel_label(mangled: str):
    """``chase_kernel<4,0,0,1>`` for a mangled K3, K4, K5 or K6 instantiation
    (its template arguments in order), ``policy_vision_rollout_kernel<bf16,
    1,0,4>`` for K7 and K8 (weight type, bf16, instrumented, motors), else
    None."""
    m = ACTOR_KERNELS.search(mangled)
    if m:
        args = ["bf16" if m.group(2) != "f" else "f32"] + re.findall(r"L[bi](\d+)E", m.group(3))
        return f"{m.group(1)}<{','.join(args)}>"
    m = REPORTED_KERNELS.search(mangled)
    if not m:
        return None
    args = re.findall(r"L[bi](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report() -> dict:
    """Kernel label -> ptxas' registers and spills, from this process's
    build log (empty where the library was built before)."""
    ptxas, name = {}, None
    for ln in str(_build.build_info.get("log", "")).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in ln or "registers" in ln):
            ptxas[name] = (ptxas.get(name, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return ptxas


def kernel_report(sections: dict) -> dict:
    """ptxas' registers and spills and the SASS instruction counts (all but
    NOP; MUFU, the special-function unit's; SHFL, the warp shuffles) of each
    K3, K4, K5, K6, K7 and K8 instantiation, and its trigonometric range reductions
    (the multiplies by 2/pi that start each inline ``sinf``/``cosf``: a sine
    and a cosine of one argument fused into one ``sincosf`` share one).
    Template arguments: K3's lanes and motors; K4's lanes, motors,
    DomainRand, wind, instrumented; K6's motors, DomainRand, wind,
    instrumented (motors 4: the quad's contact loop, 0: the generic one)."""
    ptxas = ptxas_report()
    report = {}
    for mangled, lines in sections.items():
        label = kernel_label(mangled)
        if label is None:
            continue
        ops = [m.group(1) for m in (SASS_OP.search(ln) for ln in lines) if m]
        report[label] = {"ptxas": ptxas.get(label, "not in the build log"),
                         "sass_instructions": sum(op != "NOP" for op in ops),
                         "MUFU": sum(op.startswith("MUFU") for op in ops),
                         "SHFL": sum(op.startswith("SHFL") for op in ops),
                         "trig_reductions": sum("0.63661974" in ln for ln in lines)}
    for label in sorted(report):
        log(f"{label}: {json.dumps(report[label])}")
    return report


def phase_split(label: str, launch, n: int) -> dict:
    """The step's phases inside one launch of K7 or K8: ``launch(phase_ns)``
    runs the kernel, instrumented when ``phase_ns`` is a tensor. Prints the
    split as ms a launch (each block's time averaged over the blocks) beside
    the instrumented and the plain launch's times."""
    plain_ms = cuda_ms(lambda: launch(None), 3)
    ns = torch.zeros(pk.N_PHASES, dtype=torch.int64, device="cuda")
    launch(ns)  # warm-up of the instrumented instantiation
    ns.zero_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    launch(ns)
    ev[1].record()
    torch.cuda.synchronize()
    split = pk.phase_split_ms(ns, n)
    log(f"{label} phase split (ms a launch, %globaltimer, mean over blocks): "
        f"{json.dumps(split)}; phases sum {sum(split.values()):.6f} ms, instrumented launch "
        f"{ev[0].elapsed_time(ev[1]):.6f} ms, plain launch {plain_ms:.6f} ms")
    return split


def cublas_yardstick(dev, K: int, n_prop: int) -> float:
    """ms of the actor's products for one launch done by cuBLAS in bf16 (one
    ``torch.matmul`` each, a yardstick the port never calls): per step the
    embed (N*108, K*64) @ (K*64, 128) and the fc (N, 108*128 + n_prop) @
    (., 256), times T steps."""
    g = torch.Generator(device=dev).manual_seed(K)
    a = torch.rand(N_VISION * 108, K * 64, device=dev, generator=g).to(torch.bfloat16)
    we = torch.randn(K * 64, 128, device=dev, generator=g).to(torch.bfloat16)
    x = torch.rand(N_VISION, 108 * 128 + n_prop, device=dev, generator=g).to(torch.bfloat16)
    wf = torch.randn(108 * 128 + n_prop, 256, device=dev, generator=g).to(torch.bfloat16)

    def products():
        for _ in range(K7_STEPS):
            torch.matmul(a, we)
            torch.matmul(x, wf)

    return cuda_ms(products, 5)


def k5_yardstick(cfg, consts, cols: torch.Tensor, wcol: torch.Tensor, rig) -> float:
    """T = 32 times K5's ms (``launch_render_depth``, the kernel that
    ``fused_render_depth`` launches) on one step of a K7 or K8 bank: the
    cameras of its state rows (``consts``' mount and offset) over the same
    render config and world columns (K5 renders row-major, the rollouts
    patch-major: the same pixels). The per-pixel rate the card already
    reaches on that scene, a yardstick for the rollout's render phase."""
    st = list(cols.unbind(1))
    cR, (cx, cy, cz) = vk.camera_rows(consts.mount, consts.rel, st)
    zero = torch.zeros_like(cx)
    cam = torch.stack([cx, cy, cz] + cR + [zero] * 4, dim=1).contiguous()
    dcam = vk.device_dcam(rig, cols.device)
    return K7_STEPS * cuda_ms(lambda: vk.launch_render_depth(cfg, dcam, cam, wcol), 50)


def actor_phases(dev, gen, rig) -> None:
    """The step's phases inside K7 (the trainer's shape) and K8 (1 and 4
    frames), each beside cuBLAS's time for the same products and the K5
    yardstick of its render (:func:`k5_yardstick`)."""
    envk, _, kcols, wbf, kcfg, kwcol = policy_setup(dev, gen, N_VISION, 1000, bf16=True)
    split = phase_split(f"K7 (N={N_VISION}, T={K7_STEPS}, bf16)",
                        lambda ns: pk.launch_policy_vision_rollout(envk, rig, kcols, kwcol, kcfg,
                                                                   wbf, K7_STEPS, 9, phase_ns=ns),
                        N_VISION)
    log(f"K7 products: embed + fc {split['embed'] + split['fc']:.6f} ms a launch in the kernel; "
        f"cuBLAS bf16 yardstick {cublas_yardstick(dev, 1, 5):.6f} ms")
    k5 = k5_yardstick(kcfg, pk.policy_constants(envk, rig), kcols, kwcol, rig)
    log(f"K7 render: {split['render']:.6f} ms a launch; K5 yardstick on K7's scene "
        f"({K7_STEPS} x K5 on the bank's cameras and worlds) {k5:.6f} ms, "
        f"render / yardstick {split['render'] / k5:.3f}")
    for K in (1, RACE_STACK):
        venvr, rcols, rhist, rwbf, rwcol, rocol = race_setup(dev, gen, N_VISION, K, 0, 2000,
                                                             bf16=True)
        split = phase_split(f"K8 (N={N_VISION}, T={K7_STEPS}, K={K} frames, bf16)",
                            lambda ns: rk.launch_race_vision_rollout(
                                venvr, rcols, rhist, rwcol, rocol, rwbf, K7_STEPS, 9,
                                phase_ns=ns), N_VISION)
        log(f"K8 products (K={K}): embed + fc {split['embed'] + split['fc']:.6f} ms a launch in "
            f"the kernel; cuBLAS bf16 yardstick {cublas_yardstick(dev, K, 11):.6f} ms")
        k5 = k5_yardstick(rk.race_render_config(venvr), rk.race_constants(venvr), rcols, rwcol,
                          venvr.rig)
        log(f"K8 render (K={K}): {split['render']:.6f} ms a launch; K5 yardstick on K8's scene "
            f"{k5:.6f} ms, render / yardstick {split['render'] / k5:.3f}")


def build_report(t0: float) -> None:
    """The build's time, ptxas' registers and spills, the tensor-core check,
    K3's, K4's, K5's and K6's registers, spills and instruction counts."""
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
        f"{_build.build_info.get('seconds', 0.0):.3f} s); ptxas: "
        + "; ".join(ln.strip() for ln in str(_build.build_info.get("log", "")).splitlines()
                    if "registers" in ln or "spill" in ln))
    sections = sass_sections()
    sass_mma_counts(sections)
    kernel_report(sections)


def chase_phases(dev, env, s28, wm, rig, k: int, plain_ms: float) -> dict:
    """The step's phases inside K6 on the chase state s28 (the default
    world): the instrumented instantiation's split (ms a launch, mean over
    the blocks) and the pixels its box tested and lit, beside the plain
    launch's ``plain_ms``."""
    n = s28.shape[1]
    probe = torch.zeros(vk.N_CHASE_PROBE, dtype=torch.int64, device=dev)
    timed_ms = cuda_ms(lambda: vk.launch_vision_env_rollout(env, s28, wm, k, rig, probe=probe), 10)
    probe.zero_()
    vk.launch_vision_env_rollout(env, s28, wm, k, rig, probe=probe)
    split = vk.chase_probe_split(probe, n, k)
    phases = sum(split[name] for name in vk.CHASE_PHASES)
    log(f"K6 (N={n}, K={k}, default world) phase split (ms a launch, %globaltimer, mean over "
        f"blocks): {json.dumps(split)}; phases sum {phases:.6f} ms, instrumented launch "
        f"{timed_ms:.6f} ms, plain launch {plain_ms:.6f} ms")
    return split


def chase_steady_bank(env, world, gen, n: int, steps: int = 8192):
    """A chase bank in its steady state: ``steps`` main-path steps from a
    reset (several 1000-step episodes), as (28, N) state and world rows."""
    st, _ = vector_reset(env, gen, n, world)
    st, w, _, _, _ = vk.fused_vision_env_rollout(env, st, world, steps)
    return vk.chase_state_matrix(st), ek.env_world_matrix(w)


def chase_placed(env, world, rig, gen, n: int, c_cam) -> torch.Tensor:
    """A fresh (28, N) chase bank with each drone moved so that the target's
    centre at step 0 sits at ``c_cam`` in its camera's frame."""
    st, _ = vector_reset(env, gen, n, world)
    s28 = vk.chase_state_matrix(st)
    p = vk.chase_constants(rig, vk.ChasePilot(), env.params)
    cR, cpos = vk.camera_rows(p.mount, p.rel, s28)
    T = update_targets(world).sphere_center[0]
    for k in range(3):
        ahead = cR[3 * k] * c_cam[0] + cR[3 * k + 1] * c_cam[1] + cR[3 * k + 2] * c_cam[2]
        s28[k] = T[k] - ahead - (cpos[k] - s28[k])
    return s28


def start_box(env, world, rig, s28):
    """The target's pixel box at step 0 (the plain ``target_pixel_box``)
    and whether any pixel of the frame's column 0 is lit."""
    p = vk.chase_constants(rig, vk.ChasePilot(), env.params)
    cR, cpos = vk.camera_rows(p.mount, p.rel, s28)
    n = s28.shape[1]
    T = update_targets(world).sphere_center[0]
    r = world.sphere_radius[0].expand(n)
    W, H = rig.resolution
    box = vk.target_pixel_box(p, cR, cpos, [T[k].expand(n) for k in range(3)], r, W, H)
    cfg = vk.RenderConfig(n_spheres=1, n_cylinders=0, n_gates=0, spheres=True, cylinders=False,
                          ground=False, gates=False, max_depth=1.0)
    wcol = torch.cat([T.expand(n, 3), r[:, None], torch.ones(n, 1, device=T.device),
                      torch.zeros(n, 1, device=T.device)], 1)
    dcam = torch.from_numpy(vk.flat_dcam(rig)).to(T.device)
    lit = vk.render_tiles(cfg, dcam, vk.camera_matrix(torch.stack(cpos, 1),
                                                      torch.stack(cR, 1).reshape(n, 3, 3)),
                          wcol) < 1e30
    return box + (lit.reshape(n, H, W)[:, :, 0].any(1),)


def render_data_ops(cfg, dcam, cam, wcol) -> int:
    """Counted operations of K5's frame on this data (csrc/render.cuh,
    render_levels): per pixel the world ray, the level and the per-pixel
    terms; per primitive and pixel a miss (inactive, disc < 0, a gate plane
    behind or parallel) ends early, a hit pays its full test. The pairs that
    reach the root are counted from the plain version's arithmetic. The
    kernel ends a miss early only where all of a thread's pixels miss, so
    this is the least its frame takes."""
    S, C, G = cfg.n_spheres, cfg.n_cylinders, cfg.n_gates
    n, hw = cam.shape[0], dcam.shape[1]
    wc = wcol.expand(n, -1)
    R = [cam[:, 3 + k:4 + k] for k in range(9)]
    d = [R[3 * i] * dcam[0:1] + R[3 * i + 1] * dcam[1:2] + R[3 * i + 2] * dcam[2:3]
         for i in range(3)]
    o = [cam[:, k:k + 1] for k in range(3)]
    per_pixel = 15 + 8 + (5 if cfg.spheres and S else 0) + (5 if cfg.cylinders and C else 0)
    per_pixel += (11 + (8 if cfg.ground_extent is not None else 0)) if cfg.ground else 0
    ops = n * hw * per_pixel
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    for s in range(S if cfg.spheres else 0):
        q = [wc[:, 5 * s + j:5 * s + j + 1] for j in range(5)]
        ox = [o[k] - q[k] for k in range(3)]
        b = ox[0] * d[0] + ox[1] * d[1] + ox[2] * d[2]
        c = ox[0] * ox[0] + ox[1] * ox[1] + ox[2] * ox[2] - q[3] * q[3]
        hit = ((b * b - a * c) >= 0) & (q[4] > 0.5)
        ops += n * hw * 9 + int(hit.sum().item()) * 24
    a2 = d[0] * d[0] + d[1] * d[1]
    for ci in range(C if cfg.cylinders else 0):
        q = [wc[:, 5 * S + 6 * ci + j:5 * S + 6 * ci + j + 1] for j in range(6)]
        ox, oy = o[0] - q[0], o[1] - q[1]
        b = ox * d[0] + oy * d[1]
        c = ox * ox + oy * oy - q[3] * q[3]
        hit = ((b * b - a2 * c) >= 0) & (q[5] > 0.5)
        ops += n * hw * 9 + int(hit.sum().item()) * 36
    for g in range(G if cfg.gates else 0):
        q = [wc[:, 5 * S + 6 * C + 15 * g + j:5 * S + 6 * C + 15 * g + j + 1] for j in range(15)]
        ndotd = q[3] * d[0] + q[4] * d[1] + q[5] * d[2]
        ndot0 = q[3] * (q[0] - o[0]) + q[4] * (q[1] - o[1]) + q[5] * (q[2] - o[2])
        front = (ndot0 * ndotd > 0) & (q[13] > 0.5)
        ops += n * hw * 9 + int(front.sum().item()) * 60
    return ops


def acro_main_path(label: str, env, world, gen, hover, smi: str):
    """The acro main path on one world: ``fused_env_rollout`` at N_ENVS
    envs from a reset, a 20000-step warm-up that sizes K so a launch takes
    about RUN_SECONDS, then two timed launches. Returns (env-steps/s, the
    state and world it left)."""
    state, _ = vector_reset(env, gen, N_ENVS, world)
    k_warm = 20_000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, w, rs = ek.fused_env_rollout(env, state, hover, world, k_warm, seed=0)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / k_warm
    k = min(int(RUN_SECONDS / per_step), ek.MAX_STEPS_PER_LAUNCH - 10_000)
    times = []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, w, rs = ek.fused_env_rollout(env, state, hover, w, k, seed=1 + rep)
        total = rs.sum().item()  # completion on the host is part of the time
        times.append(time.perf_counter() - t0)
        if not math.isfinite(total):
            raise AssertionError(f"main path ({label}): non-finite reward sum")
    check_state(f"main path ({label})", ek.env_state_to_matrix(state), N_ENVS,
                max_t=env.max_episode_steps)
    rate = N_ENVS * k / min(times)
    log(f"main path ({label}): {rate:.6e} env-steps/s at N={N_ENVS}, K={k} per launch, best of "
        f"{[round(t, 6) for t in times]} s, on {smi}")
    return rate, state, w


def env_phases(label: str, env, s24, a4, wm, k: int, cyl=None, plain_ms=None) -> dict:
    """The step's phases inside K4 on the bank s24: the instrumented
    instantiation's split (ms a launch, the first thread of each block,
    mean over the blocks) and the env-steps that reset, beside the plain
    launch's time (``plain_ms``, or timed here)."""
    n = s24.shape[1]
    probe = torch.zeros(ek.N_ENV_PROBE, dtype=torch.int64, device=s24.device)
    if plain_ms is None:
        plain_ms = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, wm, k, cyl_mat=cyl), 50)
    timed_ms = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, wm, k, cyl_mat=cyl,
                                                     probe=probe), 50)
    probe.zero_()
    ek.launch_env_rollout(env, s24, a4, wm, k, cyl_mat=cyl, probe=probe)
    split = ek.env_probe_split(probe, n)
    phases = sum(split[name] for name in ek.ENV_PHASES)
    log(f"K4 (N={n}, K={k}, {label}) phase split (ms a launch, %globaltimer, mean over blocks): "
        f"{json.dumps(split)}; phases sum {phases:.6f} ms, instrumented launch {timed_ms:.6f} "
        f"ms, plain launch {plain_ms:.6f} ms, {split['resets']} env-steps reset")
    return split


def acro_phases(dev, gen, smi: str) -> None:
    """``--phases``' K3 and K4: K3's time at its row's shape, K4's split on
    the default world from a fresh reset and on the bank the acro main path
    leaves, and on the params.yaml world with DomainRand and wind."""
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    world = env.default_world(dev)
    hover = torch.zeros(N_ENVS, 4, device=dev)
    hover[:, 3] = THROTTLE
    a4 = sk.action_matrix(hover)
    st, _ = vector_reset(env, gen, N_ENVS, world)
    s15, sph = sk.state_to_matrix(st.drone), sk.sphere_matrix(world)
    log(f"K3 (N={N_ENVS}, K=256, default world): "
        f"{cuda_ms(lambda: sk.launch_rollout(env.params, s15, a4, sph, 256), 20):.6f} ms")
    wm = ek.env_world_matrix(world)
    env_phases("default world, fresh reset", env, ek.env_state_to_matrix(st), a4, wm, 64)
    _, state, w = acro_main_path("default world", env, world, gen, hover, smi)
    env_phases("default world, the bank the main path left", env,
               ek.env_state_to_matrix(state), a4, ek.env_world_matrix(w), 64)
    env_dr = AcroEnv(params=env.params, randomize=True, wind=(1.0, 0.5, 0.0), wind_scale=0.5)
    pworld = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=dev)
    st, _ = vector_reset(env_dr, gen, N_ENVS, pworld)
    env_phases("params.yaml world + DR + wind, fresh reset", env_dr, ek.env_state_to_matrix(st),
               a4, ek.env_world_matrix(pworld), 64, sk.cylinder_matrix(pworld))


def phases_only(dev, smi: str) -> int:
    """``--phases``: build, then only K3's time and the phase splits of K4
    (fresh and on the main path's bank), K6 (on a steady-state bank), K7
    and K8 at the timed shapes."""
    t0 = time.perf_counter()
    _build.library()
    log(f"device: {smi}")
    build_report(t0)
    gen = torch.Generator().manual_seed(0)
    acro_phases(dev, gen, smi)
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    world = env.default_world(dev)
    rig = default_vision_rig()
    s28, wm = chase_steady_bank(env, world, gen, N_VISION)
    chase_phases(dev, env, s28, wm, rig, 64,
                 cuda_ms(lambda: vk.launch_vision_env_rollout(env, s28, wm, 64, rig), 10))
    actor_phases(dev, gen, rig)
    levels_lut_check(dev, smi)
    log(f"card: {smi}")
    return 0


def train_rows(label: str, log_dir: Path, iters: int):
    """The trainer's metrics log: one finite row an iteration."""
    rows = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != iters or not all(math.isfinite(r["loss"]) and
                                     math.isfinite(r["mean_reward"]) for r in rows):
        raise AssertionError(f"{label}: missing or non-finite losses or rewards")
    return rows


def state_learner(label: str, train, make, smi: str, **kw) -> float:
    """A state trainer's main path with its counters at 0 (it launches no
    kernel: the counters must stay 0), its rate, the split and a trace.
    Returns the rate (trained env-steps/s)."""
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / f"{label}_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train(num_iterations=TRAIN_ITERS, scan_chunk=TRAIN_CHUNK, print_every=0,
                log_dir=str(log_dir), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    if any(counts.values()):
        raise AssertionError(f"{label}: the eager path launched {counts}")
    rows = train_rows(label, log_dir, TRAIN_ITERS)
    gates = (f", mean gates passed {rows[0]['mean_gates_passed']:.6f} -> "
             f"{rows[-1]['mean_gates_passed']:.6f}" if "mean_gates_passed" in rows[0] else "")
    log(f"{label} main path: {res.steps_per_second:.6e} trained env-steps/s ({json.dumps(kw)}, "
        f"T={K7_STEPS}, {TRAIN_ITERS} iterations in chunks of {TRAIN_CHUNK}, first chunk left "
        f"out; {wall:.3f} s in all), reward {res.mean_reward_first:.6f} -> "
        f"{res.mean_reward_last:.6f}{gates}, last loss {rows[-1]['loss']:.6f}; kernel "
        f"launches {json.dumps(counts)}; on {smi}")
    trainer_split(label, make(**kw), rollout=f"{K7_STEPS} eager env steps")
    return res.steps_per_second


def state_net_check(dev) -> float:
    """ActorCritic on the card against the same weights on the CPU, over a
    4096-env reset's observations: float32, TF32 off, within 1e-5."""
    from fpyv_tpu_torch.models.policy import ActorCritic

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls")
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    _, obs = env.reset(torch.Generator().manual_seed(3), env.default_world("cpu"), (STATE_ENVS,))
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, device="cpu").init_params(
        torch.Generator().manual_seed(4))
    card = ActorCritic(action_dim=4, obs_dim=env.obs_dim, device=dev)
    card.load_state_dict(net.state_dict())
    with torch.no_grad():
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(card(obs.to(dev)), net(obs)))
    if not err <= 1e-5:
        raise AssertionError(f"state net: max abs err {err} > 1e-5 against the CPU")
    log(f"state net (ActorCritic, float32, N={STATE_ENVS}) on the card against the CPU: max abs "
        f"err {err}")
    return err


def flagship_eval(smi: str) -> None:
    """The shipped racer's deterministic eval at bench.py's shape, three
    seeds, with the K5 launches and the device's busy share."""
    # imported here, as the state trainers in main: tools/ab_kernels.py runs
    # this file's timer against older checkouts, which lack these modules
    from fpyv_tpu_torch import interop
    from fpyv_tpu_torch.apps.play import load_flagship, make_player, play_policy

    t0 = time.perf_counter()
    net, play_kw = load_flagship()
    play_kw.pop("seed", None)
    params = net.state_dict()
    log(f"flagship: loaded runs/flagship_torch in {time.perf_counter() - t0:.3f} s, play kwargs "
        f"{json.dumps(play_kw)}")
    gates, rates = [], []
    for seed in FLAGSHIP_SEEDS:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = play_policy(env_name="vision_race", steps=FLAGSHIP_STEPS, num_envs=FLAGSHIP_ENVS,
                          chunk=FLAGSHIP_CHUNK, seed=seed, params=params, **play_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        if (counts.get("render_depth", 0) < FLAGSHIP_STEPS
                or counts.get("levels_lut", 0) < FLAGSHIP_STEPS
                or any(v for k, v in counts.items() if k not in ("render_depth", "levels_lut"))):
            raise AssertionError(f"flagship eval: expected one K5 launch and one levels_lut (the "
                                 f"net's input) a step and no other kernel, saw {counts}")
        if not (math.isfinite(out["final_gates_passed_mean"])
                and math.isfinite(out["mean_reward_per_step"])):
            raise AssertionError(f"flagship eval: non-finite output {out}")
        gates.append(out["final_gates_passed_mean"])
        rates.append(FLAGSHIP_ENVS * out["steps"] / wall)
        log(f"flagship eval seed {seed}: final_gates_passed_mean {gates[-1]:.6f}, mean reward "
            f"per step {out['mean_reward_per_step']:.6f}, {out['crash_events']} crash events, "
            f"{rates[-1]:.6e} eval env-steps/s ({FLAGSHIP_ENVS} envs x {out['steps']} steps in "
            f"chunks of {FLAGSHIP_CHUNK}, {wall:.3f} s), launches {json.dumps(counts)}")
    mean = sum(gates) / len(gates)
    spread = max(gates) - min(gates)
    log(f"flagship eval: final_gates_passed_mean over seeds {list(FLAGSHIP_SEEDS)}: mean "
        f"{mean:.6f}, spread (max - min) {spread:.6f}, std "
        f"{(sum((g - mean) ** 2 for g in gates) / len(gates)) ** 0.5:.6f}; the JAX package on "
        f"the TPU: {FLAGSHIP_TPU_GATES} gates (BENCH_r05.json, a count of gates, not a speed); "
        f"eval {sum(rates) / len(rates):.6e} env-steps/s on {smi}")
    if mean < 0.85 * FLAGSHIP_TPU_GATES:
        raise AssertionError(f"flagship eval: mean gates {mean} below 85 % of "
                             f"{FLAGSHIP_TPU_GATES}")
    player = make_player("vision_race", interop.policy_params_to_numpy(net),
                         num_envs=FLAGSHIP_ENVS, **play_kw)
    gen = torch.Generator().manual_seed(FLAGSHIP_SEEDS[0])
    with torch.no_grad():
        st, obs = player.reset(gen)

        def hundred_steps():
            nonlocal st, obs
            for _ in range(100):
                st, obs, *_ = player.step(st, obs, gen)
            torch.cuda.synchronize()

        hundred_steps()  # warm-up
        busy, top = device_busy(hundred_steps, top=6)
    log(f"flagship eval trace (100 steps, {FLAGSHIP_ENVS} envs): device busy {busy:.6f} of the "
        f"wall time; top kernels by device time (ms): {json.dumps(top)}")


BF16_STEP = 2.0 ** -8  # one bf16 step at a layer's largest output, relative to it
BF16_STEP_SHARE = 1e-2  # at most this share of a bf16 layer's outputs off at all


def bf16_layers_teacher_forced(net, card, args, dev, scope=None) -> dict:
    """Each bf16 layer of ``card`` (the card's copy of ``net``) fed the CPU
    net's own input to that layer, in ``scope`` (default: the net's
    ``flax_reductions``): (the largest difference from the CPU's output over
    one bf16 step at the layer's largest output, the share of outputs that
    differ) a layer; then the float32 rest (the GRU, the heads) fed the
    CPU's features: its max abs error ("tail"). The libraries sum in
    another order than the CPU, and cuDNN's bf16 convolutions are not all
    correctly rounded from a float32 sum, so a few outputs land off."""
    from fpyv_tpu_torch.models import policy as tpolicy

    calls, names = [], {id(m): n for n, m in net.named_modules()}
    real_dense, real_conv = tpolicy.dense, tpolicy.F.conv2d

    def dense_rec(layer, x, dtype):
        out = real_dense(layer, x, dtype)
        if dtype is not None:
            name = names[id(layer)]
            calls.append((name, lambda xc: real_dense(card.get_submodule(name), xc, dtype),
                          x, out))
        return out

    def conv_rec(x, w, **kw):
        out = real_conv(x, w, **kw)
        calls.append((f"conv{len(calls)}", lambda xc: real_conv(xc, w.to(dev), **kw), x, out))
        return out

    tpolicy.dense, tpolicy.F.conv2d = dense_rec, conv_rec
    try:
        with torch.no_grad():
            feats = net.features(*args[:2])
    finally:
        tpolicy.dense, tpolicy.F.conv2d = real_dense, real_conv
    stats = {}
    with torch.no_grad(), (card.numerics() if scope is None else scope()):
        for name, run, x, out in calls:
            got, ref = run(x.to(dev)).cpu().float(), out.float()
            d = (got - ref).abs()
            stats[name] = [d.max().item() / (BF16_STEP * ref.abs().max().item()),
                           (d > 0).float().mean().item()]
        tail = card.heads(feats.to(dev), *(a.to(dev) for a in args[2:]))
        ref_tail = net.heads(feats, *args[2:])
    stats["tail"] = max((a.cpu() - b).abs().max().item() for a, b in zip(tail, ref_tail))
    return stats


def pixel_nets_check(dev) -> None:
    """The conv net and the GRU net on the card against the same weights on
    the CPU over 256 frames of 96x72 levels, inside the nets'
    ``flax_reductions`` scope (no bf16 split-K reductions in cuBLAS, no TF32
    in cuDNN): float32 end to end within 1e-5; bf16 teacher-forced layer by
    layer (``bf16_layers_teacher_forced``), its end-to-end error printed
    beside the CPU tests' 1e-3 of the largest output. Also prints what each
    net would move with the library defaults left on."""
    from fpyv_tpu_torch.models import policy as tpolicy

    g = torch.Generator().manual_seed(6)
    px = torch.randint(0, 256, (256, 72, 96), generator=g, dtype=torch.uint8)
    flags = (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32)
    for torso, gru, bf16 in (("conv", 0, False), ("conv", 0, True), ("patch", GRU_WIDTH, False),
                             ("patch", GRU_WIDTH, True)):
        proprio = 11 if gru else 5
        kw = dict(action_dim=4, n_patches=108, proprio_dim=proprio, torso=torso, gru=gru,
                  image_hw=(72, 96), compute_dtype=torch.bfloat16 if bf16 else None)
        net = tpolicy.PixelActorCritic(device="cpu", **kw).init_params(
            torch.Generator().manual_seed(5))
        card = tpolicy.PixelActorCritic(device=dev, **kw)
        card.load_state_dict(net.state_dict())
        args = [px, torch.randn(256, proprio, generator=g)]
        if gru:
            args.append(torch.randn(256, gru, generator=g))
        with torch.no_grad():
            ref = net(*args)
            out = card(*(a.to(dev) for a in args))
        if (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                torch.backends.cudnn.allow_tf32) != flags:
            raise AssertionError("the pixel net left the library's flags changed")
        errs = [(a.cpu() - b).abs().max().item() for a, b in zip(out, ref)]
        rel = [e / max(b.abs().max().item(), 1e-30) for e, b in zip(errs, ref)]
        label = f"{torso}{f' + GRU-{gru}' if gru else ''}, {'bf16' if bf16 else 'float32'}"
        if not all(torch.isfinite(o).all() for o in out):
            raise AssertionError(f"pixel net ({label}): non-finite outputs")
        if bf16:
            stats = bf16_layers_teacher_forced(net, card, args, dev)
            bad = [k for k, v in stats.items() if k != "tail" and (
                v[0] > 1.0 or v[1] > BF16_STEP_SHARE)]
            if bad or not stats["tail"] <= 1e-5:
                raise AssertionError(f"pixel net ({label}) teacher-forced: {stats}")
            loose = bf16_layers_teacher_forced(net, card, args, dev, contextlib.nullcontext)
            check = (f"teacher-forced, each bf16 layer's [max abs err over one bf16 step at its "
                     f"largest output, share of outputs off] and the float32 tail's max abs err: "
                     f"{json.dumps(stats)} (at most 1, {BF16_STEP_SHARE}, 1e-5); "
                     f"with the library defaults {json.dumps(loose)}; end to end, max abs err "
                     f"over the largest output")
        else:
            if not max(errs) <= 1e-5:
                raise AssertionError(f"pixel net ({label}): errors {errs} above 1e-5")
            check = "end to end within 1e-5; relative to the largest output"
        # the same net with the library's defaults: what the scope keeps out
        real = tpolicy.flax_reductions
        tpolicy.flax_reductions = contextlib.nullcontext
        try:
            with torch.no_grad():
                loose = card(*(a.to(dev) for a in args))
        finally:
            tpolicy.flax_reductions = real
        loose_err = max((a.cpu() - b).abs().max().item() for a, b in zip(loose, ref))
        log(f"pixel net ({label}, N=256, 96x72) on the card against the CPU: max abs err "
            f"mean {errs[0]}, value {errs[2]}{f', hidden {errs[3]}' if gru else ''}; {check}: "
            f"mean {rel[0]:.3e}, value {rel[2]:.3e}{f', hidden {rel[3]:.3e}' if gru else ''} "
            f"(the CPU tests hold bf16 to 1e-3); with the library defaults (bf16 "
            f"reduced-precision reduction {flags[0]}, cuDNN TF32 {flags[1]}) the max abs err "
            f"would be {loose_err}")


def race_render_check(dev, gen, smi: str) -> float:
    """K5 on the 4-agent race's frames, the opponents (and 3 obstacles)
    as per-camera spheres, against ``render_depth_reference``: levels
    equal. 256 races x 4 agents (the GRU recipe's cameras), a few steps
    from a reset. Returns the max abs error."""
    from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv

    err = 0.0
    for n_obstacles in (0, 3):
        venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=GRU_AGENTS, n_obstacles=n_obstacles,
                                               max_episode_steps=2000, gate_size=7.0))
        world = venv.default_world(dev)
        st, _ = venv.reset_batched(gen, world, GRU_RACES)
        act = torch.zeros(GRU_RACES * GRU_AGENTS, 4, device=dev)
        act[:, 3] = -0.3
        for _ in range(5):
            st, *_ = venv.step_batched(st, act, world, generator=gen)
        cam_pos, cam_R, rworld, include = venv.render_scene(st, world)
        cfg, dcam, cam, wcol = vk.render_inputs(venv.rig, cam_pos, cam_R, rworld, venv.max_depth,
                                                include, None, venv.frame_width)
        out = vk.launch_render_depth(cfg, dcam, cam, wcol)
        torch.cuda.synchronize()
        ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
        bad = int((out != ref).sum().item())
        lit = (ref > 0).float().mean().item()
        if bad or lit <= 0.0 or cfg.n_spheres != GRU_AGENTS - 1 + n_obstacles:
            raise AssertionError(f"K5 (race, A={GRU_AGENTS}, {n_obstacles} obstacles): {bad} "
                                 f"levels differ, lit share {lit}, {cfg.n_spheres} spheres")
        err = max(err, (out - ref).abs().max().item())
        ms = cuda_ms(lambda: vk.launch_render_depth(cfg, dcam, cam, wcol), 20)
        log(f"K5 render_depth (race, {GRU_RACES} races x {GRU_AGENTS} agents = {cam.shape[0]} "
            f"cameras, {cfg.n_spheres} spheres a camera: {GRU_AGENTS - 1} opponents + "
            f"{n_obstacles} obstacles, 96x72): 0 of {out.numel()} levels differ, lit share "
            f"{lit:.4f}, {ms:.6f} ms a launch on {smi}")
    return err


def scan_counts(label: str, iters: int, steps: int = K7_STEPS) -> dict:
    """A scan trainer's launch counters: K5 at least once an env step, K7
    and K8 never."""
    counts = dict(_build.launch_counts)
    if (counts.get("render_depth", 0) < iters * steps or counts.get("policy_vision_rollout")
            or counts.get("race_vision_rollout")):
        raise AssertionError(f"{label}: expected >= {steps} K5 launches an iteration and no "
                             f"K7 or K8, saw {counts}")
    log(f"{label} launches: {json.dumps(counts)} ({counts['render_depth'] / iters:.2f} K5 "
        f"launches an iteration)")
    return counts


def scan_trainer(smi: str) -> None:
    """JAX's documented round-2 recipe on the scan rollout: the conv torso,
    float32 pixel storage, 4 epochs, 1024 envs in per-env randomized
    worlds, the default 96x72 rig."""
    from fpyv_tpu_torch.apps.train import make_vision_trainer

    kw = dict(rollout="scan", torso="conv", pixel_store="f32", update_epochs=4)
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "scan_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_vision(num_envs=N_VISION, num_iterations=SCAN_ITERS, scan_chunk=SCAN_CHUNK,
                       print_every=0, log_dir=str(log_dir), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan_counts("conv scan trainer main path", SCAN_ITERS)
    rows = train_rows("conv scan trainer", log_dir, SCAN_ITERS)
    log(f"conv scan trainer main path: {res.steps_per_second:.6e} trained env-steps/s "
        f"({json.dumps(kw)}, N={N_VISION}, T={K7_STEPS}, {SCAN_ITERS} iterations in chunks of "
        f"{SCAN_CHUNK}, first chunk left out; {wall:.3f} s in all), reward "
        f"{res.mean_reward_first:.6f} -> {res.mean_reward_last:.6f}, last loss "
        f"{rows[-1]['loss']:.6f}, losses finite; on {smi}")
    trainer_split("conv scan trainer", make_vision_trainer(num_envs=N_VISION, **kw),
                  rollout=f"{K7_STEPS} eager env steps")


def curriculum_trainer(smi: str) -> None:
    """``train_vision(curriculum_iters=4)`` (auto -> the scan rollout, the
    patch torso) at 1024 envs, a chunk an iteration: the worlds the hook
    draws before each chunk differ from chunk to chunk and ramp the
    obstacle count with the difficulty."""
    from fpyv_tpu_torch.apps import train as tapp

    drawn = []
    real = tapp.curriculum_worlds

    def spy(generator, n_envs, difficulty, **kw):
        w = real(generator, n_envs, difficulty, **kw)
        drawn.append((float(difficulty), int(w.cyl_active.sum().item()),
                      float(w.cyl_center.sum().item())))
        return w

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "curriculum_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    tapp.curriculum_worlds = spy
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = train_vision(num_envs=N_VISION, num_iterations=CURRICULUM_ITERS, scan_chunk=1,
                           curriculum_iters=CURRICULUM_ITERS, print_every=0,
                           log_dir=str(log_dir))
    finally:
        tapp.curriculum_worlds = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan_counts("curriculum trainer", CURRICULUM_ITERS)
    train_rows("curriculum trainer", log_dir, CURRICULUM_ITERS)
    hooks = drawn[1:]  # the first draw is the start's, at difficulty 0
    want = [min(1.0, it / CURRICULUM_ITERS) for it in range(CURRICULUM_ITERS)]
    if ([d for d, _, _ in hooks] != want
            or len({c for _, _, c in drawn}) != len(drawn)
            or [a for _, a, _ in hooks] != [N_VISION * math.ceil(4 * d) for d in want]):
        raise AssertionError(f"curriculum: the worlds did not change or ramp as asked: {drawn}")
    log(f"curriculum trainer (curriculum_iters={CURRICULUM_ITERS}, N={N_VISION}, chunks of 1): "
        f"worlds drawn before each chunk (difficulty, active cylinders, sum of centres) "
        f"{json.dumps(hooks)}, every draw distinct; {res.steps_per_second:.6e} trained "
        f"env-steps/s (first chunk left out; {wall:.3f} s in all), losses finite; on {smi}")


def gru_race_trainer(smi: str) -> None:
    """The repo's recurrent recipe (tools/experiments_r5.py:580): 256 races
    of 4 agents (1024 learner rows), spawn slots permuted, GRU-128, gates
    of 7 m, a few iterations: the rate, the split, the busy share, K5's
    launches, the gates, and a finite, non-zero hidden in the checkpoint."""
    from fpyv_tpu_torch.apps.train import make_vision_race_trainer
    from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint

    kw = dict(num_envs=GRU_RACES, n_agents=GRU_AGENTS, permute_spawns=True, gru=GRU_WIDTH,
              gate_size=7.0)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    log_dir, ck_dir = root / "gru_log", root / "gru_ck"
    for d in (log_dir, ck_dir):
        shutil.rmtree(d, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_vision_race(num_iterations=SCAN_ITERS, scan_chunk=SCAN_CHUNK, print_every=0,
                            log_dir=str(log_dir), checkpoint_dir=str(ck_dir),
                            checkpoint_every=SCAN_ITERS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan_counts("GRU race trainer main path", SCAN_ITERS)
    rows = train_rows("GRU race trainer", log_dir, SCAN_ITERS)
    hidden = restore_checkpoint(str(ck_dir), SCAN_ITERS)["env_state"][1]
    if (hidden.shape != (GRU_RACES * GRU_AGENTS, GRU_WIDTH) or not torch.isfinite(hidden).all()
            or not hidden.abs().max().item() > 0.0):
        raise AssertionError(f"GRU race trainer: hidden {tuple(hidden.shape)} not finite or all "
                             f"zero")
    log(f"GRU race trainer main path: {res.steps_per_second:.6e} trained env-steps/s "
        f"({json.dumps(kw)}, {GRU_RACES * GRU_AGENTS} learner rows, T={K7_STEPS}, "
        f"{SCAN_ITERS} iterations in chunks of {SCAN_CHUNK}, first chunk left out; {wall:.3f} s "
        f"in all), reward {res.mean_reward_first:.6f} -> {res.mean_reward_last:.6f}, mean gates "
        f"passed {rows[0]['mean_gates_passed']:.6f} -> {rows[-1]['mean_gates_passed']:.6f}, "
        f"last loss {rows[-1]['loss']:.6f}; hidden finite, max |h| "
        f"{hidden.abs().max().item():.6f}, {(hidden != 0).any(-1).float().mean().item():.4f} of "
        f"the rows non-zero; on {smi}")
    trainer_split("GRU race trainer", make_vision_race_trainer(rollout="scan", **kw),
                  rollout=f"{K7_STEPS} eager env steps")


@contextlib.contextmanager
def swapped(owner, name: str, value):
    """``owner.name`` replaced by ``value`` inside the scope (a seam fed with
    fixed draws, or a spy); yields the original."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)


def event_spy(spans: dict, kind: str, fn):
    """``fn`` wrapped to record a pair of CUDA events around each call, kept
    in ``spans[kind]``."""
    def wrapper(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a, **k)
        ev[1].record()
        spans[kind].append(ev)
        return out
    return wrapper


def sac_update_check(dev) -> None:
    """The SAC actor and critic, and one train step with one update, on the
    card against the same weights, replay and draws on the CPU (float32,
    TF32 off). The draws go through the learner's seams
    (``rl.replay.replay_indices``, ``rl.sac.squash_noise``); the env step
    is a fixed transition. Forward within 1e-5; the update's losses, alpha
    and entropy within 1e-6 + 1e-5 relative, every parameter of the actor,
    critic and target critic and log_alpha within 1e-6 + 1e-4 relative."""
    from fpyv_tpu_torch.models.policy import SquashedGaussianActor, TwinQNetwork
    from fpyv_tpu_torch.rl import replay as rp
    from fpyv_tpu_torch.rl import sac as rs

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls")
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    g = torch.Generator().manual_seed(5)
    _, obs = env.reset(g, env.default_world("cpu"), (SAC_ENVS,))
    O = env.obs_dim
    actor = SquashedGaussianActor(4, O, device="cpu").init_params(g)
    critic = TwinQNetwork(O, 4, device="cpu").init_params(g)
    pre = (torch.randn(SAC_PREFILL, O, generator=g), 2.0 * torch.rand(SAC_PREFILL, 4, generator=g)
           - 1.0, torch.randn(SAC_PREFILL, generator=g), torch.randn(SAC_PREFILL, O, generator=g),
           torch.rand(SAC_PREFILL, generator=g) < 0.05)
    step_out = (obs + 0.01 * torch.randn(obs.shape, generator=g),
                torch.randn(SAC_ENVS, generator=g), torch.rand(SAC_ENVS, generator=g) < 0.05)
    idx = torch.randint(0, SAC_PREFILL + SAC_ENVS, (SAC_BATCH,), generator=g)
    noises = (torch.randn(SAC_ENVS, 4, generator=g), torch.randn(SAC_BATCH, 4, generator=g),
              torch.randn(SAC_BATCH, 4, generator=g))  # the action's, the next action's, the actor's

    def run(device):
        a = SquashedGaussianActor(4, O, device=device)
        c = TwinQNetwork(O, 4, device=device)
        a.load_state_dict(actor.state_dict())
        c.load_state_dict(critic.state_dict())
        nxt, rew, done = (x.to(device) for x in step_out)
        cfg = rs.SacConfig(num_envs=SAC_ENVS, buffer_capacity=SAC_BUFFER, batch_size=SAC_BATCH)
        init, step = rs.make_sac(lambda st, act, gen: (st, nxt, rew, done), cfg, O, 4)
        state = init(a, c, None, obs.to(device), torch.Generator(device=device))
        state = state.replace(buffer=rp.replay_add_batch(state.buffer,
                                                         *(x.to(device) for x in pre)))
        queue = list(noises)
        with torch.no_grad():
            fwd = (*a(obs.to(device)), *c(obs.to(device), pre[1][:SAC_ENVS].to(device)))
        with swapped(rs, "squash_noise", lambda shape, gen, dtype, d: queue.pop(0).to(d)), \
                swapped(rp, "replay_indices", lambda b, high, gen, d: idx.to(d)):
            state, metrics = step(state)
        if queue:
            raise AssertionError("phase 24: the step took fewer draws than fed")
        params = {f"{net}.{k}": v.detach() for net, m in (("actor", state.actor),
                                                           ("critic", state.critic),
                                                           ("target", state.target_critic))
                  for k, v in m.state_dict().items()}
        params["log_alpha"] = state.log_alpha.detach()
        return [x.detach() for x in fwd], metrics, params

    cpu_fwd, cpu_m, cpu_p = run(torch.device("cpu"))
    card_fwd, card_m, card_p = run(dev)
    fwd_err = max((x.cpu() - y).abs().max().item() for x, y in zip(card_fwd, cpu_fwd))
    if not fwd_err <= 1e-5:
        raise AssertionError(f"SAC nets: max abs err {fwd_err} > 1e-5 against the CPU")
    m_err = {k: abs(card_m[k].item() - cpu_m[k].item()) for k in cpu_m}
    bad = [k for k, e in m_err.items() if not e <= 1e-6 + 1e-5 * abs(cpu_m[k].item())]
    p_err = {k: (card_p[k].cpu() - v).abs().max().item() for k, v in cpu_p.items()}
    bad += [k for k, v in cpu_p.items()
            if not ((card_p[k].cpu() - v).abs() <= 1e-6 + 1e-4 * v.abs()).all()]
    if bad:
        raise AssertionError(f"SAC update on the card against the CPU: {bad} off; metrics "
                             f"{m_err}, params {p_err}")
    moved = (cpu_p["actor.mean.bias"].abs().max().item(), abs(cpu_p["log_alpha"].item()))
    if not min(moved) > 1e-4:
        raise AssertionError(f"SAC update: the step did not move the actor or alpha {moved}")
    log(f"SAC nets (actor and twin critic, float32, N={SAC_ENVS}) on the card against the CPU: "
        f"max abs err {fwd_err}; one step + one update (batch {SAC_BATCH}, replay "
        f"{SAC_PREFILL + SAC_ENVS} of {SAC_BUFFER}, the same draws): metrics "
        f"{json.dumps({k: cpu_m[k].item() for k in cpu_m})}, abs err {json.dumps(m_err)}; "
        f"largest parameter err {max(p_err.values())} ({max(p_err, key=p_err.get)})")


def sac_main_path(smi: str) -> None:
    """``train_sac``'s defaults (1024 envs, buffer 500 000, batch 2048, 8
    updates a step, 50 warm-up steps) for 300 iterations in chunks of 100,
    the first left out, with its counters at 0 (no kernel: they must stay
    0); the replay's fill through a spy on its insert; then the split of an
    iteration with CUDA events on spies around the env step and the replay
    insert (the rest is the action sample and the updates), and a trace."""
    from fpyv_tpu_torch.apps.train import make_sac_trainer, train_sac
    from fpyv_tpu_torch.rl import sac as rs

    fills = []
    real = rs.replay_add_batch

    def spy(buf, *a):
        out = real(buf, *a)
        fills.append((out.size, out.ptr))
        return out

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "sac_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with swapped(rs, "replay_add_batch", spy):
        res = train_sac(num_envs=SAC_ENVS, num_iterations=SAC_ITERS, warmup_steps=SAC_WARMUP,
                        buffer_capacity=SAC_BUFFER, batch_size=SAC_BATCH,
                        scan_chunk=SAC_CHUNK, print_every=0, log_dir=str(log_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    if any(counts.values()):
        raise AssertionError(f"SAC: the eager path launched {counts}")
    rows = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    keys = ("critic_loss", "actor_loss", "alpha", "entropy", "mean_reward")
    if len(rows) != SAC_ITERS or not all(math.isfinite(r[k]) for r in rows for k in keys):
        raise AssertionError("SAC: missing or non-finite metrics")
    want = min(SAC_BUFFER, SAC_ENVS * (SAC_WARMUP + SAC_ITERS))
    if len(fills) != SAC_WARMUP + SAC_ITERS or fills[-1][0] != want:
        raise AssertionError(f"SAC: {len(fills)} inserts, replay size {fills[-1]}, want {want}")
    log(f"SAC main path: {res.steps_per_second:.6e} trained env-steps/s (transitions stored a "
        f"second; N={SAC_ENVS}, batch {SAC_BATCH}, 8 updates a step, {SAC_WARMUP} warm-up steps, "
        f"{SAC_ITERS} iterations in chunks of {SAC_CHUNK}, first chunk left out; {wall:.3f} s in "
        f"all), reward {res.mean_reward_first:.6f} -> {res.mean_reward_last:.6f}, alpha "
        f"{rows[0]['alpha']:.6f} -> {rows[-1]['alpha']:.6f}, entropy {rows[-1]['entropy']:.6f}, "
        f"critic loss {rows[-1]['critic_loss']:.6f}; replay size {fills[-1][0]} of {SAC_BUFFER} "
        f"(ptr {fills[-1][1]}); kernel launches {json.dumps(counts)}; on {smi}")

    trainer = make_sac_trainer(num_envs=SAC_ENVS, buffer_capacity=SAC_BUFFER,
                               batch_size=SAC_BATCH)
    state, _ = trainer.train_iteration(trainer.state)  # warm-up
    split = []
    for _ in range(3):
        spans = {"env step": [], "insert": []}
        whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        with swapped(AcroEnv, "step", event_spy(spans, "env step", AcroEnv.step)), \
                swapped(rs, "replay_add_batch", event_spy(spans, "insert", rs.replay_add_batch)):
            whole[0].record()
            state, _ = trainer.train_iteration(state)
            whole[1].record()
        torch.cuda.synchronize()
        if len(spans["env step"]) != 1 or len(spans["insert"]) != 1:
            raise AssertionError(f"SAC: an iteration ran {len(spans['env step'])} env steps and "
                                 f"{len(spans['insert'])} inserts, want 1 and 1")
        split.append((whole[0].elapsed_time(whole[1]),) + tuple(
            a.elapsed_time(b) for a, b in (spans["env step"][0], spans["insert"][0])))
    it_ms, env_ms, ins_ms = min(split)
    log(f"SAC iteration split (CUDA events, best of 3 by the whole iteration): whole "
        f"{it_ms:.6f} ms, the env step {env_ms:.6f} ms, the replay insert {ins_ms:.6f} ms, the "
        f"rest (the action sample and the 8 updates) {it_ms - env_ms - ins_ms:.6f} ms; all "
        f"{json.dumps([[round(x, 6) for x in r] for r in split])}")

    def one_iteration():
        nonlocal state
        state, _ = trainer.train_iteration(state)
        torch.cuda.synchronize()

    busy, top = device_busy(one_iteration, top=8)
    log(f"SAC trace: device busy {busy:.6f} of one iteration's wall time; top kernels by device "
        f"time (ms): {json.dumps(top)}")


def es_main_path(smi: str) -> None:
    """``train_es(env_name="acro")``'s defaults (128 antithetic pairs, 256
    envs a candidate, 60 steps: 65 536 envs a step) for 6 generations in
    chunks of 2, the first left out, with its counters at 0 (no kernel);
    then one generation split with CUDA events into the candidates'
    batched forward, the eager env step and the rest, and a trace; then a
    short ``env_name="rotate"`` run."""
    from fpyv_tpu_torch.apps import train as tapp

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "es_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = tapp.train_es(env_name="acro", num_iterations=ES_ITERS, scan_chunk=ES_CHUNK,
                        print_every=0, log_dir=str(log_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    if any(counts.values()):
        raise AssertionError(f"ES: the eager path launched {counts}")
    rows = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != ES_ITERS or not all(math.isfinite(r["gen_best_fitness"]) for r in rows):
        raise AssertionError("ES: missing or non-finite generation-best fitness")
    log(f"ES main path (acro): {res.steps_per_second:.6e} fitness-rollout env-steps/s (256 "
        f"candidates x 256 envs x 60 steps = 3932160 env-steps a generation, {ES_ITERS} "
        f"generations in chunks of {ES_CHUNK}, first chunk left out; {wall:.3f} s in all), "
        f"generation-best fitness {res.mean_reward_first:.6f} -> {res.mean_reward_last:.6f} "
        f"({json.dumps([round(r['gen_best_fitness'], 6) for r in rows])}); kernel launches "
        f"{json.dumps(counts)}; on {smi}")

    trainer = tapp.make_es_trainer(env_name="acro")
    state, _ = trainer.run_chunk(trainer.state, 1, trainer.generator)  # warm-up
    spans = {"forward": [], "env step": []}
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with swapped(tapp, "actor_mean_batched",
                 event_spy(spans, "forward", tapp.actor_mean_batched)), \
            swapped(AcroEnv, "step", event_spy(spans, "env step", AcroEnv.step)):
        whole[0].record()
        state, _ = trainer.run_chunk(state, 1, trainer.generator)
        whole[1].record()
    torch.cuda.synchronize()
    gen_ms = whole[0].elapsed_time(whole[1])
    split = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    log(f"ES generation split (CUDA events, acro, 65536 envs a step): whole generation "
        f"{gen_ms:.6f} ms; {len(spans['forward'])} batched forwards {split['forward']:.6f} ms, "
        f"{len(spans['env step'])} eager env steps {split['env step']:.6f} ms "
        f"({split['env step'] / max(1, len(spans['env step'])):.6f} ms a step), the rest "
        f"(resets, the ranks, theta's step) {gen_ms - sum(split.values()):.6f} ms")

    def one_generation():
        nonlocal state
        state, _ = trainer.run_chunk(state, 1, trainer.generator)
        torch.cuda.synchronize()

    busy, top = device_busy(one_generation, top=8)
    log(f"ES trace: device busy {busy:.6f} of one generation's wall time; top kernels by device "
        f"time (ms): {json.dumps(top)}")

    rot = tapp.train_es(env_name="rotate", num_iterations=2, scan_chunk=1, print_every=0)
    if not (math.isfinite(rot.mean_reward_first) and math.isfinite(rot.mean_reward_last)):
        raise AssertionError(f"ES on rotate: non-finite fitness {rot}")
    log(f"ES on rotate (defaults, 2 generations): generation-best fitness "
        f"{rot.mean_reward_first:.6f} -> {rot.mean_reward_last:.6f}, {rot.steps_per_second:.6e} "
        f"env-steps/s (the second generation)")


DIST_RANKS = 2  # gloo ranks sharing the one card
DIST_ITERS, DIST_CHUNK = 6, 2  # (d): train_acro's defaults, the first chunk of 2 left out
DIST_VISION_ITERS = 3  # (e): train_vision on the scan rollout, 1024 envs in all


def dist_layout_acro(mesh, dev, steps: int = 64):
    """(b) ``steps`` fixed-action steps of this rank's rows of the 4096-env
    acro bank, episodes of 16 steps (every env resets 4 times): rewards,
    positions and done flags (one process with ``mesh=None``)."""
    from fpyv_tpu_torch.envs.base import take_part

    part = None if mesh is None else mesh.part(STATE_ENVS)
    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=16)
    world = env.default_world(dev)
    gen = torch.Generator().manual_seed(27)
    state, _ = env.reset(gen, world, (STATE_ENVS,))
    state = take_part(state, part)
    action = torch.zeros((state.t.shape[0], 4), device=dev)
    action[:, 3] = THROTTLE
    out = []
    for _ in range(steps):
        state, _, r, d, _ = env.step(state, action, world, generator=gen, part=part)
        out.append(torch.cat([r[:, None], state.drone.pos, d[:, None].to(r.dtype)], dim=-1))
    return torch.stack(out).cpu().numpy()


def dist_layout_race(mesh, dev, steps: int = 20):
    """(b) ``steps`` fixed-action steps of this rank's whole races of the
    shared-policy race bank (1024 races x 4 agents, episodes of 8 steps):
    rewards, positions and gate counters."""
    from fpyv_tpu_torch.envs.base import take_part
    from fpyv_tpu_torch.envs.multi_race import make_shared_policy_env_step

    env = MultiRaceEnv(n_agents=RACE_AGENTS, max_episode_steps=8)
    world = env.default_world(dev)
    part = None if mesh is None else mesh.part(RACE_RACES)
    env_step, reset_fn = make_shared_policy_env_step(env, world, n_envs=RACE_RACES, part=part)
    gen = torch.Generator().manual_seed(28)
    state, _ = reset_fn(gen)
    state = take_part(state, part)
    action = torch.tensor([[0.0, 0.2, 0.0, -0.3]], device=dev).expand(
        state.t.shape[0] * RACE_AGENTS, 4)
    out = []
    for _ in range(steps):
        state, _, r, _ = env_step(state, action, gen)
        out.append(torch.cat([r.reshape(-1, RACE_AGENTS, 1), state.drones.pos,
                              state.gates_passed[..., None].to(r.dtype)], dim=-1))
    return torch.stack(out).cpu().numpy()


def dist_fixed_batch(dev):
    """(c) ActorCritic(128, 128) from a seed and a fixed 4096-env, T = 32
    trajectory around its actions (log-probs and values moved off the
    net's), made on the CPU and moved to ``dev``."""
    from fpyv_tpu_torch.models.policy import ActorCritic
    from fpyv_tpu_torch.rl.ppo import Transition, gaussian_log_prob

    g = torch.Generator().manual_seed(29)
    net = ActorCritic(action_dim=4, obs_dim=17, hidden=(128, 128), device="cpu").init_params(g)
    obs = torch.randn((K7_STEPS + 1, STATE_ENVS, 17), generator=g)
    with torch.no_grad():
        mean, log_std, value = net(obs[:K7_STEPS])
        action = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=g)
        log_prob = gaussian_log_prob(mean, log_std, action) + 0.05 * torch.randn(
            value.shape, generator=g)
    traj = Transition(obs=obs[:K7_STEPS], action=action, log_prob=log_prob,
                      value=value + 0.3 * torch.randn(value.shape, generator=g),
                      reward=torch.randn(value.shape, generator=g),
                      done=torch.rand(value.shape, generator=g) < 0.05)
    traj = Transition(**{f: getattr(traj, f).to(dev) for f in traj.__dataclass_fields__})
    return net.to(dev), traj, obs[K7_STEPS].to(dev)


DIST_PPO = dict(num_envs=STATE_ENVS, num_steps=K7_STEPS, update_epochs=1, num_minibatches=1)


def _half(traj, last, lo: int, hi: int):
    from fpyv_tpu_torch.rl.ppo import Transition

    return (Transition(**{f: getattr(traj, f)[:, lo:hi] for f in traj.__dataclass_fields__}),
            last[lo:hi])


def dist_update(mesh, dev):
    """(c) One ``make_distributed_ppo`` update on this rank's half of the
    fixed batch: the parameters after it."""
    from fpyv_tpu_torch.parallel.train import make_distributed_ppo
    from fpyv_tpu_torch.rl.ppo import PpoConfig

    net, traj, last = dist_fixed_batch(dev)
    lo, hi, _ = mesh.part(STATE_ENVS)
    traj, last = _half(traj, last, lo, hi)
    init, iteration = make_distributed_ppo(lambda m, o: m(o), None, PpoConfig(**DIST_PPO), mesh,
                                           rollout_fn=lambda s: (s.env_state, last, traj))
    state, _ = iteration(init(net, torch.zeros(1, device=dev), last,
                              torch.Generator().manual_seed(0)))
    return {k: v.cpu().numpy() for k, v in state.params.state_dict().items()}


def dist_update_reference(dev):
    """(c) In one process: each half's gradients through ``make_ppo`` (its
    update step caught before the clip), their mean, the clip, one Adam
    step."""
    from fpyv_tpu_torch.device import divisor
    from fpyv_tpu_torch.rl import ppo as tppo

    net, traj, last = dist_fixed_batch(dev)
    cfg = tppo.PpoConfig(**dict(DIST_PPO, num_envs=STATE_ENVS // DIST_RANKS))
    grads = []

    def caught(net_, opt, loss, config):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads.append([p.grad.clone() for p in net_.parameters()])

    with swapped(tppo, "_update", caught):
        for r in range(DIST_RANKS):
            k = STATE_ENVS // DIST_RANKS
            tr, la = _half(traj, last, r * k, (r + 1) * k)
            init, iteration = tppo.make_ppo(lambda m, o: m(o), None, cfg,
                                            rollout_fn=lambda s, tr=tr, la=la: (s.env_state, la,
                                                                                tr))
            iteration(init(net, torch.zeros(1, device=dev), la, torch.Generator().manual_seed(0)))
    opt = tppo.make_optimizer(net, cfg)
    for p, *gs in zip(net.parameters(), *grads):
        p.grad = sum(gs[1:], gs[0]) / divisor(DIST_RANKS, gs[0])
    tppo.clip_by_global_norm_(net.parameters(), cfg.max_grad_norm)
    opt.step()
    return {k: v.cpu().numpy() for k, v in net.state_dict().items()}


def _shard_params(ck_dir: str, mesh, step: int):
    from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint

    tree = restore_checkpoint(ck_dir, step, shard=(mesh.rank, mesh.size))
    return {k: v.numpy() for k, v in tree["params"].items()}


def dist_state_learner(mesh, root: str):
    """(d) ``train_acro(distributed=True)`` at its defaults over the ranks
    (4096 envs in all), 6 iterations, the first chunk left out; then the
    all-reduce's share of 2 more iterations (host clock around each
    collective, the card synchronised before it)."""
    from fpyv_tpu_torch.apps.train import make_acro_trainer, train_acro
    from fpyv_tpu_torch.parallel import mesh as pmesh
    from fpyv_tpu_torch.rl.ppo import scan_train

    res = train_acro(num_iterations=DIST_ITERS, scan_chunk=DIST_CHUNK, print_every=0,
                     checkpoint_dir=f"{root}/acro", checkpoint_every=DIST_ITERS,
                     distributed=True)
    trainer = make_acro_trainer(mesh=mesh)
    state, _ = scan_train(trainer.train_iteration, trainer.state, 1)  # warm-up
    spans = []

    def timed(tensors, mesh_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(tensors, mesh_)
        spans.append(time.perf_counter() - t)

    with swapped(pmesh, "pmean_", timed) as real:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, infos = scan_train(trainer.train_iteration, state, 2)
        infos["loss"].cpu()
        wall = time.perf_counter() - t0
    return dict(rate=res.steps_per_second, reward=(res.mean_reward_first, res.mean_reward_last),
                params=_shard_params(f"{root}/acro", mesh, DIST_ITERS),
                allreduce_s=sum(spans), allreduces=len(spans), wall_s=wall)


def dist_vision(mesh, root: str):
    """(e) ``train_vision(distributed=True)`` (auto -> the scan rollout) at
    1024 envs in all, per-env random worlds, 3 iterations: K5's launches in
    this rank, the rewards, the parameters."""
    from fpyv_tpu_torch.apps.train import train_vision

    _build.reset_launch_counts()
    res = train_vision(num_envs=N_VISION, num_iterations=DIST_VISION_ITERS,
                       scan_chunk=DIST_VISION_ITERS, print_every=0, log_dir=f"{root}/vision_log",
                       checkpoint_dir=f"{root}/vision", checkpoint_every=DIST_VISION_ITERS,
                       distributed=True)
    torch.cuda.synchronize()
    return dict(counts=dict(_build.launch_counts), rate=res.steps_per_second,
                params=_shard_params(f"{root}/vision", mesh, DIST_VISION_ITERS))


def dist_es(mesh):
    """(f) ``train_es(distributed=True)`` at its defaults for 2 generations
    (the rate of the second), then the trainer's own 2 generations: theta
    and the generation-best fitness (one process with ``mesh=None``)."""
    from fpyv_tpu_torch.apps.train import make_es_trainer, train_es

    rate = None
    if mesh is not None:
        rate = train_es(num_iterations=2, scan_chunk=1, print_every=0,
                        distributed=True).steps_per_second
    trainer = make_es_trainer(mesh=mesh)
    (theta, _, _), hist = trainer.run_chunk(trainer.state, 2, trainer.generator)
    return dict(rate=rate, theta=theta.cpu().numpy(), hist=hist.cpu().numpy())


def dist_rank(mesh, root: str):
    """Phase 27's rank: (b) to (f) in order, numpy back to the parent."""
    dev = mesh.device
    out = dict(acro=dist_layout_acro(mesh, dev), race=dist_layout_race(mesh, dev),
               update=dist_update(mesh, dev))
    out["learner"] = dist_state_learner(mesh, root)
    out["vision"] = dist_vision(mesh, root)
    out["es"] = dist_es(mesh)
    return out


def _bit_equal(label: str, a: dict, b: dict) -> None:
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{label}: {k} differs")


def distributed_checks(dev, smi: str, single_rate: float) -> None:
    """Phase 27: (a) ``train_acro(distributed=True)`` at world size 1 (no
    process group) equals ``distributed=False`` bit for bit; (b)-(f) over
    two gloo ranks sharing the card (``parallel.launch``): fixed-action
    rollouts bit-equal to one process, the averaged update against a
    one-process reference, the state learner (its rate beside phase 16's),
    the vision path (K5 on every rank) and ES against world size 1."""
    from fpyv_tpu_torch.apps.train import train_acro
    from fpyv_tpu_torch.parallel.launch import launch
    from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint

    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dist"
    shutil.rmtree(root, ignore_errors=True)
    # (a)
    trees, rows = [], []
    for distributed in (False, True):
        d = root / f"one_{distributed}"
        train_acro(num_iterations=3, scan_chunk=3, print_every=0, log_dir=str(d),
                   checkpoint_dir=str(d / "ck"), checkpoint_every=3, distributed=distributed)
        trees.append(restore_checkpoint(str(d / "ck"), 3, shard=(0, 1) if distributed else None))
        rows.append([{k: v for k, v in json.loads(ln).items() if k != "time"}
                     for ln in (d / "metrics.jsonl").read_text().splitlines()])
    _bit_equal("(a) parameters", *[{k: v.numpy() for k, v in t["params"].items()}
                                   for t in trees])
    _bit_equal("(a) Adam", *[{str(i): v["exp_avg"].numpy()
                              for i, v in t["opt_state"]["state"].items()} for t in trees])
    if rows[0] != rows[1] or len(rows[0]) != 3:
        raise AssertionError(f"(a) infos differ: {rows}")
    log(f"phase 27 (a) world size 1: train_acro(distributed=True) (4096 envs, T={K7_STEPS}, 3 "
        f"iterations, no process group) equals distributed=False bit for bit (parameters, "
        f"Adam, infos); on {smi}")
    # (b)-(f): two ranks; the one-process references first
    ref_acro, ref_race = dist_layout_acro(None, dev), dist_layout_race(None, dev)
    ref_update = dist_update_reference(dev)
    ref_es = dist_es(None)
    t0 = time.perf_counter()
    outs = launch(dist_rank, DIST_RANKS, (str(root),), device="cuda:0", backend="gloo",
                  deadline=300.0)
    ranks_s = time.perf_counter() - t0
    acro = np.concatenate([o["acro"] for o in outs], axis=1)
    race = np.concatenate([o["race"] for o in outs], axis=1)
    if not (np.array_equal(acro, ref_acro) and np.array_equal(race, ref_race)):
        raise AssertionError("(b) two ranks do not replay one rank's rollout")
    log(f"phase 27 (b) two gloo ranks replay one process bit for bit: acro 4096 envs x 64 "
        f"steps (episodes of 16: {int(ref_acro[..., 4].sum())} resets), shared-policy race "
        f"1024 races x 4 agents x 20 steps (episodes of 8), rewards, positions and "
        f"{'gate counters' if ref_race[..., 4].max() > 0 else 'gate counters (all 0)'} equal")
    _bit_equal("(c) replicas", outs[0]["update"], outs[1]["update"])
    err = max(float(np.abs(outs[0]["update"][k] - ref_update[k]).max()) for k in ref_update)
    if not err <= 1e-6:
        raise AssertionError(f"(c) averaged update off the reference by {err}")
    log(f"phase 27 (c) averaged update (ActorCritic(128, 128), 2048 envs a rank, T={K7_STEPS}, "
        f"1 epoch, 1 minibatch) against the one-process mean of both halves' gradients, "
        f"clipped, one Adam step: max abs err {err:.3e} (<= 1e-6), replicas equal")
    ls = [o["learner"] for o in outs]
    _bit_equal("(d) replicas", ls[0]["params"], ls[1]["params"])
    share = [x["allreduce_s"] / x["wall_s"] for x in ls]
    log(f"phase 27 (d) state learner over {DIST_RANKS} gloo ranks on one card: train_acro "
        f"defaults, {STATE_ENVS} envs in all ({STATE_ENVS // DIST_RANKS} a rank), "
        f"{DIST_ITERS} iterations in chunks of {DIST_CHUNK}, first chunk left out: aggregate "
        f"{ls[0]['rate']:.6e} trained env-steps/s (rank 0's meter, global steps; rank 1's "
        f"{ls[1]['rate']:.6e}), {ls[0]['rate'] / DIST_RANKS:.6e} a rank, against phase 16's "
        f"one process {single_rate:.6e} ({ls[0]['rate'] / single_rate:.6f}x); all-reduce "
        f"share of an iteration {share[0]:.6f} / {share[1]:.6f} ({ls[0]['allreduces']} "
        f"all-reduces in 2 iterations, {ls[0]['allreduce_s'] * 1e3 / ls[0]['allreduces']:.6f} "
        f"ms each, host clock, the card synchronised first); reward {ls[0]['reward'][0]:.6f} "
        f"-> {ls[0]['reward'][1]:.6f}; replicas equal; on {smi}")
    vs = [o["vision"] for o in outs]
    _bit_equal("(e) replicas", vs[0]["params"], vs[1]["params"])
    want = DIST_VISION_ITERS * K7_STEPS + 1  # a render a step, and the reset's
    for v in vs:
        if v["counts"].get("render_depth") != want or v["counts"].get("policy_vision_rollout"):
            raise AssertionError(f"(e) expected {want} K5 launches a rank, saw {v['counts']}")
    vrows = train_rows("(e) vision over two ranks", root / "vision_log", DIST_VISION_ITERS)
    log(f"phase 27 (e) train_vision(distributed=True) (scan rollout, {N_VISION} envs in all, "
        f"per-env random worlds, {DIST_VISION_ITERS} iterations): K5 launches a rank "
        f"{json.dumps([v['counts'].get('render_depth') for v in vs])} ({K7_STEPS} an iteration "
        f"+ the reset's), losses {json.dumps([round(r['loss'], 6) for r in vrows])} finite, "
        f"replicas equal; on {smi}")
    es = [o["es"] for o in outs]
    _bit_equal("(f) ranks", {"theta": es[0]["theta"]}, {"theta": es[1]["theta"]})
    e_theta = float(np.abs(es[0]["theta"] - ref_es["theta"]).max())
    e_hist = float(np.abs(es[0]["hist"] - ref_es["hist"]).max())
    if not (e_theta <= 1e-6 and e_hist <= 1e-6):
        raise AssertionError(f"(f) ES off world size 1: theta {e_theta}, fitness {e_hist}")
    log(f"phase 27 (f) ES over two ranks (train_es defaults, 256 candidates x 256 envs x 60 "
        f"steps, 128 candidates a rank): {es[0]['rate']:.6e} fitness-rollout env-steps/s (the "
        f"second generation, all candidates); theta and generation-best fitness against world "
        f"size 1: max abs err {e_theta:.3e} and {e_hist:.3e} (<= 1e-6; "
        f"{'bit-equal' if e_theta == 0.0 and e_hist == 0.0 else 'not bit-equal'}), ranks equal; "
        f"on {smi}")
    log(f"phase 27 ranks took {ranks_s:.3f} s (spawn, CUDA start and (b)-(f) in each rank)")


def sim_checks(smi: str) -> None:
    """Phase 28 (a)-(c): the simulator on the card. It reaches no kernel (the
    splat renderer is eager PyTorch, as JAX's is plain XLA), so every launch
    counter stays 0."""
    from fpyv_tpu_torch.apps.simulator import run_simulator

    run_simulator(steps=16)  # warm-up: the libraries' first calls
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    # (a) headless: the card against the CPU in this process
    t0 = time.perf_counter()
    card = run_simulator(steps=SIM_STEPS)
    wall = time.perf_counter() - t0
    host = run_simulator(steps=SIM_STEPS, device="cpu")
    if (card["steps"], card["crashed"]) != (host["steps"], host["crashed"]):
        raise AssertionError(f"phase 28 (a): the card flew {card['steps']} steps (crashed "
                             f"{card['crashed']}), the CPU {host['steps']} ({host['crashed']})")
    errs = {k: float(np.abs(card[k] - host[k]).max()) for k in TOL_SIM}
    if any(errs[k] > tol for k, tol in TOL_SIM.items()):
        raise AssertionError(f"phase 28 (a): card against CPU {errs}, tolerance {TOL_SIM}")
    executed = min(SIM_STEPS, -(-card["steps"] // 512) * 512)  # whole chunks of 512 run
    log(f"phase 28 (a) sim headless (params.yaml, seed 0, guided, {SIM_STEPS} steps): "
        f"{card['steps']} steps flown, crashed {card['crashed']} (the CPU alike), final state "
        f"against the CPU {json.dumps(errs)} (tolerance {json.dumps(TOL_SIM)}); "
        f"{executed / wall:.6e} sim steps/s on the card ({executed} steps executed in "
        f"{wall:.3f} s: the chunk runs whole, one host read a chunk) on {smi}")
    # (b) the 2d FPV frames
    frames, first = [], []
    t0 = time.perf_counter()
    out = run_simulator(steps=SIM_STEPS, render="2d", frame_sink=frames.append, seed=SIM_2D_SEED)
    wall = time.perf_counter() - t0
    run_simulator(steps=1, render="2d", frame_sink=first.append, seed=SIM_2D_SEED, device="cpu")
    want = (out["steps"] + 1) // 2  # t % 2 == 0 up to the last step flown
    if len(frames) != want or any(f.shape != (480, 640) or f.dtype != np.uint8 for f in frames):
        raise AssertionError(f"phase 28 (b): {len(frames)} frames for {out['steps']} steps, "
                             f"expected {want} of (480, 640) uint8")
    off = int((frames[0] != first[0]).sum())
    if off > FRAME_SHARE * frames[0].size:
        raise AssertionError(f"phase 28 (b): the first frame differs from the CPU's on {off} "
                             f"pixels")
    log(f"phase 28 (b) sim --render 2d (seed {SIM_2D_SEED}, {SIM_STEPS} steps): {out['steps']} "
        f"steps flown, {len(frames)} frames of (480, 640) uint8, the first against the CPU's: "
        f"{off} pixels differ ({'bit-equal' if off == 0 else 'within 0.5 %'}); "
        f"{len(frames) / wall:.6e} frames/s, {SIM_STEPS / wall:.6e} sim steps/s with the "
        f"frames ({wall:.3f} s) on {smi}")
    # (c) the per-step path: the virtual target, a scripted drag

    def drag(t):
        return [("down", *VT_PIXEL)] if t == 0 else [("move", *VT_PIXEL)]

    run_simulator(steps=8, seed=SIM_2D_SEED, virtual_target=True, target_events=drag)
    t0 = time.perf_counter()
    vt = run_simulator(steps=VT_STEPS, seed=SIM_2D_SEED, virtual_target=True, target_events=drag)
    wall = time.perf_counter() - t0
    if not np.isfinite(vt["final_position"]).all():
        raise AssertionError(f"phase 28 (c): non-finite state {vt}")
    log(f"phase 28 (c) the per-step path (virtual target held at {VT_PIXEL}, seed "
        f"{SIM_2D_SEED}): {vt['steps']} steps flown, crashed {vt['crashed']}, "
        f"{vt['steps'] / wall:.6e} steps/s beside the {REFERENCE_FPS:.0f}/s the reference flies "
        f"a human at (config/params.yaml:7; a measurement, not a gate) on {smi}")
    counts = dict(_build.launch_counts)
    if any(counts.values()):
        raise AssertionError(f"phase 28 (a)-(c): the simulator launched {counts}")
    log(f"phase 28 (a)-(c) the simulator's kernel launches: {json.dumps(counts)}")


def video_checks(dev, smi: str) -> dict:
    """Phase 28 (d): play's FPV video from the shipped flagship on the card:
    K5 renders every frame at 640x480, one camera; frame 0 against K5's plain
    version on the same camera; K5's time, bound and launches at that shape."""
    from fpyv_tpu_torch.apps import play as play_mod
    from fpyv_tpu_torch.physics.drone import _att_to_rotmat
    from fpyv_tpu_torch.vision.camera import camera_pose
    from fpyv_tpu_torch.vision.raycast import ALL

    net, play_kw = play_mod.load_flagship()
    play_kw.pop("seed", None)
    params = net.state_dict()
    kw = dict(env_name="vision_race", steps=VIDEO_STEPS, num_envs=VIDEO_ENVS, chunk=VIDEO_STEPS,
              params=params, **play_kw)
    play_mod.play_policy(**dict(kw, steps=8, chunk=8), frame_sink=lambda f: None)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out = play_mod.play_policy(**kw)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    first, frames = [], []
    real = play_mod.video_frame

    def spy(rig, p, drone, world):
        out = real(rig, p, drone, world)
        if not first:
            first.append((rig, p, drone, world, out))
        return out

    _build.reset_launch_counts()
    with swapped(play_mod, "video_frame", spy):
        t0 = time.perf_counter()
        out = play_mod.play_policy(frame_sink=frames.append, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    want = {k: 0 for k in counts}
    want["render_depth"] = 2 * VIDEO_STEPS + 1  # the env's frames (+ the reset's) and the video's
    want["levels_lut"] = VIDEO_STEPS  # the net's uint8 input, one forward a step
    if counts != want or len(frames) != VIDEO_STEPS or out["steps"] != VIDEO_STEPS:
        raise AssertionError(f"phase 28 (d): {len(frames)} frames for {out['steps']} steps, "
                             f"launches {counts}, expected {want}")
    if set(out) != set(plain_out):
        raise AssertionError(f"phase 28 (d): keys {sorted(out)} against {sorted(plain_out)}")
    if any(f.shape != (480, 640) or f.dtype != np.uint8 for f in frames):
        raise AssertionError("phase 28 (d): the video frames are not (480, 640) uint8")
    rig, p, drone, world, f0 = first[0]
    cam_pos, cam_R = camera_pose(rig, drone.pos, _att_to_rotmat(p, drone.att))
    cfg, dcam, cam, wcol = vk.render_inputs(rig, cam_pos, cam_R, world, 25.0, ALL, None, 0.08)
    ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
    got = vk.launch_render_depth(cfg, dcam, cam, wcol)
    err = float((got - ref).abs().max().item())
    if err != 0.0 or not torch.equal(f0, torch.round(ref * 255.0).to(torch.uint8).reshape(480, 640)):
        raise AssertionError(f"phase 28 (d): K5 at 640x480 differs from its plain version "
                             f"({err}) or from the video's frame 0")
    hw = dcam.shape[1]
    ms = cuda_ms(lambda: vk.launch_render_depth(cfg, dcam, cam, wcol), 200)
    pms = cuda_ms(lambda: vk.render_depth_reference(cfg, dcam, cam, wcol), 5)
    nbytes = ((hw + 16) + 3 * hw + cfg.n_cols) * 4
    ops = render_data_ops(cfg, dcam, cam, wcol)
    bms, by = bound(ops, nbytes)
    lit = float((ref > 0).float().mean().item())
    try:
        import cv2  # noqa: F401
        encoder = True
    except ImportError:
        encoder = False
    try:
        import matplotlib  # noqa: F401
        views = True
    except ImportError:
        views = False
    log(f"phase 28 (d) on this machine: cv2 {'imports' if encoder else 'is missing'} (the "
        f"video's encoder, the HUD), matplotlib {'imports' if views else 'is missing'} "
        f"(--render 3d, the calibration views)")
    if encoder:
        path = Path(__file__).resolve().parent / "build" / "chip_smoke" / "play_video.mp4"
        path.parent.mkdir(parents=True, exist_ok=True)
        vid = play_mod.play_policy(save_video=str(path), **kw)
        sink_note = f"save_video wrote {path.name} with {vid['video_frames']} frames"
    else:
        sink_note = ("no cv2 on this machine: the frames went through play's frame path "
                     "(HUD included) into a list, not the encoder")
    log(f"phase 28 (d) play's video (flagship, vision_race, {VIDEO_ENVS} envs, {VIDEO_STEPS} "
        f"steps): {len(frames)} frames of (480, 640) uint8, {sink_note}; "
        f"{VIDEO_STEPS / wall:.6e} video frames/s ({wall:.3f} s; the same eval without the video "
        f"{wall_plain:.3f} s, so {(wall - wall_plain) / VIDEO_STEPS * 1e3:.3f} ms a frame); "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}; the eval's statistics "
        f"equal to the run without the video: {out == plain_out}; frame 0 equals K5's plain "
        f"version (max abs err {err}) on {smi}")
    log(f"K5 at 1 x 640x480 (play's video camera, frame 0, {lit:.6f} of its pixels lit): "
        f"{ms:.6f} ms (plain {pms:.6f} ms), bound {bms:.6f} ms by {by} (the operations this "
        f"frame's pixels need, misses ending at the discriminant), {VIDEO_STEPS} launches a "
        f"{VIDEO_STEPS}-step play call, on {smi}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms}


def cli_checks(smi: str) -> None:
    """Phase 28 (e): ``python -m fpyv_tpu_torch.cli`` as subprocesses on the
    card: exit code 0 and the JSON line of each."""
    root = Path(__file__).resolve().parent
    for argv in CLI_CALLS:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "fpyv_tpu_torch.cli", *argv], cwd=root,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"phase 28 (e): cli {' '.join(argv)} exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        out = json.loads(res.stdout.strip().splitlines()[-1])
        if argv[0] == "train" and (set(out) != TRAIN_KEYS
                                   or not math.isfinite(out["mean_reward_last"])):
            raise AssertionError(f"phase 28 (e): cli {' '.join(argv)} printed {out}")
        if argv[0] == "parity" and out.get("pass") is not True:
            raise AssertionError(f"phase 28 (e): cli parity on the card failed: {out}")
        log(f"phase 28 (e) python -m fpyv_tpu_torch.cli {' '.join(argv)}: rc 0 in {wall:.3f} s "
            f"(process start included), {json.dumps(out)} on {smi}")


SENSOR_STEPS = 256  # phase 29 (a): tests/test_envs.py::TestSensorAcroEnv's action, 4096 envs
HOVER_STEPS = 600  # (b): test_envs.py::TestHoverEnv::test_rates_pid_hover_pilot's length
LEVEL_STEPS = 240  # (c): test_flight_modes.py::test_self_levels_from_tilt's length
LEVEL_TILT_DEG = 40.0  # (c): that test's tilts reach 40-44 degrees
HOVER_THROTTLE = -0.646  # (c): thrust ~= weight for the default F80 curve
RACER_STEPS = 1500  # (d): test_racer_and_io.py::TestRacer::test_rate_tracking
RACER_CMD = (80.0, 10.0, 0.0, 0.0)
SMALL = 64  # envs of each card-against-CPU check
TOL_SENSOR_OBS = 1e-4  # (a): float32 obs; an ulp of the baro's exp is 3e-5 of it
TOL_HOVER_POS = 1e-4  # (b): m after 60 closed-loop float32 steps
TOL_LEVEL_ATT = 1e-4  # (c): attitude after 240 float32 steps of a self-levelling loop
TOL_RACER = {"omega": 1e-3, "R": 1e-4, "pos": 1e-5}  # (d): after 1500 float32 steps
TOL_REL = 1e-5  # (e): terrain and attention, relative to the largest value


def _on(dev, fn):
    """fn(dev) on the card and on the CPU: (card's, CPU's)."""
    return fn(dev), fn(torch.device("cpu"))


def _max_diff(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def sensor_acro_checks(dev, smi: str) -> None:
    """Phase 29 (a): ``SensorAcroEnv`` at the main path's bank."""
    from fpyv_tpu_torch.envs.sensor_acro import SensorAcroEnv

    def run(device, n, steps):
        env, g = SensorAcroEnv(), torch.Generator().manual_seed(0)
        world = env.acro.default_world(device)
        st, obs = env.reset(g, world, (n,))
        act = torch.zeros(n, 4, device=device)
        act[:, 3] = THROTTLE
        for _ in range(steps):
            st, obs, *_ = env.step(st, act, world, generator=g)
        return obs

    card, host = _on(dev, lambda d: run(d, SMALL, 8))
    err = _max_diff(card, host)
    if err > TOL_SENSOR_OBS:
        raise AssertionError(f"phase 29 (a): card against CPU {err} > {TOL_SENSOR_OBS}")
    env, g = SensorAcroEnv(), torch.Generator().manual_seed(1)
    world = env.acro.default_world(dev)
    st, obs = env.reset(g, world, (N_ENVS,))
    act = torch.zeros(N_ENVS, 4, device=dev)
    act[:, 3] = THROTTLE
    for _ in range(8):  # warm-up
        st, obs, *_ = env.step(st, act, world, generator=g)
    torch.cuda.synchronize()
    same = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)  # an env's obs repeated
    t0 = time.perf_counter()
    for _ in range(SENSOR_STEPS):
        prev = obs
        st, obs, *_ = env.step(st, act, world, generator=g)
        same |= (prev == obs).all(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (obs.shape != (N_ENVS, env.obs_dim) or not torch.isfinite(obs).all() or same.any()
            or not st.acro.domain_rand.mass_scale.std() > 0):
        raise AssertionError(f"phase 29 (a): obs {tuple(obs.shape)}, finite "
                             f"{bool(torch.isfinite(obs).all())}, {int(same.sum())} envs "
                             f"repeated an observation")
    busy, top = device_busy(lambda: [env.step(st, act, world, generator=g) for _ in range(16)])
    acro, ag = AcroEnv(randomize=True), torch.Generator().manual_seed(1)
    ast, _ = acro.reset(ag, world, (N_ENVS,))
    for _ in range(8):
        ast, *_ = acro.step(ast, act, world, generator=ag)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(SENSOR_STEPS):
        ast, *_ = acro.step(ast, act, world, generator=ag)
    torch.cuda.synchronize()
    acro_wall = time.perf_counter() - t1
    log(f"phase 29 (a) SensorAcroEnv ({N_ENVS} envs, throttle {THROTTLE}, {SENSOR_STEPS} steps): "
        f"obs ({N_ENVS}, {env.obs_dim}) finite, successive obs differ at every step, mass scales "
        f"vary; card against CPU ({SMALL} envs, 8 steps, the same CPU generator's draws) max abs "
        f"err {err} (tolerance {TOL_SENSOR_OBS}); {N_ENVS * SENSOR_STEPS / wall:.6e} env-steps/s "
        f"({1e3 * wall / SENSOR_STEPS:.3f} ms a step) beside the eager AcroEnv(randomize=True) "
        f"step's {N_ENVS * SENSOR_STEPS / acro_wall:.6e} ({1e3 * acro_wall / SENSOR_STEPS:.3f} "
        f"ms) in this call; busy {busy:.6f}, top {json.dumps(top)} on {smi}")


def hover_checks(dev, smi: str) -> None:
    """Phase 29 (b): ``HoverEnv`` with its rates-PID pilot, closed loop."""
    from fpyv_tpu_torch.envs.hover import HoverEnv, HoverPilot

    def run(device, n, steps):
        env, pilot = HoverEnv(), HoverPilot(drone_params=DroneParams())
        g = torch.Generator().manual_seed(0)
        st, _ = env.reset(g, (n,), device)
        ps, world = pilot.init((n,), device=device), env.default_world(device)
        errs, done = [], torch.zeros(n, dtype=torch.bool, device=device)
        for _ in range(steps):
            ps, a = pilot.act(ps, st.drone, st.target_pos)
            st, _, _, d, info = env.step(st, a, world, generator=g)
            errs.append(info["pos_err"])
            done |= d
        return st, torch.stack(errs), done

    (cs, _, _), (hs, _, _) = _on(dev, lambda d: run(d, SMALL, 60))
    err = _max_diff(cs.drone.pos, hs.drone.pos)
    if err > TOL_HOVER_POS:
        raise AssertionError(f"phase 29 (b): card against CPU {err} m > {TOL_HOVER_POS}")
    run(dev, N_ENVS, 8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, errs, crashed = run(dev, N_ENVS, HOVER_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    _, host_errs, host_crashed = run(torch.device("cpu"), N_ENVS, HOVER_STEPS)
    host_wall = time.perf_counter() - t1
    errs, crashed = errs.cpu(), crashed.cpu()
    mean = errs.mean(1)
    ratio, last50 = float(mean[-1] / mean[0]), float(mean[-50:].mean())
    both = ((errs[-1] < 0.3 * errs[0]) & (errs[-50:].mean(0) < 2.0)).double().mean().item()
    if not (last50 < 2.0 and mean[-1] < mean[0]):
        raise AssertionError(f"phase 29 (b): the bank's mean error {float(mean[0])} -> "
                             f"{float(mean[-1])}, last 50 {last50}")
    if not torch.equal(crashed, host_crashed):
        raise AssertionError(f"phase 29 (b): the card crashed envs "
                             f"{crashed.nonzero().flatten().tolist()}, the CPU "
                             f"{host_crashed.nonzero().flatten().tolist()}")
    curve = _max_diff(mean, host_errs.mean(1))
    log(f"phase 29 (b) HoverEnv + HoverPilot ({N_ENVS} envs, {HOVER_STEPS} closed-loop steps): "
        f"the bank's mean position error {float(mean[0]):.6f} -> {float(mean[-1]):.6f} m (ratio "
        f"{ratio:.6f} against JAX's single-env test's 0.3: the pilot settles ~1.01 m off its "
        f"target, so envs spawned nearer than ~3.4 m cannot meet it), mean of the last 50 "
        f"{last50:.6f} (< 2.0), {int(crashed.sum())} envs crashed (the CPU's run of the same "
        f"bank: the same envs, its mean error curve within {curve:.3e}), {both:.6f} of the envs "
        f"meet both of JAX's conditions on their own; card against CPU ({SMALL} envs, 60 steps) "
        f"{err} m (tolerance {TOL_HOVER_POS}); {N_ENVS * HOVER_STEPS / wall:.6e} env-steps/s "
        f"with the pilot ({1e3 * wall / HOVER_STEPS:.3f} ms a step; the CPU's "
        f"{N_ENVS * HOVER_STEPS / host_wall:.6e}) on {smi}")


def level_checks(dev, smi: str) -> None:
    """Phase 29 (c): ANGLE and HORIZON self-level through ``drone_step``."""
    from fpyv_tpu_torch.control.flight_modes import (FlightModeParams, angle_mode_action,
                                                     flight_mode_init, horizon_mode_action)
    from fpyv_tpu_torch.ops import rotations as rot
    from fpyv_tpu_torch.physics.drone import drone_step
    from fpyv_tpu_torch.physics.world import empty_world

    params = DroneParams(att_mode="rotmat")
    fm = FlightModeParams(max_rates=params.max_rates)

    def fly(device, mode, n):
        g = torch.Generator().manual_seed(2)
        tilt = (torch.rand(n, 3, generator=g, dtype=torch.float64) * 2 - 1) \
            * torch.tensor([LEVEL_TILT_DEG, LEVEL_TILT_DEG, 180.0], dtype=torch.float64)
        st = drone_reset(params, torch.tensor([0.0, 0.0, 30.0], device=device).repeat(n, 1),
                         torch.zeros(n, 3, device=device), tilt.float().to(device))
        world, fs = empty_world(ground=True, device=device), flight_mode_init((n,), device=device)
        sticks = torch.zeros(n, 4, device=device)
        sticks[:, 3] = HOVER_THROTTLE
        for _ in range(LEVEL_STEPS):
            fs, action = mode(fm, fs, st.att, sticks)
            st, _ = drone_step(params, st, action, world)
        return st

    out = {}
    for name, mode in (("ANGLE", angle_mode_action), ("HORIZON", horizon_mode_action)):
        card, host = _on(dev, lambda d: fly(d, mode, SMALL))
        err = _max_diff(card.att, host.att)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = fly(dev, mode, N_ENVS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tilt = rot.rotmat_to_euler(st.att)[:, :2].abs().max().item() * 180.0 / math.pi
        if err > TOL_LEVEL_ATT or tilt >= 2.0 or st.done.any():
            raise AssertionError(f"phase 29 (c) {name}: card against CPU {err}, largest tilt "
                                 f"{tilt} deg, {int(st.done.sum())} crashed")
        out[name] = (err, tilt, N_ENVS * LEVEL_STEPS / wall)
    R = rot.euler_to_rotmat(torch.zeros(N_ENVS, 3, device=dev))
    full = torch.tensor([1.0, -1.0, 0.3, HOVER_THROTTLE], device=dev).repeat(N_ENVS, 1)
    _, action = horizon_mode_action(fm, flight_mode_init((N_ENVS,), device=dev), R, full)
    if not torch.equal(action, full):
        raise AssertionError("phase 29 (c): HORIZON at full stick is not acro's action")
    log(f"phase 29 (c) self-level ({N_ENVS} envs tilted up to {LEVEL_TILT_DEG:.0f} deg in roll "
        f"and pitch, centred sticks at throttle {HOVER_THROTTLE}, {LEVEL_STEPS} steps through "
        f"drone_step): " + "; ".join(
            f"{k} largest roll/pitch {v[1]:.3e} deg (< 2), no crash, card against CPU ({SMALL} "
            f"envs) {v[0]} (tolerance {TOL_LEVEL_ATT}), {v[2]:.6e} env-steps/s"
            for k, v in out.items())
        + f"; HORIZON at full stick equals acro's action exactly, on {smi}")


def racer_checks(dev, smi: str) -> None:
    """Phase 29 (d): the torque racer tracks its rate commands."""
    from fpyv_tpu_torch.physics.racer import RacerParams, racer_reset, racer_step

    params = RacerParams()

    def run(device, n):
        st = racer_reset((n,), device=device)
        cmd = torch.tensor(RACER_CMD, device=device).repeat(n, 1)
        for _ in range(RACER_STEPS):
            st = racer_step(params, st, cmd)
        return st

    card, host = _on(dev, lambda d: run(d, SMALL))
    errs = {k: _max_diff(getattr(card, k), getattr(host, k)) for k in TOL_RACER}
    if any(errs[k] > tol for k, tol in TOL_RACER.items()):
        raise AssertionError(f"phase 29 (d): card against CPU {errs}, tolerance {TOL_RACER}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(dev, N_ENVS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = torch.tensor(RACER_CMD[:2], device=dev)
    off = ((st.omega[:, :2] - want).abs() / want).max().item()
    if off > 0.05:
        raise AssertionError(f"phase 29 (d): the rates are {off:.4f} off their commands")
    log(f"phase 29 (d) racer ({N_ENVS} envs, dt {params.dt}, {RACER_STEPS} steps at commands "
        f"{RACER_CMD[:3]} deg/s): the rates within {off:.3e} of the commands (< 0.05), card "
        f"against CPU ({SMALL} envs) {json.dumps(errs)} (tolerance {json.dumps(TOL_RACER)}); "
        f"{N_ENVS * RACER_STEPS / wall:.6e} env-steps/s ({1e3 * wall / RACER_STEPS:.3f} ms a "
        f"step) on {smi}")


def small_path_checks(dev, smi: str) -> None:
    """Phase 29 (e): the peak detector, the geometry algorithms, the terrain,
    attention, the gym adapter, ``evaluate_policy`` and the health guards
    on the card."""
    from fpyv_tpu_torch.envs.gym_adapter import GymAdapter
    from fpyv_tpu_torch.envs.wrappers import evaluate_policy
    from fpyv_tpu_torch.models import nn
    from fpyv_tpu_torch.models.terrain import terrain_heightmap
    from fpyv_tpu_torch.sensors.baro import is_peak_altitude
    from fpyv_tpu_torch.utils.debug import assert_finite, finite_mask
    from fpyv_tpu_torch.vision import geometry as geo

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 3.0, 64)
    series = -(x - rng.uniform(0.5, 2.5, (N_ENVS, 1))) ** 2 + rng.normal(0.0, 0.3, (N_ENVS, 64))
    peaks = {}
    for ref_fit in (True, False):
        card, host = _on(dev, lambda d: is_peak_altitude(torch.from_numpy(x).to(d),
                                                         torch.from_numpy(series).to(d), 3,
                                                         ref_fit))
        if not torch.equal(card.cpu(), host):
            raise AssertionError(f"phase 29 (e): is_peak_altitude(use_reference_fit={ref_fit}) "
                                 f"flags {int((card.cpu() != host).sum())} series otherwise")
        peaks[ref_fit] = int(host.sum())
    # geometry at tests/test_geometry_es.py's sizes and tolerances, float64
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    th = 0.1
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    X = rng.uniform(-2, 2, (30, 3)) + np.array([0, 0, 8.0])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([Ry, np.array([[1.0], [0.2], [0.1]])])
    hom = lambda P: (P @ np.hstack([X, np.ones((30, 1))]).T).T
    p1, p2 = (hom(P)[:, :2] / hom(P)[:, 2:] for P in (P1, P2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    F = geo.eight_point(t(p1), t(p2))
    res = geo.epipolar_residual(F, t(p1), t(p2)).max().item()
    s3 = torch.linalg.svdvals(F.cpu())[2].item()
    tri = np.abs(geo.triangulate(t(P1), t(P2), t(p1), t(p2)).cpu().numpy() - X).max()
    anchors, target = rng.normal(size=(6, 3)) * 5, rng.normal(size=3)
    gn = np.abs(geo.trilaterate_gauss_newton(t(anchors), t(np.linalg.norm(
        anchors - target, axis=1))).cpu().numpy() - target).max()
    src = rng.uniform(-1, 1, (80, 2))
    Rt = np.array([[np.cos(0.12), -np.sin(0.12)], [np.sin(0.12), np.cos(0.12)]])
    Ri, ti, rmse = geo.icp_2d(t(src), t(src @ Rt.T + np.array([0.1, -0.05])), 40)
    icp = max(np.abs(Ri.cpu().numpy() - Rt).max(), np.abs(ti.cpu().numpy() - [0.1, -0.05]).max())
    if not (res < 1e-8 and s3 < 1e-10 and tri < 1e-6 and gn < 1e-8 and rmse.item() < 1e-3
            and icp < 1e-2):
        raise AssertionError(f"phase 29 (e) geometry: residual {res}, s3 {s3}, triangulation "
                             f"{tri}, Gauss-Newton {gn}, ICP rmse {rmse.item()} and {icp}")
    # the terrain at 100x100 and attention, float32 (TF32 off)
    (_, zc), (_, zh) = _on(dev, lambda d: terrain_heightmap(torch.Generator().manual_seed(0),
                                                            resolution=100, device=d))
    qkv = [torch.from_numpy(rng.normal(size=(8, 128, 64)).astype(np.float32)) for _ in range(3)]
    ac, ah = _on(dev, lambda d: nn.attention(*(a.to(d) for a in qkv)))
    rel = {"terrain": _max_diff(zc, zh) / zh.abs().max().item(),
           "attention": max(_max_diff(ac[i], ah[i]) / ah[i].abs().max().item() for i in (0, 1))}
    if max(rel.values()) > TOL_REL:
        raise AssertionError(f"phase 29 (e): card against CPU {rel} > {TOL_REL}")
    # the gym adapter and the evaluation over the acro env, on the card
    gym = GymAdapter(AcroEnv(), 16, seed=0)
    obs = gym.reset()
    a = np.zeros((16, 4), np.float32)
    a[:, 3] = THROTTLE
    o, r, d, info = gym.step(a)
    if not (isinstance(o, np.ndarray) and o.shape == obs.shape == (16, AcroEnv().obs_dim)
            and r.shape == (16,) and d.dtype == np.bool_
            and isinstance(info["dist_to_target"], np.ndarray)):
        raise AssertionError(f"phase 29 (e): the gym adapter gave {o.shape}, {r.shape}, {d.dtype}")

    def hover(o):
        act = torch.zeros(o.shape[:-1] + (4,), device=o.device)
        act[..., 3] = THROTTLE
        return act

    stats = evaluate_policy(AcroEnv(), None, hover, torch.Generator().manual_seed(0), N_ENVS, 50)
    if set(stats) != {"mean_step_reward", "total_episodes", "crash_rate_per_step",
                      "reward_per_episode_lower_bound"} or not all(
            torch.isfinite(v).all() for v in stats.values()):
        raise AssertionError(f"phase 29 (e): evaluate_policy gave {stats}")
    # the health guards on a bank with poisoned envs
    st, _ = AcroEnv().reset(torch.Generator().manual_seed(0), None, (N_ENVS,), dev)
    bad = [3, N_ENVS // 4, N_ENVS - 96]
    st.drone.pos[bad[0], 2] = float("nan")
    st.wind[bad[1]] = float("inf")
    st.domain_rand.mass_scale[bad[2]] = float("nan")
    mask = finite_mask(st)
    if mask.device != st.drone.pos.device or (~mask).nonzero().flatten().tolist() != bad:
        raise AssertionError(f"phase 29 (e): finite_mask flags "
                             f"{(~mask).nonzero().flatten().tolist()}, poisoned {bad}")
    try:
        assert_finite(st, name="bank")
        raise AssertionError("phase 29 (e): assert_finite passed a poisoned bank")
    except FloatingPointError as e:
        msg = str(e)
    if msg != ("non-finite values in bank: .drone.pos (1 values), .domain_rand.mass_scale "
               "(1 values), .wind (3 values)"):
        raise AssertionError(f"phase 29 (e): assert_finite said {msg!r}")
    log(f"phase 29 (e) small paths on the card: is_peak_altitude on ({N_ENVS}, 64) noisy "
        f"float64 series, flags equal to the CPU's (reference fit {peaks[True]} peaks, "
        f"least squares {peaks[False]}); eight_point residual {res:.3e} (< 1e-8), rank-2 "
        f"s3 {s3:.3e} (< 1e-10), triangulate {tri:.3e} (< 1e-6), Gauss-Newton {gn:.3e} "
        f"(< 1e-8), ICP rmse {rmse.item():.3e} (< 1e-3) and R, t within {icp:.3e} (< 1e-2); "
        f"terrain 100x100 and attention against the CPU relative to the largest value "
        f"{json.dumps(rel)} (tolerance {TOL_REL}); GymAdapter(AcroEnv(), 16) numpy "
        f"{o.shape}, {r.shape}, {d.dtype}; evaluate_policy ({N_ENVS} envs x 50 steps) "
        f"{json.dumps({k: float(v) for k, v in stats.items()})}; finite_mask flags exactly "
        f"envs {bad}; assert_finite: {msg!r}; {time.perf_counter() - t0:.3f} s on {smi}")


def secondary_checks(dev, smi: str) -> None:
    """Phase 29: the secondary envs, sensors, controllers and models on the
    card, with every launch counter at 0 from start to end (no kernel is on
    these paths) and TF32 off for their float32 products."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 29: TF32 is on for float32 matmuls")
    _build.reset_launch_counts()
    for part in (sensor_acro_checks, hover_checks, level_checks, racer_checks,
                 small_path_checks):
        t0 = time.perf_counter()
        part(dev, smi)
        log(f"phase 29 {part.__name__} took {time.perf_counter() - t0:.3f} s")
    counts = dict(_build.launch_counts)
    if any(counts.values()):
        raise AssertionError(f"phase 29: kernels launched {counts}")
    log(f"phase 29 (f) the kernel launches across phase 29: {json.dumps(counts)}")


# ---------------------------------------------------------------------------
# Phase 30: the configurations the Pallas kernels take past the quad and the
# 256-wide fc: any motor count through K1 (K3, K4, K6), any fc width in K7 and
# K8. Each kernel against its plain version on the card (float32 equal, bf16
# teacher-forced), each time beside the quad's or the 256-wide one's.
# ---------------------------------------------------------------------------

HEX = 6  # the hexacopter of phase 30's megaloop and chase
MOTOR_BANK = (4, 3, 6, 8)  # phase 30's contact-heavy bank, the quad first
WIDE_FC = ((256, True), (384, False), (384, True), (200, True))  # (hidden, bf16), 256 first
WIDE_CHECK_T, WIDE_CHECK_EPISODE = 4, 3  # the plain check's steps; every env resets in them
PHASE30_K = 64
PHASE30_MEGALOOP_K = 100_000  # the megaloop's steps a launch (~0.2 s at 4096 envs)


def contact_share(params, drone, world) -> float:
    """The share of envs whose first plain step feels a contact force: the
    step's velocity on ``world`` against the same step with every sphere and
    cylinder inactive (the bank flies far above the ground)."""
    s, a = sk.state_to_matrix(drone), torch.zeros(4, drone.pos.shape[0], device=drone.pos.device)
    sph = sk.sphere_matrix(world)
    free = sph.clone()
    free[4] = 0.0
    hit = sk.drone_step_reference(params, s, a, sph, sk.cylinder_matrix(world))
    miss = sk.drone_step_reference(params, s, a, free, None)
    return (hit[3:6] != miss[3:6]).any(0).float().mean().item()


def motor_checks(dev, gen, smi: str) -> dict:
    """(a) The acro megaloop (K4) of a hexacopter at 4096 envs on the
    params.yaml world with DR and wind beside the quad's; (b) the
    contact-heavy bank at 3, 6 and 8 motors through K3 and K4 beside the
    quad's; (c) the chase (K6) of a hexacopter at 1024 envs beside the
    quad's. Returns the largest error of each kernel (0.0: equal)."""
    pworld = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=dev)
    pcyl, pwm = sk.cylinder_matrix(pworld), ek.env_world_matrix(pworld)
    S, C = pworld.num_spheres, pcyl.shape[1]
    hover = torch.zeros(N_ENVS, 4, device=dev)
    hover[:, 3] = THROTTLE
    a4 = sk.action_matrix(hover)
    K = PHASE30_K
    kw = dict(randomize=True, wind=(1.0, 0.5, 0.0), wind_scale=0.5)
    k4_bytes = N_ENVS * (24 + 4 + 24 + 1) * 4 + (12 * S + 6 * C) * 4
    rows = {}
    for nm in (4, HEX):
        env = AcroEnv(params=DroneParams(att_mode="quat", n_motors=nm), **kw)
        st, _ = vector_reset(env, gen, N_ENVS, pworld)
        s24 = ek.env_state_to_matrix(st)
        out, rsum = ek.launch_env_rollout(env, s24, a4, pwm, K, seed=2, cyl_mat=pcyl)
        torch.cuda.synchronize()
        ref, ref_rsum, resets = ek.env_rollout_reference(env, s24, a4, pwm, K, seed=2,
                                                         cyl_mat=pcyl)
        equal_bits(f"K4 ({nm} motors, params.yaml world + DR + wind, N={N_ENVS}, K={K})",
                   [(out, ref), (rsum, ref_rsum)])
        ms = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, pwm, K, seed=2, cyl_mat=pcyl),
                     50)
        ops = (N_ENVS * K * (step_ops(S, C, dr=True, wind=True, n_motors=nm) + 21)
               + resets * reset_ops(True, True) + K * 18 * S + N_ENVS * 17)
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, rs = ek.fused_env_rollout(env, st, hover, pworld, PHASE30_MEGALOOP_K, seed=5)
        total = rs.sum().item()
        wall = time.perf_counter() - t0
        if _build.launch_counts["env_rollout"] != 1 or not math.isfinite(total):
            raise AssertionError(f"megaloop ({nm} motors): {dict(_build.launch_counts)}, "
                                 f"reward sum {total}")
        check_state(f"megaloop ({nm} motors)", ek.env_state_to_matrix(state), N_ENVS,
                    max_t=env.max_episode_steps)
        rows[nm] = (ms, bound(ops, k4_bytes)[0], N_ENVS * PHASE30_MEGALOOP_K / wall, resets)
    (q_ms, q_b, q_rate, _), (h_ms, h_b, h_rate, h_res) = rows[4], rows[HEX]
    log(f"K4 hexacopter (N={N_ENVS}, K={K}, params.yaml world + DR + wind, {h_res} resets): "
        f"{h_ms:.6f} ms, {h_ms / q_ms:.6f}x the quad's {q_ms:.6f} ms; bound {h_b:.6f} ms "
        f"(quad {q_b:.6f}); the megaloop (fused_env_rollout, K={PHASE30_MEGALOOP_K}, one K4 "
        f"launch) {h_rate:.6e} env-steps/s beside the quad's {q_rate:.6e}, on {smi}")

    # (b) the contact-heavy bank through K3 and K4 at 3, 6 and 8 motors
    bank = {}
    for nm in MOTOR_BANK:
        env = AcroEnv(params=DroneParams(att_mode="quat", n_motors=nm), max_episode_steps=50)
        cw, cst = contact_bank(env, gen, N_ENVS, dev)
        share = contact_share(env.params, cst.drone, cw)
        if share < 0.5:
            raise AssertionError(f"contact bank ({nm} motors): only {share} of the envs in "
                                 f"contact at the first step")
        cs15, csph, ccyl = sk.state_to_matrix(cst.drone), sk.sphere_matrix(cw), sk.cylinder_matrix(cw)
        cS, cC = csph.shape[1], ccyl.shape[1]
        out = sk.launch_rollout(env.params, cs15, a4, csph, K, ccyl)
        torch.cuda.synchronize()
        ref = sk.rollout_reference(env.params, cs15, a4, csph, K, ccyl)
        equal_bits(f"K3 ({nm} motors, contact-heavy start)", [(out, ref)])
        k3_ms = cuda_ms(lambda: sk.launch_rollout(env.params, cs15, a4, csph, K, ccyl), 50)
        s24, cwm = ek.env_state_to_matrix(cst), ek.env_world_matrix(cw)
        out, rsum = ek.launch_env_rollout(env, s24, a4, cwm, K, seed=3, cyl_mat=ccyl)
        torch.cuda.synchronize()
        ref, ref_rsum, cres = ek.env_rollout_reference(env, s24, a4, cwm, K, seed=3,
                                                       cyl_mat=ccyl)
        equal_bits(f"K4 ({nm} motors, contact-heavy start)", [(out, ref), (rsum, ref_rsum)])
        k4_ms = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, cwm, K, seed=3,
                                                      cyl_mat=ccyl), 50)
        k3_b = bound(N_ENVS * K * step_ops(cS, cC, n_motors=nm),
                     N_ENVS * (15 + 4 + 15) * 4 + (5 * cS + 6 * cC) * 4)[0]
        k4_b = bound(N_ENVS * K * (step_ops(cS, cC, n_motors=nm) + 21) + cres * reset_ops(False, False)
                     + K * 18 * cS + N_ENVS * 17,
                     N_ENVS * (24 + 4 + 24 + 1) * 4 + (12 * cS + 6 * cC) * 4)[0]
        bank[nm] = {"contact_share": share, "resets": cres, "K3_ms": k3_ms, "K3_bound_ms": k3_b,
                    "K4_ms": k4_ms, "K4_bound_ms": k4_b,
                    "K3_x_quad": k3_ms / bank[4]["K3_ms"] if nm != 4 else 1.0,
                    "K4_x_quad": k4_ms / bank[4]["K4_ms"] if nm != 4 else 1.0}
    log(f"contact-heavy bank (N={N_ENVS}, K={K}, 2 spheres, 8 cylinders) by motor count, K3 and "
        f"K4 equal to their plain versions: {json.dumps(bank)} on {smi}")

    # (c) the chase of a hexacopter at 1024 envs beside the quad's
    world = AcroEnv().default_world(dev)
    wm, rig = ek.env_world_matrix(world), default_vision_rig()
    hw = rig.resolution[0] * rig.resolution[1]
    chase = {}
    err = 0.0
    for nm in (4, HEX):  # 20-step episodes: every env resets inside the K steps
        env = AcroEnv(params=DroneParams(att_mode="quat", n_motors=nm), max_episode_steps=20)
        st, _ = vector_reset(env, gen, N_VISION, world)
        s28 = vk.chase_state_matrix(st)
        out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s28, wm, K, rig)
        torch.cuda.synchronize()
        ref, ref_rsum, resets, rc, rct = vk.vision_env_rollout_reference(env, s28, wm, K, rig)
        err = max(err, check_chase(f"{nm} motors, default world, N={N_VISION}, K={K}", env, out,
                                   ref, rsum, ref_rsum, crashes, rc, contacts, rct, N_VISION,
                                   resets))
        ms = cuda_ms(lambda: vk.launch_vision_env_rollout(env, s28, wm, K, rig), 10)
        if nm == 4:  # the pixels the target lit, counted by the quad's instrumented launch
            lit = chase_phases(dev, env, s28, wm, rig, K, ms)["lit_per_step"]
        ops = (N_VISION * K * chase_step_ops(lit, world.num_spheres, 0, False, False, nm)
               + resets * reset_ops(False, False))
        chase[nm] = (ms, bound(ops, (N_VISION * (28 + 28 + 3) + 12 * world.num_spheres
                                     + 3 * hw) * 4)[0])
    log(f"K6 hexacopter (N={N_VISION}, K={K}, default world): {chase[HEX][0]:.6f} ms, "
        f"{chase[HEX][0] / chase[4][0]:.6f}x the quad's {chase[4][0]:.6f} ms; bound "
        f"{chase[HEX][1]:.6f} ms (quad {chase[4][1]:.6f}; the lit pixels of the quad's "
        f"instrumented launch), on {smi}")
    return {"env_rollout": 0.0, "rollout": 0.0, "vision_env_rollout": err}


def width_checks(dev, gen, smi: str) -> dict:
    """K7 and K8 at the trainers' shapes (1024 envs, 96x72, T = 32; K8 with 4
    frames) with an fc of 384 units in float32 and bf16 and of 200 in bf16,
    each timed beside the 256-wide bf16 launch; each width held against its
    plain version on a hexacopter's bank of 1024 for WIDE_CHECK_T steps of
    WIDE_CHECK_EPISODE-step episodes (every env resets): float32 equal, bf16
    teacher-forced. Returns the largest error of each kernel."""
    rig = default_vision_rig()
    hw = rig.resolution[0] * rig.resolution[1]
    n_patches, T = hw // 64, WIDE_CHECK_T
    errs = {"policy_vision_rollout": 0.0, "race_vision_rollout": 0.0}
    times = {}

    def held(name, out, ref, bf16):
        frames, extra, aux, state = out
        if not (torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])):
            raise AssertionError(f"{name}: frames or env ends differ")
        if bf16:
            return max(max_err(f"{name} extra", extra, ref[1], TOL_K7["extra"]),
                       max_err(f"{name} action", aux[..., :4], ref[2][..., :4],
                               TOL_K7_BF16["action"]),
                       max_err(f"{name} value", aux[..., 6], ref[2][..., 6], TOL_K7_BF16["value"]),
                       max_err(f"{name} state", state, ref[3], TOL_K7_BF16["state"]))
        for a, b in zip(out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} (float32): not equal to its plain version, max "
                                     f"abs err {(a.float() - b.float()).abs().max().item()}")
        return 0.0

    for hidden, bf16 in WIDE_FC:
        label = f"hidden {hidden}, {'bf16' if bf16 else 'float32'}"
        env, worlds, cols, w, cfg, wcol = policy_setup(dev, gen, N_VISION, 1000, bf16, hidden)
        ms = cuda_ms(lambda: pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w,
                                                             K7_STEPS, 9), 3)
        ops, flops = policy_ops(hw, cfg, n_patches, cfg.n_spheres, cfg.n_cylinders, hidden)
        wbytes = sum(t.numel() * t.element_size() for t in (w.we, w.be, w.bf, w.wm, w.bm, w.std))
        wbytes += (n_patches * 128 + 5) * w.wf.shape[1] * w.wf.element_size()
        nbytes = (K7_STEPS * N_VISION * (hw + 2 * 8 * 4) + N_VISION * (2 * 18 + cfg.n_cols) * 4
                  + 3 * hw * 4 + wbytes)
        b = (bound(N_VISION * K7_STEPS * ops, nbytes, N_VISION * K7_STEPS * flops) if bf16
             else bound(N_VISION * K7_STEPS * (ops + flops), nbytes))[0]
        times[("K7", hidden, bf16)] = (ms, b)
        if hidden != 256:
            envc = AcroEnv(params=DroneParams(att_mode="quat", n_motors=HEX),
                           max_episode_steps=WIDE_CHECK_EPISODE)
            out = pk.launch_policy_vision_rollout(envc, rig, cols, wcol, cfg, w, T, 11)
            torch.cuda.synchronize()
            ref = pk.policy_vision_rollout_reference(
                envc, rig, cols, wcol, cfg, w, T, 11,
                forced_actions=out[2][..., :4] if bf16 else None)
            if not (out[3][:, 15] < T).all():
                raise AssertionError(f"K7 ({label}): not every env reset")
            e = held(f"K7 ({label})", out, ref, bf16)
            errs["policy_vision_rollout"] = max(errs["policy_vision_rollout"], e)
            log(f"K7 ({label}, hexacopter, N={N_VISION}, T={T}, {WIDE_CHECK_EPISODE}-step episodes): "
                f"{'frames and crash flags equal, teacher-forced' if bf16 else 'equal'}, max abs "
                f"err {e}")
        venv, rcols, rhist, rw, rwcol, rocol = race_setup(dev, gen, N_VISION, RACE_STACK, 0, 2000,
                                                          bf16, hidden)
        ms = cuda_ms(lambda: rk.launch_race_vision_rollout(venv, rcols, rhist, rwcol, rocol, rw,
                                                           K7_STEPS, 9), 3)
        rcfg = rk.race_render_config(venv)
        ops, flops = race_ops(hw, rcfg, n_patches, RACE_STACK, venv.race.n_gates, hidden)
        wbytes = sum(t.numel() * t.element_size() for t in (rw.we, rw.be, rw.bf, rw.wm, rw.bm,
                                                            rw.std))
        wbytes += (n_patches * 128 + 5 + venv.race.n_gates) * rw.wf.shape[1] * rw.wf.element_size()
        nbytes = (K7_STEPS * N_VISION * (n_patches * RACE_STACK * 64 + 2 * 16 * 4)
                  + N_VISION * (2 * 22 * 4 + n_patches * (RACE_STACK - 1) * 64) + 3 * hw * 4
                  + wbytes)
        b = (bound(N_VISION * K7_STEPS * ops, nbytes, N_VISION * K7_STEPS * flops) if bf16
             else bound(N_VISION * K7_STEPS * (ops + flops), nbytes))[0]
        times[("K8", hidden, bf16)] = (ms, b)
        if hidden != 256:
            venvc, ccols, chist, cw, cwcol, cocol = race_setup(dev, gen, N_VISION, RACE_STACK, 3,
                                                               WIDE_CHECK_EPISODE, bf16, hidden,
                                                               HEX)
            out = rk.launch_race_vision_rollout(venvc, ccols, chist, cwcol, cocol, cw, T, 11)
            torch.cuda.synchronize()
            ref = rk.race_vision_rollout_reference(
                venvc, ccols, chist, cwcol, cocol, cw, T, 11,
                forced_actions=out[2][..., :4] if bf16 else None)
            if not (out[2][..., 5].sum(0) >= 1).all():
                raise AssertionError(f"K8 ({label}): not every env ended")
            e = held(f"K8 ({label})", out, ref, bf16)
            errs["race_vision_rollout"] = max(errs["race_vision_rollout"], e)
            log(f"K8 ({label}, hexacopter, N={N_VISION}, K={RACE_STACK} frames, 3 obstacles, T={T}, "
                f"{WIDE_CHECK_EPISODE}-step episodes): "
                f"{'frames and env ends equal, teacher-forced' if bf16 else 'equal'}, max abs "
                f"err {e}")
    for kern in ("K7", "K8"):
        base = times[(kern, 256, True)][0]
        log(f"{kern} by fc width (N={N_VISION}, T={K7_STEPS}{', 4 frames' if kern == 'K8' else ''}"
            f"; ms a launch, x the 256-wide bf16 launch, bound ms): " + json.dumps(
                {f"{h} {'bf16' if bf else 'float32'}": [round(times[(kern, h, bf)][0], 6),
                                                        round(times[(kern, h, bf)][0] / base, 6),
                                                        round(times[(kern, h, bf)][1], 6)]
                 for h, bf in WIDE_FC}) + f" on {smi}")
    return errs


def any_config_checks(dev, smi: str) -> dict:
    """Phase 30: ``motor_checks`` and ``width_checks``; the largest error of
    each kernel."""
    gen = torch.Generator().manual_seed(30)
    errs = motor_checks(dev, gen, smi)
    errs.update(width_checks(dev, gen, smi))
    return errs


# ---------------------------------------------------------------------------
# Phase 31: levels_lut, the pixel net's uint8 input in one pass
# ---------------------------------------------------------------------------

LEVELS_SHAPE = (4096, 108, 256)  # race_k8's learner minibatch: 108 patches x 4 frames x 64


def levels_lut_check(dev, smi: str) -> dict:
    """Phase 31: levels_lut at the race learner's minibatch, uint8 levels
    into bf16 and float32 (and into bf16 from an input one byte off a
    16-byte boundary, the one-level-a-thread path), each bit-equal to the
    plain three-pass chain (u8 -> float32, / 255 on the device, the cast)
    and timed beside it and the bound: the levels read once and the values
    written once over PEAK_BYTES."""
    from fpyv_tpu_torch.ops import levels_kernel as lk

    g = torch.Generator(device=dev).manual_seed(0)
    levels = torch.randint(0, 256, LEVELS_SHAPE, generator=g, dtype=torch.uint8, device=dev)
    scale = torch.tensor(255.0, device=dev)
    rows = {}
    for name, lev, dtype in (("bf16", levels, torch.bfloat16),
                             ("float32", levels, torch.float32),
                             ("bf16_offset1", levels.view(-1)[1:], torch.bfloat16)):
        out = lk.launch_levels_lut(lev, dtype)
        ref = lk.levels_reference(lev, dtype, scale)
        torch.cuda.synchronize()
        bits = torch.int16 if out.element_size() == 2 else torch.int32
        if not torch.equal(out.view(bits), ref.view(bits)):
            raise AssertionError(f"phase 31: levels_lut ({name}) differs from its plain version")
        ms = cuda_ms(lambda: lk.launch_levels_lut(lev, dtype), 50)
        plain = cuda_ms(lambda: lk.levels_reference(lev, dtype, scale), 20)
        bound = lev.numel() * (1 + out.element_size()) / PEAK_BYTES * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, roofline=100.0 * bound / ms)
        log(f"phase 31 levels_lut {tuple(lev.shape)} uint8 -> {name}: {ms:.6f} ms a launch, "
            f"bound {bound:.6f} ms (bytes, {100.0 * bound / ms:.1f} %), the plain three-pass "
            f"chain {plain:.6f} ms ({plain / ms:.2f}x), bits equal, on {smi}")
    log(json.dumps({"levels_lut": rows}))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    if "--phases" in sys.argv[1:]:
        return phases_only(dev, smi)

    # ---- 1. device + build ------------------------------------------------
    t_start = t0 = time.perf_counter()
    _build.library()
    log(f"device: {smi}")
    build_report(t0)

    gen = torch.Generator().manual_seed(0)
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    params = env.params
    world = env.default_world(dev)
    pworld = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=dev)
    pcyl = sk.cylinder_matrix(pworld)
    errors = {}

    # ---- 2. K2 on the params.yaml world -----------------------------------
    st, _ = vector_reset(env, gen, N_ENVS, pworld)
    act = (torch.rand(N_ENVS, 4, generator=gen) - 0.5).to(dev)
    s15, a4 = sk.state_to_matrix(st.drone), sk.action_matrix(act)
    psph = sk.sphere_matrix(pworld)
    out = sk.launch_drone_step(params, s15, a4, psph, pcyl)
    torch.cuda.synchronize()
    ref = sk.drone_step_reference(params, s15, a4, psph, pcyl)
    check_state("K2", out, N_ENVS)
    errors["drone_step"] = compare("K2 drone_step (params.yaml world, N=4096)", out, ref,
                                   TOL_STEP)

    # ---- 3. K3, equal bit for bit: the params.yaml world and a contact-heavy start
    out = sk.launch_rollout(params, s15, a4, psph, 256, pcyl)
    torch.cuda.synchronize()
    ref = sk.rollout_reference(params, s15, a4, psph, 256, pcyl)
    check_state("K3", out, N_ENVS)
    errors["rollout"] = compare("K3 rollout (params.yaml world, N=4096, K=256)", out, ref,
                                TOL_ROLL)
    equal_bits("K3 (params.yaml world)", [(out, ref)])
    cw, cst = contact_bank(env, gen, N_ENVS, dev)
    cs15, csph, ccyl = sk.state_to_matrix(cst.drone), sk.sphere_matrix(cw), sk.cylinder_matrix(cw)
    out = sk.launch_rollout(params, cs15, a4, csph, 64, ccyl)
    torch.cuda.synchronize()
    ref = sk.rollout_reference(params, cs15, a4, csph, 64, ccyl)
    errors["rollout"] = max(errors["rollout"], compare(
        f"K3 rollout (contact-heavy start, 2 spheres, 8 cylinders, N={N_ENVS}, K=64, "
        f"{int(ref[14].sum().item())} envs done)", out, ref, TOL_ROLL))
    equal_bits("K3 (contact-heavy start)", [(out, ref)])
    n1 = ek.ONE_THREAD_ENVS  # from here one thread an env
    st1, _ = vector_reset(env, gen, n1, pworld)
    s1, a1 = sk.state_to_matrix(st1.drone), sk.action_matrix(act[:1].expand(n1, 4).contiguous())
    out = sk.launch_rollout(params, s1, a1, psph, 64, pcyl)
    torch.cuda.synchronize()
    ref = sk.rollout_reference(params, s1, a1, psph, 64, pcyl)
    errors["rollout"] = max(errors["rollout"], compare(
        f"K3 rollout (params.yaml world, N={n1}: one thread an env, K=64)", out, ref, TOL_ROLL))
    equal_bits("K3 (one thread an env)", [(out, ref)])

    # ---- 4. K4, two runs across resets -------------------------------------
    hover = torch.zeros(N_ENVS, 4, device=dev)
    hover[:, 3] = THROTTLE
    a4 = sk.action_matrix(hover)
    env50 = AcroEnv(params=params, max_episode_steps=50)
    st, _ = vector_reset(env50, gen, N_ENVS, world)
    s24, wm = ek.env_state_to_matrix(st), ek.env_world_matrix(world)
    out, rsum = ek.launch_env_rollout(env50, s24, a4, wm, 256, seed=1)
    torch.cuda.synchronize()
    ref, ref_rsum, resets = ek.env_rollout_reference(env50, s24, a4, wm, 256, seed=1)
    check_state("K4", out, N_ENVS, max_t=50)
    if resets < 4 * N_ENVS:
        raise AssertionError(f"K4: expected every env to reset several times, saw {resets}")
    e1 = max(compare(f"K4 env_rollout (default world, K=256, 50-step episodes, {resets} "
                     f"resets)", out, ref, TOL_ENV), reward_err("K4", rsum, ref_rsum))
    equal_bits("K4 (default world)", [(out, ref), (rsum, ref_rsum)])
    env_dr = AcroEnv(params=params, randomize=True, wind=(1.0, 0.5, 0.0), wind_scale=0.5)
    st, _ = vector_reset(env_dr, gen, N_ENVS, pworld)
    s24, pwm = ek.env_state_to_matrix(st), ek.env_world_matrix(pworld)
    out, rsum = ek.launch_env_rollout(env_dr, s24, a4, pwm, 64, seed=2, cyl_mat=pcyl)
    torch.cuda.synchronize()
    ref, ref_rsum, presets = ek.env_rollout_reference(env_dr, s24, a4, pwm, 64, seed=2,
                                                       cyl_mat=pcyl)
    check_state("K4 params", out, N_ENVS, max_t=env_dr.max_episode_steps)
    e2 = max(compare(f"K4 env_rollout (params.yaml world + DR + wind, K=64, {presets} "
                     f"resets)", out, ref, TOL_ENV), reward_err("K4 params", rsum, ref_rsum))
    equal_bits("K4 (params.yaml world + DR + wind)", [(out, ref), (rsum, ref_rsum)])
    cw, cst = contact_bank(env50, gen, N_ENVS, dev)
    s24, cwm, ccyl = ek.env_state_to_matrix(cst), ek.env_world_matrix(cw), sk.cylinder_matrix(cw)
    out, rsum = ek.launch_env_rollout(env50, s24, a4, cwm, 64, seed=3, cyl_mat=ccyl)
    torch.cuda.synchronize()
    ref, ref_rsum, cresets = ek.env_rollout_reference(env50, s24, a4, cwm, 64, seed=3,
                                                      cyl_mat=ccyl)
    e3 = max(compare(f"K4 env_rollout (contact-heavy start, 2 spheres, 8 cylinders, K=64, "
                     f"{cresets} resets)", out, ref, TOL_ENV),
             reward_err("K4 contact", rsum, ref_rsum))
    equal_bits("K4 (contact-heavy start)", [(out, ref), (rsum, ref_rsum)])
    n1 = ek.ONE_THREAD_ENVS  # from here one thread an env
    st1, _ = vector_reset(env50, gen, n1, world)
    s24, a1 = ek.env_state_to_matrix(st1), sk.action_matrix(hover[:1].expand(n1, 4))
    out, rsum = ek.launch_env_rollout(env50, s24, a1, wm, 64, seed=4)
    torch.cuda.synchronize()
    ref, ref_rsum, oresets = ek.env_rollout_reference(env50, s24, a1, wm, 64, seed=4)
    e4 = max(compare(f"K4 env_rollout (default world, N={n1}: one thread an env, K=64, "
                     f"{oresets} resets)", out, ref, TOL_ENV),
             reward_err("K4 one thread", rsum, ref_rsum))
    equal_bits("K4 (one thread an env)", [(out, ref), (rsum, ref_rsum)])
    errors["env_rollout"] = max(e1, e2, e3, e4)

    # ---- 5. K5 on three setups -----------------------------------------------
    errors["render_depth"] = 0.0
    gate_world = build_world(WorldSpec.from_config(SimulatorConfig(track={
        "count": 3, "radius": 6, "gate_size": 2, "gate_resolution": 17}), seed=2), device=dev)
    gate_world = gate_world.replace(
        gate_shape=torch.tensor([0, 1, 2], dtype=torch.int32, device=dev),
        sphere_center=torch.tensor([[0.0, 0.0, 3.0]], device=dev))
    for label, w, n, rig in (
            (f"params.yaml world, shared, {N_VISION} envs, 96x72", pworld, N_VISION,
             default_vision_rig()),
            (f"sample_worlds per-env worlds, {N_VISION} envs, 96x72",
             sample_worlds(gen, N_VISION, n_spheres=1, n_cylinders=4, device=dev), N_VISION,
             default_vision_rig()),
            ("gate track (shapes 0, 1, 2) + cylinders, 8 envs, 640x480", gate_world, 8,
             CameraRig(resolution=(640, 480))),
            (f"params.yaml world, 64 envs, 33x17 (H*W not a multiple of the "
             f"1024-pixel tile)", pworld, 64,
             CameraRig(resolution=(33, 17)))):
        sub, _ = vector_reset(env, gen, n, w)
        cam_pos, cam_R = VisionAcroEnv(acro=env, rig=rig)._camera(sub)
        cfg = vk.RenderConfig.for_world(w, 25.0)
        dcam = torch.from_numpy(vk.flat_dcam(rig)).to(dev)
        cam, wcol = vk.camera_matrix(cam_pos, cam_R), vk.world_cols(w)
        out = vk.launch_render_depth(cfg, dcam, cam, wcol)
        torch.cuda.synchronize()
        ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
        lit = (ref > 0).float().mean().item()
        e = (out - ref).abs().max().item()
        bad = int((out != ref).sum().item())
        log(f"K5 render_depth ({label}): {bad} of {out.numel()} levels differ, max abs err "
            f"{e}, lit share {lit:.4f}")
        if bad or not torch.isfinite(out).all() or lit <= 0.0:
            raise AssertionError(f"K5 ({label}): levels differ or frame empty")
        errors["render_depth"] = max(errors["render_depth"], e)

    # ---- 6. K6, two runs across resets ---------------------------------------
    rig = default_vision_rig()
    errors["vision_env_rollout"] = 0.0
    env20 = AcroEnv(params=params, max_episode_steps=20)
    for label, e_, w in (("default world, 20-step episodes", env20, world),
                         ("params.yaml world + DR + wind", env_dr, pworld)):
        st, _ = vector_reset(e_, gen, 64, w)
        s28, cwm = vk.chase_state_matrix(st), ek.env_world_matrix(w)
        cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
        out, rsum, crashes, contacts = vk.launch_vision_env_rollout(e_, s28, cwm, 64, rig,
                                                                    seed=3, cyl_mat=cyl)
        torch.cuda.synchronize()
        ref, ref_rsum, resets, rc, rct = vk.vision_env_rollout_reference(e_, s28, cwm, 64, rig,
                                                                         seed=3, cyl_mat=cyl)
        if e_ is env20 and resets < 64:
            raise AssertionError(f"K6: expected every env to reset, saw {resets}")
        errors["vision_env_rollout"] = max(errors["vision_env_rollout"], check_chase(
            f"{label}, N=64, K=64", e_, out, ref, rsum, ref_rsum, crashes, rc, contacts, rct,
            64, resets))
    # the pixel box's edges: the full-frame fallback (the camera inside the
    # target; the target across the camera plane, beside the camera) and a
    # target clipped by the frame's left edge, 6 m ahead
    r0 = float(world.sphere_radius[0])
    x_left = float(rig.K_inv[0, 2])  # the ray of u = 0 at depth 1
    for label, c_cam in (("camera inside the target", (0.0, 0.0, 0.3 * r0)),
                         ("target across the camera plane", (1.5 * r0, 0.2 * r0, 0.5 * r0)),
                         ("target clipped by the frame's edge", (6.0 * x_left, 0.0, 6.0)),
                         ("target behind the camera", (1.0, 0.5, -4.0)),
                         ("target beside the camera, outside the frame's cone",
                          (6.0, 0.0, 0.3))):
        s28 = chase_placed(env, world, rig, gen, 64, c_cam)
        box = start_box(env, world, rig, s28)
        probe = torch.zeros(vk.N_CHASE_PROBE, dtype=torch.int64, device=dev)
        vk.launch_vision_env_rollout(env, s28, wm, 64, rig, probe=probe)
        full_steps = int(probe[len(vk.CHASE_PHASES) + 1].item())
        if "edge" in label:
            if box[4].any() or (box[0] != 0).any() or not box[5].all():
                raise AssertionError(f"K6 ({label}): premise failed: the step-0 box is not "
                                     f"clipped at u = 0 with the target lit there")
        elif "behind" in label or "beside" in label:
            if box[4].any() or (box[1] >= box[0]).any():
                raise AssertionError(f"K6 ({label}): premise failed: the step-0 box is not empty")
        elif not (box[4].all() and full_steps >= 64):
            raise AssertionError(f"K6 ({label}): the full-frame fallback did not run "
                                 f"({full_steps} full-frame steps)")
        out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s28, wm, 64, rig)
        torch.cuda.synchronize()
        ref, ref_rsum, resets, rc, rct = vk.vision_env_rollout_reference(env, s28, wm, 64, rig)
        log(f"K6 ({label}): {full_steps} full-frame env-steps in the instrumented launch")
        errors["vision_env_rollout"] = max(errors["vision_env_rollout"], check_chase(
            f"{label}, N=64, K=64", env, out, ref, rsum, ref_rsum, crashes, rc, contacts, rct,
            64, resets))

    # ---- 7. acro main path, counters from 0 ----------------------------------
    _build.reset_launch_counts()
    st, _ = vector_reset(env, gen, N_ENVS, world)
    stepped = sk.fused_drone_step(params, st.drone, hover, world)
    rolled = sk.fused_rollout(params, st.drone, hover, world, 256)
    _, state, w = acro_main_path("default world", env, world, gen, hover, smi)
    acro_bank = (ek.env_state_to_matrix(state), ek.env_world_matrix(w))
    acro_main_path("params.yaml world + DR + wind", env_dr, pworld, gen, hover, smi)
    launches = {}
    for t in (stepped.pos, rolled.pos):
        if not torch.isfinite(t).all():
            raise AssertionError("main path: non-finite physics state")
    read_counts("acro main path", ("drone_step", "rollout", "env_rollout"), launches)

    # plain env version on the card as a reference figure (not a yardstick)
    st, _ = vector_reset(env, gen, N_ENVS, world)
    s24, wm = ek.env_state_to_matrix(st), ek.env_world_matrix(world)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ek.env_rollout_reference(env, s24, a4, wm, 64, seed=0)
    torch.cuda.synchronize()
    log(f"plain env_rollout_reference on the card: {N_ENVS * 64 / (time.perf_counter() - t0):.6e}"
        f" env-steps/s at N={N_ENVS}, K=64 (reference figure)")

    # occupancy probe: K4's rate as the bank grows past one warp per SM
    probe = {}
    for n in PROBE_ENVS:
        pst, _ = vector_reset(env, gen, n, world)
        ps, pa = ek.env_state_to_matrix(pst), sk.action_matrix(hover[:1].expand(n, 4))
        ms = cuda_ms(lambda: ek.launch_env_rollout(env, ps, pa, wm, PROBE_K, seed=0), 3)
        probe[n] = n * PROBE_K / (ms * 1e-3)
    log(f"occupancy probe (default world, K={PROBE_K}, env-steps/s by N): "
        f"{json.dumps(probe)} on {smi}")

    # ---- 8. vision env main path, counters from 0 -------------------------------
    venv = VisionAcroEnv(acro=env, renderer="raycast_pallas", target_only=False)
    _build.reset_launch_counts()

    def vision_episode():
        state, obs = venv.reset_batched(gen, pworld, None, N_VISION)
        frames = [obs["pixels"]]
        for _ in range(8):
            state, obs, _, _, _ = venv.step_batched(state, hover[:N_VISION], pworld, None)
            frames.append(obs["pixels"])
        torch.cuda.synchronize()
        return state, frames

    vtimes = []
    for _ in range(4):  # the first is a warm-up
        t0 = time.perf_counter()
        vstate, frames = vision_episode()
        vtimes.append(time.perf_counter() - t0)
    for f in frames:
        if f.shape != (N_VISION, 72, 96) or not ((f >= 0) & (f <= 1)).all():
            raise AssertionError("vision env: frames misshaped or out of [0, 1]")
    if (frames[-1] > 0).float().mean().item() <= 0.0:
        raise AssertionError("vision env: blank frames")
    read_counts("vision env main path", ("render_depth",), launches)
    log(f"vision env main path: {9 * N_VISION / min(vtimes[1:]):.6e} frames/s (reset + 8 "
        f"steps at N={N_VISION}, 96x72, params.yaml world, best of "
        f"{[round(t, 6) for t in vtimes[1:]]} s after a warm-up) on {smi}")
    busy, top = device_busy(vision_episode)
    log(f"vision env trace: device busy {busy:.6f} of the wall time; top kernels by device "
        f"time: {json.dumps(top)}")

    # ---- 9. chase main path, counters from 0 ----------------------------------------
    _build.reset_launch_counts()
    cstate, _ = vector_reset(env, gen, N_VISION, world)
    cworld = world

    def chase(k, seed):
        nonlocal cstate, cworld
        torch.cuda.synchronize()
        t = time.perf_counter()
        cstate, cworld, rs, crashes, _ = vk.fused_vision_env_rollout(env, cstate, cworld, k,
                                                                     seed=seed)
        total = rs.sum().item()  # completion on the host is part of the time
        t = time.perf_counter() - t
        if not math.isfinite(total):
            raise AssertionError("chase: non-finite reward sum")
        return t

    k_warm = 512
    per_step = chase(k_warm, 0) / k_warm
    k = min(int(CHASE_SECONDS / per_step), ek.MAX_STEPS_PER_LAUNCH - 10_000)
    times = [chase(k, 1 + rep) for rep in range(2)]
    check_state("chase main path", ek.env_state_to_matrix(cstate), N_VISION,
                max_t=env.max_episode_steps)
    chase_rate = N_VISION * k / min(times)
    log(f"chase main path: {chase_rate:.6e} env-steps/s at N={N_VISION}, K={k} per launch, "
        f"best of {[round(t, 6) for t in times]} s, default world, 96x72 rig, on {smi}")
    slope = {}
    for kk in (512, 2048):
        chase(kk, 7)
        slope[kk] = min(chase(kk, 8 + r) for r in range(3))
    slope_rate = N_VISION * (2048 - 512) / (slope[2048] - slope[512])
    log(f"chase K-slope (bench.py measure_vision, K = 512 -> 2048): {slope_rate:.6e} "
        f"env-steps/s at N={N_VISION} on {smi}")
    steady = (vk.chase_state_matrix(cstate), ek.env_world_matrix(cworld))
    # station keeping (tests/test_pallas_vision.py::test_follows_orbiting_target)
    cstate, _ = vector_reset(env, gen, N_VISION, world)
    cstate, w2, _, _, _ = vk.fused_vision_env_rollout(env, cstate, world, 100)
    cstate, _, _, crashes, _ = vk.fused_vision_env_rollout(env, cstate, w2, 200, seed=1)
    keep = (cstate.prev_dist - vk.ChasePilot().keep_distance).abs().mean().item()
    crashed_envs = int((crashes > 0).sum().item())
    log(f"chase station keeping: mean |distance - 6 m| = {keep:.6f} m after 300 steps, "
        f"{crashed_envs} of {N_VISION} envs crashed in the last 200")
    if keep >= 1.5 or crashed_envs > N_VISION // 100:
        raise AssertionError("chase: station keeping failed")
    read_counts("chase main path", ("vision_env_rollout",), launches)

    # ---- 10. kernels line: times at the main path's shapes -------------------
    s15, sph = sk.state_to_matrix(st.drone), sk.sphere_matrix(world)
    S = world.num_spheres
    kernels = []

    def row(name, ms, plain_ms, ops, nbytes, tensor_flops=0.0):
        bms, by = bound(ops, nbytes, tensor_flops)
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None})

    step_bytes = N_ENVS * (15 + 4 + 15) * 4 + 5 * S * 4
    ms = cuda_ms(lambda: sk.launch_drone_step(params, s15, a4, sph), 200)
    pms = cuda_ms(lambda: sk.drone_step_reference(params, s15, a4, sph), 3)
    row("drone_step", ms, pms, N_ENVS * step_ops(S, 0), step_bytes)
    ms = cuda_ms(lambda: sk.launch_rollout(params, s15, a4, sph, 256), 20)
    pms = cuda_ms(lambda: sk.rollout_reference(params, s15, a4, sph, 256), 1)
    row("rollout", ms, pms, N_ENVS * 256 * step_ops(S, 0), step_bytes)
    # K4 at K = 64 on the bank the acro main path left (its resets depend on
    # the state), held against its plain version there; then from a fresh reset
    K = 64
    ms_fresh = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, wm, K, seed=0), 50)
    s24, wm = acro_bank
    out, rsum = ek.launch_env_rollout(env, s24, a4, wm, K, seed=0)
    torch.cuda.synchronize()
    ref, ref_rsum, main_resets = ek.env_rollout_reference(env, s24, a4, wm, K, seed=0)
    equal_bits("K4 (the acro main path's bank)", [(out, ref), (rsum, ref_rsum)])
    ms = cuda_ms(lambda: ek.launch_env_rollout(env, s24, a4, wm, K, seed=0), 50)
    pms = cuda_ms(lambda: ek.env_rollout_reference(env, s24, a4, wm, K, seed=0), 1)
    env_phases("default world, the bank the acro main path left", env, s24, a4, wm, K,
               plain_ms=ms)
    log(f"K4 (N={N_ENVS}, K={K}, default world): {ms:.6f} ms on the main path's bank "
        f"({main_resets} resets), {ms_fresh:.6f} ms from a fresh reset")
    env_ops = (N_ENVS * K * (step_ops(S, 0) + 21) + main_resets * reset_ops(False, False)
               + K * 18 * S + N_ENVS * 17)
    row("env_rollout", ms, pms, env_ops, N_ENVS * (24 + 4 + 24 + 1) * 4 + 12 * S * 4)

    # K5 at the vision env's shapes: 1024 envs, 96x72, params.yaml world
    rig = default_vision_rig()
    hw = rig.resolution[0] * rig.resolution[1]
    cam_pos, cam_R = venv._camera(vstate)
    cfg = vk.RenderConfig.for_world(pworld, venv.max_depth)
    dcam = torch.from_numpy(vk.flat_dcam(rig)).to(dev)
    cam, wcol = vk.camera_matrix(cam_pos, cam_R), vk.world_cols(pworld)
    ms = cuda_ms(lambda: vk.launch_render_depth(cfg, dcam, cam, wcol), 200)
    pms = cuda_ms(lambda: vk.render_depth_reference(cfg, dcam, cam, wcol), 3)
    live_gates = (int(pworld.gate_active.reshape(-1, pworld.num_gates).any(0).sum().item())
                  if pworld.num_gates else 0)
    k5_bytes = (N_VISION * (hw + 16) + 3 * hw + cfg.n_cols) * 4
    old_ms, _ = bound(N_VISION * hw * render_ops(cfg, live_gates), k5_bytes)
    k5_ops = render_data_ops(cfg, dcam, cam, wcol)
    log(f"K5 bound: {bound(k5_ops, k5_bytes)[0]:.6f} ms counting the operations this frame's "
        f"pixels need (misses end at the discriminant; the kernels line carries it), "
        f"{old_ms:.6f} ms counting every primitive's full hit test at every pixel")
    row("render_depth", ms, pms, k5_ops, k5_bytes)
    # K6 at the chase's shapes: 1024 envs, default world and rig, K = 64, on
    # the bank the main path's launches left (its steady state); held against
    # its plain version once more there
    K = 64
    s28, swm = steady
    out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s28, swm, K, rig)
    torch.cuda.synchronize()
    ref, ref_rsum, chase_resets, rc, rct = vk.vision_env_rollout_reference(env, s28, swm, K, rig)
    errors["vision_env_rollout"] = max(errors["vision_env_rollout"], check_chase(
        f"default world, the main path's bank, N={N_VISION}, K={K}", env, out, ref, rsum,
        ref_rsum, crashes, rc, contacts, rct, N_VISION, chase_resets))
    ms = cuda_ms(lambda: vk.launch_vision_env_rollout(env, s28, swm, K, rig), 20)
    pms = cuda_ms(lambda: vk.vision_env_rollout_reference(env, s28, swm, K, rig), 1)
    # inside K6 at this shape: the phases and the pixels its box tested and lit
    split = chase_phases(dev, env, s28, swm, rig, K, ms)
    k6_bytes = (N_VISION * (28 + 28 + 3) + 12 * S + 3 * hw) * 4
    resets_ops = chase_resets * reset_ops(False, False)

    def k6_bound(pixels):
        return bound(N_VISION * K * chase_step_ops(pixels, S, 0, False, False) + resets_ops,
                     k6_bytes)[0]

    k6_ops = N_VISION * K * chase_step_ops(split["lit_per_step"], S, 0, False, False) + resets_ops
    log(f"K6 bound: {k6_bound(split['lit_per_step']):.6f} ms counting the hit test on the "
        f"{split['lit_per_step']:.3f} pixels an env-step that the target lit (the kernels line "
        f"carries it); {k6_bound(split['pixels_per_step']):.6f} ms on the "
        f"{split['pixels_per_step']:.3f} its box tested; {k6_bound(hw):.6f} ms on all {hw} "
        f"pixels of the frame")
    row("vision_env_rollout", ms, pms, k6_ops, k6_bytes)
    # ---- 11. K7 against its plain version ----------------------------------------------
    # (a) float32 weights across resets
    env8, pworlds, cols, w32, pcfg, pwcol = policy_setup(dev, gen, 64, 8, bf16=False)
    out = pk.launch_policy_vision_rollout(env8, rig, cols, pwcol, pcfg, w32, 16, 5)
    torch.cuda.synchronize()
    ref = pk.policy_vision_rollout_reference(env8, rig, cols, pwcol, pcfg, w32, 16, 5)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[2][..., 5], ref[2][..., 5])
            and torch.equal(out[3][:, 14:16], ref[3][:, 14:16])):
        raise AssertionError("K7 (float32): frames, crash flags or t differ")
    resets_a = int((out[3][:, 15] < 16).sum().item())
    if resets_a < 64:
        raise AssertionError(f"K7 (float32): expected every env to reset, saw {resets_a}")
    e7 = max(max_err("extra", out[1], ref[1], TOL_K7["extra"]),
             max_err("action", out[2][..., :4], ref[2][..., :4], TOL_K7["action"]),
             max_err("reward", out[2][..., 4], ref[2][..., 4], TOL_K7["reward"]),
             max_err("value", out[2][..., 6], ref[2][..., 6], TOL_K7["value"]),
             max_err("log_prob", out[2][..., 7], ref[2][..., 7], TOL_K7["log_prob"]),
             max_err("state", out[3], ref[3], TOL_K7["state"]))
    log(f"K7 policy_vision_rollout (float32, N=64, K=16, 8-step episodes, every env reset, "
        f"{int(ref[2][..., 5].sum().item())} crashes): frames, crash flags and t equal, max abs "
        f"err {e7}")
    # (b) bf16 at the timed shape, teacher-forced
    envk, kworlds, kcols, wbf, kcfg, kwcol = policy_setup(dev, gen, N_VISION, 1000, bf16=True)
    frames, extra, aux, kstate = pk.launch_policy_vision_rollout(envk, rig, kcols, kwcol, kcfg,
                                                                 wbf, K7_STEPS, 9)
    torch.cuda.synchronize()
    # timed once: this run is K7's plain_ms (forcing the actions changes no work)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rf, rex, raux, rstate = pk.policy_vision_rollout_reference(
        envk, rig, kcols, kwcol, kcfg, wbf, K7_STEPS, 9, forced_actions=aux[..., :4])
    ev[1].record()
    torch.cuda.synchronize()
    k7_plain_ms = ev[0].elapsed_time(ev[1])
    if not (torch.equal(frames, rf) and torch.equal(aux[..., 5], raux[..., 5])):
        raise AssertionError("K7 (bf16, teacher-forced): frames or crash flags differ")
    k7_crashes = int(aux[..., 5].sum().item())
    eb = max(max_err("bf16 extra", extra, rex, TOL_K7["extra"]),
             max_err("bf16 action", aux[..., :4], raux[..., :4], TOL_K7_BF16["action"]),
             max_err("bf16 value", aux[..., 6], raux[..., 6], TOL_K7_BF16["value"]),
             max_err("bf16 reward", aux[..., 4], raux[..., 4], TOL_K7_BF16["reward"]),
             max_err("bf16 state", kstate, rstate, TOL_K7_BF16["state"]))
    errors["policy_vision_rollout"] = max(e7, eb)
    if not (torch.isfinite(aux).all() and torch.isfinite(kstate).all()):
        raise AssertionError("K7: non-finite outputs")
    log(f"K7 policy_vision_rollout (bf16, N={N_VISION}, K={K7_STEPS}, teacher-forced, "
        f"{k7_crashes} crashes): frames and crash flags equal, max abs err {eb}")

    # ---- 12. trainer main path, counters from 0 ---------------------------------------
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "train_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_vision(num_envs=N_VISION, num_iterations=TRAIN_ITERS, scan_chunk=TRAIN_CHUNK,
                       print_every=0, log_dir=str(log_dir))
    train_s = time.perf_counter() - t0
    got = {}
    read_counts("trainer main path", ("policy_vision_rollout", "render_depth"), got)
    if got["policy_vision_rollout"] != TRAIN_ITERS or got["render_depth"] < TRAIN_ITERS:
        raise AssertionError(f"trainer: expected {TRAIN_ITERS} K7 launches and at least as many "
                             f"K5 launches, saw {got}")
    launches["policy_vision_rollout"] = got["policy_vision_rollout"]
    rows = train_rows("trainer", log_dir, TRAIN_ITERS)
    log(f"trainer main path: {res.steps_per_second:.6e} trained env-steps/s (N={N_VISION}, "
        f"T={K7_STEPS}, {TRAIN_ITERS} iterations in chunks of {TRAIN_CHUNK}, first chunk left "
        f"out; {train_s:.3f} s in all), reward {res.mean_reward_first:.6f} -> "
        f"{res.mean_reward_last:.6f}, last loss {rows[-1]['loss']:.6f}, on {smi}")
    trainer_split("trainer", make_vision_trainer(num_envs=N_VISION))

    # K7's row: 1024 envs, K = 32, bf16, at the trainer's shapes
    n_patches = hw // 64
    ms = cuda_ms(lambda: pk.launch_policy_vision_rollout(envk, rig, kcols, kwcol, kcfg, wbf,
                                                         K7_STEPS, 9), 10)
    ops, flops = policy_ops(hw, kcfg, n_patches, kcfg.n_spheres, kcfg.n_cylinders)
    wbytes = sum(t.numel() * t.element_size() for t in (wbf.we, wbf.be, wbf.bf, wbf.wm, wbf.bm,
                                                        wbf.std))
    wbytes += (n_patches * 128 + 5) * wbf.wf.shape[1] * wbf.wf.element_size()
    k7_bytes = (K7_STEPS * N_VISION * (hw + 2 * 8 * 4) + N_VISION * (2 * 18 + kcfg.n_cols) * 4
                + 3 * hw * 4 + wbytes)
    row("policy_vision_rollout", ms, k7_plain_ms, N_VISION * K7_STEPS * ops + k7_crashes
        * reset_ops(False, False), k7_bytes, N_VISION * K7_STEPS * flops)

    # ---- 13. K8 against its plain version ----------------------------------------------
    # (a) float32 weights across resets, 3 obstacles, a 3-frame stack
    venv8, rcols, rhist, rw32, rwcol, rocol = race_setup(dev, gen, 64, 3, 3, 8, bf16=False)
    out = rk.launch_race_vision_rollout(venv8, rcols, rhist, rwcol, rocol, rw32, 16, 5)
    torch.cuda.synchronize()
    ref = rk.race_vision_rollout_reference(venv8, rcols, rhist, rwcol, rocol, rw32, 16, 5)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[2][..., 5], ref[2][..., 5])
            and all(torch.equal(out[3][:, c], ref[3][:, c]) for c in (14, 15, 16, 19, 21))):
        raise AssertionError("K8 (float32): frames, env ends or gate counters differ")
    ends_a = int(ref[2][..., 5].sum().item())
    if not (ref[2][..., 5].sum(0) >= 2).all():
        raise AssertionError("K8 (float32): expected every env to end at least twice")
    e8 = max(max_err("extra", out[1], ref[1], TOL_K7["extra"]),
             max_err("action", out[2][..., :4], ref[2][..., :4], TOL_K7["action"]),
             max_err("reward", out[2][..., 4], ref[2][..., 4], TOL_K7["reward"]),
             max_err("value", out[2][..., 6], ref[2][..., 6], TOL_K7["value"]),
             max_err("log_prob", out[2][..., 7], ref[2][..., 7], TOL_K7["log_prob"]),
             max_err("state", out[3], ref[3], TOL_K7["state"]))
    log(f"K8 race_vision_rollout (float32, N=64, K=3 frames, 3 obstacles, T=16, 8-step "
        f"episodes, {ends_a} env ends): frames, env ends and gate counters equal, max abs err "
        f"{e8}")
    # (b) bf16 at the race trainer's shape, teacher-forced
    venvr, rcols, rhist, rwbf, rwcol, rocol = race_setup(dev, gen, N_VISION, RACE_STACK, 0, 2000,
                                                         bf16=True)
    frames, extra, aux, rstate_k = rk.launch_race_vision_rollout(venvr, rcols, rhist, rwcol,
                                                                 rocol, rwbf, K7_STEPS, 9)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rf, rex, raux, rstate = rk.race_vision_rollout_reference(
        venvr, rcols, rhist, rwcol, rocol, rwbf, K7_STEPS, 9, forced_actions=aux[..., :4])
    ev[1].record()
    torch.cuda.synchronize()
    k8_plain_ms = ev[0].elapsed_time(ev[1])
    if not (torch.equal(frames, rf) and torch.equal(aux[..., 5], raux[..., 5])):
        raise AssertionError("K8 (bf16, teacher-forced): frames or env ends differ")
    k8_ends = int(aux[..., 5].sum().item())
    eb = max(max_err("bf16 extra", extra, rex, TOL_K7["extra"]),
             max_err("bf16 action", aux[..., :4], raux[..., :4], TOL_K7_BF16["action"]),
             max_err("bf16 value", aux[..., 6], raux[..., 6], TOL_K7_BF16["value"]),
             max_err("bf16 reward", aux[..., 4], raux[..., 4], TOL_K7_BF16["reward"]),
             max_err("bf16 state", rstate_k, rstate, TOL_K7_BF16["state"]))
    errors["race_vision_rollout"] = max(e8, eb)
    if not (torch.isfinite(aux).all() and torch.isfinite(rstate_k).all()):
        raise AssertionError("K8: non-finite outputs")
    log(f"K8 race_vision_rollout (bf16, N={N_VISION}, K={RACE_STACK} frames, T={K7_STEPS}, "
        f"teacher-forced, {k8_ends} env ends): frames and env ends equal, max abs err {eb}")
    # (c) K7 and K8 on the render's edge worlds
    for name, e in edge_world_checks(dev, rig).items():
        errors[name] = max(errors[name], e)

    # ---- 14. race trainer main path, counters from 0 ------------------------------------
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "race_log"
    shutil.rmtree(log_dir, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_vision_race(num_envs=N_VISION, num_iterations=TRAIN_ITERS,
                            frame_stack=RACE_STACK, gate_size=5.0, scan_chunk=TRAIN_CHUNK,
                            print_every=0, log_dir=str(log_dir))
    train_s = time.perf_counter() - t0
    got = {}
    read_counts("race trainer main path", ("race_vision_rollout", "render_depth"), got)
    if got["race_vision_rollout"] != TRAIN_ITERS or got["render_depth"] < TRAIN_ITERS:
        raise AssertionError(f"race trainer: expected {TRAIN_ITERS} K8 launches and at least as "
                             f"many K5 launches, saw {got}")
    launches["race_vision_rollout"] = got["race_vision_rollout"]
    rows = train_rows("race trainer", log_dir, TRAIN_ITERS)
    log(f"race trainer main path: {res.steps_per_second:.6e} trained env-steps/s "
        f"(N={N_VISION}, T={K7_STEPS}, K={RACE_STACK} frames, gate size 5, {TRAIN_ITERS} "
        f"iterations in chunks of {TRAIN_CHUNK}, first chunk left out; {train_s:.3f} s in all), "
        f"reward {res.mean_reward_first:.6f} -> {res.mean_reward_last:.6f}, mean gates passed "
        f"{rows[0]['mean_gates_passed']:.6f} -> {rows[-1]['mean_gates_passed']:.6f}, last loss "
        f"{rows[-1]['loss']:.6f}, on {smi}")
    trainer_split("race trainer", make_vision_race_trainer(num_envs=N_VISION,
                                                           frame_stack=RACE_STACK))

    # K8's row: 1024 envs, T = 32, K = 4, bf16, at the race trainer's shapes
    ms = cuda_ms(lambda: rk.launch_race_vision_rollout(venvr, rcols, rhist, rwcol, rocol, rwbf,
                                                       K7_STEPS, 9), 5)
    rcfg = rk.race_render_config(venvr)
    G = venvr.n_gates
    ops, flops = race_ops(hw, rcfg, n_patches, RACE_STACK, G)
    wbytes = sum(t.numel() * t.element_size() for t in (rwbf.we, rwbf.be, rwbf.bf, rwbf.wm,
                                                        rwbf.bm, rwbf.std))
    wbytes += (n_patches * 128 + 5 + G) * rwbf.wf.shape[1] * rwbf.wf.element_size()
    k8_bytes = (K7_STEPS * N_VISION * (RACE_STACK * hw + (16 + 8) * 4)
                + N_VISION * (2 * 22 * 4 + (RACE_STACK - 1) * hw) + 3 * hw * 4
                + (15 * G + 1 + 8) * 4 + wbytes)
    # what the stack costs: K8 at 1, 2 and 4 frames, same envs and steps
    sweep = {}
    for K in (1, 2, RACE_STACK):
        sv, scols, shist, sw, swcol, socol = race_setup(dev, gen, N_VISION, K, 0, 2000, bf16=True)
        sweep[K] = cuda_ms(lambda: rk.launch_race_vision_rollout(sv, scols, shist, swcol, socol,
                                                                 sw, K7_STEPS, 9), 3)
    log(f"K8 by frame stack (N={N_VISION}, T={K7_STEPS}, bf16, ms a launch): "
        f"{json.dumps(sweep)} on {smi}")
    row("race_vision_rollout", ms, k8_plain_ms, N_VISION * K7_STEPS * ops
        + k8_ends * RACE_RESET_OPS, k8_bytes, N_VISION * K7_STEPS * flops)

    # ---- 15. inside K7 and K8: the step's phases, the products' yardstick --------------
    actor_phases(dev, gen, rig)

    # ---- 16. state learner main path, counters from 0 -----------------------------------
    from fpyv_tpu_torch.apps.train import (make_acro_trainer, make_race_trainer, train_acro,
                                           train_race)

    t0 = time.perf_counter()
    state_net_check(dev)
    acro_rate = state_learner("state learner", train_acro, make_acro_trainer, smi,
                              num_envs=STATE_ENVS)
    log(f"phase 16 took {time.perf_counter() - t0:.3f} s")

    # ---- 17. state race learner main path, counters from 0 ------------------------------
    t0 = time.perf_counter()
    state_learner("state race learner", train_race, make_race_trainer, smi,
                  num_envs=RACE_RACES, n_agents=RACE_AGENTS)
    log(f"phase 17 took {time.perf_counter() - t0:.3f} s")

    # ---- 18. flagship eval, counters from 0 ---------------------------------------------
    t0 = time.perf_counter()
    flagship_eval(smi)
    log(f"phase 18 took {time.perf_counter() - t0:.3f} s")

    # ---- 19. the conv and GRU nets on the card against the CPU ---------------------------
    t0 = time.perf_counter()
    pixel_nets_check(dev)
    log(f"phase 19 took {time.perf_counter() - t0:.3f} s")

    # ---- 20. K5 on the 4-agent race's frames --------------------------------------------
    t0 = time.perf_counter()
    e5 = race_render_check(dev, gen, smi)
    for kr in kernels:
        if kr["name"] == "render_depth":
            kr["max_abs_err"] = max(kr["max_abs_err"], e5)
    log(f"phase 20 took {time.perf_counter() - t0:.3f} s")

    # ---- 21. the conv scan trainer main path, counters from 0 ---------------------------
    t0 = time.perf_counter()
    scan_trainer(smi)
    log(f"phase 21 took {time.perf_counter() - t0:.3f} s")

    # ---- 22. the curriculum, counters from 0 ---------------------------------------------
    t0 = time.perf_counter()
    curriculum_trainer(smi)
    log(f"phase 22 took {time.perf_counter() - t0:.3f} s")

    # ---- 23. the GRU race trainer main path, counters from 0 ----------------------------
    t0 = time.perf_counter()
    gru_race_trainer(smi)
    log(f"phase 23 took {time.perf_counter() - t0:.3f} s")

    # ---- 24. the SAC nets and one update on the card against the CPU -------------------
    t0 = time.perf_counter()
    sac_update_check(dev)
    log(f"phase 24 took {time.perf_counter() - t0:.3f} s")

    # ---- 25. SAC main path at full width, counters from 0 --------------------------------
    t0 = time.perf_counter()
    sac_main_path(smi)
    log(f"phase 25 took {time.perf_counter() - t0:.3f} s")

    # ---- 26. ES main path at full width, counters from 0 ---------------------------------
    t0 = time.perf_counter()
    es_main_path(smi)
    log(f"phase 26 took {time.perf_counter() - t0:.3f} s")

    # ---- 27. multi-process training: world size 1, then 2 gloo ranks on the card ----------
    t0 = time.perf_counter()
    distributed_checks(dev, smi, acro_rate)
    log(f"phase 27 took {time.perf_counter() - t0:.3f} s")

    # ---- 28. the front door: simulator, play's video (K5 at 640x480), the CLI ------------
    t0 = time.perf_counter()
    sim_checks(smi)
    k5_video = video_checks(dev, smi)
    for kr in kernels:
        if kr["name"] == "render_depth":
            kr["max_abs_err"] = max(kr["max_abs_err"], k5_video["max_abs_err"])
    cli_checks(smi)
    log(f"phase 28 took {time.perf_counter() - t0:.3f} s")

    # ---- 29. the secondary envs, sensors, controllers and models ---------------------------
    t0 = time.perf_counter()
    secondary_checks(dev, smi)
    log(f"phase 29 took {time.perf_counter() - t0:.3f} s")

    # ---- 30. any motor count through K1, any fc width in K7 and K8 ------------------------
    t0 = time.perf_counter()
    for name, err in any_config_checks(dev, smi).items():
        for kr in kernels:
            if kr["name"] == name:
                kr["max_abs_err"] = max(kr["max_abs_err"], err)
    log(f"phase 30 took {time.perf_counter() - t0:.3f} s (budget 60 s)")

    # ---- 31. levels_lut: the pixel net's uint8 input in one pass -------------------------
    levels_lut_check(dev, smi)

    for kr in kernels:
        log(f"{kr['name']}: {kr['ms']:.6f} ms (plain {kr['plain_ms']:.3f} ms, bound "
            f"{kr['bound_ms']:.6f} ms by {kr['bound_by']}), {kr['launches']} main-path "
            f"launches, max abs err {kr['max_abs_err']}")
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.3f} s")
    log(f"card: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
