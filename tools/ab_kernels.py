"""Times K2 to K8 of one checkout of the PyTorch/CUDA port on one
NVIDIA GPU, for a parent-against-change comparison with one timer.

    python3 tools/ab_kernels.py [ROOT] [--only k7,k8]

ROOT (default: this checkout) is the checkout whose ``fpyv_tpu_torch`` is
imported, built and timed; the timer, ``chip_smoke.cuda_ms``, and this
script always come from this checkout, so two checkouts run in turns in one
call (parent, change, change, parent) are timed alike. Each kernel is timed
two ways at ``chip_smoke.py``'s shapes:

- ``cuda_ms``: CUDA events around back-to-back wrapper calls after the
  device has slept through the host's enqueue, so a wrapper that waits on
  the host inside each call (a blocking copy) shows that wait;
- ``kernel_ms``: the kernel's own device time under ``torch.profiler``,
  the mean over the launches the trace kept of the same calls, which
  leaves any copy around it out.

K2: 4096 envs, one step, the hover action, from a reset on the default
world (its kernel's name differs between checkouts: any kernel in the
trace counts). K3: 4096 envs, K = 256, the hover action, from a reset on the default and
on the params.yaml world. K4: 4096 envs, K = 64, hover, on the default
world from a fresh reset and on a steady bank 1,000,000 steps on (crashes
have put the envs' 1000-step episodes out of step, so some reset in every
window), and on the params.yaml world with DomainRand and wind from a
reset, each with the resets the plain version counts there; and at 1M
envs on the default world from a reset (the occupancy probe's largest
bank, where one thread runs an env).
K5: 1024 envs, 96x72, the params.yaml world, cameras after a reset. K6:
1024 envs, K = 64, the default world and rig, from a fresh reset and on a
steady-state bank (8192 chase steps from that reset), and ``bench.py``'s
chase K-slope (K = 512 -> 2048, host clock). K7: the pixel trainer's
shape (1024 envs, 96x72, T = 32, bf16, the 256-wide fc) and K7 in float32
at 64 envs, T = 16; K8: the race trainer's (1024 envs, 4 frames, T = 32,
bf16), each with the phase split of its instrumented launch (ms a launch,
``policy_kernel.phase_split_ms``: the render phase among them) and a
checksum of its frames beside that of its aux rows. ``--only`` keeps the
named entries (k2, k3, k4, k5, k6, chase, k7, k8, t7, t8). t7 and t8 are
the K7 and K8 trainers' iterations at ``bench.py``'s recipes (1024 envs,
T = 32; K8's 4 frames, gate size 5), split with CUDA events into the
rollout (one launch and the bootstrap frame) and the whole iteration,
best of 5 after a warm-up. ``ptxas`` holds K7's and
K8's registers and spills where this run built the library. Prints one
JSON line;
each entry's checksum (a sum over its output) shows both checkouts
computed the same.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = set(args[i + 1].split(","))
        del args[i:i + 2]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))

    def want(name: str) -> bool:
        return only is None or name in only

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # its fpyv_tpu_torch imports resolve to ROOT's
    from fpyv_tpu_torch.config import SimulatorConfig
    from fpyv_tpu_torch.envs.acro import AcroEnv, vector_reset
    from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv, default_vision_rig
    from fpyv_tpu_torch.ops import _build
    from fpyv_tpu_torch.ops import env_kernel as ek
    from fpyv_tpu_torch.ops import step_kernel as sk
    from fpyv_tpu_torch.ops import vision_kernel as vk
    from fpyv_tpu_torch.physics.drone import DroneParams
    from fpyv_tpu_torch.world.generators import WorldSpec, build_world

    if not Path(vk.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {vk.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    n = smoke.N_VISION
    _build.library()
    ptxas = {k: v for k, v in smoke.ptxas_report().items() if "vision_rollout" in k}

    def kernel_ms(fn, reps: int, name: str) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA and name in ev.key]
        seen = sum(ev.count for ev in evs)  # the trace may drop some of a fast run's launches
        if not 0 < seen <= reps:
            raise AssertionError(f"profiler saw {[(ev.key, ev.count) for ev in evs]} for {name}")
        return sum(ev.device_time_total for ev in evs) * 1e-3 / seen

    res = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), "ptxas": ptxas}
    gen = torch.Generator().manual_seed(0)
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    rig = default_vision_rig()
    world = env.default_world(dev)
    pworld = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=dev)
    pcyl = sk.cylinder_matrix(pworld)
    env_dr = AcroEnv(params=env.params, randomize=True, wind=(1.0, 0.5, 0.0), wind_scale=0.5)
    na = smoke.N_ENVS
    hover = torch.zeros(na, 4, device=dev)
    hover[:, 3] = smoke.THROTTLE
    a4 = sk.action_matrix(hover)

    # K2 at the acro main path's shape
    st, _ = vector_reset(env, gen, na, world)
    s15, sph = sk.state_to_matrix(st.drone), sk.sphere_matrix(world)

    def k2():
        return sk.launch_drone_step(env.params, s15, a4, sph)

    if want("k2"):
        res["k2"] = {"cuda_ms": smoke.cuda_ms(k2, 200), "kernel_ms": kernel_ms(k2, 200, "kernel"),
                     "checksum": float(k2().double().sum().item())}

    # K3 at the acro main path's shape, on both worlds
    k3_worlds = (("default", world, None), ("params", pworld, pcyl)) if want("k3") else ()
    for label, w, cyl in k3_worlds:
        st, _ = vector_reset(env, gen, na, w)
        s15, sph = sk.state_to_matrix(st.drone), sk.sphere_matrix(w)

        def k3():
            return sk.launch_rollout(env.params, s15, a4, sph, 256, cyl)

        res[f"k3_{label}"] = {"cuda_ms": smoke.cuda_ms(k3, 20),
                              "kernel_ms": kernel_ms(k3, 20, "rollout_kernel"),
                              "checksum": float(k3().double().sum().item())}

    # K4 on the default world: fresh, and on a steady bank (crashes have put
    # the envs' episodes out of step); then the params.yaml world with DR + wind
    st, _ = vector_reset(env, gen, na, world)
    wm0 = ek.env_world_matrix(world)
    runs = {"fresh": (env, ek.env_state_to_matrix(st), wm0, None)}
    if want("k4"):
        sb, wb, _ = ek.fused_env_rollout(env, st, hover, world, 1_000_000, seed=7)
        runs["steady"] = (env, ek.env_state_to_matrix(sb), ek.env_world_matrix(wb), None)
        st, _ = vector_reset(env_dr, gen, na, pworld)
        runs["params_dr_wind"] = (env_dr, ek.env_state_to_matrix(st), ek.env_world_matrix(pworld),
                                  pcyl)
    else:
        runs = {}
    for label, (e, s24, wm, cyl) in runs.items():
        def k4():
            return ek.launch_env_rollout(e, s24, a4, wm, 64, seed=0, cyl_mat=cyl)

        _, _, resets = ek.env_rollout_reference(e, s24, a4, wm, 64, seed=0, cyl_mat=cyl)
        res[f"k4_{label}"] = {"cuda_ms": smoke.cuda_ms(k4, 50),
                              "kernel_ms": kernel_ms(k4, 50, "env_rollout_kernel"),
                              "resets": resets,
                              "checksum": float(k4()[1].double().sum().item())}
    # K4 on the occupancy probe's largest bank: 1M envs, default world, fresh
    if want("k4"):
        nb = 1 << 20
        st, _ = vector_reset(env, gen, nb, world)
        sb, ab = ek.env_state_to_matrix(st), sk.action_matrix(hover[:1].expand(nb, 4))

        def k4_big():
            return ek.launch_env_rollout(env, sb, ab, wm0, 64, seed=0)

        res["k4_1M_envs"] = {"cuda_ms": smoke.cuda_ms(k4_big, 5),
                             "kernel_ms": kernel_ms(k4_big, 5, "env_rollout_kernel"),
                             "checksum": float(k4_big()[1].double().sum().item())}

    # K5 at the vision env's shape
    if want("k5"):
        venv = VisionAcroEnv(acro=env, renderer="raycast_pallas", target_only=False)
        vstate, _ = venv.reset_batched(gen, pworld, None, n)
        cam_pos, cam_R = venv._camera(vstate)
        cfg = vk.RenderConfig.for_world(pworld, venv.max_depth)
        dcam = torch.from_numpy(vk.flat_dcam(rig)).to(dev)
        cam, wcol = vk.camera_matrix(cam_pos, cam_R), vk.world_cols(pworld)

        def k5():
            return vk.launch_render_depth(cfg, dcam, cam, wcol)

        res["k5"] = {"cuda_ms": smoke.cuda_ms(k5, 200),
                     "kernel_ms": kernel_ms(k5, 200, "render_depth_kernel"),
                     "checksum": float(k5().double().sum().item())}

    # K6 from a fresh reset and on a steady-state bank
    if want("k6"):
        st, _ = vector_reset(env, gen, n, world)
        banks = {"fresh": (vk.chase_state_matrix(st), ek.env_world_matrix(world))}
        st, w, _, _, _ = vk.fused_vision_env_rollout(env, st, world, 8192)
        banks["steady"] = (vk.chase_state_matrix(st), ek.env_world_matrix(w))
        for label, (s28, wm) in banks.items():
            def k6():
                return vk.launch_vision_env_rollout(env, s28, wm, 64, rig)

            res[f"k6_{label}"] = {"cuda_ms": smoke.cuda_ms(k6, 20),
                                  "kernel_ms": kernel_ms(k6, 20, "chase_kernel"),
                                  "checksum": float(k6()[1].double().sum().item())}

    # bench.py::measure_vision's K-slope on the chase main path
    if want("chase"):
        st, _ = vector_reset(env, gen, n, world)

        def chase(k: int, seed: int) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = vk.fused_vision_env_rollout(env, st, world, k, seed=seed)
            out[2].sum().item()  # completion on the host is part of the time
            return time.perf_counter() - t

        slope = {}
        for kk in (512, 2048):
            chase(kk, 7)
            slope[kk] = min(chase(kk, 8 + r) for r in range(3))
        res["chase_k_slope"] = n * (2048 - 512) / (slope[2048] - slope[512])

    # K7 and K8 at the trainers' shapes (bf16), K7 in float32 at phase 11's
    from fpyv_tpu_torch.ops import policy_kernel as pk
    from fpyv_tpu_torch.ops import race_kernel as rk

    def rollout_entry(launch, reps: int, name: str, nk: int, probe: bool) -> dict:
        out = launch(None)
        entry = {"cuda_ms": smoke.cuda_ms(lambda: launch(None), reps),
                 "kernel_ms": kernel_ms(lambda: launch(None), reps, name),
                 "checksum": float(out[2].double().sum().item()),
                 "frames_checksum": float(out[0].double().sum().item())}
        if probe:  # the instrumented instantiation's phases (bf16 weights)
            ns = torch.zeros(pk.N_PHASES, dtype=torch.int64, device=dev)
            launch(ns)
            ns.zero_()
            launch(ns)
            entry["phases_ms"] = pk.phase_split_ms(ns, nk)
        return entry

    if want("k7"):
        for label, nk, steps, bf16 in (("k7", n, smoke.K7_STEPS, True),
                                       ("k7_f32", 64, 16, False)):
            e7, _, cols, w, cfg, wcol = smoke.policy_setup(dev, gen, nk, 1000, bf16=bf16)
            res[label] = rollout_entry(
                lambda ns: pk.launch_policy_vision_rollout(e7, rig, cols, wcol, cfg, w, steps, 9,
                                                           phase_ns=ns),
                5, "policy_vision_rollout_kernel", nk, bf16)
    if want("k8"):
        venv, rcols, rhist, rw, rwcol, rocol = smoke.race_setup(dev, gen, n, smoke.RACE_STACK,
                                                                0, 2000, bf16=True)
        res["k8"] = rollout_entry(
            lambda ns: rk.launch_race_vision_rollout(venv, rcols, rhist, rwcol, rocol, rw,
                                                     smoke.K7_STEPS, 9, phase_ns=ns),
            5, "race_vision_rollout_kernel", n, True)
    # the K7 and K8 trainers' iteration at bench.py's recipes, split with CUDA
    # events into the rollout (one launch and the bootstrap frame) and the rest
    from fpyv_tpu_torch.apps.train import make_vision_race_trainer, make_vision_trainer

    makers = {"t7": lambda: make_vision_trainer(num_envs=n),
              "t8": lambda: make_vision_race_trainer(num_envs=n, frame_stack=smoke.RACE_STACK,
                                                     gate_size=5.0)}
    for label, make in makers.items():
        if not want(label):
            continue
        trainer = make()
        tstate, _ = trainer.train_iteration(trainer.state)  # warm-up
        split = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            trainer.rollout_fn(tstate)
            ev[1].record()
            ev[2].record()
            tstate, _ = trainer.train_iteration(tstate)
            ev[3].record()
            torch.cuda.synchronize()
            split.append((ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])))
        res[label] = {"rollout_ms": min(r for r, _ in split),
                      "iteration_ms": min(i for _, i in split),
                      "all": [[round(a, 6), round(b, 6)] for a, b in split]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
