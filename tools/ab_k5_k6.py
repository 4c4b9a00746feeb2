"""Times K5 and K6 of one checkout of the PyTorch/CUDA port on one NVIDIA GPU,
for a parent-against-change comparison with one timer.

    python3 tools/ab_k5_k6.py [ROOT]

ROOT (default: this checkout) is the checkout whose ``fpyv_tpu_torch`` is
imported, built and timed; the timer, ``chip_smoke.cuda_ms``, and this
script always come from this checkout, so two checkouts run in turns in one
call (parent, change, change, parent) are timed alike. Each kernel is timed
two ways at ``chip_smoke.py``'s shapes:

- ``cuda_ms``: CUDA events around back-to-back wrapper calls after the
  device has slept through the host's enqueue, so a wrapper that waits on
  the host inside each call (a blocking copy) shows that wait;
- ``kernel_ms``: the kernel's own device time under ``torch.profiler``,
  the mean over the same calls, which leaves any copy around it out.

K5: 1024 envs, 96x72, the params.yaml world, cameras after a reset. K6:
1024 envs, K = 64, the default world and rig, from a fresh reset and on a
steady-state bank (8192 chase steps from that reset), and ``bench.py``'s
chase K-slope (K = 512 -> 2048, host clock). Prints one JSON line.
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
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_k5_k6: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # its fpyv_tpu_torch imports resolve to ROOT's
    from fpyv_tpu_torch.config import SimulatorConfig
    from fpyv_tpu_torch.envs.acro import AcroEnv, vector_reset
    from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv, default_vision_rig
    from fpyv_tpu_torch.ops import _build
    from fpyv_tpu_torch.ops import env_kernel as ek
    from fpyv_tpu_torch.ops import vision_kernel as vk
    from fpyv_tpu_torch.physics.drone import DroneParams
    from fpyv_tpu_torch.world.generators import WorldSpec, build_world

    if not Path(vk.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {vk.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    n = smoke.N_VISION
    _build.library()

    def kernel_ms(fn, reps: int, name: str) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA and name in ev.key]
        if sum(ev.count for ev in evs) != reps:
            raise AssertionError(f"profiler saw {[(ev.key, ev.count) for ev in evs]} for {name}")
        return sum(ev.device_time_total for ev in evs) * 1e-3 / reps

    res = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()}
    gen = torch.Generator().manual_seed(0)
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    rig = default_vision_rig()

    # K5 at the vision env's shape
    pworld = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=dev)
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
                 "levels_sum": float(k5().double().sum().item())}

    # K6 from a fresh reset and on a steady-state bank
    world = env.default_world(dev)
    st, _ = vector_reset(env, gen, n, world)
    banks = {"fresh": (vk.chase_state_matrix(st), ek.env_world_matrix(world))}
    st, w, _, _, _ = vk.fused_vision_env_rollout(env, st, world, 8192)
    banks["steady"] = (vk.chase_state_matrix(st), ek.env_world_matrix(w))
    for label, (s28, wm) in banks.items():
        def k6():
            return vk.launch_vision_env_rollout(env, s28, wm, 64, rig)

        res[f"k6_{label}"] = {"cuda_ms": smoke.cuda_ms(k6, 20),
                              "kernel_ms": kernel_ms(k6, 20, "chase_kernel"),
                              "bank_sum": float(s28[:3].double().sum().item()),
                              "rsum": float(k6()[1].double().sum().item())}

    # bench.py::measure_vision's K-slope on the chase main path
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
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
