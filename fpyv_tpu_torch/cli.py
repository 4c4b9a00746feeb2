"""Command-line interface of the port: simulate, train, play, parity,
calibrate, hover-time (mirrors ``fpyv_tpu.cli``, subcommand for subcommand
and flag for flag):

    python -m fpyv_tpu_torch.cli sim --steps 600 --render none
    python -m fpyv_tpu_torch.cli train --num-envs 4096 --iterations 100
    python -m fpyv_tpu_torch.cli play --checkpoint-dir ckpts --save-video flight.mp4
    python -m fpyv_tpu_torch.cli parity --steps 300
    python -m fpyv_tpu_torch.cli hover-time --csv config.csv --dry-mass 100
    torchrun --nproc-per-node 4 -m fpyv_tpu_torch.cli train --distributed

Everything runs on the CUDA device unless ``--device cpu`` is given (before
or after the subcommand); asking for CUDA where there is none raises, the
port never falls back to the CPU on its own. ``bench`` refuses: the headline
benchmark, ``bench.py``, belongs to the JAX package, and
``python3 chip_smoke.py`` drives and times the port on the card.
"""

from __future__ import annotations

import argparse
import json

BENCH_REFUSAL = ("bench: bench.py is the JAX package's benchmark and the port does not run "
                 "it; `python3 chip_smoke.py` drives and times the port on the card")


def _config(path):
    from fpyv_tpu_torch.config import FpyvConfig

    return FpyvConfig.from_yaml(path) if path else FpyvConfig()


def _cmd_sim(args):
    from fpyv_tpu_torch.apps.simulator import run_simulator

    cfg = _config(args.params)
    sink = None
    if args.save_video:
        if args.render != "2d":
            raise SystemExit("--save-video requires --render 2d (FPV frames)")
        from fpyv_tpu_torch.viz.video import VideoWriterSink

        sink = VideoWriterSink(args.save_video, fps=cfg.simulator.fps)
    try:
        out = run_simulator(cfg, steps=args.steps, render=args.render,
                            guided=not args.no_guidance, use_joystick=args.joystick,
                            seed=args.seed, frame_sink=sink, device=args.device)
    finally:
        if sink is not None:
            sink.close()
    if sink is not None:
        out["video"] = sink.path
        out["video_frames"] = sink.frames_written
    print(json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                      for k, v in out.items()}))


def _cmd_train(args):
    from fpyv_tpu_torch.apps.train import (train_acro, train_es, train_race, train_sac,
                                           train_vision, train_vision_race)

    num_envs = args.num_envs or (
        256 if args.algo == "es"
        else 1024 if (args.vision or args.env == "race" or args.algo == "sac")
        else 4096)
    if args.env == "race" and args.vision:
        # pixels-to-action gate racing (BASELINE #4's gate/track markers)
        if args.algo != "ppo":
            raise SystemExit("--env race --vision runs PPO")
        res = train_vision_race(
            num_envs=num_envs,
            n_agents=args.agents if args.agents is not None else 1,
            distributed=args.distributed,
            num_iterations=args.iterations,
            num_steps=args.num_steps, seed=args.seed, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            gate_size=args.gate_size,
            max_episode_steps=args.max_episode_steps, torso=args.torso,
            gate_onehot=not args.no_gate_onehot,
            frame_stack=args.frame_stack,
            gru=args.gru,
            permute_spawns=args.permute_spawns,
            n_obstacles=args.obstacles,
            agent_collision_radius=args.collision_radius,
            w_overtake=args.w_overtake,
            show_opponents=not args.no_show_opponents,
            rollout=args.rollout,
            patch_pool=args.patch_pool,
            adam_mu_dtype=args.adam_mu_dtype,
            kernel_exact_logprob=args.kernel_exact_logprob,
            device=args.device,
            **({"update_epochs": args.update_epochs}
               if args.update_epochs else {}),
            **({"ent_coef": args.ent_coef}
               if args.ent_coef is not None else {}),
        )
    elif args.env == "race":
        if args.algo != "ppo":
            raise SystemExit("--env race runs shared-policy PPO "
                             "(no --algo es|sac)")
        if args.obstacles:
            raise SystemExit("--obstacles is a vision-race feature (the "
                             "state observation carries no obstacle "
                             "information) — add --vision")
        res = train_race(
            num_envs=num_envs,
            n_agents=args.agents if args.agents is not None else 4,
            distributed=args.distributed,
            num_iterations=args.iterations, num_steps=args.num_steps,
            seed=args.seed, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            gate_size=args.gate_size,
            max_episode_steps=args.max_episode_steps,
            agent_collision_radius=args.collision_radius,
            w_overtake=args.w_overtake,
            others_in_obs=not args.no_others_obs,
            permute_spawns=args.permute_spawns,
            device=args.device,
        )
    elif args.algo == "es":
        res = train_es(
            env_name=args.env, num_envs=num_envs,
            num_iterations=args.iterations, num_steps=args.num_steps,
            n_perturbations=args.population // 2,
            fitness_tail=args.fitness_tail, seed=args.seed,
            distributed=args.distributed, randomize=args.randomize,
            noise_std=args.noise_std, sigma_decay=args.sigma_decay,
            learning_rate=args.es_lr, log_dir=args.log_dir,
            device=args.device,
        )
    elif args.algo == "sac":
        if args.vision:
            raise SystemExit("--algo sac runs on state observations "
                             "(no --vision)")
        res = train_sac(
            num_envs=num_envs, num_iterations=args.iterations,
            warmup_steps=args.warmup_steps,
            updates_per_step=args.updates_per_step, seed=args.seed,
            randomize=args.randomize, log_dir=args.log_dir,
            device=args.device,
        )
    elif args.vision:
        res = train_vision(
            num_envs=num_envs, num_iterations=args.iterations,
            num_steps=args.num_steps, seed=args.seed,
            distributed=args.distributed, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            randomize_worlds=args.randomize, renderer=args.renderer,
            target_only=args.target_only, torso=args.torso,
            pixel_store=args.pixel_store, rollout=args.rollout,
            kernel_exact_logprob=args.kernel_exact_logprob,
            curriculum_iters=args.curriculum,
            patch_pool=args.patch_pool,
            adam_mu_dtype=args.adam_mu_dtype,
            device=args.device,
            **({"update_epochs": args.update_epochs}
               if args.update_epochs else {}),
        )
    else:
        res = train_acro(
            num_envs=num_envs, num_iterations=args.iterations,
            num_steps=args.num_steps, seed=args.seed,
            distributed=args.distributed, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            randomize=args.randomize, device=args.device,
        )
    print(json.dumps({
        "iterations": res.iterations,
        "mean_reward_first": res.mean_reward_first,
        "mean_reward_last": res.mean_reward_last,
        "env_steps_per_second": res.steps_per_second,
    }))


def _cmd_play(args):
    from fpyv_tpu_torch.apps.play import play_policy

    agents = args.agents if args.agents is not None else (
        4 if args.env == "race" else 1)
    out = play_policy(
        checkpoint_dir=args.checkpoint_dir, env_name=args.env,
        steps=args.steps, num_envs=args.num_envs, seed=args.seed,
        n_agents=agents, randomize_worlds=args.randomize,
        torso=args.torso, gate_onehot=not args.no_gate_onehot,
        frame_stack=args.frame_stack,
        show_opponents=not args.no_show_opponents,
        gate_size=args.gate_size, n_obstacles=args.obstacles,
        save_video=args.save_video, chunk=args.chunk, device=args.device,
    )
    print(json.dumps(out))


def _cmd_bench(args):
    raise SystemExit(BENCH_REFUSAL)


def _cmd_parity(args):
    """Fixed-seed trajectory check: the port's float64 ``drone_step`` on
    ``--device`` against the float64 NumPy oracle."""
    import numpy as np
    import torch

    from fpyv_tpu_torch.device import resolve_device
    from fpyv_tpu_torch.oracle.sim import OracleDrone, OracleGround
    from fpyv_tpu_torch.physics.drone import DroneParams, drone_reset, drone_step
    from fpyv_tpu_torch.physics.world import empty_world

    device = resolve_device(args.device)
    cfg = _config(args.params)
    rng = np.random.default_rng(args.seed)
    actions = rng.uniform(-1, 1, (args.steps, 4)) * np.array([0.3, 0.3, 0.2, 1.0])
    actions[:, 3] = rng.uniform(-0.6, 0.3, args.steps)

    oracle = OracleDrone(cfg)
    oracle.reset(cfg.drone.initial_position, cfg.drone.initial_velocity,
                 cfg.drone.initial_orientation)
    objs = [OracleGround()]
    params = DroneParams.from_config(cfg)
    kw = dict(dtype=torch.float64, device=device)
    world = empty_world(ground=True, **kw)
    state = drone_reset(params, torch.tensor(cfg.drone.initial_position, **kw),
                        torch.tensor(cfg.drone.initial_velocity, **kw),
                        torch.tensor(cfg.drone.initial_orientation, **kw))
    wind = np.zeros(3)
    # every step on the device, the trajectory read once; the oracle's
    # pose after each step beside it, up to its crash
    states, ref = [], []
    zero_wind = torch.zeros(3, **kw)
    with torch.no_grad():
        for a, a_dev in zip(actions, torch.tensor(actions, **kw)):
            oracle.step(a, wind, objs)
            state, _ = drone_step(params, state, a_dev, world, zero_wind)
            states.append(torch.cat([state.pos, state.att.reshape(-1)]))
            ref.append(np.concatenate([oracle.pos, oracle.R.reshape(-1)]))
            if oracle.done:
                break
    got = torch.stack(states).cpu().numpy()
    ref = np.stack(ref)
    max_pos_err = float(np.abs(got[:, :3] - ref[:, :3]).max())
    max_att_err = float(np.abs(got[:, 3:] - ref[:, 3:]).max())
    print(json.dumps({
        "steps": int(args.steps),
        "max_position_error": max_pos_err,
        "max_attitude_error": max_att_err,
        "pass": max_pos_err < 1e-8 and max_att_err < 1e-8,
    }))


def _cmd_calibrate(args):
    """Joystick calibration wizard + live view — the runnable twin of the
    reference's get_sticks.py __main__ (calibrate, then live read loop,
    the reference's src/utils/get_sticks.py:268-283)."""
    from fpyv_tpu_torch.inputs.rc import Joystick

    rc = Joystick(index=args.index)
    if not rc.status:
        raise SystemExit("no joystick device found (/dev/input/js*)")
    rc.calibrate(args.calibration, load_calibration_file=not args.wizard)
    out = {"calibration": args.calibration, "sticks": rc.sticks,
           "switches": rc.switches}
    if args.live > 0:
        # live bars/axes view, display-gated (headless hosts just read)
        rc.live_view(t_sec=args.live, rps=args.rps, mode=args.view)
        out["live_seconds"] = args.live
    out["action"] = [float(x) for x in rc.read_action()]
    print(json.dumps(out))


def _cmd_hover_time(args):
    from fpyv_tpu_torch.io.motor_csv import read_motor_test_report
    from fpyv_tpu_torch.physics.motor import Battery, check_battery_cells, max_hover_time

    block = read_motor_test_report(args.csv)[args.idx]
    battery = Battery(cells=args.cells, capacity_mah=args.capacity,
                      mass_g=args.battery_mass)
    cells = check_battery_cells(block.voltage)
    minutes = max_hover_time(args.dry_mass, battery, block.thrust_g,
                             block.power, args.motor_mass)
    print(json.dumps({
        "motor": block.motor_name, "propeller": block.propeller,
        "detected_cells": cells, "max_hover_time_minutes": minutes,
    }))


DEVICES = ("cuda", "cpu")


def _add_device(parser, default):
    parser.add_argument("--device", choices=DEVICES, default=default,
                        help="where the port runs (default cuda; cpu for hosts without a GPU)")


def build_parser() -> argparse.ArgumentParser:
    """JAX's parser, every subcommand and flag, plus ``--device``: on the
    top level and on each subcommand (where it overrides only when given)."""
    p = argparse.ArgumentParser(prog="fpyv_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _add_device(p, "cuda")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("sim", help="run the interactive simulator")
    sp.add_argument("--params", default=None, help="params.yaml path")
    sp.add_argument("--steps", type=int, default=10000)
    sp.add_argument("--render", choices=["none", "2d", "3d"], default="none")
    sp.add_argument("--no-guidance", action="store_true")
    sp.add_argument("--joystick", action="store_true")
    sp.add_argument("--save-video", default=None, metavar="PATH",
                    help="record the FPV view (HUD included) to a video "
                         "file — the headless twin of the reference's live "
                         "cv2 window (requires --render 2d)")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=_cmd_sim)

    tp = sub.add_parser("train", help="policy training on the acro env")
    tp.add_argument("--algo", choices=["ppo", "es", "sac"], default="ppo",
                    help="learner: PPO (on-policy gradient), NES evolutionary "
                         "search (gradient-free, population-parallel), or "
                         "SAC (off-policy, on-device replay)")
    tp.add_argument("--warmup-steps", type=int, default=50,
                    help="(sac) uniform-random exploration env steps")
    tp.add_argument("--updates-per-step", type=int, default=8,
                    help="(sac) gradient updates per synchronized env step")
    tp.add_argument("--env", choices=["acro", "rotate", "race"],
                    default="acro",
                    help="task: acro chase (default), attitude rotate (es), "
                         "or the multi-agent gate race (shared-policy PPO)")
    tp.add_argument("--agents", type=int, default=None,
                    help="(race) drones per race instance (default 4; the "
                         "pixels racer --env race --vision defaults to 1 — "
                         "multi-agent FPV costs one render per agent)")
    tp.add_argument("--gate-size", type=float, default=5.0,
                    help="(race) gate size (m) — big gates for curriculum "
                         "phase 1, resume smaller")
    tp.add_argument("--max-episode-steps", type=int, default=2000,
                    help="(race) episode horizon (laps-per-episode ceiling)")
    tp.add_argument("--collision-radius", type=float, default=0.35,
                    help="(race) inter-agent contact radius (m); 0 disables "
                         "collisions — the collision-curriculum lever "
                         "(train at 0, resume at 0.35)")
    tp.add_argument("--w-overtake", type=float, default=0.0,
                    help="(race) reward per race position gained (zero-sum "
                         "opponent-conditioned shaping)")
    tp.add_argument("--no-others-obs", action="store_true",
                    help="(race, state obs) zero the opponent-relpos obs "
                         "block (ablation)")
    tp.add_argument("--permute-spawns", action="store_true",
                    help="(race) randomly assign agents to spawn-ring slots "
                         "each episode so self-play roles cannot attach to "
                         "spawn positions (the r4 role-lock-in fix)")
    tp.add_argument("--no-show-opponents", action="store_true",
                    help="(race --vision) do not render opponents in the "
                         "FPV frame (ablation)")
    tp.add_argument("--no-gate-onehot", action="store_true",
                    help="(race --vision) train from pixels + IMU alone "
                         "(the next-gate onehot block stays zeroed)")
    tp.add_argument("--frame-stack", type=int, default=1,
                    help="(race --vision) stack the last K depth frames as "
                         "the pixel obs (temporal memory)")
    tp.add_argument("--gru", type=int, default=0,
                    help="(race --vision) recurrent temporal memory: GRU "
                         "width between torso and heads, trained with the "
                         "sequence-minibatched recurrent PPO (alternative "
                         "to --frame-stack; scan rollout only)")
    tp.add_argument("--obstacles", type=int, default=0,
                    help="(race --vision) moving obstacle spheres orbiting "
                         "the track (rendered in-frame; contact = crash)")
    tp.add_argument("--population", type=int, default=256,
                    help="(es) candidates per generation (antithetic pairs)")
    tp.add_argument("--noise-std", type=float, default=0.05,
                    help="(es) initial perturbation sigma")
    tp.add_argument("--sigma-decay", type=float, default=1.0,
                    help="(es) sigma anneal on non-improving generations")
    tp.add_argument("--es-lr", type=float, default=0.02,
                    help="(es) NES gradient step size")
    tp.add_argument("--fitness-tail", type=int, default=None,
                    help="(es) fitness = mean reward over the last N steps "
                         "(default: whole rollout)")
    tp.add_argument("--num-envs", type=int, default=None,
                    help="parallel envs (default 4096 ppo / 1024 vision / "
                         "256-per-candidate es)")
    tp.add_argument("--iterations", type=int, default=100)
    tp.add_argument("--num-steps", type=int, default=32)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--distributed", action="store_true")
    tp.add_argument("--randomize", action="store_true")
    tp.add_argument("--vision", action="store_true",
                    help="pixels-to-action PPO on the vision env")
    tp.add_argument("--renderer",
                    choices=["raycast", "raycast_pallas", "splat"],
                    default="raycast",
                    help="vision obs renderer: analytic raycast (fast, "
                         "full-world default) or reference-parity splat")
    tp.add_argument("--target-only", action="store_true",
                    help="render only the chased target (the reference's "
                         "guidance view) instead of the full world")
    tp.add_argument("--torso", choices=["patch", "conv"], default="patch",
                    help="(vision) image torso: patch-embed matmuls (the "
                         "kernels' default) or the conv stack")
    tp.add_argument("--pixel-store", choices=["u8", "f32"], default="u8",
                    help="(vision) rollout pixel storage dtype (u8 exact)")
    tp.add_argument("--rollout", choices=["auto", "scan", "kernel"],
                    default="auto",
                    help="(vision / race --vision) rollout engine: the "
                         "policy-in-kernel CUDA megaloop (render + actor "
                         "+ env step fused: K7, or K8 with gate state and "
                         "K-frame stacks) when supported, else the eager "
                         "per-step rollout; force with scan/kernel")
    tp.add_argument("--kernel-exact-logprob", action="store_true",
                    help="(vision --rollout kernel) recompute log_prob/value "
                         "with the exact PyTorch forward instead of trusting "
                         "the kernel's bf16 emissions")
    tp.add_argument("--update-epochs", type=int, default=None,
                    help="PPO epochs per iteration (default: trainer's)")
    tp.add_argument("--patch-pool", type=int, default=1,
                    help="(vision) pooled-patch fc: mix groups of N "
                         "consecutive patch embeddings through one "
                         "Dense(embed) before the fc stack — shrinks the "
                         "learner's biggest matmul N-fold (VERDICT r4 #1)")
    tp.add_argument("--adam-mu-dtype", choices=["bf16"], default=None,
                    help="store adam's first moment in bfloat16")
    tp.add_argument("--ent-coef", type=float, default=None,
                    help="PPO entropy bonus (default: trainer's; the pixel "
                         "racer uses 0.01 against entropy collapse)")
    tp.add_argument("--curriculum", type=int, default=None, metavar="N",
                    help="(vision, with --randomize) ramp world difficulty "
                         "0 -> 1 over N iterations (obstacle count/size)")
    tp.add_argument("--log-dir", default=None)
    tp.add_argument("--checkpoint-dir", default=None)
    tp.add_argument("--resume", action="store_true")
    tp.set_defaults(fn=_cmd_train)

    yp = sub.add_parser("play", help="fly a trained checkpoint (optionally "
                                     "recording the FPV view to video)")
    yp.add_argument("--checkpoint-dir", required=True)
    yp.add_argument("--env", choices=["acro", "vision", "race",
                                      "vision_race"],
                    default="acro")
    yp.add_argument("--torso", choices=["patch", "conv"], default=None,
                    help="(vision/vision_race) image torso (default: "
                         "detected from the checkpoint's param tree)")
    yp.add_argument("--no-gate-onehot", action="store_true",
                    help="(vision_race) evaluate a pure-pixels checkpoint "
                         "(the gate_onehot obs block stays zeroed)")
    yp.add_argument("--steps", type=int, default=600)
    yp.add_argument("--num-envs", type=int, default=16)
    yp.add_argument("--agents", type=int, default=None,
                    help="(race/vision_race) drones per race "
                         "(default 4 race / 1 vision_race)")
    yp.add_argument("--frame-stack", type=int, default=1,
                    help="(vision_race) must match the trained net")
    yp.add_argument("--no-show-opponents", action="store_true",
                    help="(vision_race) evaluate without in-frame opponents")
    yp.add_argument("--gate-size", type=float, default=5.0,
                    help="(race/vision_race) track gate size — match the "
                         "trained curriculum phase")
    yp.add_argument("--obstacles", type=int, default=0,
                    help="(vision_race) moving track obstacles — match "
                         "training")
    yp.add_argument("--randomize", action="store_true",
                    help="(vision) evaluate on randomized worlds")
    yp.add_argument("--save-video", default=None, metavar="PATH")
    yp.add_argument("--chunk", type=int, default=120,
                    help="steps per device call")
    yp.add_argument("--seed", type=int, default=0)
    yp.set_defaults(fn=_cmd_play)

    bp = sub.add_parser("bench", help="refused: bench.py is the JAX package's "
                                      "benchmark; run python3 chip_smoke.py")
    bp.set_defaults(fn=_cmd_bench)

    pp = sub.add_parser("parity", help="fixed-seed trajectory check vs oracle")
    pp.add_argument("--params", default=None)
    pp.add_argument("--steps", type=int, default=300)
    pp.add_argument("--seed", type=int, default=42)
    pp.set_defaults(fn=_cmd_parity)

    cp = sub.add_parser("calibrate",
                        help="joystick calibration wizard / live view")
    cp.add_argument("--calibration", default="calibration.json",
                    help="calibration JSON path (frsky.json schema)")
    cp.add_argument("--wizard", action="store_true",
                    help="run the interactive wizard (records stick sweeps) "
                         "instead of loading the file")
    cp.add_argument("--index", type=int, default=0, help="joystick device #")
    cp.add_argument("--live", type=float, default=0.0, metavar="SECONDS",
                    help="after calibrating, run the live view this long")
    cp.add_argument("--view", choices=["axes", "bars"], default="axes",
                    help="live view mode: calibrated stick axes or raw bars")
    cp.add_argument("--rps", type=int, default=20, help="live reads/second")
    cp.set_defaults(fn=_cmd_calibrate)

    hp = sub.add_parser("hover-time", help="max hover time from a motor CSV")
    hp.add_argument("--csv", required=True)
    hp.add_argument("--idx", type=int, default=0)
    hp.add_argument("--dry-mass", type=float, default=100.0)
    hp.add_argument("--cells", type=int, default=6)
    hp.add_argument("--capacity", type=float, default=3000.0)
    hp.add_argument("--battery-mass", type=float, default=304.2)
    hp.add_argument("--motor-mass", type=float, default=19.7)
    hp.set_defaults(fn=_cmd_hover_time)

    for sp_ in sub.choices.values():
        _add_device(sp_, argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
