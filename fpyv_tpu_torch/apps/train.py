"""Trainers (mirrors ``fpyv_tpu.apps.train``): the PPO trainers
``train_acro``, ``train_race``, ``train_vision`` and ``train_vision_race``,
off-policy ``train_sac`` and gradient-free ``train_es``.

``train_acro`` trains the state-observation ``ActorCritic`` on ``AcroEnv``
(quaternion attitude, the default world), and ``train_race`` one shared
``ActorCritic`` for every agent of ``MultiRaceEnv`` (a flat batch of
``num_envs * n_agents`` learner rows through ``make_shared_policy_env_step``,
gates passed in the metrics). Both step the eager env once a step inside
``make_ppo``'s per-step rollout (:func:`fpyv_tpu_torch.rl.ppo.make_step_rollout`),
as the JAX trainers step ``AcroEnv.step`` and the race env under
``jax.vmap``; the env hands the learner terminations only (crashes, not
time limits).

``train_vision`` trains ``PixelActorCritic`` on ``VisionAcroEnv``'s depth
view, on per-env randomized worlds or params.yaml's, through one of two
rollouts, chosen as the JAX trainer chooses (:func:`vision_rollout`):

- ``"kernel"``: every iteration is one launch of K7 (render, actor, sample,
  env step for T steps over all envs, :mod:`fpyv_tpu_torch.ops.policy_kernel`)
  and the bootstrap frame through K5, then the PyTorch PPO learner
  (:mod:`fpyv_tpu_torch.rl.ppo`). It takes the patch torso on the raycast
  view;
- ``"scan"``: ``make_ppo``'s per-step rollout over the eager
  ``VisionAcroEnv.step_batched`` (whose raycast render is one K5 launch a
  step), for the conv torso, the splat and target-only views, float32
  pixel storage and the world curriculum. The worlds ride the PPO carry as
  ``(env_state, worlds)``; with ``curriculum_iters`` a hook before each
  chunk resamples them at difficulty ``min(1, it / curriculum_iters)`` from a
  generator seeded by the world seed and ``it``, so a resumed run equals an
  unbroken one.

``train_vision_race`` trains the gate racer from pixels over
``VisionRaceEnv``'s FPV view of the track (with orbiting obstacles where
asked): one launch of K8 an iteration (:mod:`fpyv_tpu_torch.ops.race_kernel`)
for one agent, the patch torso and no GRU, else the per-step scan rollout
(:func:`race_rollout`), which takes ``n_agents > 1`` (every agent sees the
others as spheres; ``num_envs * n_agents`` learner rows, each agent's done
the env's flattened ``crashed``, race resets included), the conv torso and
``gru > 0`` through :func:`fpyv_tpu_torch.rl.ppo.make_recurrent_ppo`, whose
hidden rides the carry as ``(env_state, hidden)``.

``train_sac`` runs SAC (:mod:`fpyv_tpu_torch.rl.sac`) on ``AcroEnv``: an
iteration is one eager env step over the bank, its transitions into the
device replay, then ``updates_per_step`` updates; its generators live on
the training device. ``train_es`` runs NES (:mod:`fpyv_tpu_torch.rl.es`) on
``ActorCritic``'s flattened parameters over ``AcroEnv`` or ``RotateEnv``:
every generation evaluates all candidates at once on a (2P, num_envs)
bank, one batched forward of the candidates' nets a step, the reset draws
shared across candidates (common random numbers).

The PPO trainers' checkpoints hold the full state (params, Adam, the env
carry with its worlds, frame history or hidden, last obs, generator), so a
resumed run continues exactly as an unbroken one (as in JAX, SAC and ES keep
none). ``adam_mu_dtype="bf16"`` stores Adam's first
moment in bfloat16 in every pixel trainer.

``distributed=True`` trains over every rank of the job, one process per
GPU under ``torch.distributed`` (start them with ``torchrun
--nproc-per-node=N``; :func:`fpyv_tpu_torch.parallel.mesh.make_mesh` joins
the group, the one-rank mesh without one). The PPO trainers build the whole
bank on every rank and keep their rows of it
(:mod:`fpyv_tpu_torch.parallel.train`); the draws are made at the whole
bank's shape and sliced, so W ranks replay one rank's rollout, and world
size 1 is the single-process trainer bit for bit. Each minibatch's
gradients are averaged over the ranks before the clip, the infos after the
iteration. As in JAX, ``distributed`` runs on the scan rollouts only (K7
and K8 are refused with it, the GRU too), and a race stays whole on one
rank. ``train_es`` splits its population over the ranks. Rank 0 alone
writes the metrics log; every rank's meter counts the global env-steps, and
each rank checkpoints its own shard (``utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.rotate import RotateEnv
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv, make_shared_policy_env_step
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv
from fpyv_tpu_torch.interop import policy_params_to_numpy
from fpyv_tpu_torch.models.policy import (
    ActorCritic,
    PixelActorCritic,
    SquashedGaussianActor,
    TwinQNetwork,
    actor_mean_batched,
)
from fpyv_tpu_torch.ops.policy_kernel import PP, acro_state_to_cols, make_kernel_vision_ppo_parts
from fpyv_tpu_torch.ops.race_kernel import make_kernel_race_ppo_parts
from fpyv_tpu_torch.parallel.mesh import make_mesh, shard_leading_axis
from fpyv_tpu_torch.parallel.train import local_config, make_distributed_ppo, shard_ppo_state
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.rl.es import make_policy_es
from fpyv_tpu_torch.rl.ppo import (
    PpoConfig,
    make_ppo,
    make_recurrent_ppo,
    make_recurrent_rollout,
    make_step_rollout,
    scan_train,
)
from fpyv_tpu_torch.rl.sac import SacConfig, make_sac
from fpyv_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from fpyv_tpu_torch.utils.metrics import MetricsLogger
from fpyv_tpu_torch.utils.profiling import Throughput, span
from fpyv_tpu_torch.world.randomize import curriculum_worlds


@dataclass
class TrainResult:
    iterations: int
    mean_reward_first: float
    mean_reward_last: float
    steps_per_second: float


def _train_loop(state, train_iteration, *, num_envs, num_steps, num_iterations, start_iter,
                scan_chunk, log_dir, print_every, checkpoint_dir,
                checkpoint_every, chunk_hook=None, reward_key="mean_reward", mesh=None,
                log_row=None) -> TrainResult:
    """The chunked host loop: ``scan_chunk`` iterations, then ONE
    device-to-host read of their infos, which also ends the chunk's device
    work before the meter counts it. The first chunk is left out of the
    rate (warm-up). ``chunk_hook(state, it) -> state`` (optional) runs
    before each chunk: the curriculum's world resample. The result's first
    and last rewards are the info ``reward_key``'s. ``log_row(it)``
    (optional) picks the iterations the metrics log keeps (every one by
    default). Over a ``mesh`` (``num_envs`` the global count) rank 0 alone
    logs, and each rank checkpoints its shard. Under ``torch.profiler``
    (``utils.profiling.trace``) each chunk is a ``train.chunk`` span and
    its read-back a ``train.readback`` span."""
    lead = mesh is None or mesh.rank == 0
    logger = MetricsLogger(log_dir if lead else None, print_every=print_every if lead else 0)
    shard = None if mesh is None else (mesh.rank, mesh.size)
    meter = Throughput()
    first_reward = last_reward = float("nan")
    it = start_iter
    end = start_iter + num_iterations
    first_chunk = True
    while it < end:
        n = min(scan_chunk, end - it)
        if chunk_hook is not None:
            state = chunk_hook(state, it)
        with span("train.chunk"):
            state, infos = scan_train(train_iteration, state, n)
        keys = list(infos)
        with span("train.readback"):
            host = torch.stack([infos[k].to(torch.float32) for k in keys]).cpu().numpy()
        rewards = host[keys.index(reward_key)].astype(np.float64)
        if first_chunk:
            first_reward = float(rewards[0])
            meter.reset()
            first_chunk = False
        else:
            meter.add(num_envs * num_steps * n)
        last_reward = float(rewards[-1])
        for i in range(n):
            if log_row is None or log_row(it + i):
                logger.log(it + i, {k: host[j, i] for j, k in enumerate(keys)})
        it += n
        if checkpoint_dir and (it % checkpoint_every == 0 or it == end):
            save_checkpoint(checkpoint_dir, it, state, shard=shard)
    logger.close()
    return TrainResult(iterations=num_iterations, mean_reward_first=first_reward,
                       mean_reward_last=last_reward, steps_per_second=meter.rate())


def _generators(seed: int, device="cpu"):
    """Four independent generators on ``device`` (the PPO trainers': worlds,
    env resets, net init, training, on the CPU), as the JAX trainer splits
    its key four ways."""
    seeds = np.random.SeedSequence(seed).generate_state(4)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def _chunk_generator(seed: int, it: int) -> torch.Generator:
    """The curriculum's worlds for the chunk starting at iteration ``it``:
    a generator from the world seed and ``it`` (JAX's ``fold_in(k_world,
    it)``)."""
    world_seed = int(np.random.SeedSequence(seed).generate_state(4)[0])
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([world_seed, it]).generate_state(1)[0]))


@dataclass
class Trainer:
    """A trainer's pieces: the PPO state (the net, Adam, the env carry, the
    bootstrap obs, the generator), one iteration, the rollout alone (T
    eager env steps, or one K7 or K8 launch and the bootstrap frame), which
    the iteration runs first (None for SAC, whose iteration is one env
    step), the hook run before each chunk (or None), and the mesh the state
    is laid out over (None on one process)."""

    state: object
    train_iteration: object
    rollout_fn: object
    chunk_hook: object = None
    mesh: object = None


def _cdt(compute_dtype: str):
    if compute_dtype not in ("bf16", "f32"):
        raise ValueError(f"compute_dtype must be 'bf16' or 'f32', got {compute_dtype!r}")
    return torch.bfloat16 if compute_dtype == "bf16" else None


def vision_rollout(rollout: str, *, torso: str = "patch", renderer: str = "raycast",
                   target_only: bool = False, curriculum_iters: Optional[int] = None,
                   distributed: bool = False) -> str:
    """``train_vision``'s rollout, by the JAX trainer's rule: ``"auto"``
    takes the kernel (K7) exactly for the patch torso on the ``"raycast"``
    view, without ``target_only``, a curriculum or ``distributed``, and the
    scan rollout for anything else, and prints its choice; ``"kernel"``
    raises for a recipe K7 does not take."""
    if rollout not in ("auto", "kernel", "scan"):
        raise ValueError(f"rollout must be 'auto', 'kernel' or 'scan', got {rollout!r}")
    if rollout == "auto":
        supported = (torso == "patch" and renderer == "raycast" and not target_only
                     and not curriculum_iters and not distributed)
        rollout = "kernel" if supported else "scan"
        print(f"train_vision: rollout='auto' takes the {rollout} rollout")
    if rollout == "kernel":
        if torso != "patch" or renderer != "raycast":
            raise ValueError("rollout='kernel' requires torso='patch' and renderer='raycast'")
        if curriculum_iters or distributed:
            raise ValueError("rollout='kernel' does not compose with distributed or "
                             "curriculum_iters (the worlds bake into the kernel's world "
                             "columns)")
        if target_only:
            raise ValueError("rollout='kernel' renders the whole world; target_only runs on "
                             "the scan rollout")
    return rollout


def race_rollout(rollout: str, *, n_agents: int = 1, torso: str = "patch", gru: int = 0,
                 distributed: bool = False) -> str:
    """``train_vision_race``'s rollout, by the JAX trainer's rule:
    ``"auto"`` takes the kernel (K8) exactly for one agent, the patch torso,
    no GRU and no ``distributed``, and the scan rollout for anything else,
    and prints its choice; ``"kernel"`` raises for a recipe K8 does not
    take, and the GRU raises with ``distributed``."""
    if rollout not in ("auto", "kernel", "scan"):
        raise ValueError(f"rollout must be 'auto', 'kernel' or 'scan', got {rollout!r}")
    if rollout == "auto":
        rollout = ("kernel" if (n_agents == 1 and torso == "patch" and not gru
                                and not distributed) else "scan")
        print(f"train_vision_race: rollout='auto' takes the {rollout} rollout")
    if gru and rollout == "kernel":
        raise ValueError("gru runs on the scan rollout (the kernel's temporal mechanism is "
                         "the K-frame stack)")
    if gru and distributed:
        raise ValueError("gru + distributed is not wired yet (as in the JAX trainer)")
    if rollout == "kernel":
        if n_agents != 1:
            raise ValueError("rollout='kernel' is single-agent (multi-agent FPV views read "
                             "cross-env opponent positions)")
        if torso != "patch" or distributed:
            raise ValueError("rollout='kernel' requires torso='patch' and no distributed")
    return rollout


def make_vision_trainer(num_envs: int = 1024, num_steps: int = 32, seed: int = 0,
                        randomize_worlds: bool = True, rig=None, learning_rate: float = 3e-4,
                        num_minibatches: int = 8, update_epochs: int = 2,
                        compute_dtype: str = "bf16", patch_pool: int = 1,
                        kernel_exact_logprob: bool = False, renderer: str = "raycast",
                        target_only: bool = False, torso: str = "patch",
                        pixel_store: str = "u8", curriculum_iters: Optional[int] = None,
                        adam_mu_dtype: Optional[str] = None, rollout: str = "kernel",
                        device=None, mesh=None) -> Trainer:
    """train_vision's pieces, ready to run on ``rollout`` ("kernel" or
    "scan", as :func:`vision_rollout` resolves it): the env bank in its
    worlds, the net, the PPO learner around the K7 or the per-step rollout
    (arguments as :func:`train_vision`'s). Over a ``mesh`` (the scan
    rollout) the state holds this rank's envs and their worlds."""
    cdt = _cdt(compute_dtype)
    device = _device(device, mesh)
    if mesh is not None and rollout == "kernel":
        raise ValueError("the kernel rollout (K7) trains on one process")
    config = PpoConfig(num_envs=num_envs, num_steps=num_steps, learning_rate=learning_rate,
                       num_minibatches=num_minibatches, update_epochs=update_epochs,
                       adam_mu_dtype=adam_mu_dtype)
    g_world, g_env, g_net, g_train = _generators(seed)
    rig_kw = {"rig": rig} if rig is not None else {}
    if rollout == "kernel":
        # the kernel integrates attitude as a quaternion; the obs carries none
        venv = VisionAcroEnv(acro=AcroEnv(params=DroneParams(att_mode="quat")),
                             renderer="raycast", target_only=False, pixel_dtype="u8", **rig_kw)
    else:
        venv = VisionAcroEnv(renderer=renderer, target_only=target_only,
                             pixel_dtype=pixel_store, **rig_kw)
    if randomize_worlds:
        worlds, bank = venv.make_randomized_worlds(g_world, num_envs, device=device)
        if curriculum_iters:
            worlds = curriculum_worlds(g_world, num_envs, 0.0, device=device)
    else:
        worlds, bank = venv.make_world(device=device)
        if mesh is not None:  # per-env worlds, so each rank keeps its rows
            worlds = _tile(worlds, num_envs)
    W, H = venv.rig.resolution
    net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PP, torso=torso,
                           prepatched=rollout == "kernel", compute_dtype=cdt,
                           patch_pool=patch_pool, image_hw=(H, W),
                           device=device).init_params(g_net)
    env_state, obs = venv.reset_batched(g_env, worlds, bank, num_envs)
    if rollout == "kernel":
        apply_fn, make_rollout_fn, obs_from_cols = make_kernel_vision_ppo_parts(
            venv, worlds, net, num_envs)
        cols = acro_state_to_cols(env_state)
        rollout_fn = make_rollout_fn(num_steps, compute_dtype=cdt,
                                     exact_logprob=kernel_exact_logprob)
        init, train_iteration = make_ppo(apply_fn, None, config, rollout_fn=rollout_fn)
        return Trainer(init(net, cols, obs_from_cols(cols), g_train), train_iteration,
                       rollout_fn)

    def apply_fn(net, obs):
        return net(obs["pixels"], torch.cat([obs["rates"], obs["accel_z"], obs["thrust"]],
                                            dim=-1))

    part = _part(mesh, num_envs)

    # the worlds ride the carry, so the curriculum hook swaps them as data
    def env_step(carry, action, generator):
        st, w = carry
        st, obs, reward, _, info = venv.step_batched(st, action, w, bank, generator=generator,
                                                     part=part)
        return (st, w), obs, reward, info["crashed"]

    init, train_iteration, rollout_fn = _ppo(apply_fn, env_step, config, mesh)
    chunk_hook = None
    if curriculum_iters:
        def chunk_hook(state, it):
            # the whole bank's new worlds, from the same generator on every
            # rank; each rank keeps its rows
            difficulty = min(1.0, it / curriculum_iters)
            new_worlds = curriculum_worlds(_chunk_generator(seed, it), num_envs, difficulty,
                                           device=device)
            if mesh is not None:
                new_worlds = shard_leading_axis(new_worlds, mesh)
            return state.replace(env_state=(state.env_state[0], new_worlds))

    return Trainer(_place(init(net, (env_state, worlds), obs, g_train), mesh), train_iteration,
                   rollout_fn, chunk_hook, mesh)


def _device(device, mesh) -> torch.device:
    """The trainer's device: the rank's over a mesh, else ``device``
    (CUDA unless told)."""
    return resolve_device(device) if mesh is None else mesh.device


def _part(mesh, n: int):
    """This rank's rows of an ``n``-row bank (None on one process)."""
    return None if mesh is None else mesh.part(n)


def _ppo(apply_fn, env_step, config: PpoConfig, mesh, metrics_fn=None):
    """``(init, train_iteration, rollout_fn)`` around the per-step rollout:
    ``make_ppo``'s on one process, ``make_distributed_ppo``'s over a mesh
    (``config.num_envs`` global, the action noise drawn for the whole bank
    and sliced)."""
    rollout_fn = make_step_rollout(apply_fn, env_step,
                                   config if mesh is None else local_config(config, mesh),
                                   part=_part(mesh, config.num_envs))
    if mesh is None:
        init, train_iteration = make_ppo(apply_fn, None, config, metrics_fn=metrics_fn,
                                         rollout_fn=rollout_fn)
    else:
        init, train_iteration = make_distributed_ppo(apply_fn, None, config, mesh,
                                                     metrics_fn=metrics_fn,
                                                     rollout_fn=rollout_fn)
    return init, train_iteration, rollout_fn


def _place(state, mesh):
    return state if mesh is None else shard_ppo_state(state, mesh)


def _mesh(distributed: bool, device):
    """The job's mesh for ``distributed=True`` (on ``device``), else None."""
    return make_mesh(device=device) if distributed else None


def _whole_races(num_envs: int, mesh) -> None:
    if mesh is not None and num_envs % mesh.size:
        raise ValueError(f"num_envs={num_envs} must divide the mesh size {mesh.size} "
                         "(whole races per shard)")


def _resume_and_train(trainer: Trainer, *, resume, checkpoint_dir, **loop) -> TrainResult:
    state, start_iter, mesh = trainer.state, 0, trainer.mesh
    world_size = None if mesh is None else mesh.size
    shard = None if mesh is None else (mesh.rank, mesh.size)
    if resume and checkpoint_dir:
        step = latest_step(checkpoint_dir, world_size=world_size)
        if step is not None:
            start_iter = step
            state = restore_checkpoint(checkpoint_dir, step, template=state, shard=shard)
            print(f"resumed from checkpoint at iteration {start_iter}")
    return _train_loop(state, trainer.train_iteration, start_iter=start_iter,
                       checkpoint_dir=checkpoint_dir, chunk_hook=trainer.chunk_hook, mesh=mesh,
                       **loop)


def _apply(net, obs):
    return net(obs)


def make_acro_trainer(num_envs: int = 4096, num_steps: int = 32, seed: int = 0,
                      randomize: bool = False, hidden=(128, 128), learning_rate: float = 3e-4,
                      shuffle_block: int = 64, device=None, mesh=None) -> Trainer:
    """train_acro's pieces, ready to run: the env bank on the default
    world, ``ActorCritic``, the PPO learner around the per-step rollout
    (arguments as :func:`train_acro`'s; over a ``mesh`` the state holds
    this rank's envs)."""
    device = _device(device, mesh)
    env = AcroEnv(params=DroneParams(att_mode="quat"), randomize=randomize)
    world = env.default_world(device)
    _, g_env, g_net, g_train = _generators(seed)
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=hidden,
                      device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs, num_steps=num_steps, learning_rate=learning_rate,
                       shuffle_block=shuffle_block)
    part = _part(mesh, num_envs)

    def env_step(env_state, action, generator):
        st, obs, reward, _, info = env.step(env_state, action, world, generator=generator,
                                            part=part)
        # hand the learner terminations only: a time-limit truncation
        # bootstraps V(s') (the env still auto-resets on either)
        return st, obs, reward, info["crashed"]

    env_state, obs = env.reset(g_env, world, (num_envs,))
    init, train_iteration, rollout_fn = _ppo(_apply, env_step, config, mesh)
    return Trainer(_place(init(net, env_state, obs, g_train), mesh), train_iteration,
                   rollout_fn, mesh=mesh)


def train_acro(
    num_envs: int = 4096,
    num_iterations: int = 100,
    num_steps: int = 32,
    seed: int = 0,
    distributed: bool = False,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    resume: bool = False,
    randomize: bool = False,
    hidden=(128, 128),
    learning_rate: float = 3e-4,
    print_every: int = 10,
    scan_chunk: int = 25,  # iterations between host reads of the infos
    shuffle_block: int = 64,  # PPO minibatch shuffle granularity (rl/ppo.py)
    device=None,  # CUDA unless "cpu"
) -> TrainResult:
    """State-observation PPO on ``AcroEnv``: returns the rewards of the
    first and last iteration and the trained env-steps/s after the first
    chunk. ``distributed`` splits the ``num_envs`` envs over the job's
    ranks (see the module's docstring)."""
    trainer = make_acro_trainer(num_envs=num_envs, num_steps=num_steps, seed=seed,
                                randomize=randomize, hidden=hidden,
                                learning_rate=learning_rate, shuffle_block=shuffle_block,
                                device=device, mesh=_mesh(distributed, device))
    return _resume_and_train(trainer, resume=resume, checkpoint_dir=checkpoint_dir,
                             num_envs=num_envs, num_steps=num_steps,
                             num_iterations=num_iterations, scan_chunk=scan_chunk,
                             log_dir=log_dir, print_every=print_every,
                             checkpoint_every=checkpoint_every)


def make_race_trainer(num_envs: int = 1024, n_agents: int = 4, num_steps: int = 32,
                      seed: int = 0, hidden=(128, 128), learning_rate: float = 3e-4,
                      gate_size: float = 5.0, max_episode_steps: int = 2000,
                      agent_collision_radius: float = 0.35, w_overtake: float = 0.0,
                      others_in_obs: bool = True, permute_spawns: bool = False,
                      device=None, mesh=None) -> Trainer:
    """train_race's pieces, ready to run: the race bank on the default
    track, one shared ``ActorCritic``, the PPO learner over the flat
    ``num_envs * n_agents`` agent batch (arguments as :func:`train_race`'s;
    over a ``mesh`` the state holds this rank's whole races)."""
    device = _device(device, mesh)
    _whole_races(num_envs, mesh)
    env = MultiRaceEnv(n_agents=n_agents, gate_size=gate_size,
                       max_episode_steps=max_episode_steps,
                       agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
                       others_in_obs=others_in_obs, permute_spawns=permute_spawns)
    world = env.default_world(device)
    env_step, reset_fn = make_shared_policy_env_step(env, world, n_envs=num_envs,
                                                     part=_part(mesh, num_envs))
    _, g_env, g_net, g_train = _generators(seed)
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=hidden,
                      device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs * n_agents, num_steps=num_steps,
                       learning_rate=learning_rate)

    def race_metrics(env_state):
        gates = env_state.gates_passed.to(torch.float32)
        t = torch.clamp_min(env_state.t, 1).to(torch.float32)[..., None]
        # the rolling per-step passing rate (x100) survives the resets that
        # zero the counters
        return {"mean_gates_passed": gates.mean(),
                "gates_per_100_steps": (gates / t).mean() * 100.0}

    env_state, obs = reset_fn(g_env)
    init, train_iteration, rollout_fn = _ppo(_apply, env_step, config, mesh, race_metrics)
    return Trainer(_place(init(net, env_state, obs, g_train), mesh), train_iteration,
                   rollout_fn, mesh=mesh)


def train_race(
    num_envs: int = 1024,  # races (learner rows: num_envs * n_agents)
    n_agents: int = 4,
    num_iterations: int = 300,
    num_steps: int = 32,
    seed: int = 0,
    distributed: bool = False,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    resume: bool = False,
    hidden=(128, 128),
    learning_rate: float = 3e-4,
    print_every: int = 10,
    scan_chunk: int = 25,
    gate_size: float = 5.0,  # a resumed run may shrink the gates (curriculum)
    max_episode_steps: int = 2000,
    agent_collision_radius: float = 0.35,  # 0 turns contact off (curriculum)
    w_overtake: float = 0.0,  # reward per race position gained
    others_in_obs: bool = True,  # False zeroes the opponents' block of the obs
    permute_spawns: bool = False,  # random spawn slot per agent and episode
    device=None,  # CUDA unless "cpu"
) -> TrainResult:
    """Shared-policy PPO on the multi-agent race env: every agent of every
    race acts through one ``ActorCritic``; the metrics log the mean gates
    passed and the gates per 100 steps. ``distributed`` splits the races
    over the job's ranks, whole races a rank."""
    trainer = make_race_trainer(
        num_envs=num_envs, n_agents=n_agents, num_steps=num_steps, seed=seed, hidden=hidden,
        learning_rate=learning_rate, gate_size=gate_size, max_episode_steps=max_episode_steps,
        agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
        others_in_obs=others_in_obs, permute_spawns=permute_spawns, device=device,
        mesh=_mesh(distributed, device))
    return _resume_and_train(trainer, resume=resume, checkpoint_dir=checkpoint_dir,
                             num_envs=num_envs * n_agents, num_steps=num_steps,
                             num_iterations=num_iterations, scan_chunk=scan_chunk,
                             log_dir=log_dir, print_every=print_every,
                             checkpoint_every=checkpoint_every)


def train_vision(
    num_envs: int = 1024,
    num_iterations: int = 100,
    num_steps: int = 32,
    seed: int = 0,
    distributed: bool = False,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    resume: bool = False,
    randomize_worlds: bool = True,
    rig=None,
    learning_rate: float = 3e-4,
    print_every: int = 10,
    scan_chunk: int = 20,
    num_minibatches: int = 8,
    update_epochs: int = 2,
    renderer: str = "raycast",  # "raycast" | "raycast_pallas" | "splat" (scan rollout)
    target_only: bool = False,  # render the chased target alone (scan rollout)
    compute_dtype: str = "bf16",  # image-torso compute: "bf16" | "f32"
    torso: str = "patch",  # "patch" | "conv" (scan rollout)
    pixel_store: str = "u8",  # (scan rollout) rollout pixels as "u8" levels or "f32"
    curriculum_iters: Optional[int] = None,  # (scan rollout) ramp world difficulty 0 -> 1
    #   over this many iterations; needs randomize_worlds; worlds resample every chunk
    patch_pool: int = 1,  # consecutive patch embeddings mixed per fc block
    adam_mu_dtype: Optional[str] = None,  # "bf16" stores Adam's first moment in bfloat16
    kernel_exact_logprob: bool = False,  # True recomputes log_prob/value with
    #   the learner's forward over the stored obs (epoch-0 ratio exactly 1);
    #   False trusts the kernel's own, as the JAX trainer's default
    rollout: str = "auto",  # "kernel" (K7), "scan" (the per-step rollout) or
    #   "auto": the JAX trainer's rule (vision_rollout)
    device=None,  # CUDA unless "cpu" (the kernels' plain versions)
) -> TrainResult:
    """Pixels-to-action PPO on ``VisionAcroEnv``'s depth view (the whole
    world through the raycast by default): every env in its own randomized
    world (``randomize_worlds``), or all in params.yaml's world. Returns the
    rewards of the first and last iteration and the trained env-steps/s
    after the first chunk. ``torso="conv", pixel_store="f32",
    update_epochs=4`` is the JAX package's round-2 recipe. ``distributed``
    splits the envs and their worlds over the job's ranks, on the scan
    rollout."""
    if curriculum_iters and not randomize_worlds:
        raise ValueError("curriculum_iters requires randomize_worlds=True")
    rollout = vision_rollout(rollout, torso=torso, renderer=renderer, target_only=target_only,
                             curriculum_iters=curriculum_iters, distributed=distributed)
    trainer = make_vision_trainer(
        num_envs=num_envs, num_steps=num_steps, seed=seed, randomize_worlds=randomize_worlds,
        rig=rig, learning_rate=learning_rate, num_minibatches=num_minibatches,
        update_epochs=update_epochs, compute_dtype=compute_dtype, patch_pool=patch_pool,
        kernel_exact_logprob=kernel_exact_logprob, renderer=renderer, target_only=target_only,
        torso=torso, pixel_store=pixel_store, curriculum_iters=curriculum_iters,
        adam_mu_dtype=adam_mu_dtype, rollout=rollout, device=device,
        mesh=_mesh(distributed, device))
    return _resume_and_train(trainer, resume=resume, checkpoint_dir=checkpoint_dir,
                             num_envs=num_envs, num_steps=num_steps,
                             num_iterations=num_iterations, scan_chunk=scan_chunk,
                             log_dir=log_dir, print_every=print_every,
                             checkpoint_every=checkpoint_every)


def make_vision_race_trainer(num_envs: int = 1024, num_steps: int = 32, seed: int = 0,
                             rig=None, learning_rate: float = 3e-4, num_minibatches: int = 8,
                             update_epochs: int = 2, gate_size: float = 5.0,
                             max_episode_steps: int = 2000, frame_width: float = 0.35,
                             compute_dtype: str = "bf16", ent_coef: float = 0.01,
                             gate_onehot: bool = True, frame_stack: int = 1,
                             n_obstacles: int = 0, obstacle_period: int = 600,
                             patch_pool: int = 1, kernel_exact_logprob: bool = False,
                             n_agents: int = 1, agent_collision_radius: float = 0.35,
                             w_overtake: float = 0.0, permute_spawns: bool = False,
                             show_opponents: bool = True, torso: str = "patch", gru: int = 0,
                             adam_mu_dtype: Optional[str] = None, rollout: str = "kernel",
                             device=None, mesh=None) -> Trainer:
    """train_vision_race's pieces, ready to run on ``rollout`` ("kernel" or
    "scan", as :func:`race_rollout` resolves it): the race bank on the
    default track, the net, the PPO learner (recurrent with ``gru > 0``)
    around the K8 or the per-step rollout (arguments as
    :func:`train_vision_race`'s; over a ``mesh``, the feedforward scan
    rollout, the state holds this rank's whole races)."""
    cdt = _cdt(compute_dtype)
    device = _device(device, mesh)
    _whole_races(num_envs, mesh)
    if mesh is not None and (rollout == "kernel" or gru):
        raise ValueError("the kernel rollout (K8) and the GRU train on one process")
    venv = VisionRaceEnv(
        race=MultiRaceEnv(n_agents=n_agents, gate_size=gate_size,
                          max_episode_steps=max_episode_steps,
                          agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
                          n_obstacles=n_obstacles, obstacle_period=obstacle_period,
                          permute_spawns=permute_spawns),
        frame_width=frame_width, gate_onehot=gate_onehot, frame_stack=frame_stack,
        show_opponents=show_opponents, **({"rig": rig} if rig is not None else {}))
    _, g_env, g_net, g_train = _generators(seed)
    world = venv.default_world(device)
    W, H = venv.rig.resolution
    net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PP, proprio_dim=5 + venv.n_gates,
                           torso=torso, prepatched=rollout == "kernel", compute_dtype=cdt,
                           patch_pool=patch_pool, frame_stack=frame_stack, gru=gru,
                           image_hw=(H, W), device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs * n_agents, num_steps=num_steps,
                       learning_rate=learning_rate, num_minibatches=num_minibatches,
                       update_epochs=update_epochs, ent_coef=ent_coef,
                       adam_mu_dtype=adam_mu_dtype)
    if rollout == "kernel":
        apply_fn, make_rollout_fn, obs_from_carry, init_carry, race_metrics = (
            make_kernel_race_ppo_parts(venv, world, net, num_envs))
        carry = init_carry(g_env)
        rollout_fn = make_rollout_fn(num_steps, compute_dtype=cdt,
                                     exact_logprob=kernel_exact_logprob)
        init, train_iteration = make_ppo(apply_fn, None, config, metrics_fn=race_metrics,
                                         rollout_fn=rollout_fn)
        return Trainer(init(net, carry, obs_from_carry(carry), g_train), train_iteration,
                       rollout_fn)

    def proprio(obs):
        return torch.cat([obs["rates"], obs["accel_z"], obs["thrust"], obs["gate_onehot"]],
                         dim=-1)

    part = _part(mesh, num_envs)

    def env_step(env_state, action, generator):
        st, obs, reward, _, info = venv.step_batched(env_state, action, world,
                                                     generator=generator, part=part)
        return st, obs, reward, info["crashed"]

    def race_metrics(env_state):
        rs = getattr(env_state, "race", env_state)  # the frame-stacked carry
        gates = rs.gates_passed.to(torch.float32)
        t = torch.clamp_min(rs.t, 1).to(torch.float32)[..., None]
        return {"mean_gates_passed": gates.mean(),
                "gates_per_100_steps": (gates / t).mean() * 100.0}

    env_state, obs = venv.reset_batched(g_env, world, num_envs)
    if gru:
        def apply_fn_r(net, obs, hidden):
            return net(obs["pixels"], proprio(obs), hidden)

        rollout_fn = make_recurrent_rollout(apply_fn_r, env_step, config)
        init, train_iteration = make_recurrent_ppo(apply_fn_r, None, config,
                                                   metrics_fn=race_metrics,
                                                   rollout_fn=rollout_fn)
        hidden0 = torch.zeros((num_envs * n_agents, gru), dtype=torch.float32, device=device)
        return Trainer(init(net, env_state, obs, hidden0, g_train), train_iteration,
                       rollout_fn)

    def apply_fn(net, obs):
        return net(obs["pixels"], proprio(obs))

    init, train_iteration, rollout_fn = _ppo(apply_fn, env_step, config, mesh, race_metrics)
    return Trainer(_place(init(net, env_state, obs, g_train), mesh), train_iteration,
                   rollout_fn, mesh=mesh)


def train_vision_race(
    num_envs: int = 1024,  # races (learner rows: num_envs * n_agents)
    n_agents: int = 1,  # > 1: every agent sees the others as spheres (scan rollout)
    num_iterations: int = 300,
    num_steps: int = 32,
    seed: int = 0,
    distributed: bool = False,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    resume: bool = False,
    learning_rate: float = 3e-4,
    print_every: int = 10,
    scan_chunk: int = 20,
    num_minibatches: int = 8,
    update_epochs: int = 2,
    gate_size: float = 5.0,
    max_episode_steps: int = 2000,
    frame_width: float = 0.35,
    torso: str = "patch",  # "patch" | "conv" (scan rollout)
    compute_dtype: str = "bf16",
    ent_coef: float = 0.01,  # pixels explore harder than state obs
    gate_onehot: bool = True,  # False: race from the pixels and the IMU alone
    frame_stack: int = 1,  # the last K depth frames as the pixel obs
    agent_collision_radius: float = 0.35,  # 0 turns contact off (curriculum)
    w_overtake: float = 0.0,  # reward per race position gained
    permute_spawns: bool = False,  # random spawn slot per agent and episode
    show_opponents: bool = True,  # False leaves the other agents out of the frame
    n_obstacles: int = 0,  # obstacle spheres orbiting the track (contact = crash)
    obstacle_period: int = 600,  # steps per obstacle revolution
    rollout: str = "auto",  # "kernel" (K8), "scan" (the per-step rollout) or
    #   "auto": the JAX trainer's rule (race_rollout)
    patch_pool: int = 1,
    adam_mu_dtype: Optional[str] = None,  # "bf16" stores Adam's first moment in bfloat16
    kernel_exact_logprob: bool = False,
    gru: int = 0,  # a GRU of this width between torso and heads, trained by
    #   the sequence-minibatched recurrent PPO (scan rollout)
    rig=None,
    device=None,  # CUDA unless "cpu" (the kernels' plain versions)
) -> TrainResult:
    """Gate racing from pixels: ``MultiRaceEnv`` whose observation is each
    agent's FPV depth view of the gate track (``VisionRaceEnv``), trained
    with the PPO recipe of ``train_vision``; every agent of every race acts
    through one shared net, and the metrics log gates passed.
    ``distributed`` splits the races over the job's ranks, whole races a
    rank, on the scan rollout without the GRU (as in JAX)."""
    rollout = race_rollout(rollout, n_agents=n_agents, torso=torso, gru=gru,
                           distributed=distributed)
    trainer = make_vision_race_trainer(
        num_envs=num_envs, num_steps=num_steps, seed=seed, rig=rig,
        learning_rate=learning_rate, num_minibatches=num_minibatches,
        update_epochs=update_epochs, gate_size=gate_size, max_episode_steps=max_episode_steps,
        frame_width=frame_width, compute_dtype=compute_dtype, ent_coef=ent_coef,
        gate_onehot=gate_onehot, frame_stack=frame_stack, n_obstacles=n_obstacles,
        obstacle_period=obstacle_period, patch_pool=patch_pool,
        kernel_exact_logprob=kernel_exact_logprob, n_agents=n_agents,
        agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
        permute_spawns=permute_spawns, show_opponents=show_opponents, torso=torso, gru=gru,
        adam_mu_dtype=adam_mu_dtype, rollout=rollout, device=device,
        mesh=_mesh(distributed, device))
    return _resume_and_train(trainer, resume=resume, checkpoint_dir=checkpoint_dir,
                             num_envs=num_envs * n_agents, num_steps=num_steps,
                             num_iterations=num_iterations, scan_chunk=scan_chunk,
                             log_dir=log_dir, print_every=print_every,
                             checkpoint_every=checkpoint_every)


def make_sac_trainer(num_envs: int = 1024, seed: int = 0, randomize: bool = False,
                     buffer_capacity: int = 500_000, batch_size: int = 2048,
                     updates_per_step: int = 8, hidden=(128, 128), device=None) -> Trainer:
    """train_sac's pieces, ready to run: the env bank on the default world,
    the SAC actor and critic, the learner. ``train_iteration(state,
    random_actions=False)`` is one ``train_step`` (one env step, its
    transitions stored, ``updates_per_step`` updates); no ``rollout_fn``.
    The generators (env reset, actor init, critic init, training, JAX's
    split order) live on the training device, so the env's reset draws and
    the learner's draws are made there, not copied from the host; the CPU
    and the card give different streams for one seed."""
    device = resolve_device(device)
    env = AcroEnv(params=DroneParams(att_mode="quat"), randomize=randomize)
    world = env.default_world(device)
    g_env, g_actor, g_critic, g_train = _generators(seed, device)
    actor = SquashedGaussianActor(action_dim=4, obs_dim=env.obs_dim, hidden=hidden,
                                  device=device).init_params(g_actor)
    critic = TwinQNetwork(obs_dim=env.obs_dim, action_dim=4, hidden=hidden,
                          device=device).init_params(g_critic)
    config = SacConfig(num_envs=num_envs, buffer_capacity=buffer_capacity,
                       batch_size=batch_size, updates_per_step=updates_per_step)

    def env_step(env_state, action, generator):
        st, obs, reward, _, info = env.step(env_state, action, world, generator=generator)
        # done = terminations only (bootstrap at time limits); the replay
        # stores the pre-reset successor at truncations, so the Q target
        # bootstraps from the true next state, not the respawn
        store_obs = torch.where(info["truncated"][..., None], info["final_obs"], obs)
        return st, obs, reward, info["crashed"], store_obs

    env_state, obs = env.reset(g_env, world, (num_envs,))
    init, train_step = make_sac(env_step, config, env.obs_dim, 4)
    return Trainer(init(actor, critic, env_state, obs, g_train), train_step, None)


def train_sac(
    num_envs: int = 1024,
    num_iterations: int = 4000,  # env steps (each = num_envs transitions)
    warmup_steps: int = 50,  # uniform-random exploration steps
    seed: int = 0,
    randomize: bool = False,
    buffer_capacity: int = 500_000,
    batch_size: int = 2048,
    updates_per_step: int = 8,  # synchronized collection over 1024 envs is
    #   data-rich and update-poor: the JAX package's recipe takes 8
    hidden=(128, 128),
    log_dir: Optional[str] = None,
    print_every: int = 100,
    scan_chunk: int = 100,  # env steps between host reads of the metrics
    device=None,  # CUDA unless "cpu"
) -> TrainResult:
    """Off-policy SAC on ``AcroEnv``: ``warmup_steps`` steps of uniform
    actions, then ``num_iterations`` iterations, each one synchronized env
    step over the bank (``num_envs`` transitions into the replay) and
    ``updates_per_step`` updates. Returns the rewards of the first and last
    iteration and the trained env-steps/s (transitions stored a second)
    after the first chunk. The metrics log holds the iterations JAX logs,
    every ``print_every``-th, and every iteration at ``print_every=0``
    (where JAX divides by zero). Like the JAX trainer it keeps no
    checkpoint."""
    trainer = make_sac_trainer(num_envs=num_envs, seed=seed, randomize=randomize,
                               buffer_capacity=buffer_capacity, batch_size=batch_size,
                               updates_per_step=updates_per_step, hidden=hidden, device=device)
    state = trainer.state
    for _ in range(warmup_steps):
        state, _ = trainer.train_iteration(state, random_actions=True)
    return _train_loop(state, trainer.train_iteration, num_envs=num_envs, num_steps=1,
                       num_iterations=num_iterations, start_iter=0, scan_chunk=scan_chunk,
                       log_dir=log_dir, print_every=print_every, checkpoint_dir=None,
                       checkpoint_every=1,
                       log_row=lambda it: print_every <= 0 or it % print_every == 0)


def _leading_leaf(tree) -> torch.Tensor:
    """The first tensor of a nested dict."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _tile(tree, n: int):
    """Every leaf of a state tree repeated along a new leading (n,) axis."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _tile(getattr(tree, f.name), n)
                             for f in dataclasses.fields(tree)})
    return tree.expand((n,) + tuple(tree.shape)).contiguous()


@dataclass
class EsTrainer:
    """train_es's pieces: the ES state (theta, sigma, best), ``run_chunk(state,
    n, generator)``, ``unravel(theta)``, the batched fitness, the training
    generator and the env-steps a generation."""

    state: object
    run_chunk: object
    unravel: object
    fitness: object
    generator: torch.Generator
    steps_per_generation: int


def make_es_trainer(env_name: str = "acro", num_envs: int = 256, num_steps: int = 60,
                    n_perturbations: int = 128, fitness_tail: Optional[int] = None,
                    seed: int = 0, randomize: bool = False, noise_std: float = 0.05,
                    learning_rate: float = 0.02, sigma_decay: float = 1.0, hidden=(64, 64),
                    device=None, mesh=None) -> EsTrainer:
    """train_es's pieces (arguments as :func:`train_es`'s). The fitness runs
    all 2P candidates at once: the env bank is (2P, num_envs), every step
    one batched forward of the candidates' nets (``actor_mean_batched``)
    and one eager env step over the whole bank. With common random numbers
    (the default) the reset draws are (num_envs,) and shared across the
    candidates, at the start and at every auto-reset, as in JAX every
    candidate's env i holds the same key. Over a ``mesh`` each rank runs
    its slice of the candidates (the bank's leading axis), and the draws
    shaped by the candidates are made for all 2P and sliced."""
    device = _device(device, mesh)
    if env_name == "acro":
        env = AcroEnv(params=DroneParams(att_mode="quat"), randomize=randomize)
        world = env.default_world(device)
        action_dim, obs_dim = 4, env.obs_dim

        def reset_fn(gen, shape, part):
            return env.reset(gen, world, shape, part=part)

        def step_fn(st, action, gen, reset_shape, part):
            return env.step(st, action, world, generator=gen, reset_shape=reset_shape, part=part)
    elif env_name == "rotate":
        env = RotateEnv()
        action_dim, obs_dim = 3, 18

        def reset_fn(gen, shape, part):
            return env.reset(gen, shape, device, part=part)

        def step_fn(st, action, gen, reset_shape, part):
            return env.step(st, action, gen, reset_shape=reset_shape, part=part)
    else:
        raise ValueError(f"unknown env for ES: {env_name!r}")

    g_net, g_train = _generators(seed, device)[:2]
    net = ActorCritic(action_dim=action_dim, obs_dim=obs_dim, hidden=hidden,
                      device=device).init_params(g_net)
    tail = num_steps if fitness_tail is None else min(fitness_tail, num_steps)
    part = _part(mesh, 2 * n_perturbations)

    def fitness(p, generator, common):
        cands = _leading_leaf(p).shape[0]  # this rank's candidates
        st, obs = (reset_fn(generator, (num_envs,), None) if common
                   else reset_fn(generator, (cands, num_envs), part))
        if common:
            st, obs = _tile(st, cands), _tile(obs, cands)
        rewards = []
        for _ in range(num_steps):
            mean = actor_mean_batched(p, obs.reshape(cands, num_envs, -1))
            st, obs, r, _, _ = step_fn(st, torch.tanh(mean), generator,
                                       (num_envs,) if common else None, part)
            rewards.append(r.mean(-1))
        return torch.stack(rewards)[-tail:].mean(0)

    init_state, run_chunk, unravel = make_policy_es(
        policy_params_to_numpy(net), fitness, n_perturbations=n_perturbations, noise_std=noise_std,
        learning_rate=learning_rate, sigma_decay=sigma_decay, mesh=mesh, device=device)
    return EsTrainer(init_state(), run_chunk, unravel, fitness, g_train,
                     2 * n_perturbations * num_envs * num_steps)


def train_es(
    env_name: str = "acro",
    num_envs: int = 256,  # eval envs per candidate (fitness batch)
    num_iterations: int = 400,  # generations
    num_steps: int = 60,  # rollout horizon per fitness evaluation
    n_perturbations: int = 128,  # population = 2x this (antithetic pairs)
    fitness_tail: Optional[int] = None,  # mean reward over the last N steps
    #   (None = the whole rollout)
    seed: int = 0,
    distributed: bool = False,
    randomize: bool = False,
    noise_std: float = 0.05,
    learning_rate: float = 0.02,
    sigma_decay: float = 1.0,
    hidden=(64, 64),
    log_dir: Optional[str] = None,
    print_every: int = 10,
    scan_chunk: int = 50,  # generations between host reads of the history
    device=None,  # CUDA unless "cpu"
) -> TrainResult:
    """Evolution strategies: gradient-free NES on the ``ActorCritic`` policy.
    Every generation evaluates 2 * n_perturbations candidate policies, each
    on its own ``num_envs`` envs, all at once; the policy is tanh of the
    actor's mean, as in PPO's nets, and the fitness the mean reward over the
    last ``fitness_tail`` steps. Returns the first and last generation's
    best fitness and the fitness rollouts' env-steps/s after the first
    chunk (of all candidates, on every rank). ``distributed`` splits the
    population over the job's ranks."""
    mesh = _mesh(distributed, device)
    trainer = make_es_trainer(env_name=env_name, num_envs=num_envs, num_steps=num_steps,
                              n_perturbations=n_perturbations, fitness_tail=fitness_tail,
                              seed=seed, randomize=randomize, noise_std=noise_std,
                              learning_rate=learning_rate, sigma_decay=sigma_decay,
                              hidden=hidden, device=device, mesh=mesh)

    def train_iteration(es_state):
        es_state, hist = trainer.run_chunk(es_state, 1, trainer.generator)
        return es_state, {"gen_best_fitness": hist[0]}

    return _train_loop(trainer.state, train_iteration, num_envs=trainer.steps_per_generation,
                       num_steps=1, num_iterations=num_iterations, start_iter=0,
                       scan_chunk=scan_chunk, log_dir=log_dir, print_every=print_every,
                       checkpoint_dir=None, checkpoint_every=1, reward_key="gen_best_fitness",
                       mesh=mesh)
