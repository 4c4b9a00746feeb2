"""PPO trainers (mirrors ``fpyv_tpu.apps.train``'s ``train_acro``,
``train_race``, and ``train_vision`` and ``train_vision_race`` on their
kernel rollout paths).

``train_acro`` trains the state-observation ``ActorCritic`` on ``AcroEnv``
(quaternion attitude, the default world), and ``train_race`` one shared
``ActorCritic`` for every agent of ``MultiRaceEnv`` (a flat batch of
``num_envs * n_agents`` learner rows through ``make_shared_policy_env_step``,
gates passed in the metrics). Both step the eager env once a step inside
``make_ppo``'s per-step rollout (:func:`fpyv_tpu_torch.rl.ppo.make_step_rollout`),
as the JAX trainers step ``AcroEnv.step`` and the race env under
``jax.vmap``; the env hands the learner terminations only (crashes, not
time limits).

``train_vision`` trains ``PixelActorCritic(torso="patch")`` on per-env
randomized worlds with the policy-in-kernel rollout: every iteration is one
launch of K7 (render, actor, sample, env step for T steps over all envs,
:mod:`fpyv_tpu_torch.ops.policy_kernel`), the bootstrap frame through K5,
then the PyTorch PPO learner (:mod:`fpyv_tpu_torch.rl.ppo`). Checkpoints
hold the full state (params, Adam, env matrix, last obs, generator), so a
resumed run continues exactly as an unbroken one.

``train_vision_race`` trains the single-drone gate racer from pixels: a
frame-stacked ``PixelActorCritic`` over ``VisionRaceEnv``'s FPV view of the
gate track (with orbiting obstacles where asked), one launch of K8 an
iteration (:mod:`fpyv_tpu_torch.ops.race_kernel`), the bootstrap frame
through K5, then the same learner. Its PPO carry is (state matrix, frame
history), and checkpoints hold both.

Not ported yet, and refused with a ValueError instead of the JAX trainer's
silent fallback to its scan rollout (ROADMAP queue 1): the pixel trainers'
scan rollout, the conv torso, the target-only and splat views, the world
curriculum, Adam's bf16 first moment and multi-agent pixel racing (item 3),
the GRU (item 4), and multi-device training in every trainer (item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv, make_shared_policy_env_step
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv
from fpyv_tpu_torch.models.policy import ActorCritic, PixelActorCritic
from fpyv_tpu_torch.ops.policy_kernel import PP, acro_state_to_cols, make_kernel_vision_ppo_parts
from fpyv_tpu_torch.ops.race_kernel import make_kernel_race_ppo_parts
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.rl.ppo import PpoConfig, make_ppo, make_step_rollout, scan_train
from fpyv_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from fpyv_tpu_torch.utils.metrics import MetricsLogger
from fpyv_tpu_torch.utils.profiling import Throughput


@dataclass
class TrainResult:
    iterations: int
    mean_reward_first: float
    mean_reward_last: float
    steps_per_second: float


def _train_loop(state, train_iteration, *, num_envs, num_steps, num_iterations, start_iter,
                scan_chunk, log_dir, print_every, checkpoint_dir,
                checkpoint_every) -> TrainResult:
    """The chunked host loop: ``scan_chunk`` iterations, then ONE
    device-to-host read of their infos, which also ends the chunk's device
    work before the meter counts it. The first chunk is left out of the
    rate (warm-up)."""
    logger = MetricsLogger(log_dir, print_every=print_every)
    meter = Throughput()
    first_reward = last_reward = float("nan")
    it = start_iter
    end = start_iter + num_iterations
    first_chunk = True
    while it < end:
        n = min(scan_chunk, end - it)
        state, infos = scan_train(train_iteration, state, n)
        keys = list(infos)
        host = torch.stack([infos[k].to(torch.float32) for k in keys]).cpu().numpy()
        rewards = host[keys.index("mean_reward")].astype(np.float64)
        if first_chunk:
            first_reward = float(rewards[0])
            meter.reset()
            first_chunk = False
        else:
            meter.add(num_envs * num_steps * n)
        last_reward = float(rewards[-1])
        for i in range(n):
            logger.log(it + i, {k: host[j, i] for j, k in enumerate(keys)})
        it += n
        if checkpoint_dir and (it % checkpoint_every == 0 or it == end):
            save_checkpoint(checkpoint_dir, it, state)
    logger.close()
    return TrainResult(iterations=num_iterations, mean_reward_first=first_reward,
                       mean_reward_last=last_reward, steps_per_second=meter.rate())


def _generators(seed: int):
    """Four independent CPU generators (worlds, env resets, net init,
    training), as the JAX trainer splits its key four ways."""
    seeds = np.random.SeedSequence(seed).generate_state(4)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


@dataclass
class Trainer:
    """A trainer's pieces: the PPO state (the net, Adam, the env carry, the
    bootstrap obs, the generator), one iteration, and the rollout alone (T
    eager env steps, or one K7 or K8 launch and the bootstrap frame), which
    the iteration runs first."""

    state: object
    train_iteration: object
    rollout_fn: object


def make_vision_trainer(num_envs: int = 1024, num_steps: int = 32, seed: int = 0,
                        randomize_worlds: bool = True, rig=None, learning_rate: float = 3e-4,
                        num_minibatches: int = 8, update_epochs: int = 2,
                        compute_dtype: str = "bf16", patch_pool: int = 1,
                        kernel_exact_logprob: bool = False, device=None) -> Trainer:
    """train_vision's kernel path, ready to run: the env bank in its worlds,
    the net, the PPO learner around the K7 rollout (arguments as
    :func:`train_vision`'s)."""
    if compute_dtype not in ("bf16", "f32"):
        raise ValueError(f"compute_dtype must be 'bf16' or 'f32', got {compute_dtype!r}")
    cdt = torch.bfloat16 if compute_dtype == "bf16" else None
    device = resolve_device(device)
    # the kernel integrates attitude as a quaternion; the obs carries none
    venv = VisionAcroEnv(acro=AcroEnv(params=DroneParams(att_mode="quat")), renderer="raycast",
                         target_only=False, pixel_dtype="u8",
                         **({"rig": rig} if rig is not None else {}))
    g_world, g_env, g_net, g_train = _generators(seed)
    if randomize_worlds:
        worlds, bank = venv.make_randomized_worlds(g_world, num_envs, device=device)
    else:
        worlds, bank = venv.make_world(device=device)
    W, H = venv.rig.resolution
    net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PP, torso="patch",
                           prepatched=True, compute_dtype=cdt, patch_pool=patch_pool,
                           device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs, num_steps=num_steps, learning_rate=learning_rate,
                       num_minibatches=num_minibatches, update_epochs=update_epochs)
    apply_fn, make_rollout_fn, obs_from_cols = make_kernel_vision_ppo_parts(
        venv, worlds, net, num_envs)
    env_state, _ = venv.reset_batched(g_env, worlds, bank, num_envs)
    cols = acro_state_to_cols(env_state)
    rollout_fn = make_rollout_fn(num_steps, compute_dtype=cdt,
                                 exact_logprob=kernel_exact_logprob)
    init, train_iteration = make_ppo(apply_fn, None, config, rollout_fn=rollout_fn)
    return Trainer(init(net, cols, obs_from_cols(cols), g_train), train_iteration,
                         rollout_fn)


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP queue 1); the port trains the "
                      "kernel rollout: torso='patch', renderer='raycast', one device")


def _one_device_only() -> ValueError:
    return ValueError("distributed=True is not ported yet (ROADMAP queue 1 item 8: "
                      "multi-GPU); the port trains on one device")


def _resume_and_train(trainer: Trainer, *, resume, checkpoint_dir, **loop) -> TrainResult:
    state, start_iter = trainer.state, 0
    if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        start_iter = latest_step(checkpoint_dir)
        state = restore_checkpoint(checkpoint_dir, start_iter, template=state)
        print(f"resumed from checkpoint at iteration {start_iter}")
    return _train_loop(state, trainer.train_iteration, start_iter=start_iter,
                       checkpoint_dir=checkpoint_dir, **loop)


def _apply(net, obs):
    return net(obs)


def make_acro_trainer(num_envs: int = 4096, num_steps: int = 32, seed: int = 0,
                      randomize: bool = False, hidden=(128, 128), learning_rate: float = 3e-4,
                      shuffle_block: int = 64, device=None) -> Trainer:
    """train_acro's pieces, ready to run: the env bank on the default
    world, ``ActorCritic``, the PPO learner around the per-step rollout
    (arguments as :func:`train_acro`'s)."""
    device = resolve_device(device)
    env = AcroEnv(params=DroneParams(att_mode="quat"), randomize=randomize)
    world = env.default_world(device)
    _, g_env, g_net, g_train = _generators(seed)
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=hidden,
                      device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs, num_steps=num_steps, learning_rate=learning_rate,
                       shuffle_block=shuffle_block)

    def env_step(env_state, action, generator):
        st, obs, reward, _, info = env.step(env_state, action, world, generator=generator)
        # hand the learner terminations only: a time-limit truncation
        # bootstraps V(s') (the env still auto-resets on either)
        return st, obs, reward, info["crashed"]

    env_state, obs = env.reset(g_env, world, (num_envs,))
    rollout_fn = make_step_rollout(_apply, env_step, config)
    init, train_iteration = make_ppo(_apply, None, config, rollout_fn=rollout_fn)
    return Trainer(init(net, env_state, obs, g_train), train_iteration, rollout_fn)


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
    chunk."""
    if distributed:
        raise _one_device_only()
    trainer = make_acro_trainer(num_envs=num_envs, num_steps=num_steps, seed=seed,
                                randomize=randomize, hidden=hidden,
                                learning_rate=learning_rate, shuffle_block=shuffle_block,
                                device=device)
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
                      device=None) -> Trainer:
    """train_race's pieces, ready to run: the race bank on the default
    track, one shared ``ActorCritic``, the PPO learner over the flat
    ``num_envs * n_agents`` agent batch (arguments as :func:`train_race`'s)."""
    device = resolve_device(device)
    env = MultiRaceEnv(n_agents=n_agents, gate_size=gate_size,
                       max_episode_steps=max_episode_steps,
                       agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
                       others_in_obs=others_in_obs, permute_spawns=permute_spawns)
    world = env.default_world(device)
    env_step, reset_fn = make_shared_policy_env_step(env, world, n_envs=num_envs)
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
    rollout_fn = make_step_rollout(_apply, env_step, config)
    init, train_iteration = make_ppo(_apply, None, config, metrics_fn=race_metrics,
                                     rollout_fn=rollout_fn)
    return Trainer(init(net, env_state, obs, g_train), train_iteration, rollout_fn)


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
    passed and the gates per 100 steps."""
    if distributed:
        raise _one_device_only()
    trainer = make_race_trainer(
        num_envs=num_envs, n_agents=n_agents, num_steps=num_steps, seed=seed, hidden=hidden,
        learning_rate=learning_rate, gate_size=gate_size, max_episode_steps=max_episode_steps,
        agent_collision_radius=agent_collision_radius, w_overtake=w_overtake,
        others_in_obs=others_in_obs, permute_spawns=permute_spawns, device=device)
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
    renderer: str = "raycast",
    target_only: bool = False,
    compute_dtype: str = "bf16",  # actor compute: "bf16" | "f32"
    torso: str = "patch",
    curriculum_iters: Optional[int] = None,
    patch_pool: int = 1,  # consecutive patch embeddings mixed per fc block
    adam_mu_dtype: Optional[str] = None,
    kernel_exact_logprob: bool = False,  # True recomputes log_prob/value with
    #   the learner's forward over the stored obs (epoch-0 ratio exactly 1);
    #   False trusts the kernel's own, as the JAX trainer's default
    rollout: str = "auto",  # "auto" and "kernel": the K7 rollout
    device=None,  # CUDA unless "cpu" (the kernels' plain versions)
) -> TrainResult:
    """Pixels-to-action PPO on ``VisionAcroEnv``'s full-world depth view:
    every env in its own randomized world (``randomize_worlds``), or all in
    params.yaml's world. Returns the rewards of the first and last
    iteration and the trained env-steps/s after the first chunk."""
    if rollout not in ("auto", "kernel"):
        raise _not_ported(f"rollout={rollout!r}")
    if torso != "patch":
        raise _not_ported(f"torso={torso!r}")
    if renderer not in ("raycast", "raycast_pallas") or target_only:
        raise _not_ported(f"renderer={renderer!r}, target_only={target_only}")
    if distributed:
        raise _one_device_only()
    if curriculum_iters:
        raise _not_ported("curriculum_iters")
    if adam_mu_dtype is not None:
        raise _not_ported(f"adam_mu_dtype={adam_mu_dtype!r}")
    trainer = make_vision_trainer(
        num_envs=num_envs, num_steps=num_steps, seed=seed, randomize_worlds=randomize_worlds,
        rig=rig, learning_rate=learning_rate, num_minibatches=num_minibatches,
        update_epochs=update_epochs, compute_dtype=compute_dtype, patch_pool=patch_pool,
        kernel_exact_logprob=kernel_exact_logprob, device=device)
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
                             device=None) -> Trainer:
    """train_vision_race's kernel path, ready to run: the race bank on the
    default track, the frame-stacked net, the PPO learner around the K8
    rollout (arguments as :func:`train_vision_race`'s)."""
    if compute_dtype not in ("bf16", "f32"):
        raise ValueError(f"compute_dtype must be 'bf16' or 'f32', got {compute_dtype!r}")
    cdt = torch.bfloat16 if compute_dtype == "bf16" else None
    device = resolve_device(device)
    venv = VisionRaceEnv(
        race=MultiRaceEnv(n_agents=1, gate_size=gate_size, max_episode_steps=max_episode_steps,
                          n_obstacles=n_obstacles, obstacle_period=obstacle_period),
        frame_width=frame_width, gate_onehot=gate_onehot, frame_stack=frame_stack,
        **({"rig": rig} if rig is not None else {}))
    _, g_env, g_net, g_train = _generators(seed)
    world = venv.default_world(device)
    W, H = venv.rig.resolution
    net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PP, proprio_dim=5 + venv.n_gates,
                           torso="patch", prepatched=True, compute_dtype=cdt,
                           patch_pool=patch_pool, frame_stack=frame_stack,
                           device=device).init_params(g_net)
    config = PpoConfig(num_envs=num_envs, num_steps=num_steps, learning_rate=learning_rate,
                       num_minibatches=num_minibatches, update_epochs=update_epochs,
                       ent_coef=ent_coef)
    apply_fn, make_rollout_fn, obs_from_carry, init_carry, race_metrics = (
        make_kernel_race_ppo_parts(venv, world, net, num_envs))
    carry = init_carry(g_env)
    rollout_fn = make_rollout_fn(num_steps, compute_dtype=cdt,
                                 exact_logprob=kernel_exact_logprob)
    init, train_iteration = make_ppo(apply_fn, None, config, metrics_fn=race_metrics,
                                     rollout_fn=rollout_fn)
    return Trainer(init(net, carry, obs_from_carry(carry), g_train), train_iteration,
                         rollout_fn)


def train_vision_race(
    num_envs: int = 1024,
    n_agents: int = 1,
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
    torso: str = "patch",
    compute_dtype: str = "bf16",
    ent_coef: float = 0.01,  # pixels explore harder than state obs
    gate_onehot: bool = True,  # False: race from the pixels and the IMU alone
    frame_stack: int = 1,  # the last K depth frames as the pixel obs
    n_obstacles: int = 0,  # obstacle spheres orbiting the track (contact = crash)
    obstacle_period: int = 600,  # steps per obstacle revolution
    rollout: str = "auto",  # "auto" and "kernel": the K8 rollout
    patch_pool: int = 1,
    adam_mu_dtype: Optional[str] = None,
    kernel_exact_logprob: bool = False,
    gru: int = 0,
    rig=None,
    device=None,  # CUDA unless "cpu" (the kernels' plain versions)
) -> TrainResult:
    """Gate racing from pixels: the single-drone ``MultiRaceEnv`` whose
    observation is the FPV depth view of the gate track
    (``VisionRaceEnv``), trained with the PPO recipe of ``train_vision``;
    the metrics log gates passed. The multi-agent knobs of the JAX trainer
    (collision radius, overtake reward, spawn permutation, opponents in
    view) come with ``n_agents > 1``, which is not ported yet."""
    if rollout not in ("auto", "kernel"):
        raise _not_ported(f"rollout={rollout!r}")
    if n_agents != 1:
        raise _not_ported(f"n_agents={n_agents} (multi-agent racing)")
    if gru:
        raise _not_ported(f"gru={gru} (recurrent PPO)")
    if torso != "patch":
        raise _not_ported(f"torso={torso!r}")
    if distributed:
        raise _one_device_only()
    if adam_mu_dtype is not None:
        raise _not_ported(f"adam_mu_dtype={adam_mu_dtype!r}")
    trainer = make_vision_race_trainer(
        num_envs=num_envs, num_steps=num_steps, seed=seed, rig=rig,
        learning_rate=learning_rate, num_minibatches=num_minibatches,
        update_epochs=update_epochs, gate_size=gate_size, max_episode_steps=max_episode_steps,
        frame_width=frame_width, compute_dtype=compute_dtype, ent_coef=ent_coef,
        gate_onehot=gate_onehot, frame_stack=frame_stack, n_obstacles=n_obstacles,
        obstacle_period=obstacle_period, patch_pool=patch_pool,
        kernel_exact_logprob=kernel_exact_logprob, device=device)
    return _resume_and_train(trainer, resume=resume, checkpoint_dir=checkpoint_dir,
                             num_envs=num_envs, num_steps=num_steps,
                             num_iterations=num_iterations, scan_chunk=scan_chunk,
                             log_dir=log_dir, print_every=print_every,
                             checkpoint_every=checkpoint_every)
