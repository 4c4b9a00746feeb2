"""The ranks' side of the multi-process tests (``tests/test_torch_dist_*.py``
and the card case in ``tests/test_torch_cuda.py``): module-level functions
that ``fpyv_tpu_torch.parallel.launch`` pickles into spawned ranks. Each
takes the rank's mesh first and returns numpy. Torch and the port only: the
JAX references stay in the test files.

A function that takes ``mesh=None`` runs the single-process program the
ranks are held against (no ``part``, no process group).
"""

from __future__ import annotations

import numpy as np
import torch

from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.base import take_part, tree_map_tensors
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv, make_shared_policy_env_step
from fpyv_tpu_torch.models.policy import ActorCritic, PixelActorCritic, actor_mean_batched
from fpyv_tpu_torch.parallel.mesh import pmean_tree, replicate, shard_leading_axis
from fpyv_tpu_torch.parallel.train import local_config, make_distributed_ppo, shard_ppo_state
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.rl import ppo as tppo
from fpyv_tpu_torch.rl.es import make_policy_es
from fpyv_tpu_torch.rl.ppo import (
    PpoConfig,
    Transition,
    make_recurrent_ppo,
    make_recurrent_rollout,
)

OBS = 17  # AcroEnv's observation width (quaternion attitude)
HIDDEN = (16, 16)


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _params(net) -> dict:
    return interop.policy_params_to_numpy(net)


def _floats(info) -> dict:
    return {k: float(v) for k, v in info.items()}


# ---------------------------------------------------------------------------
# The averaged update against JAX's shard_map'd learners
# ---------------------------------------------------------------------------


def ppo_update(mesh, params, traj, last_obs, kw):
    """One ``make_distributed_ppo`` iteration of ``ActorCritic`` on this
    rank's envs of a fixed trajectory (numpy, (T, N, ...); ``last_obs``
    (N, ...)): the parameters, the averaged info and the global norms the
    clip saw."""
    net = ActorCritic(action_dim=4, obs_dim=OBS, hidden=HIDDEN, device="cpu")
    net.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    lo, hi, _ = mesh.part(last_obs.shape[0])
    last_obs = last_obs[lo:hi]
    t = {k: torch.from_numpy(v[:, lo:hi]) for k, v in traj.items()}
    ttraj = Transition(obs=t["obs"], action=t["action"], log_prob=t["log_prob"],
                       value=t["value"], reward=t["reward"], done=t["done"])
    tlast = torch.from_numpy(last_obs)
    norms = []
    real_clip = tppo.clip_by_global_norm_

    def clip_spy(ps, max_norm):
        norm = real_clip(ps, max_norm)
        norms.append(norm.item())
        return norm

    tppo.clip_by_global_norm_ = clip_spy
    init, iteration = make_distributed_ppo(
        lambda m, o: m(o), None, PpoConfig(**kw), mesh,
        rollout_fn=lambda s: (s.env_state, tlast, ttraj))
    state = init(replicate(net, mesh), torch.zeros(1), tlast, torch.Generator().manual_seed(0))
    state, info = iteration(state)
    return _params(state.params), _floats(info), norms


T_R, GRU, HW = 6, 8, (8, 16)  # the recurrent toy: two 8x8 patches
_grid = np.random.default_rng(7).normal(size=(2,) + HW).astype(np.float32)


def toy(xp):
    """``tests/test_torch_recurrent.py``'s toy env in either framework
    (``xp`` = jnp or torch): a point pushed by the first two action
    components; reward -|x|^2; done where |x|^2 > 0.5, which resets x to 0.
    Obs: pixels linear in x, and x."""
    grid = torch.from_numpy(_grid) if xp is torch else xp.asarray(_grid)

    def obs(x):
        return {"pixels": x[:, 0, None, None] * grid[0] + x[:, 1, None, None] * grid[1],
                "proprio": x}

    def step(x, action):
        x = x + 0.25 * action[:, :2]
        reward = -xp.sum(x * x, -1)
        done = reward < -0.5
        x = xp.where(done[:, None], xp.zeros_like(x), x)
        return x, obs(x), reward, done

    return obs, step


def recurrent_update(mesh, params, x0, noises, perms, kw):
    """One ``make_recurrent_ppo`` iteration with ``axis_name`` on this
    rank's rows of the toy bank ``x0`` (the whole bank's). ``noises``: the
    whole bank's action noise a step (each shard's JAX draws side by side),
    drawn through the seam at the global shape and sliced; ``perms``: this
    rank's epoch permutations (``perms[rank]``). Returns the parameters, the final (x,
    hidden) and the averaged info."""
    tnet = PixelActorCritic(action_dim=4, n_patches=2, proprio_dim=2, torso="patch", gru=GRU,
                            compute_dtype=None, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    obs_fn, step = toy(torch)
    noise_q = [torch.from_numpy(v) for v in noises]
    perm_q = [torch.from_numpy(p.astype(np.int64)) for p in perms[mesh.rank]]

    def noise(mean, gen):
        out = noise_q.pop(0)
        assert out.shape == mean.shape, (out.shape, mean.shape)  # the global template
        return out

    tppo.action_noise = noise
    tppo.permutation = lambda m, gen, device: perm_q.pop(0)
    n = x0.shape[0]
    cfg = local_config(PpoConfig(num_envs=n, num_steps=T_R, **kw), mesh)

    def apply_fn(net, obs, h):
        return net(obs["pixels"], obs["proprio"], h)

    def env_step(x, a, gen):
        return step(x, a)

    rollout = make_recurrent_rollout(apply_fn, env_step, cfg, part=mesh.part(n))
    init, iteration = make_recurrent_ppo(apply_fn, None, cfg, rollout_fn=rollout)
    x = shard_leading_axis(torch.from_numpy(x0), mesh)
    state = init(tnet, x, obs_fn(x), torch.zeros((x.shape[0], GRU)),
                 torch.Generator().manual_seed(0))
    state, info = iteration(state)
    assert not noise_q and not perm_q  # every draw consumed, none more
    return _params(state.params), _numpy(state.env_state), _floats(pmean_tree(info, mesh))


# ---------------------------------------------------------------------------
# Layout independence: fixed-action rollouts
# ---------------------------------------------------------------------------


def acro_layout(mesh, n, steps, max_episode_steps, device="cpu"):
    """``steps`` fixed-action steps of this rank's rows of an ``n``-env
    ``AcroEnv`` bank (episodes of ``max_episode_steps``, so the envs
    reset on the way): rewards, positions and done flags a step."""
    part = None if mesh is None else mesh.part(n)
    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=max_episode_steps)
    world = env.default_world(device)
    gen = torch.Generator().manual_seed(3)
    state, _ = env.reset(gen, world, (n,))
    state = take_part(state, part)
    action = torch.zeros((state.t.shape[0], 4), device=device)
    action[:, 3] = -0.6
    rewards, pos, done = [], [], []
    for _ in range(steps):
        state, _, r, d, _ = env.step(state, action, world, generator=gen, part=part)
        rewards.append(r)
        pos.append(state.drone.pos)
        done.append(d)
    return _numpy((torch.stack(rewards), torch.stack(pos), torch.stack(done)))


def race_layout(mesh, n_races, n_agents, steps, device="cpu"):
    """``steps`` fixed-action steps of this rank's whole races of the
    shared-policy race bank: rewards, positions and gate counters a step."""
    env = MultiRaceEnv(n_agents=n_agents, max_episode_steps=8)
    world = env.default_world(device)
    part = None if mesh is None else mesh.part(n_races)
    env_step, reset_fn = make_shared_policy_env_step(env, world, n_envs=n_races, part=part)
    gen = torch.Generator().manual_seed(4)
    state, _ = reset_fn(gen)
    state = take_part(state, part)
    rows = state.t.shape[0] * n_agents
    action = torch.tensor([[0.0, 0.2, 0.0, -0.3]], device=device).expand(rows, 4)
    rewards, pos, gates = [], [], []
    for _ in range(steps):
        state, _, r, _ = env_step(state, action, gen)
        rewards.append(r)
        pos.append(state.drones.pos)
        gates.append(state.gates_passed)
    return _numpy((torch.stack(rewards), torch.stack(pos), torch.stack(gates)))


def first_rollout(mesh, n):
    """The first PPO rollout of ``train_acro``'s trainer with its net (this
    rank's rows): the transitions and the last observation."""
    from fpyv_tpu_torch.apps.train import make_acro_trainer

    trainer = make_acro_trainer(num_envs=n, num_steps=6, hidden=HIDDEN, device="cpu", mesh=mesh)
    _, last_obs, traj = trainer.rollout_fn(trainer.state)
    return _numpy((traj.obs, traj.action, traj.log_prob, traj.value, traj.reward, traj.done,
                   last_obs))


# ---------------------------------------------------------------------------
# dryrun_multichip's four sub-checks
# ---------------------------------------------------------------------------


def _local_infos():
    """Spy on the info average: the list it fills with this rank's info
    before each average."""
    from fpyv_tpu_torch.parallel import train as ptrain

    seen, real = [], ptrain.pmean_tree

    def spy(info, mesh):
        seen.append(_floats(info))
        return real(info, mesh)

    ptrain.pmean_tree = spy
    return seen


def dryrun_acro(mesh, n_envs):
    """One ``make_distributed_ppo`` iteration of ``ActorCritic`` on the acro
    bank: the averaged info, this rank's own info, the parameters."""
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    world = env.default_world("cpu")
    part = mesh.part(n_envs)

    def env_step(env_state, action, generator):
        st, obs, reward, done, _ = env.step(env_state, action, world, generator=generator,
                                            part=part)
        return st, obs, reward, done

    seen = _local_infos()
    config = PpoConfig(num_envs=n_envs, num_steps=4, update_epochs=1, num_minibatches=2)
    init, iteration = make_distributed_ppo(lambda m, o: m(o), env_step, config, mesh)
    env_state, obs = env.reset(torch.Generator().manual_seed(0), world, (n_envs,))
    net = ActorCritic(action_dim=4, obs_dim=OBS, hidden=(32, 32), device="cpu").init_params(
        torch.Generator().manual_seed(1 + mesh.rank))  # rank 0's weights win the broadcast
    state = shard_ppo_state(init(net, env_state, obs, torch.Generator().manual_seed(2)), mesh)
    state, info = iteration(state)
    return _floats(info), seen[-1], _params(state.params)


def vision_rig():
    from fpyv_tpu_torch.vision.camera import CameraRig

    return CameraRig(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                     resolution=(32, 24))


def dryrun_vision(mesh, n_envs):
    """One iteration of ``train_vision``'s scan trainer over the mesh: the
    pytree observation ({pixels, rates, accel_z, thrust}, uint8 pixels) and
    the ``(env_state, worlds)`` carry. The averaged info, this rank's own
    info, the parameters, this rank's worlds' target centres and the
    observation's keys."""
    from fpyv_tpu_torch.apps.train import make_vision_trainer

    seen = _local_infos()
    trainer = make_vision_trainer(num_envs=n_envs, num_steps=4, rig=vision_rig(),
                                  num_minibatches=2, update_epochs=1, compute_dtype="f32",
                                  rollout="scan", device="cpu", mesh=mesh)
    keys = sorted(trainer.state.last_obs)
    assert trainer.state.last_obs["pixels"].dtype == torch.uint8
    state, info = trainer.train_iteration(trainer.state)
    return (_floats(info), seen[-1], _params(state.params),
            _numpy(state.env_state[1].sphere_center), keys)


def dryrun_es(mesh, n_perturbations, generations):
    """``make_policy_es`` with the population split over the mesh (``mesh``
    None: one process) on the acro env: theta and the generation-best
    fitness a generation."""
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    world = env.default_world("cpu")
    net = ActorCritic(action_dim=4, obs_dim=OBS, hidden=(16,), device="cpu").init_params(
        torch.Generator().manual_seed(8))
    part = None if mesh is None else mesh.part(2 * n_perturbations)

    def fitness(p, generator, common):
        # the shared episodes of all 2P candidates, this rank's rows of them
        st, obs = env.reset(generator, world, (4,))
        st, obs = take_part(_tile((st, obs), 2 * n_perturbations), part)
        rewards = []
        for _ in range(3):
            mean = actor_mean_batched(p, obs)
            st, obs, r, _, _ = env.step(st, torch.tanh(mean), world, generator=generator,
                                        reset_shape=(4,))
            rewards.append(r.mean(-1))
        return torch.stack(rewards).mean(0)

    init_state, run_chunk, _ = make_policy_es(_params(net), fitness,
                                              n_perturbations=n_perturbations, mesh=mesh,
                                              device="cpu")
    state, hist = run_chunk(init_state(), generations, torch.Generator().manual_seed(9))
    return _numpy(state[0]), _numpy(hist)


def _tile(tree, n):
    return tree_map_tensors(lambda x: x.expand((n,) + tuple(x.shape)).contiguous(), tree)


def dryrun_race(mesh, n_races, n_agents):
    """One shared-policy race iteration over the mesh: the ``MultiRaceState``
    carry split on the race axis, the learner on the flat race-major agent
    batch. The averaged info, this rank's own info, the parameters and the
    shape of this rank's carry."""
    env = MultiRaceEnv(n_agents=n_agents, max_episode_steps=64)
    world = env.default_world("cpu")
    env_step, reset_fn = make_shared_policy_env_step(env, world, n_envs=n_races,
                                                     part=mesh.part(n_races))
    seen = _local_infos()
    config = PpoConfig(num_envs=n_races * n_agents, num_steps=4, update_epochs=1,
                       num_minibatches=2)

    def race_metrics(env_state):
        return {"mean_gates_passed": env_state.gates_passed.to(torch.float32).mean()}

    init, iteration = make_distributed_ppo(lambda m, o: m(o), env_step, config, mesh,
                                           metrics_fn=race_metrics)
    state0, obs0 = reset_fn(torch.Generator().manual_seed(10))
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=(32, 32),
                      device="cpu").init_params(torch.Generator().manual_seed(11))
    state = shard_ppo_state(init(net, state0, obs0, torch.Generator().manual_seed(12)), mesh)
    state, info = iteration(state)
    return (_floats(info), seen[-1], _params(state.params),
            tuple(state.env_state.gates_passed.shape))


# ---------------------------------------------------------------------------
# Resume and the curriculum
# ---------------------------------------------------------------------------


def resume_runs(mesh, root):
    """``train_acro(distributed=True)``: 4 iterations in one run, and 2 + a
    resume for 2 more, each rank checkpointing its shard under ``root``."""
    from fpyv_tpu_torch.apps.train import train_acro

    def run(name, iterations, resume=False):
        return train_acro(num_envs=8, num_iterations=iterations, num_steps=4, seed=5,
                          scan_chunk=1, hidden=HIDDEN, checkpoint_dir=f"{root}/{name}",
                          checkpoint_every=2, resume=resume, print_every=0,
                          distributed=True, device="cpu")

    run("whole", 4)
    run("split", 2)
    run("split", 2, resume=True)
    return mesh.rank


def curriculum_slice(mesh, n_envs, seed, it):
    """The curriculum hook of ``train_vision``'s scan trainer over the mesh,
    at iteration ``it``: this rank's new worlds (all fields)."""
    import dataclasses

    from fpyv_tpu_torch.apps.train import make_vision_trainer

    trainer = make_vision_trainer(num_envs=n_envs, num_steps=2, seed=seed, rig=vision_rig(),
                                  compute_dtype="f32", curriculum_iters=4, rollout="scan",
                                  device="cpu", mesh=mesh)
    worlds = trainer.chunk_hook(trainer.state, it).env_state[1]
    return {f.name: _numpy(getattr(worlds, f.name)) for f in dataclasses.fields(worlds)}
