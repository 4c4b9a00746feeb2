"""The pixel trainers' scan rollout on the CPU: which rollout ``"auto"``
takes (held against the JAX trainers' own routing), the ``rollout="kernel"``
refusals, one iteration of every option the scan rollout brings (finite
losses), resume against an unbroken run with the curriculum's worlds and
the GRU's hidden in the checkpoint, and ``play_policy`` on conv and GRU
weights.

The routing test runs the JAX ``train_vision`` and ``train_vision_race``
themselves, stopped where they branch: their kernel paths
(``_train_vision_kernel``, ``_train_vision_race_kernel``) and the scan
paths' first use of ``PixelActorCritic`` are monkeypatched to report the
branch taken. The port's trainers are stopped at ``make_vision_trainer`` and
``make_vision_race_trainer``. Small sizes: a 32x24 rig, 8 envs, T = 4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpyv_tpu.apps.train as japp
import fpyv_tpu.models.policy as jpolicy
from fpyv_tpu.apps.play import play_policy as jplay
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.vision.camera import CameraRig as JRig
import fpyv_tpu_torch.apps.train as tapp
from fpyv_tpu_torch.apps.play import make_player, play_policy
from fpyv_tpu_torch.apps.train import train_vision, train_vision_race
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint
from fpyv_tpu_torch.vision.camera import CameraRig as TRig

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(32, 24))
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


class _Branch(Exception):
    pass


def _raise(branch):
    def stop(*args, **kwargs):
        raise _Branch(branch)
    return stop


def _jax_choice(fn, **kw) -> str:
    try:
        return fn(num_envs=2, num_iterations=1, rig=JRIG, **kw)
    except _Branch as b:
        return str(b)
    except ValueError:
        return "raises"


def _port_choice(fn, capsys, **kw):
    try:
        fn(num_envs=2, num_iterations=1, rig=TRIG, device="cpu", **kw)
        choice = "ran"
    except _Branch as b:
        choice = str(b)
    except ValueError:
        choice = "raises"
    return choice, capsys.readouterr().out


VISION_GRID = [dict(torso=t, renderer=r, target_only=o, curriculum_iters=c)
               for t in ("patch", "conv") for r in ("raycast", "raycast_pallas", "splat")
               for o in (False, True) for c in (None, 2)]
RACE_GRID = [dict(n_agents=a, torso=t, gru=g) for a in (1, 2) for t in ("patch", "conv")
             for g in (0, 8)]


@pytest.mark.parametrize("rollout", ["auto", "kernel"])
def test_vision_routing_matches_jax(rollout, monkeypatch, capsys):
    """``train_vision``: over torso x renderer x target_only x curriculum,
    the port takes the rollout JAX takes, raises where JAX raises, and
    ``auto`` prints its choice. One kept difference: ``rollout="kernel"``
    with ``target_only`` raises in the port (K7 renders the whole world),
    where JAX runs its kernel on the whole world."""
    monkeypatch.setattr(japp, "_train_vision_kernel", lambda **kw: "kernel")
    monkeypatch.setattr(jpolicy, "PixelActorCritic", _raise("scan"))
    monkeypatch.setattr(tapp, "make_vision_trainer", lambda **kw: _raise(kw["rollout"])())
    seen = set()
    for kw in VISION_GRID:
        want = _jax_choice(japp.train_vision, rollout=rollout, **kw)
        got, out = _port_choice(train_vision, capsys, rollout=rollout, **kw)
        if rollout == "kernel" and kw["target_only"] and want == "kernel":
            want = "raises"
        assert got == want, (kw, got, want)
        if rollout == "auto":
            assert out == f"train_vision: rollout='auto' takes the {got} rollout\n", out
        seen.add(got)
    # premise: the grid reaches both rollouts (auto) or both outcomes (kernel)
    assert seen == ({"kernel", "scan"} if rollout == "auto" else {"kernel", "raises"})
    # the fault repaired: raycast_pallas takes the scan, as in JAX
    assert _port_choice(train_vision, capsys, renderer="raycast_pallas")[0] == "scan"


@pytest.mark.parametrize("rollout", ["auto", "kernel"])
def test_race_routing_matches_jax(rollout, monkeypatch, capsys):
    """``train_vision_race``: over agents x torso x GRU, the port takes the
    rollout JAX takes, raises where JAX raises, and ``auto`` prints its
    choice."""
    monkeypatch.setattr(japp, "_train_vision_race_kernel", lambda **kw: "kernel")
    monkeypatch.setattr(jpolicy, "PixelActorCritic", _raise("scan"))
    monkeypatch.setattr(tapp, "make_vision_race_trainer", lambda **kw: _raise(kw["rollout"])())
    seen = set()
    for kw in RACE_GRID:
        want = _jax_choice(japp.train_vision_race, rollout=rollout, **kw)
        got, out = _port_choice(train_vision_race, capsys, rollout=rollout, **kw)
        assert got == want, (kw, got, want)
        if rollout == "auto":
            assert out == f"train_vision_race: rollout='auto' takes the {got} rollout\n", out
        seen.add(got)
    assert seen == ({"kernel", "scan"} if rollout == "auto" else {"kernel", "raises"})


@pytest.mark.parametrize("fn,kw,match", [
    (train_vision, dict(rollout="kernel", renderer="raycast_pallas"), "renderer='raycast'"),
    (train_vision, dict(rollout="kernel", renderer="splat"), "renderer='raycast'"),
    (train_vision, dict(rollout="kernel", torso="conv"), "torso='patch'"),
    (train_vision, dict(rollout="kernel", curriculum_iters=2), "curriculum"),
    (train_vision, dict(rollout="kernel", target_only=True), "target_only"),
    (train_vision, dict(curriculum_iters=2, randomize_worlds=False), "randomize_worlds"),
    (train_vision, dict(rollout="fused"), "rollout must be"),
    (train_vision_race, dict(rollout="kernel", gru=8), "gru runs on the scan"),
    (train_vision_race, dict(rollout="kernel", n_agents=2), "single-agent"),
    (train_vision_race, dict(rollout="kernel", torso="conv"), "torso='patch'"),
], ids=["raycast_pallas", "splat", "conv", "curriculum", "target_only",
        "curriculum-without-random-worlds", "unknown-rollout", "race-gru", "race-agents",
        "race-conv"])
def test_kernel_rollout_refusals(fn, kw, match):
    """JAX's own ``rollout="kernel"`` errors (and the curriculum's need for
    per-env worlds), raised before any env is built."""
    with pytest.raises(ValueError, match=match):
        fn(num_envs=8, num_iterations=1, device="cpu", **kw)


# ---------------------------------------------------------------------------
# One iteration of each option on the CPU
# ---------------------------------------------------------------------------


def _rows(log_dir):
    return [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]


# the first five were refusals until the scan rollout was ported
VISION_OPTIONS = {
    "rollout-scan": dict(rollout="scan"),
    "torso-conv": dict(torso="conv"),
    "curriculum": dict(curriculum_iters=2),
    "adam-bf16": dict(adam_mu_dtype="bf16"),
    "target-only": dict(target_only=True),
    "splat": dict(renderer="splat", target_only=True),
    "raycast_pallas": dict(renderer="raycast_pallas"),
    "round-2-recipe": dict(torso="conv", pixel_store="f32", update_epochs=4,
                           compute_dtype="f32"),
    "params-yaml-world": dict(rollout="scan", randomize_worlds=False),
}


@pytest.mark.parametrize("option", list(VISION_OPTIONS))
def test_train_vision_option_cpu_smoke(option, tmp_path):
    train_vision(num_envs=8, num_iterations=1, num_steps=4, seed=1, rig=TRIG, scan_chunk=1,
                 num_minibatches=2, log_dir=str(tmp_path), print_every=0, device="cpu",
                 **VISION_OPTIONS[option])
    rows = _rows(tmp_path)
    assert len(rows) == 1
    assert all(np.isfinite(rows[0][k]) for k in ("loss", "pg_loss", "v_loss", "approx_kl",
                                                 "mean_reward"))


# the first five were refusals until the scan rollout and the GRU were ported
RACE_OPTIONS = {
    "rollout-scan": dict(rollout="scan"),
    "torso-conv": dict(torso="conv"),
    "two-agents": dict(n_agents=2),
    "gru": dict(gru=64),
    "adam-bf16": dict(adam_mu_dtype="bf16"),
    "multi-agent-knobs": dict(n_agents=3, permute_spawns=True, w_overtake=1.0,
                              agent_collision_radius=0.0, show_opponents=False),
    "gru-conv-agents-stack": dict(n_agents=2, gru=16, torso="conv", frame_stack=2,
                                  n_obstacles=2),
}


@pytest.mark.parametrize("option", list(RACE_OPTIONS))
def test_train_vision_race_option_cpu_smoke(option, tmp_path):
    kw = RACE_OPTIONS[option]
    train_vision_race(num_envs=4, num_iterations=1, num_steps=4, seed=1, rig=TRIG,
                      scan_chunk=1, num_minibatches=2, max_episode_steps=6,
                      log_dir=str(tmp_path), print_every=0, device="cpu", **kw)
    rows = _rows(tmp_path)
    assert len(rows) == 1
    assert all(np.isfinite(rows[0][k]) for k in ("loss", "pg_loss", "v_loss", "approx_kl",
                                                 "mean_reward", "mean_gates_passed"))


# ---------------------------------------------------------------------------
# Resume against an unbroken run
# ---------------------------------------------------------------------------


def _equal_trees(a, b):
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) > 10
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _curriculum(tmp_path, name, iterations, resume=False):
    return train_vision(num_envs=8, num_iterations=iterations, num_steps=4, seed=2, rig=TRIG,
                        scan_chunk=1, num_minibatches=2, update_epochs=1, curriculum_iters=3,
                        compute_dtype="f32", checkpoint_dir=str(tmp_path / name),
                        checkpoint_every=2, resume=resume, print_every=0, device="cpu")


def test_curriculum_resume_matches_unbroken_run(tmp_path):
    """4 iterations with a resample before each (chunks of 1) against 2 + a
    resume for 2 more: the step-4 checkpoints, the worlds riding the carry
    included, are equal; the worlds moved between the checkpoints, and the
    obstacle count rose with the difficulty."""
    _curriculum(tmp_path, "whole", 4)
    _curriculum(tmp_path, "split", 2)
    _curriculum(tmp_path, "split", 2, resume=True)
    a = restore_checkpoint(str(tmp_path / "whole"), 4)
    b = restore_checkpoint(str(tmp_path / "split"), 4)
    assert a["update_count"] == b["update_count"] == 4
    _equal_trees(a, b)
    w2 = restore_checkpoint(str(tmp_path / "split"), 2)["env_state"][1]
    w4 = b["env_state"][1]
    assert not torch.equal(w2["cyl_center"], w4["cyl_center"])
    # chunk 1 at difficulty 1/3 (2 of 4 cylinders), chunk 3 at 1 (all 4)
    assert w2["cyl_active"].sum(-1).tolist() == [2] * 8
    assert w4["cyl_active"].sum(-1).tolist() == [4] * 8


def _gru_race(tmp_path, name, iterations, resume=False):
    return train_vision_race(num_envs=4, n_agents=2, gru=8, num_iterations=iterations,
                             num_steps=4, seed=2, rig=TRIG, scan_chunk=1, num_minibatches=2,
                             update_epochs=1, compute_dtype="f32", adam_mu_dtype="bf16",
                             max_episode_steps=6, checkpoint_dir=str(tmp_path / name),
                             checkpoint_every=2, resume=resume, print_every=0, device="cpu")


def test_gru_race_resume_matches_unbroken_run(tmp_path):
    """The recurrent learner, 2 agents a race, Adam's bf16 moment: 4
    iterations against 2 + a resume for 2 more; the step-4 checkpoints,
    the (env state, hidden) carry and the bf16 moments included, are
    equal."""
    _gru_race(tmp_path, "whole", 4)
    _gru_race(tmp_path, "split", 2)
    _gru_race(tmp_path, "split", 2, resume=True)
    a = restore_checkpoint(str(tmp_path / "whole"), 4)
    b = restore_checkpoint(str(tmp_path / "split"), 4)
    _equal_trees(a, b)
    hidden = b["env_state"][1]
    assert hidden.shape == (8, 8) and hidden.abs().max() > 1e-3
    assert not torch.equal(hidden, restore_checkpoint(str(tmp_path / "split"), 2)["env_state"][1])
    moments = [s["exp_avg"] for s in b["opt_state"]["state"].values()]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)


# ---------------------------------------------------------------------------
# play_policy on conv and GRU weights
# ---------------------------------------------------------------------------


def _tree(torso, gru, proprio, frame_stack=1):
    net = JNet(action_dim=4, torso=torso, gru=gru)
    shape = (1, 72, 96) if frame_stack == 1 else (1, frame_stack, 72, 96)
    args = [jnp.zeros(shape, jnp.float32), jnp.zeros((1, proprio), jnp.float32)]
    if gru:
        args.append(jnp.zeros((1, gru), jnp.float32))
    return jax.tree.map(np.asarray, net.init(jax.random.key(4), *args))


@pytest.mark.parametrize("case", ["conv-vision", "conv-vision_race", "gru-vision_race"])
def test_play_policy_plays_conv_and_gru(case):
    """Fresh conv and GRU weights at the default 96x72 rigs, 8 steps in
    chunks of 4: the JAX function's keys, finite values; a port state_dict
    gives the same run."""
    torso, env_name = case.split("-")
    if env_name == "vision":
        tree, kw = _tree("conv", 0, 5), dict(num_envs=2)
    else:
        gru = 16 if torso == "gru" else 0
        tree = _tree("conv" if torso == "conv" else "patch", gru, 11, frame_stack=2)
        kw = dict(num_envs=2, n_agents=2, frame_stack=2)
    ref = jplay(None, env_name=env_name, steps=8, chunk=4, params=tree, **kw)
    out = play_policy(env_name=env_name, steps=8, chunk=4, params=tree, device="cpu", **kw)
    assert set(out) == set(ref) and out["steps"] == 8
    assert np.isfinite(out["mean_reward_per_step"])
    net = make_player(env_name, tree, device="cpu", **kw).net
    assert net.torso == ("patch" if torso == "gru" else "conv") and bool(net.gru) == (torso == "gru")
    again = play_policy(env_name=env_name, steps=8, chunk=4, params=net.state_dict(),
                        device="cpu", **kw)
    assert again == out


def test_gru_play_zeroes_the_hidden_at_episode_ends():
    """A GRU player carries (env state, hidden) and zeroes the hidden rows
    of the agents whose episode ended, as training does."""
    tree = _tree("patch", 16, 11)
    player = make_player("vision_race", tree, num_envs=2, n_agents=2, device="cpu")
    real = player.env_step
    ended = torch.tensor([False, True, False, True])

    def env_step(st, action, generator):
        st, obs, r, crashed, extra = real(st, action, generator)
        return st, obs, r, ended, extra

    player.env_step = env_step
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        (st, hidden), obs = player.reset(g)
        assert hidden.shape == (4, 16) and not hidden.any()
        (st, hidden), obs, *_ = player.step((st, hidden), obs, g)
    assert not hidden[ended].any()
    assert hidden[~ended].abs().min() > 0.0
