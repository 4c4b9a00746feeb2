"""The bf16 patch actor of K7 and K8 on the tensor cores: what its summation
order may move, and the host-side layout code around it.

The bf16 kernels sum the embed's and the fc's float32 products on the tensor
cores (``mma.sync``, ``csrc/actor.cuh``) in the hardware's order: within a
16-wide k-block in one order, then block after block into the accumulator.
The plain version (``policy_forward_reference``) sums in row order. Both
round to bf16 after the embed and the fc, so a sum that lands by an ulp on
the other side of a bf16 rounding boundary moves an embedding or a hidden
unit by one bf16 step. ``test_summation_order_moves_heads_within_tolerance``
runs the plain actor at the trainers' real widths (108 patches, embed 128,
hidden 256; K7's 1 frame with 5 proprio, K8's 4 frames with 5 + 6) under
both orders, with the card tests' nets (a mean head scaled by 30), and holds
the mean and value to ``TOL_BF16_HEADS``: the tolerance the card checks use
for the bf16 kernels (tests/test_torch_cuda.py, chip_smoke.py). 1e-3, the
plain layout's, does not hold: over 1024 rows at K = 4 the value moved by up
to 1.2e-3 (the mean 3.4e-4); the constant keeps a margin of about 3 for the
card's 32x more rows. Here 256 rows keep the test to a few seconds.

No JAX here: the plain version is held against the Pallas kernels in
tests/test_torch_policy_kernel.py and tests/test_torch_race_kernel.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fpyv_tpu_torch.apps.train import train_vision_race
from fpyv_tpu_torch.models.policy import PixelActorCritic
from fpyv_tpu_torch.ops import policy_kernel as pk
from fpyv_tpu_torch.ops import race_kernel as rk
from fpyv_tpu_torch.vision.camera import CameraRig

NP, HW = 108, 96 * 72  # the 96x72 rig's 8x8 patches
N_ENVS = 256


def _net(K, n_prop, seed):
    net = PixelActorCritic(action_dim=4, n_patches=NP, proprio_dim=n_prop, torso="patch",
                           prepatched=True, compute_dtype=torch.bfloat16, frame_stack=K,
                           device="cpu").init_params(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # as the card tests: a mean head that steers
        net.pi_mean.weight.mul_(30.0)
    return pk.build_policy_weights(net, torch.bfloat16)


def _blocked_forward(w, levels, proprio, block=16):
    """The actor as the tensor cores sum it (pool 1): each product's k-blocks
    of ``block`` summed on their own, the blocks then added one after the
    other; rounding, bias and heads as ``policy_forward_reference``."""
    f = torch.float32

    def rnd(x):
        return x.to(torch.bfloat16).to(f)

    def blocked(x, wt):  # (..., k) @ (k, out), block by block
        acc = torch.zeros(x.shape[:-1] + (wt.shape[1],), dtype=f)
        for k0 in range(0, wt.shape[0], block):
            acc = acc + x[..., k0:k0 + block] @ wt[k0:k0 + block]
        return acc

    n = levels.shape[0]
    x = rnd(levels / torch.tensor(255.0)).reshape(n, NP, w.we.shape[0])
    emb = torch.clamp_min(rnd(rnd(blocked(x, w.we.to(f))) + w.be.to(f)[0]), 0.0)
    fc_in = emb.reshape(n, -1)
    wf = w.wf.to(f)
    acc = blocked(fc_in, wf[:fc_in.shape[1]])
    for i in range(len(proprio)):
        acc = acc + rnd(proprio[i])[:, None] * wf[fc_in.shape[1] + i]
    h = torch.clamp_min(rnd(rnd(acc) + w.bf.to(f)[0]), 0.0)
    mm = torch.zeros(n, 5, dtype=f)
    for j in range(h.shape[1]):
        mm = mm + h[:, j:j + 1] * w.wm[j, :5]
    return mm + w.bm[0, :5]


@pytest.fixture
def one_thread():
    """The plain actor is ~14K small ops a call: with the suite's workers
    sharing the cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,n_prop", [(1, 5), (4, 11)])  # K7; K8 with 6 gates
def test_summation_order_moves_heads_within_tolerance(one_thread, K, n_prop):
    rng = np.random.default_rng(K)
    w = _net(K, n_prop, seed=K)
    levels = torch.from_numpy(rng.integers(0, 256, size=(N_ENVS, NP * K * 64)).astype(np.float32))
    proprio = [torch.from_numpy(rng.normal(size=N_ENVS).astype(np.float32))
               for _ in range(n_prop)]
    row = pk.policy_forward_reference(w, levels, proprio, 1)
    blk = _blocked_forward(w, levels, proprio)
    err = (row - blk).abs()
    assert (err > 0).any()  # premise: the two orders differ somewhere
    assert err[:, :4].max().item() <= pk.TOL_BF16_HEADS  # mean
    assert err[:, 4].max().item() <= pk.TOL_BF16_HEADS  # value


@pytest.mark.parametrize("ki,h", [(16, 16), (64, 32), (NP * 128, 256)])
def test_fragment_order_is_a_bijection(ki, h):
    w = torch.arange(ki * h, dtype=torch.float32).reshape(ki, h)
    f = pk.fragment_order_fc(w)
    assert f.shape == (h // 16, ki // 16, 32, 8)
    assert torch.equal(torch.sort(f.reshape(-1)).values, w.reshape(-1))  # each value once
    assert torch.equal(pk.fc_from_fragment_order(f), w)


def test_fragment_order_matches_the_mma_a_fragment():
    """Lane l of tile (m, k) holds A = wᵀ's registers a0..a3: rows g and
    g + 8 (hidden), columns 2t, 2t + 1 and 2t + 8, 2t + 9 (fc input), with
    g = l // 4, t = l % 4, each register's lower column first."""
    w = torch.randn(32, 48)
    f = pk.fragment_order_fc(w)
    for m, k, lane in [(0, 0, 0), (1, 1, 5), (2, 0, 31), (0, 1, 18)]:
        g, t = lane // 4, lane % 4
        hr, kc = 16 * m, 16 * k
        want = [w[kc + 2 * t, hr + g], w[kc + 2 * t + 1, hr + g],
                w[kc + 2 * t, hr + g + 8], w[kc + 2 * t + 1, hr + g + 8],
                w[kc + 2 * t + 8, hr + g], w[kc + 2 * t + 9, hr + g],
                w[kc + 2 * t + 8, hr + g + 8], w[kc + 2 * t + 9, hr + g + 8]]
        assert torch.equal(f[m, k, lane], torch.stack(want))


def test_fragment_order_refuses_ragged_rows():
    with pytest.raises(ValueError, match="multiples of 16"):
        pk.fragment_order_fc(torch.zeros(24, 16))


def test_build_policy_weights_adds_the_fragment_copy_in_bf16_only():
    w = _net(2, 11, seed=0)
    rows = NP * 128
    assert w.wf.shape[0] > rows  # the proprio rows follow the patch rows
    assert torch.equal(pk.fc_from_fragment_order(w.wf_tc), w.wf[:rows])
    pk.check_tc_weights(w, rows)
    with pytest.raises(ValueError, match="fragment order"):
        pk.check_tc_weights(dataclasses.replace(w, wf_tc=None), rows)
    net = PixelActorCritic(action_dim=4, n_patches=12, torso="patch", prepatched=True,
                           device="cpu").init_params(torch.Generator().manual_seed(0))
    assert pk.build_policy_weights(net, None).wf_tc is None


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [0, 3])
@pytest.mark.parametrize("pool", [1, 4])
def test_k8_bf16_layout_fits_every_trainer_recipe(K, S, pool):
    batch = rk.race_actor_batch(HW, K, S, 6, 256, pool)
    assert batch and batch % pool == 0 and NP % batch == 0
    shared = rk.race_shared_bytes(HW, K, S, 6, 256, pool, batch)
    assert shared <= rk.SHARED_LIMIT
    # the levels tile holds the batch's stacks: it grows with K, the
    # older frames themselves stay in device memory
    if K > 1:
        assert shared - rk.race_shared_bytes(HW, K - 1, S, 6, 256, pool, batch) == (
            2 * 64 * (128 + batch * 8))
    # batch 0 is the float32 layout, the default
    assert rk.race_shared_bytes(HW, K, S, 6, 256, pool) == rk.race_shared_bytes(
        HW, K, S, 6, 256, pool, 0)


def test_bf16_layouts_refuse_what_does_not_fit():
    assert rk.race_actor_batch(640 * 480, 1, 0, 6, 256, 1) == 0
    n_phys = 5 + 6 * 4  # 1 sphere, 4 cylinders
    assert pk.actor_batch(4800, 1, lambda b: pk.policy_shared_bytes(
        640 * 480, 30, n_phys, 256, 1, b)) == 0
    # K7 at the trainer's rig: a batch of 12 patches, under the limit
    batch = pk.actor_batch(NP, 1, lambda b: pk.policy_shared_bytes(HW, 30, n_phys, 256, 1, b))
    assert batch == pk.MAX_BATCH
    assert pk.policy_shared_bytes(HW, 30, n_phys, 256, 1, batch) <= pk.SHARED_LIMIT


def test_actor_batch_is_a_multiple_of_the_pool_dividing_the_patches():
    assert pk.actor_batch(108, 1, lambda b: 0) == 12
    assert pk.actor_batch(108, 4, lambda b: 0) == 12
    assert pk.actor_batch(12, 3, lambda b: 0) == 12
    assert pk.actor_batch(20, 1, lambda b: 0) == 10
    assert pk.actor_batch(108, 1, lambda b: b * 20_000) == 9  # the largest that fits
    assert pk.actor_batch(108, 4, lambda b: b * 60_000) == 0


def test_cpu_race_rollout_ignores_the_fragment_copy():
    """The plain version reads wf itself: the fragment-order copy changes
    nothing on the CPU."""
    from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
    from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv

    rig = CameraRig(resolution=(32, 24))
    venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=1, max_episode_steps=4, n_obstacles=3),
                         rig=rig, frame_stack=2)
    world = venv.default_world("cpu")
    g = torch.Generator().manual_seed(0)
    st, _ = venv.race.reset(g, world, (8,))
    hist = torch.randint(0, 256, (8, 12 * 64), generator=g, dtype=torch.uint8)
    net = PixelActorCritic(action_dim=4, n_patches=12, proprio_dim=11, torso="patch",
                           prepatched=True, compute_dtype=torch.bfloat16, frame_stack=2,
                           device="cpu").init_params(g)
    w = pk.build_policy_weights(net, torch.bfloat16)
    cols = rk.race_state_to_cols(st)
    a = rk.fused_race_vision_rollout(venv, cols, hist, world, w, 6, 3)
    b = rk.fused_race_vision_rollout(venv, cols, hist, world,
                                     dataclasses.replace(w, wf_tc=None), 6, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_train_vision_race_cpu_bf16():
    res = train_vision_race(num_envs=16, num_iterations=2, num_steps=4, frame_stack=4,
                            n_obstacles=3, rig=CameraRig(resolution=(32, 24)), print_every=0,
                            device="cpu")
    assert res.iterations == 2
    assert np.isfinite(res.mean_reward_first) and np.isfinite(res.mean_reward_last)
