"""The conv torso and the GRU of the port's ``PixelActorCritic`` against
Flax's: outputs on the same weights and inputs, the Flax <-> state_dict
interop of conv and GRU trees, and the initial distributions.

Two rigs: 32x24 (even sides: Flax's "SAME" pads 0 before and 1 after at
stride 2, 24 -> 12 -> 6 -> 3) and 33x17 (odd sides: 1 on each side,
17 -> 9 -> 5 -> 3). Tolerances as tests/test_torch_policy.py's: float32
1e-6 absolute (the same products summed in another order), bf16 1e-3 of
the output's largest magnitude; the GRU's hidden (magnitude up to ~2)
1e-6 absolute in float32. ``log_std`` is equal. The conv net on the card
against the CPU is in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.models import policy as tpolicy
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.models.policy import same_pads

RIGS = [(24, 32), (17, 33)]  # (H, W)
N = 8
P = 5


def _nets(hw, K=1, bf16=False, gru=0, torso="conv", seed=0):
    H, W = hw
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jnet = JNet(action_dim=4, torso=torso, compute_dtype=jdt, gru=gru)
    shape = (1, H, W) if K == 1 else (1, K, H, W)
    args = [jnp.zeros(shape, jnp.float32), jnp.zeros((1, P), jnp.float32)]
    if gru:
        args.append(jnp.zeros((1, gru), jnp.float32))
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed), *args))
    tnet = TNet(action_dim=4, n_patches=(H // 8) * (W // 8), torso=torso, compute_dtype=tdt,
                gru=gru, frame_stack=K, image_hw=hw, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    return jnet, params, tnet


def _inputs(hw, K, u8, gru=0, seed=1, n=N):
    rng = np.random.default_rng(seed)
    shape = (n,) + hw if K == 1 else (n, K) + hw
    lev = rng.integers(0, 256, size=shape).astype(np.uint8)
    px = lev if u8 else (lev.astype(np.float32) / np.float32(255.0))
    proprio = rng.normal(size=(n, P)).astype(np.float32)
    hidden = rng.normal(size=(n, gru)).astype(np.float32) if gru else None
    return px, proprio, hidden


def _run(jnet, params, tnet, px, proprio, hidden=None):
    jargs = [jnp.asarray(px), jnp.asarray(proprio)]
    targs = [torch.from_numpy(px), torch.from_numpy(proprio)]
    if hidden is not None:
        jargs.append(jnp.asarray(hidden))
        targs.append(torch.from_numpy(np.array(hidden)))
    jout = [np.asarray(x, np.float32) for x in jnet.apply(params, *jargs)]
    with torch.no_grad():
        tout = [x.numpy() for x in tnet(*targs)]
    return jout, tout


def _check(jout, tout, bf16):
    names = ("mean", "log_std", "value", "hidden")
    for name, j, t in zip(names, jout, tout):
        if name == "log_std":
            np.testing.assert_array_equal(t, j)
            continue
        tol = 1e-3 * np.abs(j).max() if bf16 else 1e-6
        np.testing.assert_allclose(t, j, atol=tol, rtol=0, err_msg=name)
    assert np.abs(jout[0]).max() > 1e-3  # premise: the heads are not all zero


@pytest.mark.parametrize("hw", RIGS, ids=["32x24", "33x17"])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_conv_net_matches_flax(hw, K, u8, bf16):
    jnet, params, tnet = _nets(hw, K, bf16)
    px, proprio, _ = _inputs(hw, K, u8)
    jout, tout = _run(jnet, params, tnet, px, proprio)
    assert tout[0].dtype == tout[2].dtype == np.float32
    _check(jout, tout, bf16)


@pytest.mark.parametrize("hw", RIGS, ids=["32x24", "33x17"])
def test_same_padding_is_flax_asymmetric_one(hw):
    """The pads per side, and the premise that ``nn.Conv2d(padding=1)``'s
    symmetric padding gives other features on even sides (32x24: every
    conv input even) and the same on odd ones (33x17: every input odd)."""
    H, W = hw
    assert same_pads(72) == (0, 1) and same_pads(96) == (0, 1) and same_pads(17) == (1, 1)
    jnet, params, tnet = _nets(hw)
    px, proprio, _ = _inputs(hw, 1, False)
    jout, tout = _run(jnet, params, tnet, px, proprio)
    _check(jout, tout, False)
    x = torch.from_numpy(px)[:, None]
    with torch.no_grad():
        ref = tnet._conv_torso(x, None)
        for i in range(3):
            conv = getattr(tnet, f"conv{i}")
            x = torch.relu(F.conv2d(x, conv.weight, conv.bias, stride=2, padding=1))
        sym = x.permute(0, 2, 3, 1).reshape(N, -1)
    assert sym.shape == ref.shape == (N, 3 * (4 if H == 24 else 5) * 32)
    if H % 2 == 0:
        assert (sym - ref).abs().max() > 1e-3
    else:
        torch.testing.assert_close(sym, ref, atol=1e-6, rtol=0)


def test_conv_flatten_order_is_nhwc():
    """fc0's rows follow Flax's (h, w, c) flatten: a (c, h, w) flatten of
    the same features gives another value."""
    jnet, params, tnet = _nets(RIGS[0])
    px, proprio, _ = _inputs(RIGS[0], 1, False)
    jout, tout = _run(jnet, params, tnet, px, proprio)
    _check(jout, tout, False)
    with torch.no_grad():
        feats = tnet._conv_torso(torch.from_numpy(px)[:, None], None)  # (N, h*w*c)
        chw = feats.reshape(N, 3, 4, 32).permute(0, 3, 1, 2).reshape(N, -1)
        x = torch.relu(tpolicy.dense(tnet.fc0, torch.cat([chw, torch.from_numpy(proprio)], -1),
                                     None))
        wrong = tpolicy.dense(tnet.v_out, x, None)[..., 0].numpy()
    assert np.abs(wrong - jout[2]).max() > 1e-3


@pytest.mark.parametrize("torso", ["patch", "conv"])
@pytest.mark.parametrize("bf16", [False, True])
def test_gru_net_matches_flax(torso, bf16):
    """Hidden in and out: the 4-tuple against Flax's, and two steps with
    the hidden carried."""
    hw = RIGS[0]
    jnet, params, tnet = _nets(hw, 1, bf16, gru=16, torso=torso)
    px, proprio, hidden = _inputs(hw, 1, True, gru=16)
    jout, tout = _run(jnet, params, tnet, px, proprio, hidden)
    assert len(tout) == 4 and tout[3].shape == (N, 16)
    _check(jout, tout, bf16)
    # the second step from each side's own new hidden
    px2, proprio2, _ = _inputs(hw, 1, True, seed=2)
    jout2, tout2 = _run(jnet, params, tnet, px2, proprio2, jout[3])
    _, tout2b = _run(jnet, params, tnet, px2, proprio2, tout[3])
    _check(jout2, tout2, bf16)
    np.testing.assert_allclose(tout2b[3], jout2[3], atol=1e-3 if bf16 else 1e-6, rtol=0)
    assert np.abs(jout2[3] - jout[3]).max() > 1e-2  # premise: the hidden moved


def test_gru_cell_is_flax_not_torch():
    """Flax's cell: no biases on the r and z recurrent layers, h' = (1 - z) n
    + z h; ``torch.nn.GRUCell`` on the same weights differs once its b_hr
    and b_hz are not zero, and so do the parameter counts."""
    _, params, tnet = _nets(RIGS[0], gru=16, torso="patch")
    names = {k for k in tnet.state_dict() if k.startswith("gru_cell.")}
    assert names == {f"gru_cell.{g}.weight" for g in ("ir", "iz", "in", "hr", "hz", "hn")} | {
        f"gru_cell.{g}.bias" for g in ("ir", "iz", "in", "hn")}
    assert set(params["params"]["gru"]["hr"]) == {"kernel"}
    cell = tnet.gru_cell
    ref = torch.nn.GRUCell(cell.ir.in_features, 16)
    with torch.no_grad():
        cell_in = getattr(cell, "in")  # a keyword as an attribute name
        ref.weight_ih.copy_(torch.cat([cell.ir.weight, cell.iz.weight, cell_in.weight]))
        ref.weight_hh.copy_(torch.cat([cell.hr.weight, cell.hz.weight, cell.hn.weight]))
        ref.bias_ih.copy_(torch.cat([cell.ir.bias, cell.iz.bias, cell_in.bias]))
        ref.bias_hh.copy_(torch.cat([torch.zeros(32), cell.hn.bias]))
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.normal(size=(N, cell.ir.in_features)).astype(np.float32))
        h = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32))
        # with b_hr = b_hz = 0 the two cells agree ...
        torch.testing.assert_close(cell(h, x), ref(x, h), atol=1e-6, rtol=0)
        # ... and torch's trainable b_hr, b_hz move its output where Flax has none
        ref.bias_hh[:32] += 0.1
        assert (cell(h, x) - ref(x, h)).abs().max() > 1e-3


@pytest.mark.parametrize("case", ["conv", "conv+gru", "patch+gru", "conv4+gru"])
def test_conv_gru_interop_round_trip(case):
    """Flax tree -> state_dict -> Flax tree, bit for bit, the structure
    included; a port state_dict round-trips too."""
    K = 4 if case.startswith("conv4") else 1
    patch = case.startswith("patch")  # the patch torso needs sides divisible by 8
    _, params, tnet = _nets(RIGS[0] if patch else RIGS[1], K, gru=16 if "gru" in case else 0,
                            torso="patch" if patch else "conv")
    back = interop.policy_params_to_numpy(tnet)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = interop.policy_params_from_numpy(back, "cpu")
    for k, v in tnet.state_dict().items():
        assert torch.equal(again[k], v), k
    if case.startswith("conv"):
        assert params["params"]["conv0"]["kernel"].shape == (3, 3, K, 16)  # HWIO
        assert tnet.conv0.weight.shape == (16, K, 3, 3)  # OIHW


def test_conv_gru_init_follows_flax_distributions():
    """Flax Conv: lecun_normal kernels (fan_in = 3*3*in), zero biases; the
    GRU: lecun_normal input kernels, orthogonal recurrent ones, zero biases;
    fc0 sized from the (H, W) given, 9*12*32 + P rows at 72x96."""
    net = TNet(action_dim=4, torso="conv", image_hw=(72, 96), proprio_dim=P, gru=128,
               device="cpu").init_params(torch.Generator().manual_seed(0))
    assert net.fc0.weight.shape == (256, 9 * 12 * 32 + P)
    for i, fan_in in ((1, 9 * 16), (2, 9 * 32)):
        w = getattr(net, f"conv{i}").weight.detach()
        std = 1.0 / np.sqrt(fan_in)
        assert abs(w.std().item() / std - 1.0) < 0.05, i
        assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6
        assert not getattr(net, f"conv{i}").bias.detach().any()
    cell = net.gru_cell
    for name in ("ir", "iz", "in"):
        w = getattr(cell, name).weight.detach()
        assert abs(w.std().item() * np.sqrt(256) - 1.0) < 0.02, name
        assert not getattr(cell, name).bias.detach().any()
    for name in ("hr", "hz", "hn"):
        w = getattr(cell, name).weight.detach().double()
        torch.testing.assert_close(w @ w.T, torch.eye(128, dtype=torch.float64), atol=1e-6,
                                   rtol=0)
    assert not cell.hn.bias.detach().any()
    assert cell.hr.bias is None and cell.hz.bias is None
    pm = net.pi_mean.weight.detach().double()  # orthogonal(0.01) over the GRU's 128
    torch.testing.assert_close(pm @ pm.T, 1e-4 * torch.eye(4, dtype=torch.float64), atol=1e-9,
                               rtol=0)


@pytest.mark.parametrize("torso,bf16", [("conv", False), ("conv", True), ("patch", True)])
def test_nets_scope_flax_reductions(torso, bf16, monkeypatch):
    """Every layer of the pixel net runs with cuBLAS's bf16 reduced-precision
    reductions and cuDNN's TF32 off (Flax's float32 sums, one rounding),
    forward and in the learner's backward scope, and the flags come back
    after."""
    seen = []
    real_conv, real_dense = F.conv2d, tpolicy.dense

    def flags():
        return (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                torch.backends.cudnn.allow_tf32)

    def conv_spy(*a, **kw):
        seen.append(flags())
        return real_conv(*a, **kw)

    def dense_spy(*a, **kw):
        seen.append(flags())
        return real_dense(*a, **kw)

    monkeypatch.setattr(tpolicy.F, "conv2d", conv_spy)
    monkeypatch.setattr(tpolicy, "dense", dense_spy)
    before = flags()
    assert before == (True, True)  # premise: the library defaults allow both
    _, _, tnet = _nets(RIGS[0], bf16=bf16, torso=torso)
    px, proprio, _ = _inputs(RIGS[0], 1, False)
    tnet(torch.from_numpy(px), torch.from_numpy(proprio))
    assert len(seen) == (3 if torso == "conv" else 1) + 3  # layers, fc0, the heads
    assert set(seen) == {(False, False)} and flags() == before
    with tnet.numerics():
        assert flags() == (False, False)
    assert flags() == before
