"""levels_lut (``ops/levels_kernel.py``, ``csrc/levels_kernels.cu``): uint8
depth levels into the pixel net's input dtype through a 256-entry table.

On the CPU: the table equals the pixel net's old input chain (u8 ->
float32, a true division by its device-resident 255, a cast) bit for bit in
bf16, fp16 and float32, and the correctly rounded quotients; it is made once
per device and dtype; ``levels_as`` runs that chain on a CPU tensor and
launches nothing; the wrapper refuses what the kernel does not take; the
net's features on prepatched and strided uint8 levels equal those on the
chain's float32. On the card (``-m cuda``, skips here): the kernel against
its plain version bit for bit on all 256 levels, at the learner's shape
(4096, 108, 256), at ragged sizes (1, 15, 17, 4095 x 27,648 + 3) and on
inputs off a 16-byte boundary, in each output dtype; the launch counter
counts the wrapper's calls, and a CUDA graph replays a captured launch
without a call. Imports neither JAX nor ``fpyv_tpu``:

    python -m pytest --noconftest -q tests/test_torch_levels_lut.py
"""

from __future__ import annotations

import pytest
import torch

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.models.policy import PixelActorCritic
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import levels_kernel as lk

CPU = torch.device("cpu")
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
IDS = ("bf16", "fp16", "f32")
# the learner's minibatch of race_k8: 4096 samples x 108 patches x 4 frames of 64 levels
LEARNER_SHAPE = (4096, 108, 256)
RAGGED = (1, 15, 17, 4095 * 27648 + 3)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _old_chain(levels: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor) -> torch.Tensor:
    """The pixel net's input before levels_lut: features' float32 division,
    then the torso's cast."""
    return (levels.to(torch.float32) / scale).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_the_table_is_the_old_chain_and_the_rounded_quotients(dtype):
    lk.level_table.cache_clear()
    table = lk.level_table(CPU, dtype)
    u = torch.arange(256, dtype=torch.uint8)
    assert table.shape == (256,) and table.dtype == dtype
    assert torch.equal(_bits(table), _bits(_old_chain(u, dtype, torch.tensor(255.0))))
    rounded = (u.to(torch.float64) / 255.0).to(torch.float32).to(dtype)
    assert torch.equal(_bits(table), _bits(rounded))
    assert float(table[0]) == 0.0 and float(table[255]) == 1.0


def test_the_table_is_made_once_a_device_and_dtype():
    lk.level_table.cache_clear()
    a = lk.level_table(CPU, torch.bfloat16)
    assert lk.level_table(CPU, torch.bfloat16) is a
    assert lk.level_table(CPU, torch.float32) is not a
    assert lk.level_table.cache_info().misses == 2


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_levels_as_on_the_cpu_is_the_old_chain_and_launches_nothing(dtype):
    levels = torch.randint(0, 256, (6, 108, 256), generator=torch.Generator().manual_seed(3),
                           dtype=torch.uint8)
    scale = divisor(255.0, levels)
    before = dict(_build.launch_counts)
    out = lk.levels_as(levels, dtype, scale)
    assert _build.launch_counts == before  # the CPU path launches no kernel
    assert out.dtype == dtype and out.shape == levels.shape
    assert torch.equal(_bits(out), _bits(_old_chain(levels, dtype, scale)))


def test_levels_as_refuses_what_the_kernel_does_not_take():
    levels = torch.zeros(4, 8, dtype=torch.uint8)
    scale = torch.tensor(255.0)
    with pytest.raises(TypeError, match="uint8"):
        lk.levels_as(levels.to(torch.float32), torch.bfloat16, scale)
    with pytest.raises(TypeError, match="uint8"):
        lk.levels_as(levels.to(torch.int8), torch.bfloat16, scale)
    with pytest.raises(ValueError, match="contiguous"):
        lk.levels_as(levels.t(), torch.bfloat16, scale)
    with pytest.raises(ValueError, match="contiguous"):
        lk.levels_as(levels[:, ::2], torch.bfloat16, scale)
    with pytest.raises(TypeError, match="gives one of"):
        lk.levels_as(levels, torch.float64, scale)
    with pytest.raises(ValueError, match="scale"):
        lk.levels_as(levels, torch.bfloat16, scale.to(torch.float64))
    with pytest.raises(ValueError, match="scale"):
        lk.levels_as(levels, torch.bfloat16, torch.tensor([255.0]))
    with pytest.raises(ValueError, match="CUDA"):
        lk.launch_levels_lut(levels, torch.bfloat16)


def _race_net(dtype):
    """race_k8's patch net, narrowed: 4 frames of prepatched 64-level patches."""
    net = PixelActorCritic(action_dim=4, n_patches=6, proprio_dim=5, torso="patch",
                           prepatched=True, frame_stack=4, hidden=(32,), embed=16,
                           compute_dtype=dtype)
    return net.init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_features_on_prepatched_and_strided_levels_equal_the_old_chain(dtype):
    net = _race_net(dtype)
    g = torch.Generator().manual_seed(1)
    levels = torch.randint(0, 256, (8, 6, 256), generator=g, dtype=torch.uint8)
    proprio = torch.randn(8, 5, generator=g)
    old = levels.to(torch.float32) / net.level_scale
    assert torch.equal(net.features(levels, proprio), net.features(old, proprio))
    strided = levels[::2]  # not contiguous: features takes a contiguous copy
    assert not strided.is_contiguous()
    assert torch.equal(net.features(strided, proprio[::2]), net.features(old[::2], proprio[::2]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _card_equal(levels: torch.Tensor, dtype: torch.dtype) -> None:
    """levels_lut against its plain version on the card and on the CPU."""
    out = lk.launch_levels_lut(levels, dtype)
    ref = lk.levels_reference(levels, dtype, divisor(255.0, levels))
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == levels.shape
    assert torch.equal(_bits(out), _bits(ref))
    if levels.numel() <= 1 << 20:
        host = lk.levels_reference(levels.cpu(), dtype, torch.tensor(255.0))
        assert torch.equal(_bits(out.cpu()), _bits(host))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_cuda_every_level_equals_the_plain_version(cuda_device, dtype):
    levels = torch.arange(256, dtype=torch.uint8, device=cuda_device).repeat(33)
    _card_equal(levels, dtype)
    _card_equal(levels.flip(0).contiguous(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_cuda_the_learners_shape_equals_the_plain_version(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    levels = torch.randint(0, 256, LEARNER_SHAPE, generator=g, dtype=torch.uint8,
                           device=cuda_device)
    _card_equal(levels, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("n", RAGGED)
def test_cuda_ragged_sizes_equal_the_plain_version(cuda_device, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(n % 1000)
    levels = torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8, device=cuda_device)
    _card_equal(levels, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("offset", [1, 3, 8, 16])
def test_cuda_an_input_off_a_16_byte_boundary_equals_the_plain_version(cuda_device, offset,
                                                                      dtype):
    g = torch.Generator(device=cuda_device).manual_seed(offset)
    base = torch.randint(0, 256, (offset + 4096 * 16 + 5,), generator=g, dtype=torch.uint8,
                         device=cuda_device)
    levels = base[offset:]  # contiguous, at an offset of its storage
    assert levels.is_contiguous() and levels.data_ptr() % 16 == offset % 16
    _card_equal(levels, dtype)


@pytest.mark.cuda
def test_cuda_the_counter_counts_the_wrappers_calls_not_a_graphs_replays(cuda_device):
    levels = torch.randint(0, 256, (64, 108, 256), dtype=torch.uint8, device=cuda_device)
    scale = divisor(255.0, levels)
    _build.reset_launch_counts()
    want = lk.levels_as(levels, torch.bfloat16, scale)
    lk.levels_as(levels, torch.float32, scale)
    net = _race_net(torch.bfloat16).to(cuda_device)
    net(levels[:, :6].contiguous(), torch.zeros(64, 5, device=cuda_device))
    assert _build.launch_counts["levels_lut"] == 3
    assert sum(_build.launch_counts.values()) == 3
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = lk.levels_as(levels, torch.bfloat16, scale)
    assert _build.launch_counts["levels_lut"] == 4
    for _ in range(5):
        out.zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert _build.launch_counts["levels_lut"] == 4
    assert torch.equal(_bits(out), _bits(want))


@pytest.mark.cuda
def test_cuda_the_table_is_not_made_inside_a_capture(cuda_device):
    lk.level_table.cache_clear()
    levels = torch.zeros(16, dtype=torch.uint8, device=cuda_device)
    scale = divisor(255.0, levels)  # a host-to-device copy: not inside the capture
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            lk.levels_as(levels, torch.float16, scale)
    torch.cuda.synchronize()
    assert lk.level_table.cache_info().currsize == 0
