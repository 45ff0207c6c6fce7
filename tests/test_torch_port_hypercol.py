"""The pixel head's ``hypercol_upsample`` (``ops/hypercol.py``) on the CPU.

On the CPU the wrapper takes its plain version, which is the composition
the pixel head ran before the kernel: ``resize_w_only`` per stage,
``fused_upsample_sum``, the bias cast to the maps' dtype and added, ReLU.
Here that is held bitwise, and so is ``forward_pixel`` against a frozen
copy of its route through that composition.  The kernel's tap tables
are held against the dense interpolation matrices, and a replay of the
kernel's arithmetic (``torch_hypercol.replay``) against the composition
with the card tests' limits.  The kernel itself is held on the card
(``tests/test_torch_port_cuda.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))

import torch_hypercol  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch import ops  # noqa: E402
from wesup_tpu_torch.models import wesup  # noqa: E402
from wesup_tpu_torch.ops import hypercol  # noqa: E402
from wesup_tpu_torch.ops.resize import (_interp_matrix,  # noqa: E402
                                        fused_upsample_sum, resize_w_only)

DTYPES = [torch.float32, torch.bfloat16]
# (B, H, W, C): a 32-aligned canvas, a non-square one, and one whose
# stage 4 is a single row and column
SHAPES = [(2, 32, 48, 24), (1, 64, 32, 16), (1, 16, 16, 8)]


def _composition(maps, bias):
    """The parent's pixel-head composition, written out."""
    W = maps[0].shape[2]
    z = fused_upsample_sum([resize_w_only(m, W) for m in maps],
                           maps[0].shape[1])
    return F.relu(z + bias.to(z.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_upsample_on_cpu_is_the_composition(shape, dtype):
    maps, bias = torch_hypercol.stage_maps(*shape, dtype)
    ops.reset_launches()
    got = hypercol.upsample(maps, bias)
    want = _composition(maps, bias)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)
    assert torch.equal(hypercol.upsample_plain(maps, bias), want)
    assert ops.launch_counts()["hypercol_upsample"] == 0


@pytest.mark.parametrize("in_size,out_size", [
    (1, 7), (2, 2), (2, 9), (3, 1), (13, 13), (26, 416), (104, 416),
    (208, 416), (5, 160), (52, 51)])
def test_interp_taps_are_the_matrix_rows(in_size, out_size):
    idx, w = hypercol.interp_taps(in_size, out_size)
    assert idx.shape == w.shape == (out_size, 2)
    assert idx.min() >= 0 and idx.max() < in_size
    dense = np.zeros((out_size, in_size), np.float32)
    for k in range(2):
        np.add.at(dense, (np.arange(out_size), idx[:, k]), w[:, k])
    assert np.array_equal(dense, _interp_matrix(in_size, out_size, True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tables_round_the_weights_as_the_composition(dtype):
    """The tables' weights are the matrices' entries rounded to the maps'
    dtype, as ``resize_w_only`` and ``fused_upsample_sum`` round them."""
    maps, _ = torch_hypercol.stage_maps(1, 64, 96, 8, dtype)
    xidx, xw, yidx, yw = hypercol._tables(maps, dtype, torch.device("cpu"))
    assert xidx.shape == xw.shape == (4, 96, 2)
    assert yidx.shape == yw.shape == (4, 64, 2)
    assert xidx.dtype == yidx.dtype == torch.int32
    for s in range(1, 5):
        for idx, w, n, full in ((xidx, xw, 96 >> s, 96),
                                (yidx, yw, 64 >> s, 64)):
            A = torch.as_tensor(_interp_matrix(n, full, True), dtype=dtype)
            rows = torch.arange(full)
            for k in range(2):
                picked = A[rows, idx[s - 1, :, k].long()].float()
                assert torch.equal(w[s - 1, :, k][w[s - 1, :, k] != 0],
                                   picked[w[s - 1, :, k] != 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_replay_is_within_the_card_limits(shape, dtype):
    """The kernel's arithmetic, replayed, against the composition with
    the limits the card tests hold the kernel to."""
    maps, bias = torch_hypercol.stage_maps(*shape, dtype, seed=3)
    beyond, worst = torch_hypercol.gap(torch_hypercol.replay(maps, bias),
                                       maps, bias, _composition(maps, bias))
    assert beyond == 0, worst


def _parent_forward_pixel(model, img, dtype):
    """``forward_pixel`` as it ran before the kernel: each stage projected
    and W-resized, one contraction, the bias added in the map's dtype,
    then the head with its first ReLU."""
    W = img.shape[2]
    taps, w1_blocks, side_ws, bias = wesup._backbone(model, img, dtype)
    maps = []
    for s in range(5):
        stage_taps, proj = wesup._stage_taps_and_proj(side_ws, taps,
                                                      w1_blocks, s, dtype)
        maps.append(resize_w_only(stage_taps @ proj, W))
    z = fused_upsample_sum(maps, img.shape[1])
    z = z + bias.to(z.dtype)
    probs, _ = wesup._mlp_head(model, z)
    return probs


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_pixel_on_cpu_is_bitwise_unchanged(dtype):
    model = wesup.WESUP(fc_width=48,
                        generator=torch.Generator().manual_seed(1)).eval()
    img = torch.rand((2, 32, 64, 3), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        got = wesup.forward_pixel(model, img, dtype)
        want = _parent_forward_pixel(model, img, dtype)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64, 2)
    assert torch.equal(got, want)


def test_upsample_refuses_what_the_kernel_does_not_take():
    maps, bias = torch_hypercol.stage_maps(1, 32, 32, 8, torch.float32)
    with pytest.raises(ValueError, match="5"):
        hypercol.upsample(maps[:4], bias)
    grad = [m.clone().requires_grad_() for m in maps]
    with pytest.raises(RuntimeError, match="not differentiable"):
        hypercol.upsample(grad, bias)
    with pytest.raises(RuntimeError, match="not differentiable"):
        hypercol.upsample(maps, bias.clone().requires_grad_())
    with pytest.raises(TypeError):
        hypercol.upsample([maps[0]] + [m.to(torch.bfloat16)
                                       for m in maps[1:]], bias)
    with pytest.raises(TypeError):
        hypercol.upsample([m.double() for m in maps], bias)
    with pytest.raises(ValueError, match="shape"):
        hypercol.upsample(maps[:4] + [maps[4][..., :4]], bias)
    with pytest.raises(ValueError, match="shape"):
        hypercol.upsample(maps, bias[:4])
    with pytest.raises(ValueError, match="contiguous"):
        hypercol.upsample(maps[:1] + [m.transpose(1, 2).contiguous()
                                      .transpose(1, 2) for m in maps[1:]],
                          bias)
