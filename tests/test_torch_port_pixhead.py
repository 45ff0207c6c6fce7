"""The pixel head after fc2, ``pixel_head`` (``ops/pixhead.py``), on the CPU.

On the CPU the wrapper takes its plain version, which is the composition
the pixel head ran before the kernel: fc2's bias add and ReLU, fc3, its
bias and ReLU, the classifier and the softmax.  Here that is held
bitwise, and so is ``forward_pixel`` against a frozen copy of its route
through ``_mlp_head``'s tail.  A replay of the kernel's arithmetic
(``torch_pixhead.replay``: its sum orders, its rounding points) is held
within the card tests' intervals (``torch_pixhead.bounds``), which the
composition itself must lie in too, and the kernel's column groups are
held to cover each column once.  The kernel itself is held on the card
(``tests/test_torch_port_cuda.py``).
"""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))

import torch_pixhead  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch import ops  # noqa: E402
from wesup_tpu_torch.models import wesup  # noqa: E402
from wesup_tpu_torch.ops import hypercol, pixhead  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
# (N, C, D, n): the bf16 kernel's 16-row tiles and the f32 kernel's
# 128-row blocks whole, rows past both, one row; fc1's width, a width
# that ends inside a 64-column chunk, a narrow fc3 and three classes
SHAPES = [(80, 1024, 32, 2), (256, 1024, 32, 2), (1000, 1024, 32, 2),
          (1, 1024, 32, 2), (333, 48, 20, 3), (130, 1000, 32, 4)]


def _composition(z, b2, w3, b3, wc, bc):
    """The parent's tail of ``_mlp_head`` after fc2, written out."""
    h = F.relu(z + b2)
    feats = F.relu(h @ w3.t() + b3)
    logits = feats @ wc.t() + bc
    return torch.softmax(logits.float(), dim=-1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_head_on_cpu_is_the_composition(shape, dtype):
    N, C, D, n = shape
    z, params = torch_pixhead.head_inputs(N, C, D, n, dtype, seed=N)
    ops.reset_launches()
    got = pixhead.head(z, *params)
    want = _composition(z, *params)
    assert got.dtype == torch.float32 and got.shape == (N, n)
    assert torch.equal(got, want)
    assert torch.equal(pixhead.head_plain(z, *params), want)
    # any leading shape: (B, H, W, C) -> (B, H, W, n)
    z4 = z.reshape(1, 1, N, C)
    assert torch.equal(pixhead.head(z4, *params), want.reshape(1, 1, N, n))
    assert ops.launch_counts()["pixel_head"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_replay_is_within_the_card_limits(shape, dtype):
    """The kernel's arithmetic, replayed, and the composition both lie in
    the intervals the card tests hold the kernel to."""
    N, C, D, n = shape
    z, params = torch_pixhead.head_inputs(N, C, D, n, dtype, seed=7)
    for got in (torch_pixhead.replay(z, *params), _composition(z, *params)):
        beyond, worst, _ = torch_pixhead.gap(got, z, params)
        assert beyond == 0, worst


@pytest.mark.parametrize("C", [8, 48, 64, 1000, 1024])
def test_kernel_groups_cover_each_column_once(C):
    cols = [c for g in torch_pixhead.groups(C) for c in g]
    assert sorted(cols) == list(range(C))
    assert all(len(g) == 16 for g in torch_pixhead.groups(C)[:C // 64 * 4])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bounds_catch_a_missing_rounding_and_a_lost_column(dtype):
    """The intervals are tight enough to see one feature's bias left out
    and one column of fc3 lost; in bf16 also fc3's product left unrounded
    (the kernel's rounding points are held through them)."""
    z, (b2, w3, b3, wc, bc) = torch_pixhead.head_inputs(2000, 1024, 32, 2,
                                                        dtype, seed=5)
    params = (b2, w3, b3, wc, bc)
    faults = [_composition(z, b2, w3, b3.clone().index_fill_(0,
                                     torch.tensor([5]), 0), wc, bc),
              _composition(z, b2, w3.clone().index_fill_(1,
                                     torch.tensor([17]), 0), b3, wc, bc)]
    if dtype is torch.bfloat16:
        f = F.relu(z + b2).float() @ w3.float().t()
        feats = F.relu(f + b3.float()).to(dtype)
        faults.append(torch.softmax((feats @ wc.t() + bc).float(), dim=-1))
    for got in faults:
        assert torch_pixhead.gap(got, z, params)[0] > 0


def _parent_forward_pixel(model, img, dtype):
    """``forward_pixel`` as it ran before the kernel: the upsample, then
    ``_mlp_head``'s tail after fc1's ReLU."""
    maps, bias = wesup._projected_stages(model, img, dtype)
    h = hypercol.upsample(maps, bias)
    fc2, fc3, cls = model.fc_layers[2], model.fc_layers[4], \
        model.classifier[0]
    h = h @ fc2.weight.t().to(dtype)
    h = F.relu(h + fc2.bias.to(dtype))
    feats = F.relu(h @ fc3.weight.t().to(dtype) + fc3.bias.to(dtype))
    logits = feats @ cls.weight.t().to(dtype) + cls.bias.to(dtype)
    return torch.softmax(logits.float(), dim=-1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fc_width", [48, 1024])
def test_forward_pixel_on_cpu_is_bitwise_the_parents(dtype, fc_width):
    model = wesup.WESUP(fc_width=fc_width,
                        generator=torch.Generator().manual_seed(1)).eval()
    img = torch.rand((2, 32, 64, 3),
                     generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        ops.reset_launches()
        got = wesup.forward_pixel(model, img, dtype)
        want = _parent_forward_pixel(model, img, dtype)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64, 2)
    assert torch.equal(got, want)
    assert not any(ops.launch_counts().values())


def test_head_refuses_what_the_kernel_does_not_take():
    z, params = torch_pixhead.head_inputs(64, 48, 32, 2, torch.float32)
    b2, w3, b3, wc, bc = params
    with pytest.raises(RuntimeError, match="not differentiable"):
        pixhead.head(z.clone().requires_grad_(), *params)
    with pytest.raises(RuntimeError, match="not differentiable"):
        pixhead.head(z, b2, w3.clone().requires_grad_(), b3, wc, bc)
    with torch.no_grad():
        assert torch.equal(
            pixhead.head(z, b2, w3.clone().requires_grad_(), b3, wc, bc),
            pixhead.head(z, *params))
    with pytest.raises(ValueError, match="contiguous"):
        pixhead.head(z.t().contiguous().t(), *params)
    # a width other than fc2's
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z[:, :40].contiguous(), *params)
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z, b2[:40], w3, b3, wc, bc)
    # wrong dtypes
    with pytest.raises(TypeError):
        pixhead.head(z.double(), *(p.double() for p in params))
    with pytest.raises(TypeError):
        pixhead.head(z.half(), *(p.half() for p in params))
    with pytest.raises(TypeError):
        pixhead.head(z, b2, w3.to(torch.bfloat16), b3, wc, bc)
    with pytest.raises(TypeError):
        pixhead.head(z.to(torch.bfloat16), *params)
    # mismatched weight shapes
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z, b2, w3[:, :40], b3, wc, bc)
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z, b2, w3, b3[:16], wc, bc)
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z, b2, w3, b3, wc[:, :16], bc)
    with pytest.raises(ValueError, match="shape"):
        pixhead.head(z, b2, w3, b3, wc, bc[:1])
    with pytest.raises(ValueError, match="contiguous"):
        pixhead.head(z, b2, w3.t().contiguous().t(), b3, wc, bc)
    # what the kernel's registers do not hold
    wide = torch_pixhead.head_inputs(8, 48, 40, 2, torch.float32)[1]
    with pytest.raises(ValueError, match="width 40"):
        pixhead.head(z, *wide)
    many = torch_pixhead.head_inputs(8, 48, 32, 5, torch.float32)[1]
    with pytest.raises(ValueError, match="5 classes"):
        pixhead.head(z, *many)
