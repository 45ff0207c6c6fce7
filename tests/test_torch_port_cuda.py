"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker, needs a CUDA device and skips
without one (the fixture decides, so every worker collects the same
tests).  The file
imports neither jax nor ``wesup_tpu``, so it also runs on a machine that
has only PyTorch; there, skip the JAX suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

The shapes cover what chip_smoke.py does not: small and ragged canvases,
channel counts that are not a multiple of the kernels' 32-channel chunk,
and a cluster grid narrower than one 8-cluster block.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import wesup  # noqa: E402
from wesup_tpu_torch.models.steps import make_predict_step  # noqa: E402
from wesup_tpu_torch.ops import cellgrid, cellpool  # noqa: E402
from wesup_tpu_torch.ops.slic import make_plan, slic  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _seg(dev, B, H, W, sp_area, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((B, H, W, 3), dtype=np.float32)).to(dev)
    valid = torch.ones((B, H, W), dtype=torch.bool, device=dev)
    valid[:, -5:] = False
    valid[:, :, -7:] = False
    seg = slic(img, valid, sp_area=sp_area, update_stride=3)
    return make_plan(H, W, sp_area), seg, valid


CANVASES = [(2, 64, 160, 200), (1, 96, 128, 150), (2, 32, 64, 200),
            (1, 100, 230, 200)]


@pytest.mark.parametrize("B,H,W,sp_area", CANVASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.02)])
def test_cell_pool0_kernel_matches_plain(cuda, B, H, W, sp_area, dtype, tol):
    plan, seg, valid = _seg(cuda, B, H, W, sp_area)
    seg_m = torch.where(valid, seg, -1)
    taps = torch.randn((B, H, W, 40), device=cuda).to(dtype)
    before = cellpool.LAUNCHES["cell_pool0"]
    got = cellpool.cell_pool0(plan, seg_m, taps)
    assert cellpool.LAUNCHES["cell_pool0"] == before + 1
    want = cellpool.cell_pool0_plain(plan, seg_m, taps)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert torch.equal(got, cellpool.cell_pool0(plan, seg_m, taps))


@pytest.mark.parametrize("B,H,W,sp_area", CANVASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_pool_stage_kernel_matches_plain(cuda, B, H, W, sp_area, dtype):
    plan, seg, valid = _seg(cuda, B, H, W, sp_area, seed=1)
    e9 = cellgrid.offset_masks(plan, seg, valid, dtype)
    for s in range(1, 5):
        spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
        mc = cellgrid.stage_window_weights(spp, e9)
        taps = torch.randn((B, H >> s, W >> s, 72), device=cuda).to(dtype)
        got = cellpool.cell_pool_stage(spp, mc, taps)
        want = cellpool.cell_pool_stage_plain(spp, mc, taps)
        torch.cuda.synchronize()
        lim = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= lim, s


def test_wrappers_reject_bad_inputs(cuda):
    plan, seg, valid = _seg(cuda, 1, 64, 160, 200)
    taps = torch.randn((1, 64, 160, 8), device=cuda)
    with pytest.raises(TypeError):
        cellpool.cell_pool0(plan, seg.long(), taps)
    with pytest.raises(ValueError):
        cellpool.cell_pool0(plan, seg, taps.transpose(1, 2).contiguous()
                            .transpose(1, 2))
    with pytest.raises(TypeError):
        cellpool.cell_pool0(plan, seg, taps.half())


def test_predict_step_on_card_matches_cpu(cuda):
    cfg = WESUPConfig(compute_dtype="float32")
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(2)
    imgs = np.clip(rng.normal(200, 25, (2, 64, 160, 3)), 0, 255).astype(
        np.uint8)
    valid = np.zeros((2, 64, 160), bool)
    valid[:, :58, :141] = True
    want = make_predict_step(cfg, (64, 160), device="cpu")(model, imgs, valid)
    cellpool.reset_launches()
    got = make_predict_step(cfg, (64, 160))(model.to(cuda), imgs, valid)
    assert cellpool.LAUNCHES == {"cell_pool0": 1, "cell_pool_stage": 4}
    # SLIC on the card sums its centre updates in another order than on the
    # CPU, which may flip a near-tie pixel's superpixel; elsewhere the two
    # agree to the f32 forward's tolerance
    close = (got.cpu() - want).abs() <= 2e-4
    assert close.float().mean().item() >= 0.999
