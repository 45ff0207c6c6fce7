"""The port's CUDA kernels against their plain versions, on the card, and
the predict and train steps on the card against the CPU.

Every test here carries the ``cuda`` marker, needs a CUDA device and skips
without one (the fixture decides, so every worker collects the same
tests).  The file
imports neither jax nor ``wesup_tpu``, so it also runs on a machine that
has only PyTorch; there, skip the JAX suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

The shapes cover what chip_smoke.py does not: small and ragged canvases,
channel counts that are not a multiple of the kernels' 32-channel chunk
or 16-byte vector, misaligned bases, odd pooling windows, and a cluster
grid narrower than one 8-cluster block.  The trainer's slice is held here
too: the device resize bitwise against the CPU, the per-batch generators'
seeds on both devices, bucketed train and eval steps in the trainer's wire
formats with their launches, and a one-epoch ``fit`` on the card.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu_torch import inference  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import wesup  # noqa: E402
from wesup_tpu_torch.models import steps  # noqa: E402
from wesup_tpu_torch.models.steps import make_predict_step  # noqa: E402
from wesup_tpu_torch.ops import (adjoint, cellgrid, cellpool,  # noqa: E402
                                 hypercol, launch_counts, pixhead, pool,
                                 pooling, reset_launches, tile)
from wesup_tpu_torch.ops.resize import _interp_matrix  # noqa: E402
from wesup_tpu_torch.ops.slic import make_plan, slic  # noqa: E402
from wesup_tpu_torch.utils import prng  # noqa: E402
import torch_hypercol  # noqa: E402
import torch_pixhead  # noqa: E402
import torch_predict_host_fuse as host_fuse  # noqa: E402

pytestmark = pytest.mark.cuda

CELLPOOL = ("cell_pool0", "cell_pool_stage", "cell_pool0_bwd",
            "cell_pool_stage_bwd")
TILE = ("tile_cut", "tile_stitch")


def _counts(*names) -> dict:
    """The launch counts of the kernels ``names``."""
    counts = launch_counts()
    return {name: counts[name] for name in names}


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
    before = launch_counts()["cell_pool0"]
    got = cellpool.cell_pool0(plan, seg_m, taps)
    assert launch_counts()["cell_pool0"] == before + 1
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
    reset_launches()
    got = make_predict_step(cfg, (64, 160))(model.to(cuda), imgs, valid)
    assert _counts(*CELLPOOL) == {"cell_pool0": 1, "cell_pool_stage": 4,
                                  "cell_pool0_bwd": 0,
                                  "cell_pool_stage_bwd": 0}
    # SLIC on the card sums its centre updates in another order than on the
    # CPU, which may flip a near-tie pixel's superpixel; elsewhere the two
    # agree to the f32 forward's tolerance
    close = (got.cpu() - want).abs() <= 2e-4
    assert close.float().mean().item() >= 0.999


@pytest.mark.parametrize("B,H,W,sp_area", CANVASES[:2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_pool0_bwd_kernel_matches_plain(cuda, B, H, W, sp_area, dtype):
    """K3 is a pure selection: bitwise equal to the plain gather."""
    plan, seg, valid = _seg(cuda, B, H, W, sp_area, seed=2)
    seg_m = torch.where(valid, seg, -1)
    for C in (40, 37):  # vector and scalar paths
        dsums = torch.randn((B, plan.n_clusters, C), device=cuda)
        before = launch_counts()["cell_pool0_bwd"]
        got = cellpool.cell_pool0_bwd(plan, seg_m, dsums, dtype)
        assert launch_counts()["cell_pool0_bwd"] == before + 1
        want = cellpool.cell_pool0_bwd_plain(plan, seg_m, dsums, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("B,H,W,sp_area", CANVASES[:2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_pool_stage_bwd_kernel_matches_plain(cuda, B, H, W, sp_area,
                                                  dtype):
    """K4 sums in another order than the plain einsum: f32 to 1e-5 of the
    largest value; bf16 within one bf16 ulp (the f32 sums round to bf16)
    plus 1e-5 of the sum of |terms| (the order of the f32 sums, which
    matters where the terms cancel)."""
    plan, seg, valid = _seg(cuda, B, H, W, sp_area, seed=3)
    e9 = cellgrid.offset_masks(plan, seg, valid, dtype)
    for s in range(1, 5):
        spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
        mc = cellgrid.stage_window_weights(spp, e9)
        dsums = torch.randn((B, plan.n_clusters, 72), device=cuda)
        got = cellpool.cell_pool_stage_bwd(spp, mc, dsums)
        want = cellpool.cell_pool_stage_bwd_plain(spp, mc, dsums, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * max(1.0, want.abs().max().item())
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -126))) - 7)
            mass = cellpool.cell_pool_stage_bwd_plain(
                spp, mc.abs(), dsums.abs(), torch.float32)
            assert (err <= ulp + 1e-5 * mass).all(), s


def _train_batch(B, H, W, content, seed=0):
    rng = np.random.default_rng(seed)
    batch = {
        "image": np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(
            np.uint8),
        "valid": np.zeros((B, H, W), bool),
        "pixel_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
        "points": np.zeros((B, 16, 3), np.int32),
        "point_valid": np.zeros((B, 16), bool),
        "use_mask_as_points": np.zeros((B,), bool),
        "sample_valid": np.ones((B,), bool),
    }
    batch["valid"][:, :content[0], :content[1]] = True
    for b in range(B):
        for i in range(6):
            x, y = rng.integers(0, content[1]), rng.integers(0, content[0])
            batch["points"][b, i] = (x, y, batch["pixel_mask"][b, y, x])
            batch["point_valid"][b, i] = True
    return batch


def test_train_step_grads_on_card_match_cpu(cuda):
    """One f32 forward + loss + backward on the same prep: the card runs
    K1-K4, the CPU their plain versions.  Loss to 1e-4 relative, gradients
    to 1e-3 of each tensor's largest |grad|, the backbone convs' to 1e-2:
    cuDNN and the CPU sum convs in other orders, so a ReLU input within
    that noise of zero may take the other sign and pass (or stop) one
    position's gradient, which at the 4x10 deepest stage is ~1/80 of a
    conv's weight gradient (see tests/test_torch_port_train.py)."""
    cfg = WESUPConfig(compute_dtype="float32")
    H, W = 64, 160
    batch = _train_batch(2, H, W, (58, 141))
    plan = make_plan(H, W, cfg.sp_area)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    prep = steps._preprocess_sample(
        None, b["image"], b["valid"], b["pixel_mask"], b["points"],
        b["point_valid"], b["use_mask_as_points"], config=cfg, train=False,
        point_mode=True)
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = wesup.WESUP(fc_width=64,
                            generator=torch.Generator().manual_seed(0)).to(dev)
        p = steps.Preprocessed(*(t.to(dev) for t in prep))
        reset_launches()
        loss, _ = steps._forward_and_loss(model, p, plan.n_clusters, cfg,
                                          b["sample_valid"].to(dev), plan)
        loss.backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert _counts(*CELLPOOL) == {"cell_pool0": 1,
                                          "cell_pool_stage": 4,
                                          "cell_pool0_bwd": 1,
                                          "cell_pool_stage_bwd": 4}
        losses[str(dev)] = loss.item()
        grads[str(dev)] = {n: q.grad.cpu() for n, q in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for name, want in grads["cpu"].items():
        rel = 1e-2 if name.startswith("backbone.") else 1e-3
        err = (grads["cuda"][name] - want).abs().max().item()
        assert err <= rel * want.abs().max().item() + 1e-12, name


@pytest.mark.parametrize("point_mode", [True, False])
def test_train_step_launches_on_card(cuda, point_mode):
    cfg = WESUPConfig()
    H, W = 64, 160
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    optimizer = steps.make_optimizer(cfg, model)
    step = steps.make_train_step(cfg, (H, W), point_mode=point_mode)
    acc = steps.init_metric_acc()
    key = prng.PRNGKey(0)
    batch = _train_batch(2, H, W, (58, 141))
    acc = step(model, optimizer, acc, batch, key)
    reset_launches()
    acc = step(model, optimizer, acc, batch, key)
    torch.cuda.synchronize()
    assert _counts(*CELLPOOL) == {"cell_pool0": 1, "cell_pool_stage": 4,
                                  "cell_pool0_bwd": 1,
                                  "cell_pool_stage_bwd": 4}
    assert acc["count"].item() == 4 and not acc["nan"].item()
    assert all(np.isfinite(v.item()) for v in acc["sums"].values())


# ---------------------------------------------------------------------------
# K5, K6, K7 and the adjoint, fullres and gated configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,P,C,offset", [(2, 10240, 128, 0),
                                          (1, 3000, 70, 0),
                                          (2, 500, 40, 1),
                                          (1, 777, 1024, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_matches_plain(cuda, B, P, C, offset, dtype):
    """K5 sums in another order than the one-hot einsum: 1e-5 of the
    largest value; two launches agree bitwise.  ``offset`` moves the
    features off their 16-byte alignment (the scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    K = 37
    seg = torch.randint(-1, K, (B, P), generator=gen, device=cuda,
                        dtype=torch.int32)
    flat = torch.randn(B * P * C + offset, generator=gen, device=cuda)
    feat = flat.to(dtype)[offset:].view(B, P, C)
    before = launch_counts()["segment_sum"]
    got = pooling.segment_sum(seg, feat, K)
    assert launch_counts()["segment_sum"] == before + 1
    want = pooling.segment_sum_plain(seg, feat, K)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    assert torch.equal(got, pooling.segment_sum(seg, feat, K))


@pytest.mark.parametrize("B,H,W,sp_area", CANVASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_adjoint_pool_stage_kernel_matches_plain(cuda, B, H, W, sp_area,
                                                 dtype, channels_last):
    """K6 against its plain version, f32 to 1e-5 of the largest value; bf16
    within 2^-8 of each element's mass (the sum of its |terms|) more: the
    f32 sums of p_h's weights, formed in another order, may round to bf16
    values one ulp apart.  tapsH_T as the forward passes it (a channels-
    last view) and as a contiguous (B, C, H, Ws) tensor."""
    plan, seg, valid = _seg(cuda, B, H, W, sp_area, seed=4)
    seg_m = torch.where(valid, seg, -1).contiguous()
    K = plan.n_clusters
    for s in range(1, 5):
        Hs, Ws = H >> s, W >> s
        taps = torch.randn((B, Hs, Ws, 72), device=cuda)
        A_h = torch.as_tensor(_interp_matrix(Hs, H, True), device=cuda)
        tapsH = torch.einsum("hu,buvc->bhvc", A_h, taps).to(dtype)
        tapsH_T = tapsH.permute(0, 3, 1, 2)
        if not channels_last:
            tapsH_T = tapsH_T.contiguous()
        A_wT = torch.from_numpy(_interp_matrix(Ws, W, True)).t()
        got = adjoint.adjoint_pool_stage(seg_m, tapsH_T, A_wT, K)
        want = adjoint.adjoint_pool_stage_plain(seg_m, tapsH_T, A_wT, K)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (B, 72, K)
        lim = 1e-5 * max(1.0, want.abs().max().item())
        if dtype == torch.bfloat16:
            mass = adjoint.adjoint_pool_stage_plain(seg_m, tapsH_T.abs(),
                                                    A_wT, K)
            lim = lim + 2.0 ** -8 * mass
        assert ((got - want).abs() <= lim).all(), s
        assert torch.equal(got, adjoint.adjoint_pool_stage(seg_m, tapsH_T,
                                                           A_wT, K))


# ---------------------------------------------------------------------------
# K2 and K6 at ragged shapes: their compacted term lists, the rounds or
# windows of a list longer than the shared buffer, and the masked channel
# tail.  Each is held against its plain version within the limits above
# and checked bitwise across two launches.
# ---------------------------------------------------------------------------

RAGGED_C = [5, 12, 256, 1544]


@pytest.mark.parametrize("C", RAGGED_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["masks", "dense", "invalid"])
def test_cell_pool_stage_kernel_ragged(cuda, C, dtype, kind):
    """K2 at every stage of the main-path plan (stage 4: Ih = Jw = 7), with
    the forward's window weights ("masks"), random nonzeros in every slot,
    so that each window holds more terms than one round of the kernel
    ("dense", up to 1296 at stage 1), or the weights of an image whose
    pixels are all invalid ("invalid": every weight 0)."""
    B, H, W = 1, 288, 416
    plan, seg, valid = _seg(cuda, B, H, W, 200, seed=5)
    if kind == "invalid":
        valid = torch.zeros_like(valid)
    e9 = cellgrid.offset_masks(plan, seg, valid, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for s in range(1, 5):
        spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
        mc = cellgrid.stage_window_weights(spp, e9)
        if kind == "dense":
            mc = (torch.rand(mc.shape, generator=gen, device=cuda)
                  + 0.5).to(dtype)
        taps = torch.randn((B, H >> s, W >> s, C), device=cuda).to(dtype)
        got = cellpool.cell_pool_stage(spp, mc, taps)
        want = cellpool.cell_pool_stage_plain(spp, mc, taps)
        torch.cuda.synchronize()
        lim = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= lim, s
        assert torch.equal(got, cellpool.cell_pool_stage(spp, mc, taps)), s
        if kind == "invalid":
            assert not got.any()


def _adjoint_seg(dev, kind, B, H, W):
    """(seg, K): SLIC's ("slic"), five bands of about 2000 pixels each,
    lists longer than one window of the kernel ("big"), or all invalid."""
    if kind == "big":
        hh = torch.arange(H, device=dev)[:, None] * 5 // H
        seg = (hh + 0 * torch.arange(W, device=dev)[None, :]).to(torch.int32)
        return seg.expand(B, H, W).contiguous(), 5
    plan, seg, valid = _seg(dev, B, H, W, 200, seed=6)
    seg_m = torch.where(valid, seg, -1)
    if kind == "invalid":
        seg_m = torch.full_like(seg_m, -1)
    return seg_m.contiguous(), plan.n_clusters


@pytest.mark.parametrize("C", RAGGED_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["slic", "big", "invalid"])
@pytest.mark.parametrize("channels_last", [True, False])
def test_adjoint_pool_stage_kernel_ragged(cuda, C, dtype, kind,
                                          channels_last):
    B, H, W = 2, 64, 160
    seg, K = _adjoint_seg(cuda, kind, B, H, W)
    for s in range(1, 5):
        Hs, Ws = H >> s, W >> s
        taps = torch.randn((B, Hs, Ws, C), device=cuda)
        A_h = torch.as_tensor(_interp_matrix(Hs, H, True), device=cuda)
        tapsH_T = torch.einsum("hu,buvc->bhvc", A_h, taps).to(dtype).permute(
            0, 3, 1, 2)
        if not channels_last:
            tapsH_T = tapsH_T.contiguous()
        A_wT = torch.from_numpy(_interp_matrix(Ws, W, True)).t()
        got = adjoint.adjoint_pool_stage(seg, tapsH_T, A_wT, K)
        want = adjoint.adjoint_pool_stage_plain(seg, tapsH_T, A_wT, K)
        torch.cuda.synchronize()
        lim = 1e-5 * max(1.0, want.abs().max().item())
        if dtype == torch.bfloat16:
            mass = adjoint.adjoint_pool_stage_plain(seg, tapsH_T.abs(), A_wT,
                                                    K)
            lim = lim + 2.0 ** -8 * mass
        assert ((got - want).abs() <= lim).all(), s
        assert torch.equal(got, adjoint.adjoint_pool_stage(seg, tapsH_T,
                                                           A_wT, K)), s
        if kind == "invalid":
            assert not got.any()


# ---------------------------------------------------------------------------
# K1, K3 and K4 at ragged shapes: the compacted pixel lists (K1, in rounds
# when longer than the kernel's 128-pixel buffer), K3's pixel runs and
# lane map, the term lists (K4), the masked channel tail and all-invalid
# images.  Limits as above (K3: equal); two launches agree bitwise; in bf16
# K4 also equals an ordered replay of its arithmetic.
# ---------------------------------------------------------------------------

def _pool0_seg(dev, kind):
    """(plan, seg_m) on a 96x128 canvas: SLIC with ragged validity
    ("slic"), SLIC at sp_area 1500, whose clusters hold many rounds of K1's
    pixels ("big"), or an image whose pixels are all invalid."""
    if kind == "big":
        plan, seg, valid = _seg(dev, 1, 96, 128, 1500, seed=7)
    else:
        plan, seg, valid = _seg(dev, 2, 96, 128, 150, seed=7)
    if kind == "invalid":
        valid = torch.zeros_like(valid)
    return plan, torch.where(valid, seg, -1).contiguous()


@pytest.mark.parametrize("C", [5, 40, 128, 136])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.02)])
@pytest.mark.parametrize("kind", ["slic", "big", "invalid"])
def test_cell_pool0_kernel_ragged(cuda, C, dtype, tol, kind):
    plan, seg_m = _pool0_seg(cuda, kind)
    if kind == "big":
        sizes = torch.bincount(seg_m[seg_m >= 0].long())
        assert sizes.max().item() > 4 * 128   # five rounds of the kernel
    gen = torch.Generator(device=cuda).manual_seed(0)
    taps = torch.randn(seg_m.shape + (C,), generator=gen,
                       device=cuda).to(dtype)
    before = launch_counts()["cell_pool0"]
    got = cellpool.cell_pool0(plan, seg_m, taps)
    assert launch_counts()["cell_pool0"] == before + 1
    want = cellpool.cell_pool0_plain(plan, seg_m, taps)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert torch.equal(got, cellpool.cell_pool0(plan, seg_m, taps))
    if kind == "invalid":
        assert not got.any()


@pytest.mark.parametrize("C", [5, 37, 128, 136, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["slic", "big", "invalid"])
@pytest.mark.parametrize("offset", [0, 1])
def test_cell_pool0_bwd_kernel_ragged(cuda, C, dtype, kind, offset):
    """K3 bitwise equal to the plain gather at channel counts that take its
    scalar form (5, 37), one or two slots a warp (128, 136) and four
    256-channel chunks (1024), over SLIC's segments, large segments whose
    rows the walk reuses over whole runs ("big") and all-invalid images;
    ``offset`` moves dsums off its 16-byte alignment (the scalar form)."""
    plan, seg_m = _pool0_seg(cuda, kind)
    B = seg_m.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(2)
    n = B * plan.n_clusters * C
    dsums = torch.randn(n + offset, generator=gen, device=cuda)[
        offset:].view(B, plan.n_clusters, C)
    before = launch_counts()["cell_pool0_bwd"]
    got = cellpool.cell_pool0_bwd(plan, seg_m, dsums, dtype)
    assert launch_counts()["cell_pool0_bwd"] == before + 1
    want = cellpool.cell_pool0_bwd_plain(plan, seg_m, dsums, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, cellpool.cell_pool0_bwd(plan, seg_m, dsums,
                                                    dtype))
    if kind == "invalid":
        assert not got.any()


def _k4_replay(spp, mc, dsums):
    """K4's arithmetic in torch: per stage pixel, w * T(dsums[k]) over the
    nonzero weights of clusters in the grid, added in (i, j) order, each add
    rounded to f32, the sum rounded to T.  In bf16 each product is exact in
    f32, so this is the kernel's fmaf sequence."""
    B, Hs, Ih, Ws, Jw = mc.shape
    ds = dsums.to(mc.dtype).float()
    dev = mc.device
    ay = torch.as_tensor(spp.anchor_y, device=dev).long() + spp.rmin_y
    ax = torch.as_tensor(spp.anchor_x, device=dev).long() + spp.rmin_x
    acc = torch.zeros((B, Hs, Ws, ds.shape[-1]), device=dev)
    for i in range(Ih):
        ky = ay + i
        in_y = (ky >= 0) & (ky < spp.Kh)
        for j in range(Jw):
            kx = ax + j
            in_grid = in_y[:, None] & ((kx >= 0) & (kx < spp.Kw))[None, :]
            w = mc[:, :, i, :, j].float() * in_grid
            k = (ky.clamp(0, spp.Kh - 1)[:, None] * spp.Kw
                 + kx.clamp(0, spp.Kw - 1)[None, :])
            x = ds[:, k.reshape(-1)].reshape(acc.shape)
            acc = torch.where((w != 0)[..., None], acc + w[..., None] * x,
                              acc)
    return acc.to(mc.dtype)


@pytest.mark.parametrize("C", [5, 37, 72, 256, 1544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["masks", "invalid"])
def test_cell_pool_stage_bwd_kernel_ragged(cuda, C, dtype, kind):
    """K4 at every stage of the main-path plan (stage 4: Ih = Jw = 7), with
    the forward's window weights ("masks") or those of an image whose
    pixels are all invalid (every weight 0, so every gradient 0)."""
    B, H, W = 1, 288, 416
    plan, seg, valid = _seg(cuda, B, H, W, 200, seed=8)
    if kind == "invalid":
        valid = torch.zeros_like(valid)
    e9 = cellgrid.offset_masks(plan, seg, valid, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for s in range(1, 5):
        spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
        if s == 4:
            assert (spp.Ih, spp.Jw) == (7, 7)
        mc = cellgrid.stage_window_weights(spp, e9)
        dsums = torch.randn((B, plan.n_clusters, C), generator=gen,
                            device=cuda)
        before = launch_counts()["cell_pool_stage_bwd"]
        got = cellpool.cell_pool_stage_bwd(spp, mc, dsums)
        assert launch_counts()["cell_pool_stage_bwd"] == before + 1
        want = cellpool.cell_pool_stage_bwd_plain(spp, mc, dsums, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            lim = 1e-5 * max(1.0, want.abs().max().item())
            assert err.max().item() <= lim, s
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -126))) - 7)
            mass = cellpool.cell_pool_stage_bwd_plain(
                spp, mc.abs(), dsums.abs(), torch.float32)
            assert (err <= ulp + 1e-5 * mass).all(), s
            assert torch.equal(got, _k4_replay(spp, mc, dsums)), s
        assert torch.equal(got, cellpool.cell_pool_stage_bwd(spp, mc,
                                                             dsums)), s
        if kind == "invalid":
            assert not got.any()


@pytest.mark.parametrize("B,H,W,C,cout", [(2, 32, 64, 64, 128),
                                          (2, 32, 64, 64, 64),
                                          (1, 33, 65, 64, 128),
                                          (1, 10, 14, 37, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_relu_pool_pad_kernel_matches_reference(cuda, B, H, W, C, cout,
                                                      dtype):
    """K7 and its gradient equal the plain composition (max and zero-padding
    round nothing; the backward replays it)."""
    pre = torch.randn((B, C, H, W), device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    before = launch_counts()["fused_relu_pool_pad"]
    p = pre.detach().requires_grad_(True)
    got = pool.fused_relu_pool_pad(p, cout)
    assert launch_counts()["fused_relu_pool_pad"] == before + 1
    assert got.is_contiguous() and got.shape == (B, H // 2, W // 2, cout)
    want = pool.reference(pre, cout)
    assert torch.equal(got, want)
    w = torch.randn(got.shape, device=cuda)
    (g,) = torch.autograd.grad((got.float() * w).sum(), p)
    p2 = pre.detach().requires_grad_(True)
    (g_ref,) = torch.autograd.grad((pool.reference(p2, cout).float()
                                    * w).sum(), p2)
    assert torch.equal(g, g_ref)
    with pytest.raises(ValueError):
        pool.fused_relu_pool_pad(pre.transpose(1, 2), cout)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Bad dtypes and shapes raise; a feature that requires grad is taken,
    and its gradient comes from K3's kernel (bitwise the plain gather)."""
    plan, seg, valid = _seg(cuda, 1, 64, 160, 200)
    feat = torch.randn((1, 64 * 160, 8), device=cuda, requires_grad=True)
    dsums = torch.randn((1, plan.n_clusters, 8), device=cuda)
    before = launch_counts()["segment_sum_bwd"]
    pooling.segment_sum(seg.reshape(1, -1), feat, plan.n_clusters).backward(
        dsums)
    assert launch_counts()["segment_sum_bwd"] == before + 1
    assert torch.equal(feat.grad, pooling.segment_sum_bwd_plain(
        seg.reshape(1, -1), dsums, torch.float32))
    with pytest.raises(TypeError):
        pooling.segment_sum(seg.reshape(1, -1), feat.detach().half(),
                            plan.n_clusters)
    tapsH_T = torch.randn((1, 8, 64, 80), device=cuda)
    with pytest.raises(ValueError):
        adjoint.adjoint_pool_stage(seg, tapsH_T, torch.ones(80, 150),
                                   plan.n_clusters)
    with pytest.raises(TypeError):
        adjoint.adjoint_pool_stage(
            seg, tapsH_T.double(),
            torch.from_numpy(_interp_matrix(80, 160, True)).t(),
            plan.n_clusters)


# ---------------------------------------------------------------------------
# The backward of K5 (K3's kernel through segment_sum_bwd) and of K6 (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,P,C,offset", [(2, 10240, 128, 0),
                                          (1, 3000, 37, 0),
                                          (2, 500, 40, 1),
                                          (1, 777, 1024, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_bwd_kernel_matches_plain(cuda, B, P, C, offset, dtype):
    """K5's backward on K3's kernel: a selection, bitwise equal to the
    plain gather, with ids -1 and ids >= K (which add nothing and get a
    zero gradient).  ``offset`` moves dsums off its 16-byte alignment and
    C = 37 is not a multiple of 8 (K3's scalar form)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    K = 37
    seg = torch.randint(-1, K + 4, (B, P), generator=gen, device=cuda,
                        dtype=torch.int32)
    assert (seg >= K).any() and (seg < 0).any()
    dsums = torch.randn(B * K * C + offset, generator=gen, device=cuda)[
        offset:].view(B, K, C)
    before = launch_counts()["segment_sum_bwd"]
    got = pooling.segment_sum_bwd(seg, dsums, dtype)
    assert launch_counts()["segment_sum_bwd"] == before + 1
    want = pooling.segment_sum_bwd_plain(seg, dsums, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, P, C)
    assert torch.equal(got, want)
    assert not got[(seg < 0) | (seg >= K)].any()
    assert torch.equal(got, pooling.segment_sum_bwd(seg, dsums, dtype))


def _dsums(dev, B, K, C, layout, gen):
    """A (B, K, C) f32 cotangent: contiguous, off its 16-byte alignment
    ("offset"), or a transposed (B, C, K) tensor ("strided", channels not
    contiguous); the last two take K8's scalar form."""
    if layout == "strided":
        return torch.randn((B, C, K), generator=gen, device=dev).transpose(
            1, 2)
    off = 1 if layout == "offset" else 0
    return torch.randn(B * K * C + off, generator=gen, device=dev)[
        off:].view(B, K, C)


@pytest.mark.parametrize("C", RAGGED_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["slic", "big", "invalid"])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "strided"])
def test_adjoint_pool_stage_bwd_kernel_matches_plain(cuda, C, dtype, kind,
                                                     layout):
    """K8 against its plain version at every stage of a 64x160 canvas and
    at ragged (Ws, W): f32 to 1e-5 of each element's mass (the sum of its
    |terms|: p_h's weights and the terms are summed in another order);
    bf16 also 2^-8 of the mass (p_h's f32 weight sums may round to bf16
    values one ulp apart, as for K6) and one bf16 ulp of the value (the
    output's rounding).  Two launches agree bitwise; the result is a view
    of a channels-last (B, H, Ws, C) tensor."""
    B, H, W = 2, 64, 160
    seg, K = _adjoint_seg(cuda, kind, B, H, W)
    gen = torch.Generator(device=cuda).manual_seed(4)
    for Ws, Wc in [(W >> s, W) for s in range(1, 5)] + [(7, 150), (1, 20)]:
        sg = seg[..., :Wc].contiguous()
        A_wT = torch.from_numpy(_interp_matrix(Ws, Wc, True)).t()
        dsums = _dsums(cuda, B, K, C, layout, gen)
        before = launch_counts()["adjoint_pool_stage_bwd"]
        got = adjoint.adjoint_pool_stage_bwd(sg, dsums, A_wT, K, dtype)
        assert launch_counts()["adjoint_pool_stage_bwd"] == before + 1
        want = adjoint.adjoint_pool_stage_bwd_plain(sg, dsums, A_wT, K, dtype)
        mass = adjoint.adjoint_pool_stage_bwd_plain(sg, dsums.abs(), A_wT, K,
                                                    torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, C, H, Ws)
        assert got.permute(0, 2, 3, 1).is_contiguous()
        lim = 1e-5 * mass
        if dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -126))) - 7)
            lim = lim + 2.0 ** -8 * mass + ulp
        assert ((got.float() - want.float()).abs() <= lim).all(), (Ws, Wc)
        assert torch.equal(got, adjoint.adjoint_pool_stage_bwd(
            sg, dsums, A_wT, K, dtype)), (Ws, Wc)
        if kind == "invalid":
            assert not got.any()


@pytest.mark.parametrize("pooling_,launches", [
    ("adjoint", {"segment_sum": 1, "adjoint_pool_stage": 4,
                 "segment_sum_bwd": 1, "adjoint_pool_stage_bwd": 4}),
    ("fullres", {"segment_sum": 2, "segment_sum_bwd": 2})])
def test_adjoint_and_fullres_train_on_card(cuda, pooling_, launches):
    """One f32 forward + loss + backward on the same prep, card against
    CPU, with the limits of test_train_step_grads_on_card_match_cpu; then
    the launches of one bf16 train step through make_train_step."""
    cfg = WESUPConfig(compute_dtype="float32", pooling=pooling_)
    H, W = 64, 160
    batch = _train_batch(2, H, W, (58, 141))
    plan = make_plan(H, W, cfg.sp_area)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    prep = steps._preprocess_sample(
        None, b["image"], b["valid"], b["pixel_mask"], b["points"],
        b["point_valid"], b["use_mask_as_points"], config=cfg, train=False,
        point_mode=True)
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = wesup.WESUP(fc_width=64,
                            generator=torch.Generator().manual_seed(0)).to(dev)
        p = steps.Preprocessed(*(t.to(dev) for t in prep))
        reset_launches()
        loss, _ = steps._forward_and_loss(model, p, plan.n_clusters, cfg,
                                          b["sample_valid"].to(dev), plan)
        loss.backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert launch_counts() == _expected(launches)
        losses[str(dev)] = loss.item()
        grads[str(dev)] = {n: q.grad.cpu() for n, q in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for name, want in grads["cpu"].items():
        rel = 1e-2 if name.startswith("backbone.") else 1e-3
        err = (grads["cuda"][name] - want).abs().max().item()
        assert err <= rel * want.abs().max().item() + 1e-12, name

    cfg = WESUPConfig(pooling=pooling_)
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    step = steps.make_train_step(cfg, (H, W), point_mode=True)
    reset_launches()
    acc = step(model, steps.make_optimizer(cfg, model),
               steps.init_metric_acc(), batch, prng.PRNGKey(0))
    torch.cuda.synchronize()
    assert launch_counts() == _expected(launches)
    assert not acc["nan"].item()
    assert all(torch.isfinite(q).all() for q in model.parameters())


CONFIGS = [
    ("adjoint", False, {"segment_sum": 1, "adjoint_pool_stage": 4}),
    ("fullres", False, {"segment_sum": 2}),
    ("local", True, {"cell_pool0": 1, "cell_pool_stage": 4,
                     "fused_relu_pool_pad": 1}),
]


def _expected(nonzero: dict) -> dict:
    return {name: nonzero.get(name, 0) for name in launch_counts()}


@pytest.mark.parametrize("pooling_,gated,launches", CONFIGS)
def test_predict_step_configurations_on_card(cuda, monkeypatch, pooling_,
                                             gated, launches):
    if gated:
        monkeypatch.setenv("WESUP_FUSED_POOL1", "1")
    cfg = WESUPConfig(compute_dtype="float32", pooling=pooling_)
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(2)
    imgs = np.clip(rng.normal(200, 25, (2, 64, 160, 3)), 0, 255).astype(
        np.uint8)
    valid = np.zeros((2, 64, 160), bool)
    valid[:, :58, :141] = True
    want = make_predict_step(cfg, (64, 160), device="cpu")(model, imgs, valid)
    reset_launches()
    got = make_predict_step(cfg, (64, 160))(model.to(cuda), imgs, valid)
    torch.cuda.synchronize()
    assert launch_counts() == _expected(launches)
    # as in test_predict_step_on_card_matches_cpu: SLIC may flip a
    # near-tie pixel between the card and the CPU
    close = (got.cpu() - want).abs() <= 2e-4
    assert close.float().mean().item() >= 0.999


def test_gated_train_step_on_card(cuda, monkeypatch):
    monkeypatch.setenv("WESUP_FUSED_POOL1", "1")
    cfg = WESUPConfig()
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    optimizer = steps.make_optimizer(cfg, model)
    step = steps.make_train_step(cfg, (64, 160), point_mode=True)
    acc = steps.init_metric_acc()
    reset_launches()
    acc = step(model, optimizer, acc, _train_batch(2, 64, 160, (58, 141)),
               prng.PRNGKey(0))
    torch.cuda.synchronize()
    assert launch_counts() == _expected({
        "cell_pool0": 1, "cell_pool_stage": 4, "cell_pool0_bwd": 1,
        "cell_pool_stage_bwd": 4, "fused_relu_pool_pad": 1})
    assert not acc["nan"].item()
    assert all(torch.isfinite(q).all() for q in model.parameters())


# ---------------------------------------------------------------------------
# the trainer's slice: device resize, per-batch generators, bucketed steps,
# fit
# ---------------------------------------------------------------------------

def _resize_case(seed, n=4, full=(200, 300), scale=0.3, canvases=((64, 96),
                                                                  (96, 128))):
    """A device-resize cache and one B=2 batch (plus a blank) per canvas."""
    from wesup_tpu_torch.data.loader import (CanvasSpec, _blank_meta_item,
                                             place_meta_on_canvas)

    rng = np.random.default_rng(seed)
    cache = {"imgs": rng.integers(0, 256, (n,) + full + (3,), np.uint8),
             "masks": rng.integers(0, 2, (n,) + full).astype(np.int8)}
    batches = []
    for H, W in canvases:
        spec = CanvasSpec(H, W)
        items = []
        for i in range(2):
            th = min(H, int(np.ceil(scale * full[0])) + 8 * i)
            tw = min(W, int(np.ceil(scale * full[1])) + 8 * i)
            pts = np.stack([rng.integers(0, tw, 6), rng.integers(0, th, 6),
                            rng.integers(0, 2, 6)], -1)
            items.append(place_meta_on_canvas(
                {"img_idx": i + 1, "full_hw": full, "target_hw": (th, tw),
                 "points": pts, "use_mask_as_points": False}, spec))
        items.append(_blank_meta_item(spec))
        batches.append({k: np.stack([it[k] for it in items])
                        for k in items[0]})
    return cache, batches


def test_device_resize_on_card_matches_cpu(cuda):
    from wesup_tpu_torch.ops import train_resize

    cache, batches = _resize_case(0)
    for batch in batches:
        outs = []
        for dev in ("cpu", cuda):
            outs.append(train_resize.apply_resize(
                {k: torch.from_numpy(v).to(dev) for k, v in cache.items()},
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}))
        for got, want in zip(outs[1], outs[0]):
            assert got.is_cuda and torch.equal(got.cpu(), want)


def test_batch_generators_seed_alike_on_both_devices(cuda):
    """A batch's key and draws are host arithmetic: the same on a step for
    the card as for the CPU, and what ``batch_key`` gives; the drawn
    parameters reach the card unchanged (the affine matrices, computed
    from them on each device, within 1e-4); an ``rng_idx`` on the card is
    refused."""
    base = prng.PRNGKey(12)
    cfg = WESUPConfig()
    for rng_idx in ((1, 0), (3, 7), np.array([[2, 5]] * 4, np.int32)):
        key = steps.step_key(base, {"rng_idx": rng_idx}, "train")
        pair = np.asarray(rng_idx).reshape(-1, 2)[0]
        want = steps.batch_key(base, int(pair[0]), 0, int(pair[1]))
        assert np.array_equal(key, want)
        ref, got = (steps.sample_augmentation(cfg, 4, (64, 160), False, key,
                                              dev) for dev in ("cpu", cuda))
        assert got.affine.is_cuda
        for name in ("appearance", "elastic"):
            for a, b in zip(_leaves(getattr(got, name)),
                            _leaves(getattr(ref, name))):
                assert torch.equal(a.cpu(), b), name
        assert (got.affine.cpu() - ref.affine).abs().max().item() <= 1e-4
    with pytest.raises(ValueError, match="host"):
        steps.step_key(base, {"rng_idx": torch.zeros(2, 2, device=cuda)},
                       "train")


def _leaves(x):
    """The tensors of a nested NamedTuple, in order (None skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in (x or ()) for t in _leaves(v)]


def test_bucketed_train_and_eval_steps_on_card(cuda):
    """The trainer's wire formats (img_idx with the cache, rng_idx) at two
    bucket canvases: K1-K4 per train step, K1/K2 per eval step."""
    cache, batches = _resize_case(1)
    dcache = {k: torch.from_numpy(v).to(cuda) for k, v in cache.items()}
    cfg = WESUPConfig()
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    optimizer = steps.make_optimizer(cfg, model)
    for i, batch in enumerate(batches):
        hw = (batch["rsz_iy"].shape[1], batch["rsz_ix"].shape[1])
        train = steps.make_train_step(cfg, hw, point_mode=True)
        evaluate = steps.make_eval_step(cfg, hw)
        b = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
        acc = steps.init_metric_acc()
        reset_launches()
        acc = train(model, optimizer, acc, dict(b, rng_idx=(1, i)),
                    prng.PRNGKey(5), cache=dcache)
        torch.cuda.synchronize()
        assert launch_counts() == _expected({
            "cell_pool0": 1, "cell_pool_stage": 4, "cell_pool0_bwd": 1,
            "cell_pool_stage_bwd": 4})
        assert acc["count"].item() == 2 and not acc["nan"].item()
        reset_launches()
        pred, eacc = evaluate(model, steps.init_metric_acc(
            steps.EVAL_METRIC_KEYS), b, cache=dcache)
        torch.cuda.synchronize()
        assert launch_counts() == _expected({"cell_pool0": 1,
                                             "cell_pool_stage": 4})
        assert tuple(pred.shape) == (3,) + hw
        assert torch.isfinite(pred).all() and eacc["count"].item() == 2


def _write_dataset(root, seed=0, hw=(96, 128)):
    """A small dataset written with the port's own PNG writer (no cv2):
    3 train images with masks and points, 2 val images with masks."""
    from wesup_tpu_torch.data.codec import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for split, n in (("train", 3), ("val", 2)):
        for d in ("images", "masks") + (("points",) if split == "train"
                                        else ()):
            (root / split / d).mkdir(parents=True)
        for i in range(n):
            mask = (((yy - rng.integers(20, 70)) ** 2
                     + (xx - rng.integers(20, 100)) ** 2) < 600).astype(
                         np.uint8)
            img = np.clip(np.where(mask[..., None] == 1, 150, 215)
                          + rng.normal(0, 10, hw + (3,)), 0,
                          255).astype(np.uint8)
            write_png(root / split / "images" / f"{i}.png", img)
            write_png(root / split / "masks" / f"{i}.png", mask)
            if split == "train":
                ys, xs = np.nonzero(mask >= 0)
                pick = rng.choice(len(ys), 6, replace=False)
                (root / split / "points" / f"{i}.csv").write_text("".join(
                    f"{xs[j]},{ys[j]},{mask[ys[j], xs[j]]}\n" for j in pick))


def test_fit_one_epoch_on_card(cuda, tmp_path, monkeypatch, caplog):
    from wesup_tpu_torch.train import fit

    _write_dataset(tmp_path / "ds")
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "records"))
    with caplog.at_level(logging.ERROR, logger="Train"):
        trainer = fit(tmp_path / "ds", epochs=1, batch_size=2, fc_width=64)
    # the trainer logs and skips a step that raises: none may have
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    for phase in ("train", "val"):
        stats = trainer.phase_stats[(1, phase)]
        assert stats["batches"] > 0 and stats["failed"] == 0, (phase, stats)
    assert trainer.device.type == "cuda"
    assert all(c["imgs"].is_cuda for c in trainer._resize_cache.values())
    rd = trainer.record_dir
    assert [p.name for p in (rd / "checkpoints").iterdir()] == [
        "ckpt.0001.pth"]
    rows = (rd / "history.csv").read_text().splitlines()
    assert len(rows) == 2
    assert all(np.isfinite(float(v)) for v in rows[1].split(","))


def test_val_phase_host_metrics_on_card(cuda, tmp_path):
    """The trainer's val phase with ``metrics=object_dice`` on the card: it
    reads each val batch's map back once, and the rounded masks it scores
    equal a ``device="cpu"`` run's on at least 0.999 of their pixels (f32,
    the same seeded weights)."""
    from wesup_tpu_torch.models import initialize_trainer

    _write_dataset(tmp_path / "ds")
    masks, reads = {}, {}
    for dev in ("cuda", "cpu"):
        trainer = initialize_trainer(
            "wesup", device=dev, metrics="object_dice", fc_width=64,
            compute_dtype="float32", seed=0)
        trainer.setup_dataloaders(tmp_path / "ds" / "train",
                                  tmp_path / "ds" / "val")
        seen, fetched = [], []
        real_eval, real_fetch = trainer.evaluate_host, trainer._fetch_pred
        trainer.evaluate_host = lambda fns, preds, targets: (
            seen.extend(preds) or real_eval(fns, preds, targets))
        trainer._fetch_pred = lambda pred: (fetched.append(pred.device.type)
                                            or real_fetch(pred))
        trainer.tracker.start_new_epoch(trainer.current_lr())
        trainer.tracker.eval()
        stats = trainer._run_val_phase()
        assert stats["batches"] == len(trainer.dataloaders["val"]) == 2
        assert stats["failed"] == 0
        masks[dev], reads[dev] = seen, fetched
    assert reads["cuda"] == ["cuda"] * 2 and reads["cpu"] == ["cpu"] * 2
    assert [m.shape for m in masks["cuda"]] == [m.shape for m in masks["cpu"]]
    got, want = (np.concatenate([m.ravel() for m in masks[d]])
                 for d in ("cuda", "cpu"))
    assert set(np.unique(want)) <= {0, 1}
    assert (got == want).mean() >= 0.999


def test_quality_protocol_runs_on_card(cuda, tmp_path, monkeypatch):
    """``scripts.quality_protocol`` on the card at 2 epochs and 64x80 (the
    easy generator, which draws no raster): the summary holds the JAX
    script's keys, the card's line and both splits' five metrics."""
    from wesup_tpu_torch.scripts import quality_protocol as qp

    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "unused"))
    summary = qp.main(["--epochs", "2", "--hw", "64", "80", "--n-train", "2",
                       "--n-val", "1", "--n-test", "1", "--root",
                       str(tmp_path / "qp"), "--out",
                       str(tmp_path / "qp.json")])
    assert set(summary) == {"variant", "epochs", "best_val_dice",
                            "final_val_dice", "splits", "wall_s",
                            "record_dir", "card"}
    assert (summary["variant"], summary["epochs"]) == ("easy", 2)
    assert summary["card"].startswith(torch.cuda.get_device_name(0))
    for split in ("testA", "testB"):
        got = summary["splits"][split]
        assert set(got) == {"Accuracy", "Dice", "Detection F1",
                            "Object Dice", "Object Hausdorff"}
        assert all(np.isfinite(v) for v in got.values())
    rows = (Path(summary["record_dir"]) / "history.csv").read_text()
    assert len(rows.splitlines()) == 3


def _to(x, dev):
    """A NamedTuple of tensors (nested, None kept) on ``dev``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(_to(v, dev) for v in x))


@pytest.mark.parametrize("point_mode", [True, False], ids=["points", "mask"])
def test_train_augmentation_on_card_matches_cpu(cuda, point_mode):
    """The train step's preprocessing (appearance with CLAHE and blur,
    warps, elastic, point rasterisation, SLIC and the supervision) on the
    card against the CPU, on the same drawn parameters and gland-like
    images: the masks, seg and supervision equal on at least 0.999 of the
    pixels, as JAX's prep is held on the CPU (tests/test_torch_port_train.py).
    Each image that CLAHE does not touch is within 1e-4 on at least 0.999
    of its samples, the same hold.  CLAHE quantises L into 256 bins: where
    the two devices round a colour's L to either side of a bin edge, every
    pixel of that colour moves by up to one bin's step of the equalised
    map, about the clip limit 4 over 256 bins (0.016), so an image that
    CLAHE touches may differ on a whole colour's share of its samples (one
    of this batch's does on 4.7%, by at most 0.0052 after the warp); it is
    held within 0.02 everywhere, and the batch within 1e-4 on at least
    0.98 of its samples."""
    from wesup_tpu_torch.scripts.make_dataset import make_image

    B, H, W = 4, 96, 128
    rng = np.random.default_rng(3)
    imgs, masks = zip(*(make_image(rng, H, W) for _ in range(B)))
    image = torch.from_numpy(np.stack(imgs))
    pixel_mask = torch.from_numpy(np.stack(masks).astype(np.int32))
    valid = torch.ones((B, H, W), dtype=torch.bool)
    valid[:, -9:] = False
    pixel_mask[~valid] = -1
    points = torch.zeros((B, 16, 3), dtype=torch.int32)
    point_valid = torch.zeros((B, 16), dtype=torch.bool)
    for b in range(B):
        ys, xs = np.nonzero(masks[b][:H - 9] >= 0)
        pick = rng.choice(len(ys), 8, replace=False)
        points[b, :8] = torch.from_numpy(np.stack(
            [xs[pick], ys[pick], masks[b][ys[pick], xs[pick]]], -1))
        point_valid[b, :8] = True
    use_mask = torch.zeros((B,), dtype=torch.bool)
    cfg = WESUPConfig(compute_dtype="float32")
    params = steps.sample_augmentation(cfg, B, (H, W), point_mode,
                                       prng.PRNGKey(5), "cpu")
    # every appearance branch taken by some image
    params = params._replace(appearance=params.appearance._replace(
        clahe=torch.tensor([True, False, True, False]),
        blur=torch.tensor([True, True, False, False])))
    if not point_mode:
        params = params._replace(elastic=params.elastic._replace(
            apply=torch.tensor([True, False, True, True])))
    out = {}
    for dev in ("cpu", cuda):
        args = [t.to(dev) for t in (image, valid, pixel_mask, points,
                                    point_valid, use_mask)]
        out[str(dev)] = steps._preprocess_sample(
            _to(params, dev), *args, config=cfg, train=True,
            point_mode=point_mode)
    want, got = out["cpu"], out[str(torch.device(cuda))]
    diff = (got.image.cpu() - want.image).abs()
    close = (diff <= 1e-4).flatten(1).float().mean(1)
    for b, clahe in enumerate(params.appearance.clahe.tolist()):
        if not clahe:
            assert close[b].item() >= 0.999, (b, close.tolist())
    assert close.mean().item() >= 0.98, close.tolist()
    assert diff.max().item() <= 0.02
    for name in ("valid", "target", "seg", "sup_mask"):
        same = getattr(got, name).cpu() == getattr(want, name)
        assert same.float().mean().item() >= 0.999, name
    assert want.sup_mask.sum() > 0


# ---------------------------------------------------------------------------
# The tile cut and stitch (csrc/tile.cu) and predict_tiled on the card
# ---------------------------------------------------------------------------

TILE_SLIDES = [((1512, 1516), 400), ((64, 80), 48), ((48, 48), 48)]


def _tiling(hw, patch):
    """The grid's tops and lefts (CPU int32), the patch and canvas sizes."""
    tops, lefts = (torch.from_numpy(a.astype(np.int32))
                   for a in inference.patch_grid(*hw, patch))
    h, w = min(patch, hw[0]), min(patch, hw[1])
    return tops, lefts, (h, w), (-(-h // 32) * 32, -(-w // 32) * 32)


@pytest.mark.parametrize("hw,patch", TILE_SLIDES)
def test_tile_cut_kernel_matches_plain(cuda, hw, patch):
    """Every chunk of 8, every chunk of 3 padded to 4 rows, and a shard of
    blank rows: bitwise the plain cut (IEEE division by 255 on both)."""
    slide = torch.from_numpy(np.random.default_rng(20).integers(
        0, 256, hw + (3,), dtype=np.uint8))
    tops, lefts, patch_hw, canvas_hw = _tiling(hw, patch)
    on_card = [t.to(cuda) for t in (slide, tops, lefts)]
    n = len(tops) * len(lefts)
    cases = [(first, min(chunk, n - first), min(chunk, n - first) + extra)
             for chunk, extra in ((8, 0), (3, 1))
             for first in range(0, n, chunk)] + [(n, 0, 1)]
    for first, n_real, n_rows in cases:
        before = launch_counts()["tile_cut"]
        got = tile.cut(*on_card, first, n_real, n_rows, patch_hw, canvas_hw)
        assert launch_counts()["tile_cut"] == before + 1
        want = tile.cut(slide, tops, lefts, first, n_real, n_rows, patch_hw,
                        canvas_hw)
        assert got.shape == want.shape == (n_rows, *canvas_hw, 3)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), (first, n_real)


@pytest.mark.parametrize("hw,patch", TILE_SLIDES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("round_patches", [False, True])
def test_tile_stitch_kernel_matches_plain(cuda, hw, patch, dtype,
                                          round_patches):
    """The float64 running average bitwise the plain stitch's (which is
    ``combine_patches_to_image``'s, tests/test_torch_port_infer.py), on
    float32 probabilities with ties to round and on uint8 values."""
    tops, lefts, (h, w), _ = _tiling(hw, patch)
    n = len(tops) * len(lefts)
    rng = np.random.default_rng(21)
    if dtype == torch.uint8:
        probs = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    else:
        probs = rng.random((n, h, w), dtype=np.float32)
        probs[:, 0, :3] = [0.5, 1.5, 2.5]
    probs = torch.from_numpy(probs)
    before = launch_counts()["tile_stitch"]
    got = tile.stitch(probs.to(cuda), tops.to(cuda), lefts.to(cuda), hw,
                      round_patches)
    assert launch_counts()["tile_stitch"] == before + 1
    want = tile.stitch(probs, tops, lefts, hw, round_patches)
    assert got.dtype == torch.float64 and got.shape == hw
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


def test_predict_tiled_on_card_matches_the_host_route(cuda):
    """A pixel-mode ``predict_tiled`` of a CRAG-size slide (16 patches of
    400 in chunks of 8, bfloat16) on the card equals, bitwise, the route
    that cut, copied back and stitched on the host: the same canvases
    through the same steps, ``combine_patches_to_image`` over
    ``predict_padded``.  Two cuts, one stitch, two pixel-head upsamples
    and two pixel-head tails (one each a chunk) are launched."""
    model = wesup.WESUP(generator=torch.Generator().manual_seed(0))
    pred = inference.Predictor(model, WESUPConfig(), mode="pixel",
                               device=cuda)
    img = np.random.default_rng(22).integers(0, 256, (1512, 1516, 3),
                                             dtype=np.uint8)
    patches = inference.divide_image_to_patches(img, 400)
    probs = np.concatenate([pred.predict_padded(
        patches[i:i + 8].astype(np.float32) / 255.0) for i in (0, 8)])
    want = inference.combine_patches_to_image(probs, 1512, 1516)
    reset_launches()
    got = inference.predict_tiled(pred, img, 400, chunk=8,
                                  round_patches=False)
    assert _counts(*TILE) == {"tile_cut": 2, "tile_stitch": 1}
    assert launch_counts()["hypercol_upsample"] == 2
    assert launch_counts()["pixel_head"] == 2
    assert got.dtype == np.float64 and got.shape == (1512, 1516)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_tile_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Bad dtypes, devices, layouts and sizes raise before a launch."""
    tops, lefts, patch_hw, canvas_hw = _tiling((64, 80), 48)
    tops, lefts = tops.to(cuda), lefts.to(cuda)
    slide = torch.zeros((64, 80, 3), dtype=torch.uint8, device=cuda)
    probs = torch.zeros((4, 48, 48), device=cuda)
    before = _counts(*TILE)
    for kind, call in [
            (TypeError, lambda: tile.cut(slide.float(), tops, lefts, 0, 2, 2,
                                         patch_hw, canvas_hw)),
            (TypeError, lambda: tile.cut(slide, tops.long(), lefts, 0, 2, 2,
                                         patch_hw, canvas_hw)),
            (ValueError, lambda: tile.cut(slide, tops.cpu(), lefts, 0, 2, 2,
                                          patch_hw, canvas_hw)),
            (ValueError, lambda: tile.cut(slide[:, ::2], tops, lefts, 0, 2,
                                          2, patch_hw, canvas_hw)),
            (ValueError, lambda: tile.cut(slide, tops, lefts, 0, 2, 2,
                                          patch_hw, (32, 64))),
            (ValueError, lambda: tile.cut(slide, tops, lefts, 3, 2, 2,
                                          patch_hw, canvas_hw)),
            (ValueError, lambda: tile.cut(slide, tops, lefts, 0, 3, 2,
                                          patch_hw, canvas_hw)),
            (ValueError, lambda: tile.cut(slide, tops, lefts, 0, 0, 0,
                                          patch_hw, canvas_hw)),
            (TypeError, lambda: tile.stitch(probs.double(), tops, lefts,
                                            (64, 80))),
            (TypeError, lambda: tile.stitch(probs.half(), tops, lefts,
                                            (64, 80))),
            (ValueError, lambda: tile.stitch(probs[:3], tops, lefts,
                                             (64, 80))),
            (ValueError, lambda: tile.stitch(probs.transpose(1, 2), tops,
                                             lefts, (64, 80))),
            (ValueError, lambda: tile.stitch(probs, tops, lefts.cpu(),
                                             (64, 80))),
            (ValueError, lambda: tile.stitch(probs, tops, lefts, (0, 80)))]:
        with pytest.raises(kind):
            call()
    assert _counts(*TILE) == before


# two shape groups, interleaved
CARD_SHAPES = [(130, 190), (96, 150), (130, 190), (130, 190), (96, 150),
               (130, 190), (130, 190)]


@pytest.fixture(scope="module")
def card_predictors():
    """A predictor per mode on the card, at the published widths in
    bfloat16, on a head balanced over the test images."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model = host_fuse.balanced(
        wesup.WESUP(generator=torch.Generator().manual_seed(0)),
        host_fuse.images(CARD_SHAPES, seed=30), hw=(64, 96))
    return {mode: inference.Predictor(model, WESUPConfig(), mode=mode,
                                      device=torch.device("cuda"))
            for mode in ("superpixel", "pixel")}


@pytest.mark.parametrize("max_batch", host_fuse.MAX_BATCHES)
@pytest.mark.parametrize("mode,scales,input_size", host_fuse.CASES)
def test_predict_multiscale_batch_on_card_equals_the_host_fuse(
        cuda, card_predictors, monkeypatch, mode, scales, input_size,
        max_batch):
    """On the card, bitwise the host-fuse route (zeroed canvas, each
    scale's map copied back, fused on the host), value and dtype, in
    chunks of 1, 3 and 32 over two shape groups; the forwards inside
    return bitwise the same probabilities on both routes."""
    predictor = card_predictors[mode]
    imgs = host_fuse.images(CARD_SHAPES, seed=31)
    seen = host_fuse.record_forwards(monkeypatch)
    want = host_fuse.predict_multiscale_batch(predictor, imgs, scales,
                                           input_size, max_batch)
    want_probs = seen[:]
    seen.clear()
    got = inference.predict_multiscale_batch(
        predictor, imgs, scales=scales, input_size=input_size,
        max_batch=max_batch)
    host_fuse.assert_same(got, want)
    host_fuse.assert_same_tensors(seen, want_probs)


@pytest.mark.parametrize("mode,scales", [("superpixel", (0.5,)),
                                         ("pixel", (0.5, 0.4))])
def test_predict_multiscale_batch_on_card_results_are_not_reused(
        cuda, card_predictors, mode, scales):
    """A second call, on other images of the same shape and of another,
    leaves the first call's results as they were, though its chunks pass
    through the pinned blocks the first call's chunks freed."""
    predictor = card_predictors[mode]
    first = inference.predict_multiscale_batch(
        predictor, host_fuse.images(CARD_SHAPES[:4], seed=32), scales=scales,
        max_batch=2)
    kept = [a.copy() for a in first]
    second = inference.predict_multiscale_batch(
        predictor, host_fuse.images([(130, 190), (64, 90), (130, 190)],
                                 seed=33), scales=scales, max_batch=2)
    host_fuse.assert_same(first, kept)
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))
    arrays = first + second
    assert not any(np.shares_memory(a, b) for k, a in enumerate(arrays)
                   for b in arrays[k + 1:])


@pytest.mark.parametrize("mode,scales", [("superpixel", (0.5,)),
                                         ("pixel", (0.5, 0.4))])
def test_predict_multiscale_batch_reuses_pinned_memory(cuda, card_predictors,
                                                       mode, scales):
    """After a first call has grown the caching host allocator's pool,
    later calls of the same shapes take every pinned block from it: no
    new pinned allocation, the pool's bytes unchanged."""
    predictor = card_predictors[mode]
    imgs = host_fuse.images(CARD_SHAPES, seed=34)

    def run():
        inference.predict_multiscale_batch(predictor, imgs, scales=scales,
                                           max_batch=3)

    run()
    before = torch.cuda.host_memory_stats()
    for _ in range(4):
        run()
    after = torch.cuda.host_memory_stats()
    for key in ("num_host_alloc", "allocated_bytes.current"):
        assert after[key] == before[key], key


# ---------------------------------------------------------------------------
# hypercol_upsample: the pixel head's W-resize, H-upsample and sum of the
# five stage maps, bias and ReLU in one kernel (ops/hypercol.py), against
# its plain version with tests/torch_hypercol.py's limits (why two bf16
# ulps and not one: its docstring), and bitwise against the replay of its
# arithmetic in bf16.  Canvases: the tile cell's
# 416x416 and a 32-aligned non-square multi-scale canvas; widths: fc1's
# 1024, a tensor-parallel rank's 512 and 24 (the one-channel path).
# ---------------------------------------------------------------------------

@pytest.fixture
def exact_bf16_gemms():
    """bf16 GEMMs that reduce in f32 only, as the kernel sums, for the
    plain version's contraction on the card."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    yield
    matmul.allow_bf16_reduced_precision_reduction = before


@pytest.mark.parametrize("B,H,W", [(2, 416, 416), (2, 96, 160)])
@pytest.mark.parametrize("C", [1024, 512, 24])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hypercol_kernel_matches_plain(cuda, exact_bf16_gemms, B, H, W, C,
                                       dtype):
    maps, bias = torch_hypercol.stage_maps(B, H, W, C, dtype, cuda, seed=C)
    reset_launches()
    got = hypercol.upsample(maps, bias)
    torch.cuda.synchronize()
    assert launch_counts() == _expected({"hypercol_upsample": 1})
    assert got.dtype == dtype and got.shape == (B, H, W, C)
    assert got.is_contiguous()
    beyond, worst = torch_hypercol.gap(got, maps, bias)
    assert beyond == 0, worst
    replayed = torch_hypercol.replay(maps, bias)
    if dtype is torch.bfloat16:
        assert torch.equal(got, replayed)
    else:
        assert torch_hypercol.gap(got, maps, bias, replayed)[0] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hypercol_kernel_on_misaligned_maps(cuda, exact_bf16_gemms, dtype):
    """Maps that start off a 16-byte boundary take the one-channel path."""
    maps, bias = torch_hypercol.stage_maps(2, 64, 96, 64, dtype, cuda,
                                           seed=7)
    shifted = []
    for m in maps:
        buf = torch.empty(m.numel() + 1, dtype=dtype, device=cuda)
        shifted.append(buf[1:].view(m.shape).copy_(m))
    assert shifted[1].data_ptr() % 16 != 0
    got = hypercol.upsample(shifted, bias)
    beyond, worst = torch_hypercol.gap(got, maps, bias)
    assert beyond == 0, worst
    if dtype is torch.bfloat16:
        assert torch.equal(got, torch_hypercol.replay(maps, bias))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_forward_pixel_through_the_kernel_matches_cpu(cuda, dtype, tol):
    """The pixel forward at the published widths through the kernel
    against the CPU's (the plain composition), with the limits that
    tests/test_torch_port_infer.py::test_forward_pixel_matches_jax holds
    the CPU's against JAX; one launch of each pixel-head kernel a
    forward."""
    model = wesup.WESUP(generator=torch.Generator().manual_seed(4)).eval()
    img = torch.rand((2, 96, 128, 3),
                     generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        want = wesup.forward_pixel(model, img, dtype)
        model.to(cuda)
        reset_launches()
        got = wesup.forward_pixel(model, img.to(cuda), dtype)
        torch.cuda.synchronize()
    assert launch_counts() == _expected({"hypercol_upsample": 1,
                                         "pixel_head": 1})
    assert got.shape == want.shape == (2, 96, 128, 2)
    assert (got.cpu() - want).abs().max().item() <= tol


def test_hypercol_refuses_grad_on_card(cuda):
    """The kernel has no backward: an input that requires grad, or a pixel
    forward with grad enabled, raises before a launch."""
    maps, bias = torch_hypercol.stage_maps(1, 32, 32, 8, torch.bfloat16,
                                           cuda)
    reset_launches()
    with pytest.raises(RuntimeError, match="not differentiable"):
        hypercol.upsample([maps[0].requires_grad_()] + maps[1:], bias)
    model = wesup.WESUP(fc_width=16,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    with pytest.raises(RuntimeError, match="not differentiable"):
        wesup.forward_pixel(model, torch.rand((1, 32, 32, 3), device=cuda))
    assert launch_counts()["hypercol_upsample"] == 0
    assert launch_counts()["pixel_head"] == 0


# ---------------------------------------------------------------------------
# pixel_head: the pixel head after fc2 (fc2's bias and ReLU, fc3, its bias
# and ReLU, the classifier, the softmax) in one kernel (ops/pixhead.py),
# against its plain version: both must lie in tests/torch_pixhead.py's
# intervals (why: its docstring).  Rows: the tile cell's chunk (B=8,
# 416x416) and ragged counts; widths: fc1's 1024 and 48 (a chunk ends
# inside 64 columns), with fc3 narrower than 32 and three classes.
# ---------------------------------------------------------------------------

PIXHEAD_CASES = [(8 * 416 * 416, 1024, 32, 2, torch.bfloat16),
                 (70001, 1024, 32, 2, torch.bfloat16),
                 (70001, 1024, 32, 2, torch.float32),
                 (3001, 48, 20, 3, torch.bfloat16),
                 (3001, 48, 20, 3, torch.float32)]


@pytest.mark.parametrize("N,C,D,n,dtype", PIXHEAD_CASES)
def test_pixel_head_kernel_matches_plain(cuda, exact_bf16_gemms, N, C, D, n,
                                         dtype):
    z, params = torch_pixhead.head_inputs(N, C, D, n, dtype, cuda, seed=N)
    reset_launches()
    got = pixhead.head(z, *params)
    torch.cuda.synchronize()
    assert launch_counts() == _expected({"pixel_head": 1})
    assert got.dtype == torch.float32 and got.shape == (N, n)
    assert got.is_contiguous()
    beyond, worst, width = torch_pixhead.gap(got, z, params)
    assert beyond == 0, (worst, width)
    want = pixhead.head_plain(z, *params)
    assert torch_pixhead.gap(want, z, params)[0] == 0
    # the same rows through a (B, H, W, C) view give the same bits
    assert torch.equal(pixhead.head(z.reshape(1, 1, N, C), *params),
                       got.reshape(1, 1, N, n))
    if N <= 70001:
        replayed = torch_pixhead.replay(z, *params)
        assert torch_pixhead.gap(replayed, z, params)[0] == 0


def test_pixel_head_forward_runs_no_tail_op_after_fc2(cuda):
    """In the bf16 pixel forward the head's span holds fc2's one matmul
    and the kernel: no add, ReLU, second matmul or softmax."""
    model = wesup.WESUP(generator=torch.Generator().manual_seed(4)).to(
        cuda).eval()
    img = torch.rand((1, 64, 96, 3), device=cuda)
    with torch.inference_mode():
        wesup.forward_pixel(model, img, torch.bfloat16)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            wesup.forward_pixel(model, img, torch.bfloat16)
        torch.cuda.synchronize()
    heads = [e for e in prof.events() if e.name == "wesup.step.head"]
    assert len(heads) == 1

    def names(e):
        return [e.name] + [m for c in e.cpu_children for m in names(c)]

    inside = names(heads[0])
    assert inside.count("aten::matmul") == 1
    for op in ("aten::add", "aten::relu", "aten::softmax", "aten::_softmax",
               "aten::clamp_min"):
        assert op not in inside, (op, inside)


def test_pixel_head_refuses_on_card_what_the_kernel_does_not_take(cuda):
    """A bf16 width that is no multiple of 8 and a z that starts off a
    16-byte boundary raise before a launch; f32 takes any width."""
    reset_launches()
    z, params = torch_pixhead.head_inputs(64, 44, 32, 2, torch.bfloat16,
                                          cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        pixhead.head(z, *params)
    z, params = torch_pixhead.head_inputs(64, 48, 32, 2, torch.bfloat16,
                                          cuda)
    buf = torch.empty(z.numel() + 1, dtype=z.dtype, device=cuda)
    shifted = buf[1:].view(z.shape).copy_(z)
    with pytest.raises(ValueError, match="16-byte"):
        pixhead.head(shifted, *params)
    assert launch_counts()["pixel_head"] == 0
    z, params = torch_pixhead.head_inputs(64, 44, 32, 2, torch.float32, cuda)
    assert torch_pixhead.gap(pixhead.head(z, *params), z, params)[0] == 0
    assert launch_counts()["pixel_head"] == 1
