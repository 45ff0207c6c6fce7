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
grid narrower than one 8-cluster block.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import wesup  # noqa: E402
from wesup_tpu_torch.models import steps  # noqa: E402
from wesup_tpu_torch.models.steps import make_predict_step  # noqa: E402
from wesup_tpu_torch.ops import (adjoint, cellgrid, cellpool,  # noqa: E402
                                 launch_counts, pool, pooling,
                                 reset_launches)
from wesup_tpu_torch.ops.resize import _interp_matrix  # noqa: E402
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
    assert cellpool.LAUNCHES == {"cell_pool0": 1, "cell_pool_stage": 4,
                                 "cell_pool0_bwd": 0, "cell_pool_stage_bwd": 0}
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
        before = cellpool.LAUNCHES["cell_pool0_bwd"]
        got = cellpool.cell_pool0_bwd(plan, seg_m, dsums, dtype)
        assert cellpool.LAUNCHES["cell_pool0_bwd"] == before + 1
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
        cellpool.reset_launches()
        loss, _ = steps._forward_and_loss(model, p, plan.n_clusters, cfg,
                                          b["sample_valid"].to(dev), plan)
        loss.backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert cellpool.LAUNCHES == {"cell_pool0": 1, "cell_pool_stage": 4,
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
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = _train_batch(2, H, W, (58, 141))
    acc = step(model, optimizer, acc, batch, gen)
    cellpool.reset_launches()
    acc = step(model, optimizer, acc, batch, gen)
    torch.cuda.synchronize()
    assert cellpool.LAUNCHES == {"cell_pool0": 1, "cell_pool_stage": 4,
                                 "cell_pool0_bwd": 1, "cell_pool_stage_bwd": 4}
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
    before = pooling.LAUNCHES["segment_sum"]
    got = pooling.segment_sum(seg, feat, K)
    assert pooling.LAUNCHES["segment_sum"] == before + 1
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
    before = cellpool.LAUNCHES["cell_pool0"]
    got = cellpool.cell_pool0(plan, seg_m, taps)
    assert cellpool.LAUNCHES["cell_pool0"] == before + 1
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
    before = cellpool.LAUNCHES["cell_pool0_bwd"]
    got = cellpool.cell_pool0_bwd(plan, seg_m, dsums, dtype)
    assert cellpool.LAUNCHES["cell_pool0_bwd"] == before + 1
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
        before = cellpool.LAUNCHES["cell_pool_stage_bwd"]
        got = cellpool.cell_pool_stage_bwd(spp, mc, dsums)
        assert cellpool.LAUNCHES["cell_pool_stage_bwd"] == before + 1
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
    before = pool.LAUNCHES["fused_relu_pool_pad"]
    p = pre.detach().requires_grad_(True)
    got = pool.fused_relu_pool_pad(p, cout)
    assert pool.LAUNCHES["fused_relu_pool_pad"] == before + 1
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
    before = pooling.LAUNCHES["segment_sum_bwd"]
    pooling.segment_sum(seg.reshape(1, -1), feat, plan.n_clusters).backward(
        dsums)
    assert pooling.LAUNCHES["segment_sum_bwd"] == before + 1
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
    before = pooling.LAUNCHES["segment_sum_bwd"]
    got = pooling.segment_sum_bwd(seg, dsums, dtype)
    assert pooling.LAUNCHES["segment_sum_bwd"] == before + 1
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
        before = adjoint.LAUNCHES["adjoint_pool_stage_bwd"]
        got = adjoint.adjoint_pool_stage_bwd(sg, dsums, A_wT, K, dtype)
        assert adjoint.LAUNCHES["adjoint_pool_stage_bwd"] == before + 1
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
    gen = torch.Generator(device=cuda).manual_seed(0)
    reset_launches()
    acc = step(model, steps.make_optimizer(cfg, model),
               steps.init_metric_acc(), batch, gen)
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
    gen = torch.Generator(device=cuda).manual_seed(0)
    reset_launches()
    acc = step(model, optimizer, acc, _train_batch(2, 64, 160, (58, 141)),
               gen)
    torch.cuda.synchronize()
    assert launch_counts() == _expected({
        "cell_pool0": 1, "cell_pool_stage": 4, "cell_pool0_bwd": 1,
        "cell_pool_stage_bwd": 4, "fused_relu_pool_pad": 1})
    assert not acc["nan"].item()
    assert all(torch.isfinite(q).all() for q in model.parameters())
