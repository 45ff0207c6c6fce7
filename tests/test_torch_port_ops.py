"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
Pallas kernels run in interpret mode, as tests/test_cellpool_pallas.py runs
them; the port's kernel wrappers take their plain versions for CPU tensors.
The CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_port_cuda.py and chip_smoke.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu.ops import cellgrid as j_cellgrid  # noqa: E402
from wesup_tpu.ops import cellpool_pallas as j_cellpool  # noqa: E402
from wesup_tpu.ops import resize as j_resize  # noqa: E402
from wesup_tpu.ops import slic as j_slic  # noqa: E402
from wesup_tpu_torch.ops import cellgrid, cellpool, resize  # noqa: E402
from wesup_tpu_torch.ops import slic as t_slic  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _images(kind, B, H, W, seed=0):
    """bench.py-style (normal(200, 25) uint8) or uniform images, with
    ragged validity (last rows and columns invalid)."""
    rng = np.random.default_rng(seed)
    if kind == "bench":
        img = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(
            np.uint8).astype(np.float32) / 255.0
    else:
        img = rng.random((B, H, W, 3)).astype(np.float32)
    valid = np.ones((B, H, W), bool)
    valid[:, -5:] = False
    valid[:, :, -7:] = False
    return img, valid


def _jax_seg(img, valid, sp_area=200, stride=1):
    return np.array(jax.vmap(lambda i, v: j_slic.slic(
        i, v, sp_area=sp_area, update_stride=stride))(
            jnp.asarray(img), jnp.asarray(valid)))


# ---------------------------------------------------------------------------
# numpy constants
# ---------------------------------------------------------------------------

SHAPES = [(288, 416, 200), (100, 230, 150)]  # main-path canvas, ragged


@pytest.mark.parametrize("H,W,sp_area", SHAPES)
def test_numpy_constants_equal_jax(H, W, sp_area):
    jp, tp = j_slic.make_plan(H, W, sp_area), t_slic.make_plan(H, W, sp_area)
    for field in tp._fields:  # the port's plan keeps the cell-grid fields
        assert np.array_equal(getattr(jp, field), getattr(tp, field)), field
    for s in range(1, 5):
        Hs, Ws = H >> s, W >> s
        for ac in (True, False):
            assert np.array_equal(j_resize._interp_matrix(Hs, H, ac),
                                  resize._interp_matrix(Hs, H, ac))
            assert np.array_equal(j_resize._interp_matrix(W, Ws, ac),
                                  resize._interp_matrix(W, Ws, ac))
        assert np.array_equal(j_resize._nearest_index(Hs, H),
                              resize._nearest_index(Hs, H))
        js = j_cellgrid.make_stage_pool_plan(jp, Hs, Ws, True)
        ts = cellgrid.make_stage_pool_plan(tp, Hs, Ws, True)
        for field in js._fields:
            a, b = getattr(js, field), getattr(ts, field)
            if isinstance(a, tuple):
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), field
            else:
                assert np.array_equal(a, b), field


# ---------------------------------------------------------------------------
# SLIC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bench", "uniform"])
@pytest.mark.parametrize("stride", [1, 3])
def test_slic_seg_matches_jax(kind, stride):
    """Measured: 0 of 20480 pixels differ at every parametrization (the
    arithmetic and its order mirror the JAX formulation).  The bound allows
    0.1% for summation-order flips of near ties."""
    B, H, W = 2, 64, 160
    img, valid = _images(kind, B, H, W)
    want = _jax_seg(img, valid, stride=stride)
    got = t_slic.slic(torch.from_numpy(img), torch.from_numpy(valid),
                      sp_area=200, update_stride=stride).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (got != want).mean() <= 1e-3
    assert got.min() >= 0 and got.max() < t_slic.n_clusters(H, W, 200)


@pytest.mark.parametrize("align_corners", [False, True])
def test_device_resizes_match_jax(align_corners):
    """Bilinear: the same matrices contracted in the same order (W, then
    H), so f32 agrees to rounding; nearest copies values, bit for bit."""
    x = np.random.default_rng(6).random((2, 37, 41, 3)).astype(np.float32)
    for out_hw in ((23, 29), (60, 80), (37, 20)):
        want = np.asarray(j_resize.resize_bilinear(jnp.asarray(x), out_hw,
                                                   align_corners))
        got = resize.resize_bilinear(torch.from_numpy(x), out_hw,
                                     align_corners).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert np.array_equal(
            resize.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
            np.asarray(j_resize.resize_nearest(jnp.asarray(x), out_hw)))


def test_rgb2lab_matches_jax():
    from wesup_tpu.ops.colorspace import rgb2lab as j_lab
    from wesup_tpu_torch.ops.colorspace import rgb2lab as t_lab

    rgb = np.random.default_rng(5).random((16, 16, 3)).astype(np.float32)
    rgb[0, :4] = 0.0  # the linear branch below eps
    np.testing.assert_allclose(t_lab(torch.from_numpy(rgb)).numpy(),
                               np.asarray(j_lab(jnp.asarray(rgb))),
                               atol=1e-4, rtol=1e-6)


# ---------------------------------------------------------------------------
# cell-grid ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_setup():
    B, H, W, sp_area = 2, 64, 160, 200
    img, valid = _images("uniform", B, H, W, seed=7)
    seg = _jax_seg(img, valid, sp_area)
    return t_slic.make_plan(H, W, sp_area), j_slic.make_plan(H, W, sp_area), \
        seg, valid


def test_counts_and_paint_exact(seg_setup):
    tp, jp, seg, valid = seg_setup
    K = tp.n_clusters
    want = np.stack([np.asarray(j_cellgrid.cell_counts(jp, jnp.asarray(s),
                                                       jnp.asarray(v)))
                     for s, v in zip(seg, valid)])
    got = cellgrid.cell_counts(tp, torch.from_numpy(seg),
                               torch.from_numpy(valid)).numpy()
    assert np.array_equal(got, want)
    vals = np.random.default_rng(3).random((2, K)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.stack([np.asarray(j_cellgrid.cell_paint(
            jp, jnp.asarray(s), jnp.asarray(v).astype(jdt)), np.float32)
            for s, v in zip(seg, vals)])
        got = cellgrid.cell_paint(tp, torch.from_numpy(seg),
                                  torch.from_numpy(vals).to(tdt)).float()
        assert np.array_equal(got.numpy(), want)


def test_offset_masks_and_window_weights_match_jax(seg_setup):
    tp, jp, seg, valid = seg_setup
    e9_j = j_cellgrid.offset_masks(jp, jnp.asarray(seg), jnp.asarray(valid),
                                   jnp.float32)
    e9_t = cellgrid.offset_masks(tp, torch.from_numpy(seg),
                                 torch.from_numpy(valid), torch.float32)
    assert np.array_equal(e9_t.numpy(), np.asarray(e9_j))
    for Hs, Ws in ((32, 80), (16, 40)):
        js = j_cellgrid.make_stage_pool_plan(jp, Hs, Ws, True)
        ts = cellgrid.make_stage_pool_plan(tp, Hs, Ws, True)
        np.testing.assert_allclose(
            cellgrid.stage_window_weights(ts, e9_t).numpy(),
            np.asarray(j_cellgrid.stage_window_weights(js, e9_j)),
            atol=1e-6)
        np.testing.assert_allclose(
            cellgrid.stage_adjoint_weights(ts, e9_t).numpy(),
            np.asarray(j_cellgrid.stage_adjoint_weights(js, e9_j)),
            atol=1e-6)


# ---------------------------------------------------------------------------
# K1 / K2 plain versions against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_pool0_matches_jax_kernel(seg_setup, dtype):
    tp, jp, seg, valid = seg_setup
    rng = np.random.default_rng(1)
    taps = rng.standard_normal(seg.shape + (24,)).astype(np.float32)
    seg_m = np.where(valid, seg, -1).astype(np.int32)
    jt = jnp.asarray(taps).astype(getattr(jnp, dtype))
    want = np.asarray(j_cellpool.cell_pool0(jp, jnp.asarray(seg_m), jt))
    tt = torch.from_numpy(np.array(jt, np.float32)).to(getattr(torch, dtype))
    got = cellpool.cell_pool0(tp, torch.from_numpy(seg_m), tt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(got.numpy(), want,
                               atol=tol * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("hs_ws", [(32, 80), (30, 77)])  # even and ragged
def test_cell_pool_stage_matches_jax_kernel(seg_setup, hs_ws):
    tp, jp, seg, valid = seg_setup
    Hs, Ws = hs_ws
    e9_j = j_cellgrid.offset_masks(jp, jnp.asarray(seg), jnp.asarray(valid),
                                   jnp.float32)
    js = j_cellgrid.make_stage_pool_plan(jp, Hs, Ws, True)
    taps = np.random.default_rng(8).standard_normal(
        (2, Hs, Ws, 24)).astype(np.float32)
    want = np.asarray(j_cellpool.cell_pool_stage(jp, js, e9_j,
                                                 jnp.asarray(taps)))
    ts = cellgrid.make_stage_pool_plan(tp, Hs, Ws, True)
    e9_t = cellgrid.offset_masks(tp, torch.from_numpy(seg),
                                 torch.from_numpy(valid), torch.float32)
    mc = cellgrid.stage_window_weights(ts, e9_t)
    got = cellpool.cell_pool_stage(ts, mc, torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, want,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# The CUDA kernels' window walk, emulated on the host
# ---------------------------------------------------------------------------
#
# The kernels visit, for cluster (ky, kx), only the pixel / stage-pixel
# ranges of the host tables.  Walking those same ranges in numpy and
# comparing with the dense plain versions checks that no contributing
# pixel falls outside a window (the part of the kernels' logic that lives
# in Python).

def _walk_pool0(plan, seg_m, taps):
    rl, rh, cl, ch = (t.numpy() for t in cellpool._pool0_tables(plan, "cpu"))
    B, C = seg_m.shape[0], taps.shape[-1]
    out = np.zeros((B, plan.n_clusters, C), np.float64)
    for ky in range(plan.Kh):
        for kx in range(plan.Kw):
            k = ky * plan.Kw + kx
            win = (slice(None), slice(rl[ky], rh[ky]), slice(cl[kx], ch[kx]))
            hit = (seg_m[win] == k).astype(np.float64)
            out[:, k] = np.einsum("bhw,bhwc->bc", hit, taps[win])
    return out


def _walk_stage(spp, mc, taps):
    ay, ax, pl, ph, ql, qh = (t.numpy() for t in
                              cellpool._stage_tables(spp, "cpu"))
    B, C = mc.shape[0], taps.shape[-1]
    out = np.zeros((B, spp.Kh * spp.Kw, C), np.float64)
    for ky in range(spp.Kh):
        p = np.arange(pl[ky], ph[ky])
        i = ky - ay[p] - spp.rmin_y
        assert ((0 <= i) & (i < spp.Ih)).all()
        for kx in range(spp.Kw):
            q = np.arange(ql[kx], qh[kx])
            j = kx - ax[q] - spp.rmin_x
            assert ((0 <= j) & (j < spp.Jw)).all()
            wgt = mc[:, p, i][:, :, q, j]                      # (B, np, nq)
            out[:, ky * spp.Kw + kx] = np.einsum(
                "bpq,bpqc->bc", wgt, taps[:, p][:, :, q])
    return out


@pytest.mark.parametrize("H,W,sp_area", [(64, 160, 200), (96, 128, 150),
                                         (288, 416, 200)])
def test_kernel_windows_cover_every_contribution(H, W, sp_area):
    plan = t_slic.make_plan(H, W, sp_area)
    img, valid = _images("bench", 1, H, W, seed=11)
    seg = t_slic.slic(torch.from_numpy(img), torch.from_numpy(valid),
                      sp_area=sp_area, update_stride=3)
    vt = torch.from_numpy(valid)
    seg_m = torch.where(vt, seg, -1)
    rng = np.random.default_rng(12)
    taps = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    want = cellpool.cell_pool0_plain(plan, seg_m, torch.from_numpy(taps))
    np.testing.assert_allclose(_walk_pool0(plan, seg_m.numpy(), taps),
                               want.numpy(), atol=1e-4)
    e9 = cellgrid.offset_masks(plan, seg, vt, torch.float32)
    for s in range(1, 5):
        spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
        mc = cellgrid.stage_window_weights(spp, e9)
        st = rng.standard_normal((1, H >> s, W >> s, 3)).astype(np.float32)
        want = cellpool.cell_pool_stage_plain(spp, mc, torch.from_numpy(st))
        np.testing.assert_allclose(_walk_stage(spp, mc.numpy(), st),
                                   want.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# K2's compaction and stream, replayed on the host
# ---------------------------------------------------------------------------
#
# The kernel compacts each cluster's nonzero window weights in (p, q)
# order, 32 positions per warp step (ballot + popc), into a buffer of
# ``cap`` terms; a full buffer is streamed and the compaction resumes at the
# first term that did not fit.  Each channel then takes fmaf(w, tap, acc)
# in list order.  The replay keeps both steps, so the resume logic and the
# term order are held here; the kernel itself against the plain version on
# the card.

def _k2_compact(wgt: np.ndarray, cap: int):
    """The kernel's rounds over a window's weights in position order: a
    list of rounds, each a list of (position, weight) of at most ``cap``."""
    rounds, cursor, npos = [], 0, wgt.size
    while True:
        terms = []
        while cursor < npos:
            step = 32
            nz = [i for i in range(cursor, min(cursor + 32, npos))
                  if wgt[i] != 0]
            if len(terms) + len(nz) > cap:
                fit = cap - len(terms)
                terms += [(i, wgt[i]) for i in nz[:fit]]
                step = nz[fit] - cursor          # the first that did not fit
            else:
                terms += [(i, wgt[i]) for i in nz]
            cursor = min(cursor + step, npos)
            if len(terms) == cap:
                break
        rounds.append(terms)
        if cursor >= npos:
            return rounds


def _k2_walk(spp, mc, taps, cap=256):
    """Python replay of K2: per cluster, the rounds of compacted terms, then
    the f32 fmafs in their order (the product exact in f64, one rounding).
    Returns the sums and the most rounds any window took."""
    ay, ax, pl, ph, ql, qh = (t.numpy() for t in
                              cellpool._stage_tables(spp, "cpu"))
    B, C = mc.shape[0], taps.shape[-1]
    out = np.zeros((B, spp.Kh * spp.Kw, C), np.float32)
    most = 0
    for b in range(B):
        for ky in range(spp.Kh):
            p = np.arange(pl[ky], ph[ky])
            i = ky - ay[p] - spp.rmin_y
            for kx in range(spp.Kw):
                q = np.arange(ql[kx], qh[kx])
                j = kx - ax[q] - spp.rmin_x
                wgt = mc[b, p, i][:, q, j].reshape(-1)    # (p, q) order
                rounds = _k2_compact(wgt, cap)
                flat = [t for r in rounds for t in r]
                assert [pos for pos, _ in flat] == list(np.flatnonzero(wgt))
                most = max(most, len(rounds))
                acc = np.zeros(C, np.float32)
                for pos, w in flat:
                    row = taps[b, p[pos // len(q)], q[pos % len(q)]]
                    acc = (np.float64(w) * row.astype(np.float64)
                           + acc.astype(np.float64)).astype(np.float32)
                out[b, ky * spp.Kw + kx] = acc
    return out, most


@pytest.mark.parametrize("hs_ws", [(32, 80), (30, 77)])  # even and ragged
@pytest.mark.parametrize("cap", [256, 7])  # one round; many rounds
def test_k2_compaction_walk_matches_plain_and_jax(seg_setup, hs_ws, cap):
    """The replay against the plain version and the JAX Pallas kernel
    (interpret mode), both to K2's limit of 1e-4 of the largest value."""
    tp, jp, seg, valid = seg_setup
    Hs, Ws = hs_ws
    e9_t = cellgrid.offset_masks(tp, torch.from_numpy(seg),
                                 torch.from_numpy(valid), torch.float32)
    ts = cellgrid.make_stage_pool_plan(tp, Hs, Ws, True)
    mc = cellgrid.stage_window_weights(ts, e9_t)
    taps = np.random.default_rng(9).standard_normal(
        (2, Hs, Ws, 5)).astype(np.float32)
    got, most = _k2_walk(ts, mc.numpy(), taps, cap)
    assert most > 1 or cap > 7                # cap 7 takes several rounds
    want = cellpool.cell_pool_stage_plain(ts, mc, torch.from_numpy(taps))
    lim = 1e-4 * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got, want.numpy(), atol=lim, rtol=0)
    e9_j = j_cellgrid.offset_masks(jp, jnp.asarray(seg), jnp.asarray(valid),
                                   jnp.float32)
    js = j_cellgrid.make_stage_pool_plan(jp, Hs, Ws, True)
    want_j = np.asarray(j_cellpool.cell_pool_stage(jp, js, e9_j,
                                                   jnp.asarray(taps)))
    np.testing.assert_allclose(got, want_j, atol=lim, rtol=0)


# ---------------------------------------------------------------------------
# K1's compaction and stream, replayed on the host
# ---------------------------------------------------------------------------
#
# K1 compacts each cluster's pixels from an (h, w) scan of its +-1-cell
# window, 32 positions per warp step, exactly as K2 compacts its weights
# (a seg match in place of a nonzero weight), into a buffer of ``cap``
# pixels (128 in the kernel), in rounds when a cluster holds more; each
# channel then adds the listed rows in list order.

def _k1_walk(plan, seg_m, taps, cap=128):
    """Python replay of K1: per cluster, the rounds of compacted pixels, then
    the f32 adds in their order.  Returns the sums and the most rounds any
    cluster took."""
    rl, rh, cl, ch = (t.numpy() for t in cellpool._pool0_tables(plan, "cpu"))
    B, H, W, C = taps.shape
    out = np.zeros((B, plan.n_clusters, C), np.float32)
    most = 0
    for b in range(B):
        rows = taps[b].reshape(H * W, C)
        seg_b = seg_m[b].reshape(-1)
        for ky in range(plan.Kh):
            for kx in range(plan.Kw):
                k = ky * plan.Kw + kx
                hh, ww = np.meshgrid(np.arange(rl[ky], rh[ky]),
                                     np.arange(cl[kx], ch[kx]), indexing="ij")
                pix = (hh * W + ww).reshape(-1)                # (h, w) order
                hit = seg_b[pix] == k
                rounds = _k2_compact(hit.astype(np.float32), cap)
                assert all(len(r) <= cap for r in rounds)
                flat = [pix[pos] for r in rounds for pos, _ in r]
                assert flat == list(pix[hit])
                most = max(most, len(rounds))
                acc = np.zeros(C, np.float32)
                for p in flat:
                    acc = acc + rows[p]          # one f32 rounding per add
                out[b, k] = acc
    return out, most


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [128, 256, 7])  # the kernel's; one round; many
def test_k1_compaction_walk_matches_plain_and_jax(seg_setup, dtype, cap):
    """The replay against the plain version (to 1e-5 of the largest value:
    both sum the same f32 values, in other orders) and the JAX Pallas
    kernel in interpret mode (K1's limits: 1e-5 of the largest value in
    f32, 0.02 in bf16)."""
    tp, jp, seg, valid = seg_setup
    seg_m = np.where(valid, seg, -1).astype(np.int32)
    jt = jnp.asarray(np.random.default_rng(10).standard_normal(
        seg.shape + (6,)).astype(np.float32)).astype(getattr(jnp, dtype))
    taps = np.array(jt, np.float32)
    got, most = _k1_walk(tp, seg_m, taps, cap)
    assert most > 1 or cap > 7                # cap 7 takes several rounds
    want = cellpool.cell_pool0_plain(tp, torch.from_numpy(seg_m),
                                     torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    want_j = np.asarray(j_cellpool.cell_pool0(jp, jnp.asarray(seg_m), jt))
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(got, want_j,
                               atol=tol * np.abs(want_j).max() + 1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K3's walk, replayed on the host
# ---------------------------------------------------------------------------
#
# K3 cuts the flat (b, h, w) pixel index into ranges of spw * run <= 32
# pixels (so ranges and runs cross image rows and images); a warp's task is
# one range and one 256-channel chunk, and slot j of the warp (g lanes of 8
# channels) walks pixels j * run .. (j + 1) * run - 1 of its range.  A lane keeps its
# current cotangent row, already rounded to the output dtype, and loads a
# row only where the row index b * K + seg changes along the run; a pixel
# with seg < 0 stores zeros.  The kernel issues a batch's loads before its
# stores, which changes no value.

def _k3_lane_map(C):
    """(g, spw, run, nchunk) as launch_pool0_bwd sets them."""
    lanes = -(-C // 8)
    g = min(lanes, 32)
    spw = 32 // g
    return g, spw, 32 // spw, -(-lanes // 32)


def _k3_walk(seg, dsums, dtype):
    """Python replay of K3.  Returns dtaps, the tasks' pixel ranges and one
    record per slot that stores: (first pixel, pixels, row loads)."""
    B, H, W = seg.shape
    K, C = dsums.shape[1:]
    g, spw, run, nchunk = _k3_lane_map(C)
    n_pix, span = B * H * W, spw * run
    flat = seg.reshape(-1).tolist()
    rows = dsums.reshape(B * K, C).to(dtype)
    out = torch.full((n_pix, C), float("nan")).to(dtype)
    writes = np.zeros((n_pix, C), np.int64)
    ranges, walks = [], []
    for task in range(-(-n_pix // span) * nchunk):
        rng, chunk = divmod(task, nchunk)
        p0 = rng * span
        c0 = chunk * 256
        c1 = min(C, c0 + 8 * g)
        if chunk == 0:
            ranges.append((p0, min(span, n_pix - p0)))
        # lane i's row index: pixel p0 + i's, -1 where seg < 0 or past
        keys = [(p0 + i) // (H * W) * K + flat[p0 + i]
                if i < span and p0 + i < n_pix and flat[p0 + i] >= 0 else -1
                for i in range(32)]
        for j in range(spw):
            q0 = j * run
            n_mine = min(run, n_pix - p0 - q0)
            cur_key, cur = -1, torch.zeros(c1 - c0, dtype=dtype)
            loads = 0
            for t in range(run):
                key = keys[q0 + t]
                if key != cur_key:
                    cur = rows[key, c0:c1] if key >= 0 else torch.zeros(
                        c1 - c0, dtype=dtype)
                    loads += key >= 0
                    cur_key = key
                if t < n_mine:
                    out[p0 + q0 + t, c0:c1] = cur
                    writes[p0 + q0 + t, c0:c1] += 1
            if n_mine > 0:
                walks.append((p0 + q0, n_mine, loads))
    assert (writes == 1).all()               # each element written once
    return out.reshape(B, H, W, C), ranges, walks


def _k3_seg(kind, C, B=3, H=5, W=13, K=8):
    """seg for the K3 replay: 4-pixel-wide blocks of clusters (W = 13 and
    H * W = 65 put run and range boundaries inside image rows and
    images), with invalid pixels at the start and end of every run
    ("invalid_ends") or an image whose pixels are all invalid
    ("invalid_image")."""
    hh, ww = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    seg = np.broadcast_to((hh // 3 * 4 + ww // 4) % K, (B, H, W)).copy()
    seg[1] = (seg[1] + 3) % K
    _, spw, run, _ = _k3_lane_map(C)
    pos = np.arange(B * H * W) % (spw * run) % run
    if kind == "invalid_ends":
        seg.reshape(-1)[(pos == 0) | (pos == run - 1)] = -1
    if kind == "invalid_image":
        seg[1] = -1
        seg[2, 0, :5] = -1
    return seg.astype(np.int32), K


@pytest.mark.parametrize("C", [5, 37, 128, 1024])
@pytest.mark.parametrize("kind", ["rows_images", "invalid_ends",
                                  "invalid_image"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_walk_matches_plain(kind, C, dtype):
    """The replay equals the plain gather bitwise, for run and range
    boundaries inside image rows and images, segment changes inside a run,
    runs that start or end on invalid pixels and an all-invalid image."""
    seg, K = _k3_seg(kind, C)
    B, H, W = seg.shape
    dsums = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, K, C)).astype(np.float32))
    got, ranges, walks = _k3_walk(seg, dsums, dtype)
    plan = t_slic.make_plan(H, W, 10)
    assert plan.n_clusters == K
    want = cellpool.cell_pool0_bwd_plain(plan, torch.from_numpy(seg), dsums,
                                         dtype)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    assert torch.equal(want, cellpool.cell_pool0_bwd(
        plan, torch.from_numpy(seg), dsums, dtype))
    # what each case is for
    last = [p0 + n - 1 for p0, n in ranges]
    assert any(p // W != q // W for (p, _), q in zip(ranges, last))
    assert any(p // (H * W) != q // (H * W) for (p, _), q in zip(ranges, last))
    run = _k3_lane_map(C)[2]
    flat = seg.reshape(-1)
    if run > 1:
        assert any(p // W != (p + n - 1) // W for p, n, _ in walks)
        # a segment change inside a run, and a row reused along a run
        assert any(loads >= 2 for _, _, loads in walks)
        assert any(0 < loads < n for _, n, loads in walks)
    if kind == "invalid_ends":
        assert all(flat[p] < 0 and flat[p + n - 1] < 0 for p, n, _ in walks
                   if n == run)
    if kind == "invalid_image":
        assert not got[1].float().any()


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises (here: a 'meta' tensor, as no card is present)."""
    plan = t_slic.make_plan(64, 160, 200)
    seg = torch.zeros((1, 64, 160), dtype=torch.int32, device="meta")
    taps = torch.zeros((1, 64, 160, 8), device="meta")
    with pytest.raises(ValueError):
        cellpool.cell_pool0(plan, seg, taps)
    spp = cellgrid.make_stage_pool_plan(plan, 32, 80, True)
    mc = torch.zeros((1, 32, spp.Ih, 80, spp.Jw), device="meta")
    with pytest.raises(ValueError):
        cellpool.cell_pool_stage(spp, mc, torch.zeros((1, 32, 80, 8),
                                                      device="meta"))
