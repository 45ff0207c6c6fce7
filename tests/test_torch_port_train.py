"""The port's train step against the JAX package, on the CPU.

Inputs are made with numpy from seeds; weights go through
``from_jax_params``.  The JAX Pallas kernels run in interpret mode, as
tests/test_cellpool_pallas.py runs them; the port's wrappers take their
plain versions for CPU tensors (the CUDA kernels are held against those on
the card, in tests/test_torch_port_cuda.py and chip_smoke.py).  torch cannot
draw JAX's random bits, so each augmentation is held on the parameters JAX
drew (the tests replay JAX's key splits) and the port's samplers by their
distributions.

Tolerances, each with its reason:
- K3 (a pure selection) 1e-5 abs/rel, in bf16 within one bf16 ulp; K4
  1e-5 abs, 1e-4 rel (f32 sums in another order), in bf16 within one bf16
  ulp of the JAX value (the f32 sum may round to the neighbouring bf16
  value) plus 1e-5 of the sum of |terms| (the order of the f32 sums, which
  shows where the terms cancel);
- integer stats (cell pool, label vote) exactly; the losses to 1e-6;
- f32 affine warps and elastic 1e-4: sampling positions (up to ~160 px)
  come out of f32 arithmetic done in another order (the packages invert A
  through different LAPACK paths, which differ in the last bits of a
  translation of ~100 px; the elastic field is resized by a matmul), so
  they differ by ~1e-5 px, several 1e-5 in value on an image of
  independent random pixels; nearest (order 0) resampling >= 99.9% of
  pixels equal, as such a shift can move a pixel across a rounding
  boundary;
- CLAHE >= 99.9% of pixels within 1e-4: L is rounded to integer bins, so an
  f32 ulp can move a pixel by one bin;
- the f32 train step: loss to 1e-4 relative, every gradient of the first
  step to 1e-3 of its tensor's largest |grad| but the backbone convs' to
  5e-3, parameters after 3 SGD steps (default lr) to 1e-5; bf16 loss to
  rtol 5e-2, atol 5e-3 (tests/test_train_parity.py's bf16 bound).  The
  backbone's bound: the two packages' f32 convs sum in other orders, so a
  ReLU input that close to zero can take the other sign in one of them
  (at this size about one of the 13 taps' ~2.5M values does).  That
  position's gradient passes in one package and stops in the other, and
  every conv below it sees the difference, most at the coarse stages,
  where one position is a large share of a weight's gradient.  Max-pool
  ties are broken alike (first maximum) in both.  The same limits hold for
  every pooling ("local", "adjoint", "fullres");
- the bf16 train step's first gradients, in units of r = 2^-8 (a value
  that one package rounds to bf16 at a point where the other rounds
  another value, or sums in f32 in another order before rounding, moves
  by at most half a bf16 ulp, <= 2^-8 of it): a head gradient (side
  convs, fc layers, classifier) crosses 5 such points in the forward (the
  stage taps; the pooled terms: K1/K2's window sums, the port's
  tapsH = A_h taps against JAX's t_cat = A_h^T onehot, or fullres's
  resized maps; p_h against JAX's M = A_w^T t_cat; the sums cast before
  the projection; the head's activations) and the 5 cotangents at them in
  the backward: 10 r = 0.039 of the tensor's largest |grad|.  A backbone
  gradient also crosses the 13 convs' rounded outputs and their rounded
  cotangents: 36 r = 0.141.  Measured worst on this problem: head 0.028
  (adjoint), backbone 0.083 (fullres);
- SLIC after augmentation: >= 99.9% of pixels in the same superpixel.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import objectives as j_obj  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.ops import augment as j_aug  # noqa: E402
from wesup_tpu.ops import cellgrid as j_cellgrid  # noqa: E402
from wesup_tpu.ops import cellpool_pallas as j_cellpool  # noqa: E402
from wesup_tpu.ops import clahe as j_clahe  # noqa: E402
from wesup_tpu.ops import colorspace as j_color  # noqa: E402
from wesup_tpu.ops import segments as j_segments  # noqa: E402
from wesup_tpu.ops import slic as j_slic  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import objectives, steps, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
from wesup_tpu_torch.ops import augment, cellgrid, cellpool, clahe  # noqa: E402
from wesup_tpu_torch.ops import colorspace, segments  # noqa: E402
from wesup_tpu_torch.ops import slic as t_slic  # noqa: E402

B, H, W = 2, 64, 160
FC_WIDTH = 64


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _assert_within_bf16_ulp(got, want, slack=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp + slack).all(), np.abs(got - want).max()


@pytest.fixture(scope="module")
def seg_setup():
    """bench-style images with ragged validity and their JAX SLIC seg."""
    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(
        np.uint8).astype(np.float32) / 255.0
    valid = np.ones((B, H, W), bool)
    valid[:, -5:] = False
    valid[:, :, -7:] = False
    seg = np.array(jax.vmap(lambda i, v: j_slic.slic(i, v, sp_area=150))(
        jnp.asarray(img), jnp.asarray(valid)))
    return img, valid, seg, j_slic.make_plan(H, W, 150), \
        t_slic.make_plan(H, W, 150)


# ---------------------------------------------------------------------------
# (i) K3 / K4 through the autograd Functions against jax.vjp of the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_pool0_backward_matches_jax(interpret, seg_setup, dtype):
    _, valid, seg, jplan, tplan = seg_setup
    seg_m = np.where(valid, seg, -1).astype(np.int32)
    rng = np.random.default_rng(1)
    taps = rng.standard_normal((B, H, W, 16)).astype(np.float32)
    dsums = rng.standard_normal((B, jplan.n_clusters, 16)).astype(np.float32)

    jtaps = jnp.asarray(taps, dtype)
    _, vjp = jax.vjp(lambda t: j_cellpool.cell_pool0(jplan, jnp.asarray(
        seg_m), t), jtaps)
    (want,) = vjp(jnp.asarray(dsums))

    ttaps = _t(np.asarray(jtaps).astype(np.float32)).to(
        getattr(torch, dtype)).requires_grad_()
    cellpool.cell_pool0(tplan, _t(seg_m), ttaps).backward(_t(dsums))
    got = ttaps.grad
    assert got.dtype == getattr(torch, dtype) and want.dtype == jtaps.dtype
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        _assert_within_bf16_ulp(got, want)
    assert (got[~valid] == 0).all()


def _port_mc(mct, spp):
    """(B, npb, Ih*Jw, rows*Ws) kernel-layout window weights of the JAX
    package -> the port's (B, Hs, Ih, Ws, Jw)."""
    Bm, npb = mct.shape[:2]
    rows = mct.shape[-1] // spp.Ws
    m = mct.reshape(Bm, npb, spp.Ih, spp.Jw, rows, spp.Ws)
    m = m.transpose(0, 1, 4, 2, 5, 3).reshape(Bm, npb * rows, spp.Ih, spp.Ws,
                                              spp.Jw)
    return np.ascontiguousarray(m[:, :spp.Hs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hs_ws", [(32, 80), (30, 77)])  # even and ragged
def test_cell_pool_stage_backward_matches_jax(interpret, seg_setup, dtype,
                                              hs_ws):
    _, valid, seg, jplan, tplan = seg_setup
    Hs, Ws = hs_ws
    jdt = getattr(jnp, dtype)
    e9 = j_cellgrid.offset_masks(jplan, jnp.asarray(seg), jnp.asarray(valid),
                                 jdt)
    jspp = j_cellgrid.make_stage_pool_plan(jplan, Hs, Ws, True)
    tspp = cellgrid.make_stage_pool_plan(tplan, Hs, Ws, True)
    assert np.array_equal(jspp.anchor_y, tspp.anchor_y)
    assert np.array_equal(jspp.anchor_x, tspp.anchor_x)
    # the very window weights the JAX kernel pools with, in the port's layout
    key = j_cellpool._stage_key(jplan, jspp)
    j_cellpool._SPP_REG[key] = (jplan, jspp)
    mc = _port_mc(np.asarray(j_cellpool._mct_from_e9(key, e9, 8), np.float32),
                  tspp)

    rng = np.random.default_rng(2)
    taps = jnp.asarray(rng.standard_normal((B, Hs, Ws, 24)), jdt)
    dsums = rng.standard_normal((B, jplan.n_clusters, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_cellpool.cell_pool_stage(jplan, jspp, e9, t),
                     taps)
    (want,) = vjp(jnp.asarray(dsums))

    tdt = getattr(torch, dtype)
    ttaps = _t(np.asarray(taps, np.float32)).to(tdt).requires_grad_()
    tmc = _t(mc).to(tdt)
    cellpool.cell_pool_stage(tspp, tmc, ttaps).backward(_t(dsums))
    assert ttaps.grad.dtype == tdt
    got, want = ttaps.grad.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        mass = cellpool.cell_pool_stage_bwd_plain(
            tspp, tmc.abs(), _t(np.abs(dsums)), torch.float32).numpy()
        _assert_within_bf16_ulp(got, want, 1e-5 * mass)


def _k4_walk(spp, mc, dsums, dtype):
    """Python replay of K4: per stage pixel, its list of (cluster, weight)
    terms, the nonzero weights of clusters in the grid in (i, j) order,
    then fmaf(w, T(dsums[k]), acc) in that order (the product exact in f64,
    one rounding) and the sum rounded to T.  Asserts that each list is the
    pixel's nonzero dense weights in (ky, kx) order."""
    B, Hs, Ih, Ws, Jw = mc.shape
    Md = cellgrid.expand_window_weights(spp, torch.from_numpy(mc)).numpy()
    ds = torch.from_numpy(dsums).to(dtype).float().numpy()     # T(dsums)
    ay, ax = spp.anchor_y + spp.rmin_y, spp.anchor_x + spp.rmin_x
    out = np.zeros((B, Hs, Ws, ds.shape[-1]), np.float32)
    for b in range(B):
        for p in range(Hs):
            for q in range(Ws):
                terms = [((ay[p] + i) * spp.Kw + ax[q] + j, mc[b, p, i, q, j])
                         for i in range(Ih) if 0 <= ay[p] + i < spp.Kh
                         for j in range(Jw) if 0 <= ax[q] + j < spp.Kw
                         if mc[b, p, i, q, j] != 0]
                dense = Md[b, p, :, q, :].reshape(-1)
                nz = np.flatnonzero(dense)
                assert [k for k, _ in terms] == list(nz)
                assert [w for _, w in terms] == list(dense[nz])
                acc = np.zeros(ds.shape[-1], np.float32)
                for k, w in terms:
                    acc = (np.float64(w) * ds[b, k].astype(np.float64)
                           + acc).astype(np.float32)
                out[b, p, q] = acc
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hs_ws", [(32, 80), (30, 77)])  # even and ragged
def test_k4_compaction_walk_matches_plain_and_jax(interpret, seg_setup,
                                                  dtype, hs_ws):
    """The replay against the plain version and ``jax.vjp`` of the JAX
    Pallas kernel (interpret mode), on the JAX kernel's own window weights,
    within K4's limits: f32 1e-5 of the largest value (1e-5 + 1e-4
    relative against JAX, as above); bf16 one bf16 ulp plus 1e-5 of the
    sum of |terms|."""
    _, valid, seg, jplan, tplan = seg_setup
    Hs, Ws = hs_ws
    jdt = getattr(jnp, dtype)
    e9 = j_cellgrid.offset_masks(jplan, jnp.asarray(seg), jnp.asarray(valid),
                                 jdt)
    jspp = j_cellgrid.make_stage_pool_plan(jplan, Hs, Ws, True)
    tspp = cellgrid.make_stage_pool_plan(tplan, Hs, Ws, True)
    key = j_cellpool._stage_key(jplan, jspp)
    j_cellpool._SPP_REG[key] = (jplan, jspp)
    mc = _port_mc(np.asarray(j_cellpool._mct_from_e9(key, e9, 8), np.float32),
                  tspp)
    rng = np.random.default_rng(11)
    taps = jnp.asarray(rng.standard_normal((B, Hs, Ws, 5)), jdt)
    dsums = rng.standard_normal((B, jplan.n_clusters, 5)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = _k4_walk(tspp, mc, dsums, tdt)
    assert got.dtype == tdt
    tmc = _t(mc).to(tdt)
    want = cellpool.cell_pool_stage_bwd_plain(tspp, tmc, _t(dsums), tdt)
    _, vjp = jax.vjp(lambda t: j_cellpool.cell_pool_stage(jplan, jspp, e9, t),
                     taps)
    (want_j,) = vjp(jnp.asarray(dsums))
    got, want = got.float().numpy(), want.float().numpy()
    want_j = np.asarray(want_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
        np.testing.assert_allclose(got, want_j, atol=1e-5, rtol=1e-4)
    else:
        mass = cellpool.cell_pool_stage_bwd_plain(
            tspp, tmc.abs(), _t(np.abs(dsums)), torch.float32).numpy()
        _assert_within_bf16_ulp(got, want, 1e-5 * mass)
        _assert_within_bf16_ulp(got, want_j, 1e-5 * mass)


def test_backward_plain_versions_are_the_kernels_math(seg_setup):
    """K3's plain version is the one-hot transpose; K4's is the transpose of
    its forward's dense weights, both rounded as the kernels round."""
    _, valid, seg, _, tplan = seg_setup
    seg_m = torch.where(_t(valid), _t(seg), -1)
    rng = np.random.default_rng(3)
    dsums = _t(rng.standard_normal((B, tplan.n_clusters, 8)).astype(
        np.float32))
    oh = (seg_m[..., None] == torch.arange(tplan.n_clusters)).float()
    want = torch.einsum("bhwk,bkc->bhwc", oh, dsums)
    got = cellpool.cell_pool0_bwd_plain(tplan, seg_m, dsums, torch.float32)
    assert torch.equal(got, want)
    spp = cellgrid.make_stage_pool_plan(tplan, H >> 1, W >> 1, True)
    e9 = cellgrid.offset_masks(tplan, _t(seg), _t(valid), torch.float32)
    mc = cellgrid.stage_window_weights(spp, e9)
    taps = torch.randn((B, H >> 1, W >> 1, 8), requires_grad=True)
    sums = cellpool.cell_pool_stage_plain(spp, mc, taps)
    (want,) = torch.autograd.grad(sums, taps, dsums)
    got = cellpool.cell_pool_stage_bwd(spp, mc, dsums)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (ii) cell pool, label vote, WESUP loss
# ---------------------------------------------------------------------------

def _point_sup(valid, n_points, seed, C=2):
    rng = np.random.default_rng(seed)
    sup = np.zeros(valid.shape + (C,), np.float32)
    for b in range(valid.shape[0]):
        for _ in range(n_points):
            y, x = rng.integers(0, H - 5), rng.integers(0, W - 7)
            sup[b, y, x, rng.integers(0, C)] = 1.0
    return sup


def test_cell_pool_and_superpixel_stats_match_jax(seg_setup):
    _, valid, seg, jplan, tplan = seg_setup
    K = tplan.n_clusters
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (B, H, W, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda s, xx, v: j_cellgrid.cell_pool(
        jplan, s, xx, v))(jnp.asarray(seg), jnp.asarray(x),
                          jnp.asarray(valid)))
    got = cellgrid.cell_pool(tplan, _t(seg), _t(x), _t(valid)).numpy()
    assert np.array_equal(got, want)

    sup = _point_sup(valid, 30, seed=5)
    # a tie: one superpixel with one point of each class -> multi-hot label
    ys, xs = np.nonzero(seg[0] == seg[0, 20, 20])
    sup[0, ys[0], xs[0]] = (1.0, 0.0)
    sup[0, ys[-1], xs[-1]] = (0.0, 1.0)
    for use_plan in (True, False):
        for mask in (sup, None):
            want = jax.vmap(lambda s, m, v: j_segments.superpixel_stats(
                s, K, m, v, plan=jplan if use_plan else None),
                in_axes=(0, None if mask is None else 0, 0))(
                    jnp.asarray(seg), None if mask is None else
                    jnp.asarray(mask), jnp.asarray(valid))
            got = segments.superpixel_stats(
                _t(seg), K, None if mask is None else _t(mask), _t(valid),
                plan=tplan if use_plan else None)
            for name in got._fields:
                assert np.array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name))), name
    assert (got.labels.sum(-1) > 1).any() or mask is None
    oh = segments.one_hot_assignment(_t(seg), K, _t(valid)).numpy()
    assert np.array_equal(oh, np.stack([np.asarray(
        j_segments.one_hot_assignment(jnp.asarray(s), K, jnp.asarray(v)))
        for s, v in zip(seg, valid)]))


def _gap_threshold(feats, labeled, candidate):
    """A propagation threshold in the largest gap of the candidates' max
    similarities to a labeled superpixel, so that the branch fires both
    ways and no candidate sits near it (tests/test_train_parity.py)."""
    f = np.asarray(feats, np.float64)
    d2 = ((f[:, :, None] - f[:, None, :]) ** 2).sum(-1)
    sim = np.where(labeled[:, None, :], np.exp(-d2), -np.inf)
    max_sim = np.sort(sim.max(-1)[candidate])
    i = int(np.argmax(np.diff(max_sim)[1:-1])) + 1
    return float((max_sim[i] + max_sim[i + 1]) / 2), max_sim


@pytest.mark.parametrize("class_weights", [None, (3.0, 1.0)])
def test_wesup_loss_and_its_gradient_match_jax(class_weights):
    rng = np.random.default_rng(6)
    K, C, D = 40, 2, 8
    logits = rng.standard_normal((B, K, C)).astype(np.float32)
    feats = (0.3 * rng.standard_normal((B, K, D))).astype(np.float32)
    labeled = rng.random((B, K)) < 0.3
    labels = np.zeros((B, K, C), np.float32)
    labels[labeled, rng.integers(0, C, labeled.sum())] = 1.0
    labels[0, np.nonzero(labeled[0])[0][0]] = 1.0       # a multi-hot tie
    real = rng.random((B, K)) < 0.9
    real |= labeled
    thr, sims = _gap_threshold(feats, labeled, ~labeled & real)
    assert (sims > thr).any() and (sims < thr).any()
    kw = dict(class_weights=class_weights, propagate_threshold=thr,
              propagate_weight=0.5)

    def j_total(lg):
        out = jax.vmap(lambda p, f, l, m, r: j_obj.wesup_loss(
            p, f, l, m, r, **kw))(jax.nn.softmax(lg, -1), jnp.asarray(feats),
                                  jnp.asarray(labels), jnp.asarray(labeled),
                                  jnp.asarray(real))
        return out.loss.sum(), out

    (_, want), jgrad = jax.value_and_grad(j_total, has_aux=True)(
        jnp.asarray(logits))
    tlog = _t(logits).requires_grad_()
    got = objectives.wesup_loss(torch.softmax(tlog, -1), _t(feats),
                                _t(labels), _t(labeled), _t(real), **kw)
    got.loss.sum().backward()
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tlog.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6, rtol=1e-6)
    assert 0 < got.propagated_labels.sum() < (~labeled & real).sum()

    off = objectives.wesup_loss(torch.softmax(tlog, -1), _t(feats),
                                _t(labels), _t(labeled), _t(real),
                                enable_propagation=False)
    torch.testing.assert_close(off.loss, off.ce_loss)
    assert (off.propagated_labels == 0).all()


# ---------------------------------------------------------------------------
# (iii) augmentation: apply functions on JAX-drawn parameters, samplers by
# distribution
# ---------------------------------------------------------------------------

def _replay_appearance(keys, cfg):
    """The draws of JAX's random_appearance for each key, as the port's
    AppearanceParams (its split order: h, s, v, b, c, clahe, blur)."""
    cols = {n: [] for n in augment.AppearanceParams._fields}
    for key in keys:
        k_h, k_s, k_v, k_b, k_c, k_clahe, k_blur = jax.random.split(key, 7)
        u = jax.random.uniform
        cols["dh"].append(u(k_h, (), minval=-cfg.hue_shift_limit,
                            maxval=cfg.hue_shift_limit) / 180.0)
        cols["ds"].append(u(k_s, (), minval=-cfg.sat_shift_limit,
                            maxval=cfg.sat_shift_limit) / 255.0)
        cols["dv"].append(u(k_v, (), minval=-cfg.val_shift_limit,
                            maxval=cfg.val_shift_limit) / 255.0)
        cols["contrast"].append(u(k_c, (), minval=-cfg.contrast_limit,
                                  maxval=cfg.contrast_limit))
        cols["brightness"].append(u(k_b, (), minval=-cfg.brightness_limit,
                                    maxval=cfg.brightness_limit))
        cols["clahe"].append(jax.random.bernoulli(k_clahe, cfg.clahe_p))
        cols["blur"].append(jax.random.bernoulli(k_blur, cfg.blur_p))
    return augment.AppearanceParams(
        **{n: _t(np.stack([np.asarray(v) for v in vals]))
           for n, vals in cols.items()})


def _replay_elastic(keys, hw, p, alpha=34.0, grid=8):
    apply, coarse = [], []
    for key in keys:
        apply.append(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 0), p)))
        k1, _ = jax.random.split(key)
        coarse.append(np.asarray(jax.random.normal(k1, (grid, grid, 2))
                                 * alpha / max(hw) * min(hw)))
    return augment.ElasticParams(_t(np.stack(apply)), _t(np.stack(coarse)))


def _affines(keys, hw, cfg=j_aug.PositionConfig()):
    return np.stack([np.asarray(j_aug.random_affine(k, hw, cfg))
                     for k in keys])


def test_hsv_round_trip_matches_jax():
    rgb = np.random.default_rng(7).random((64, 3)).astype(np.float32)
    rgb[:4] = [[0.2, 0.2, 0.2], [0, 0, 0], [1, 0, 0], [0.5, 0.5, 0.9]]
    hsv = colorspace.rgb_to_hsv(_t(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(j_color.rgb_to_hsv(
        jnp.asarray(rgb))), atol=1e-6)
    back = colorspace.hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(), np.asarray(j_color.hsv_to_rgb(
        jnp.asarray(hsv.numpy()))), atol=1e-6)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)


def test_clahe_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.random((B, H, W, 3)).astype(np.float32) ** 2
    want = np.stack([np.asarray(j_clahe.clahe_rgb(jnp.asarray(i)))
                     for i in img])
    got = clahe.clahe_rgb(_t(img)).numpy()
    assert (np.abs(got - want) <= 1e-4).mean() >= 0.999
    plane = rng.random((B, H, W)).astype(np.float32) * 255
    want = np.stack([np.asarray(j_clahe.clahe_plane(jnp.asarray(p)))
                     for p in plane])
    got = clahe.clahe_plane(_t(plane)).numpy()
    assert (np.abs(got - want) <= 1e-4).mean() >= 0.999


def test_random_appearance_matches_jax_on_its_draws():
    """Keys chosen so the batch holds every (CLAHE, blur) combination."""
    cfg = j_aug.AppearanceConfig()
    keys, seen = [], set()
    for seed in range(64):
        k = jax.random.fold_in(jax.random.PRNGKey(9), seed)
        ks = jax.random.split(k, 7)
        combo = (bool(jax.random.bernoulli(ks[5], 0.5)),
                 bool(jax.random.bernoulli(ks[6], 0.5)))
        if combo not in seen:
            seen.add(combo)
            keys.append(k)
    assert len(keys) == 4
    img = np.random.default_rng(9).random((4, H, W, 3)).astype(np.float32)
    fn = jax.jit(lambda k, i: j_aug.random_appearance(k, i, cfg))
    want = np.stack([np.asarray(fn(k, jnp.asarray(i)))
                     for k, i in zip(keys, img)])
    params = _replay_appearance(keys, cfg)
    got = augment.random_appearance(_t(img), params).numpy()
    assert (np.abs(got - want) <= 1e-4).mean() >= 0.999
    no_clahe = ~params.clahe.numpy()
    np.testing.assert_allclose(got[no_clahe], want[no_clahe], atol=1e-5)


@pytest.mark.parametrize("method", ["cascade", "exact"])
def test_warps_match_jax_on_its_affines(method):
    keys = [jax.random.PRNGKey(s) for s in (10, 11, 12)]
    A = _affines(keys, (H, W))
    rng = np.random.default_rng(10)
    img = rng.random((3, H, W, 3)).astype(np.float32)
    mask = rng.integers(-1, 2, (3, H, W)).astype(np.float32)
    aux = np.stack([mask, np.ones_like(mask)], -1)
    jw = j_aug.warp if method == "cascade" else j_aug.warp_exact
    tw = augment.warp if method == "cascade" else augment.warp_exact
    want1 = np.asarray(jax.jit(jax.vmap(lambda i, a: jw(i, a, order=1)))(
        jnp.asarray(img), jnp.asarray(A)))
    want0 = np.asarray(jax.jit(jax.vmap(lambda x, a: jw(
        x, a, order=0, fill=jnp.array([-1.0, 0.0]))))(jnp.asarray(aux),
                                                      jnp.asarray(A)))
    got1 = tw(_t(img), _t(A), order=1).numpy()
    got0 = tw(_t(aux), _t(A), order=0, fill=[-1.0, 0.0]).numpy()
    np.testing.assert_allclose(got1, want1, atol=1e-4)
    assert (got0 == want0).mean() >= 0.999
    # a 2-D (B, H, W) input warps as one channel
    np.testing.assert_allclose(tw(_t(img[..., 0]), _t(A), order=1).numpy(),
                               got1[..., 0], atol=1e-6)


def test_affine_and_points_match_jax():
    keys = [jax.random.PRNGKey(s) for s in range(13, 21)]
    cfg = j_aug.PositionConfig(ssr_p=0.8)
    draws = {n: [] for n in augment.AffineDraws._fields}
    for key in keys:
        k_h, k_v, k_p, k_ang, k_sc, k_sx, k_sy = jax.random.split(key, 7)
        u = jax.random.uniform
        draws["hflip"].append(jax.random.bernoulli(k_h, cfg.hflip_p))
        draws["vflip"].append(jax.random.bernoulli(k_v, cfg.vflip_p))
        draws["ssr"].append(jax.random.bernoulli(k_p, cfg.ssr_p))
        draws["angle"].append(u(k_ang, (), minval=-45.0, maxval=45.0))
        draws["scale"].append(u(k_sc, (), minval=-0.1, maxval=0.1))
        draws["shift_x"].append(u(k_sx, (), minval=-0.0625, maxval=0.0625))
        draws["shift_y"].append(u(k_sy, (), minval=-0.0625, maxval=0.0625))
    draws = augment.AffineDraws(**{n: _t(np.stack([np.asarray(v) for v in d]))
                                   for n, d in draws.items()})
    want = _affines(keys, (H, W), cfg)
    got = augment.random_affine(draws, (H, W)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)
    assert not draws.ssr.all() and draws.hflip.any() and not draws.hflip.all()

    pts = (np.random.default_rng(11).random((len(keys), 12, 2))
           * [W, H]).astype(np.float32)
    want = np.stack([np.asarray(j_aug.transform_points(jnp.asarray(p),
                                                       jnp.asarray(a)))
                     for p, a in zip(pts, want)])
    got = augment.transform_points(_t(pts), _t(got)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_random_elastic_matches_jax_on_its_field():
    keys = [jax.random.PRNGKey(s) for s in (21, 22)]
    rng = np.random.default_rng(12)
    img = rng.random((2, H, W, 3)).astype(np.float32)
    mask = rng.integers(0, 2, (2, H, W)).astype(np.float32)
    want = [j_aug.random_elastic(k, jnp.asarray(i), jnp.asarray(m))
            for k, i, m in zip(keys, img, mask)]
    params = _replay_elastic(keys, (H, W), 0.5)
    got_img, got_mask = augment.random_elastic(_t(img), _t(mask),
                                               params.coarse)
    np.testing.assert_allclose(got_img.numpy(),
                               np.stack([np.asarray(w[0]) for w in want]),
                               atol=1e-4)
    assert (got_mask.numpy() == np.stack([np.asarray(w[1]) for w in want])
            ).mean() >= 0.999


def test_box_blur_matches_jax():
    img = np.random.default_rng(13).random((2, 9, 11, 3)).astype(np.float32)
    want = np.stack([np.asarray(j_aug._box_blur3(jnp.asarray(i)))
                     for i in img])
    np.testing.assert_allclose(augment._box_blur3(_t(img)).numpy(), want,
                               atol=1e-7)


def test_samplers_draw_the_configured_distributions():
    n = 4000
    gen = torch.Generator().manual_seed(0)
    cfg = augment.PositionConfig(ssr_p=0.8)
    d = augment.sample_affine(gen, n, cfg)
    for flag, p in ((d.hflip, 0.5), (d.vflip, 0.5), (d.ssr, 0.8)):
        assert abs(flag.float().mean().item() - p) < 0.03
    for val, lim in ((d.angle, 45.0), (d.scale, 0.1), (d.shift_x, 0.0625),
                     (d.shift_y, 0.0625)):
        assert val.min() >= -lim and val.max() <= lim
        assert val.min() < -0.95 * lim and val.max() > 0.95 * lim
        assert abs(val.mean().item()) < 0.05 * lim
    A = augment.random_affine(d, (H, W))
    det = torch.linalg.det(A[:, :2, :2]).abs()
    assert det.min() >= 0.9 ** 2 - 1e-5 and det.max() <= 1.1 ** 2 + 1e-5

    app = augment.sample_appearance(gen, n, augment.AppearanceConfig())
    for flag in (app.clahe, app.blur):
        assert abs(flag.float().mean().item() - 0.5) < 0.03
    for val, lim in ((app.dh, 20 / 180), (app.ds, 30 / 255),
                     (app.dv, 20 / 255), (app.contrast, 0.3),
                     (app.brightness, 0.3)):
        assert val.abs().max() <= lim + 1e-7 and val.abs().max() > 0.95 * lim
    assert augment.sample_appearance(
        gen, 4, augment.AppearanceConfig(clahe_p=0.0)).clahe is None

    el = augment.sample_elastic(gen, n, (H, W), 0.5)
    assert abs(el.apply.float().mean().item() - 0.5) < 0.03
    std = el.coarse.std().item()
    assert abs(std - 34.0 / W * H) < 0.03 * 34.0 / W * H


# ---------------------------------------------------------------------------
# (iv) forward + loss + SGD against JAX value_and_grad + optax
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_problem(seg_setup):
    """A fixed prep (no augmentation) and weights whose fc3 is scaled so
    that the candidates' similarities spread, with the propagation threshold
    in their largest gap."""
    img, valid, seg, jplan, tplan = seg_setup
    K = tplan.n_clusters
    sup = _point_sup(valid, 25, seed=14)
    target = np.where(valid, np.random.default_rng(15).integers(
        0, 2, (B, H, W)), -1).astype(np.int32)
    prep = j_steps.Preprocessed(jnp.asarray(img), jnp.asarray(valid),
                                jnp.asarray(target), jnp.asarray(seg),
                                jnp.asarray(sup))
    params = j_wesup.init_params(jax.random.PRNGKey(0), fc_width=FC_WIDTH)
    stats = jax.vmap(lambda s, m, v: j_segments.superpixel_stats(
        s, K, m, v, plan=jplan))(prep.seg, prep.sup_mask, prep.valid)
    lab = np.asarray(stats.labeled)
    cand = ~lab & np.asarray(stats.real)

    f = np.asarray(jax.jit(lambda p: j_wesup.forward_superpixel(
        p, prep.image, prep.seg, K, prep.valid, pooling="local",
        plan=jplan).sp_features)(params))
    d2 = ((f[:, :, None] - f[:, None, :]) ** 2).sum(-1)
    dmin = np.where(lab[:, None, :], d2, np.inf).min(-1)[cand]
    s = float(np.sqrt(0.7 / np.median(dmin)))   # median similarity ~0.5
    # fc3 is linear + ReLU, so scaling its weight and bias by s > 0 scales
    # the features by s
    params = dict(params, fc3={k: v * s for k, v in params["fc3"].items()})
    thr, sims = _gap_threshold(f * s, lab, cand)
    assert (sims > thr + 1e-3).sum() > 0 and (sims < thr - 1e-3).sum() > 0
    return prep, params, thr, K, jplan, tplan


def _port_prep(prep):
    return steps.Preprocessed(*(_t(np.asarray(x)) for x in prep))


def _model(params):
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return model


# the pooling paths; "local" keeps the ids the test had before it took
# the others
SGD_CASES = [pytest.param(p, d, id=d if p == "local" else f"{p}-{d}")
             for p in ("local", "adjoint", "fullres")
             for d in ("float32", "bfloat16")]
# bf16 gradient limits, in units of r = 2^-8 of the tensor's largest
# |grad| (see the module docstring)
BF16_GRAD_HEAD = 10 * 2.0 ** -8
BF16_GRAD_BACKBONE = 36 * 2.0 ** -8


@pytest.mark.parametrize("pooling_,dtype", SGD_CASES)
def test_forward_loss_and_sgd_match_jax(train_problem, pooling_, dtype):
    prep, params, thr, K, jplan, tplan = train_problem
    kw = dict(compute_dtype=dtype, propagate_threshold=thr, pooling=pooling_)
    jcfg, tcfg = JConfig(**kw), WESUPConfig(**kw)
    sv = np.ones((B,), bool)

    tx = j_steps.make_optimizer(jcfg)
    opt = tx.init(params)

    @jax.jit
    def jstep(p, o):
        (loss, (_, losses)), g = jax.value_and_grad(
            j_steps._forward_and_loss, has_aux=True)(
                p, prep, K, jcfg, jnp.asarray(sv), jplan)
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), o, loss, g, losses

    model = _model(params)
    optimizer = steps.make_optimizer(tcfg, model)
    tprep = _port_prep(prep)
    for it in range(3):
        params, opt, jloss, jgrads, jlosses = jstep(params, opt)
        model.zero_grad(set_to_none=True)
        loss, (_, losses) = steps._forward_and_loss(model, tprep, K, tcfg,
                                                    _t(sv), tplan)
        loss.backward()
        if it == 0:
            # the propagation branch fires (and, by the fixture's threshold,
            # also stays off) for the same superpixels in both packages
            n = np.asarray(jlosses.propagated_labels)
            assert n.sum() > 0
            np.testing.assert_array_equal(
                losses.propagated_labels.numpy(), n)
        if dtype == "bfloat16":
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=5e-2,
                                       atol=5e-3)
        else:
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        if it == 0:
            # gradients on identical weights (later steps start from
            # weights that differ by the steps before)
            want = from_jax_params(jax.tree.map(np.asarray, jgrads))
            for name, p in model.named_parameters():
                bb = name.startswith("backbone.")
                if dtype == "float32":
                    rel = 5e-3 if bb else 1e-3
                else:
                    rel = BF16_GRAD_BACKBONE if bb else BF16_GRAD_HEAD
                lim = rel * want[name].abs().max().item() + 1e-12
                err = (p.grad - want[name]).abs().max().item()
                assert err <= lim, (name, err, lim)
        optimizer.step()
    if dtype == "float32":
        want = from_jax_params(jax.tree.map(np.asarray, params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=name)


def test_freeze_backbone_leaves_it_bitwise(train_problem):
    prep, params, thr, K, _, tplan = train_problem
    cfg = WESUPConfig(compute_dtype="float32", freeze_backbone=True, lr=1e-2)
    model = _model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = steps.make_optimizer(cfg, model)
    tprep = _port_prep(prep)
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = steps._forward_and_loss(model, tprep, K, cfg,
                                          torch.ones(B, dtype=torch.bool),
                                          tplan)
        loss.backward()
        optimizer.step()
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(model.fc_layers[0].weight,
                           before["fc_layers.0.weight"])


# ---------------------------------------------------------------------------
# (v) the whole steps on the CPU
# ---------------------------------------------------------------------------

def _batch(seed=16, P=16):
    rng = np.random.default_rng(seed)
    batch = {
        "image": np.clip(rng.normal(180, 40, (B, H, W, 3)), 0, 255).astype(
            np.uint8),
        "valid": np.zeros((B, H, W), bool),
        "pixel_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
        "points": np.zeros((B, P, 3), np.int32),
        "point_valid": np.zeros((B, P), bool),
        "use_mask_as_points": np.zeros((B,), bool),
        "sample_valid": np.ones((B,), bool),
    }
    batch["valid"][:, :58, :141] = True
    batch["pixel_mask"][~batch["valid"]] = -1
    for b in range(B):
        for i in range(6):
            x, y = rng.integers(0, 141), rng.integers(0, 58)
            batch["points"][b, i] = (x, y, batch["pixel_mask"][b, y, x])
            batch["point_valid"][b, i] = True
    return batch


_CFG = dict(compute_dtype="float32", slic_iters=4)


@pytest.fixture(scope="module", params=[True, False], ids=["points", "mask"])
def jax_prep(request):
    """JAX's train preprocessing of a batch and the port's, on the
    parameters JAX drew."""
    point_mode = request.param
    jcfg, tcfg = JConfig(**_CFG), WESUPConfig(**_CFG)
    batch = _batch()
    keys = jax.random.split(jax.random.PRNGKey(17), B)
    pre = jax.jit(jax.vmap(lambda *a: j_steps._preprocess_sample(
        *a, config=jcfg, train=True, point_mode=point_mode)))
    want = pre(keys, *(jnp.asarray(batch[k]) for k in (
        "image", "valid", "pixel_mask", "points", "point_valid",
        "use_mask_as_points")))
    app_cfg, pos_cfg = steps._aug_configs(point_mode)
    splits = [jax.random.split(k, 3) for k in keys]
    params = steps.AugParams(
        _replay_appearance([s[0] for s in splits], app_cfg),
        _t(_affines([s[1] for s in splits], (H, W), pos_cfg)),
        None if point_mode else _replay_elastic(
            [s[2] for s in splits], (H, W), tcfg.elastic_p))
    tb = {k: _t(v) for k, v in batch.items()}
    got = steps._preprocess_sample(
        params, tb["image"], tb["valid"], tb["pixel_mask"], tb["points"],
        tb["point_valid"], tb["use_mask_as_points"], config=tcfg, train=True,
        point_mode=point_mode)
    return point_mode, batch, want, got, params


def test_train_preprocessing_matches_jax(jax_prep):
    point_mode, _, want, got, params = jax_prep
    img_close = np.abs(got.image.numpy() - np.asarray(want.image)) <= 1e-4
    assert img_close.mean() >= 0.999
    for name in ("valid", "target", "seg", "sup_mask"):
        same = getattr(got, name).numpy() == np.asarray(getattr(want, name))
        assert same.mean() >= 0.999, (name, same.mean())
    assert got.sup_mask.sum() > 0
    if not point_mode:
        assert params.elastic is not None


def test_train_metrics_match_jax_on_the_same_prep(jax_prep):
    """The port's forward, loss and metrics on JAX's own prep."""
    from wesup_tpu.utils.metrics import device_accuracy, device_dice

    point_mode, batch, want_prep, _, _ = jax_prep
    K = t_slic.n_clusters(H, W, 200)
    jcfg, tcfg = JConfig(**_CFG), WESUPConfig(**_CFG)
    jplan, tplan = j_slic.make_plan(H, W, 200), t_slic.make_plan(H, W, 200)
    params = j_wesup.init_params(jax.random.PRNGKey(1), fc_width=FC_WIDTH)
    sv = jnp.asarray(batch["sample_valid"])
    _, (out, losses) = j_steps._forward_and_loss(params, want_prep, K, jcfg,
                                                 sv, jplan)
    pred = jnp.round(out.pred).astype(jnp.int32)
    mvalid = want_prep.valid & (want_prep.target >= 0)
    want = {"loss": losses.loss, "labeled_sp_ratio": losses.labeled_sp_ratio,
            "propagated_labels": losses.propagated_labels,
            "propagate_loss": losses.propagate_loss,
            "accuracy": device_accuracy(pred, want_prep.target, mvalid),
            "dice": device_dice(pred, want_prep.target, mvalid)}

    tprep = _port_prep(want_prep)
    with torch.no_grad():
        _, (tout, tlosses) = steps._forward_and_loss(
            _model(params), tprep, K, tcfg, _t(batch["sample_valid"]), tplan)
        got = steps._train_metrics(tout, tlosses, tprep)
    assert set(got) == set(steps.TRAIN_METRIC_KEYS)
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("pooling_,point_mode", [
    pytest.param("local", True, id="points"),
    pytest.param("local", False, id="mask"),
    pytest.param("adjoint", True, id="adjoint-points"),
    pytest.param("fullres", True, id="fullres-points")])
def test_train_step_runs_on_cpu(pooling_, point_mode):
    batch = _batch(seed=18)
    if point_mode:  # the trainer's wire format: extents, int8 mask
        batch["content_hw"] = np.full((B, 2), (58, 141), np.int32)
        del batch["valid"]
        batch["pixel_mask"] = batch["pixel_mask"].astype(np.int8)
    cfg = WESUPConfig(**_CFG, pooling=pooling_)
    model = wesup.WESUP(fc_width=FC_WIDTH,
                        generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = steps.make_optimizer(cfg, model)
    acc = steps.init_metric_acc(device="cpu")
    step = steps.make_train_step(cfg, (H, W), point_mode=point_mode,
                                 device="cpu")
    gen = torch.Generator().manual_seed(0)
    phases = []
    for _ in range(2):
        acc = step(model, optimizer, acc, batch, gen, mark=phases.append)
    assert phases[:6] == ["augment", "slic", "forward", "loss", "backward",
                          "optimizer"]
    assert acc["count"].item() == 2 * B and not acc["nan"].item()
    for k in steps.TRAIN_METRIC_KEYS:
        assert np.isfinite(acc["sums"][k].item()), k
    assert 0 < acc["sums"]["accuracy"].item() <= 2 * B
    changed = [k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])]
    assert len(changed) == len(before)


def test_eval_step_matches_jax():
    batch = _batch(seed=19)
    cfg = dict(compute_dtype="float32", slic_iters=4)
    params = j_wesup.init_params(jax.random.PRNGKey(2), fc_width=FC_WIDTH)
    jacc = j_steps.init_metric_acc(j_steps.EVAL_METRIC_KEYS)
    jpred, jacc = j_steps.make_eval_step(JConfig(**cfg), (H, W))(
        params, jacc, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    step = steps.make_eval_step(WESUPConfig(**cfg), (H, W), device="cpu")
    pred, acc = step(_model(params).eval(),
                     steps.init_metric_acc(steps.EVAL_METRIC_KEYS, "cpu"),
                     batch)
    assert (np.abs(pred.numpy() - np.asarray(jpred)) <= 2e-4).mean() >= 0.999
    assert acc["count"].item() == B
    for k in steps.EVAL_METRIC_KEYS:
        np.testing.assert_allclose(acc["sums"][k].item(),
                                   float(jacc["sums"][k]), atol=1e-3)


def test_predict_then_train_in_one_process():
    """Constants first cached under the predict step's inference mode must
    be normal tensors, so that a train step in the same process (the
    trainer validates between epochs) can use them under autograd: the
    "local" path's plan tables and the "adjoint" path's upsample matrices
    and column tables alike."""
    cellgrid._const_cache.clear()
    t_slic._GRID_CACHE.clear()
    batch = _batch(seed=20)
    cfgs = [WESUPConfig(**_CFG, pooling=p) for p in ("local", "adjoint")]
    model = wesup.WESUP(fc_width=FC_WIDTH)
    for cfg in cfgs:
        steps.make_predict_step(cfg, (H, W), device="cpu")(
            model, batch["image"], batch["valid"])
    cached = [t for v in list(cellgrid._const_cache.values())
              + list(t_slic._GRID_CACHE.values())
              for t in (v if isinstance(v, tuple) else (v,))
              for t in (t if isinstance(t, tuple) else (t,))
              if isinstance(t, torch.Tensor)]
    assert cached and not any(t.is_inference() for t in cached)
    assert any(k[0] == "adjoint_table" for k in cellgrid._const_cache)
    for cfg in cfgs:
        step = steps.make_train_step(cfg, (H, W), point_mode=True,
                                     device="cpu")
        acc = step(model, steps.make_optimizer(cfg, model),
                   steps.init_metric_acc(device="cpu"), batch,
                   torch.Generator().manual_seed(1))
        assert np.isfinite(acc["sums"]["loss"].item()), cfg.pooling


def test_later_slice_wire_formats_raise():
    cfg = WESUPConfig(**_CFG)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    step = steps.make_train_step(cfg, (H, W), point_mode=True, device="cpu")
    for key in ("img_idx", "rng_idx"):
        batch = dict(_batch(), **{key: np.zeros((B, 2), np.int32)})
        with pytest.raises(NotImplementedError, match="slice 3"):
            step(model, steps.make_optimizer(cfg, model),
                 steps.init_metric_acc(device="cpu"), batch,
                 torch.Generator())


def test_train_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = WESUPConfig()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.make_train_step(cfg, (H, W), point_mode=True, device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.make_eval_step(cfg, (H, W), device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.init_metric_acc(device=device)
