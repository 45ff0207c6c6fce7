"""The port's adjoint and fullres pooling paths, their backward, and the
fused stage-1 pool against the JAX package, on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX suite runs them
(``tests/test_adjoint_pallas.py``); the port's wrappers take their plain
versions, as they do for every CPU tensor.  The CUDA walks of K5, K6 and
K8 (K6's backward) are emulated in Python on the pixel lists and column
tables the wrappers build, so the lists, the tables and the kernels' loop
logic are held here too (the kernels themselves run in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).  JAX has no
kernel for either backward: it differentiates its einsums, which
``jax.vjp`` replays here.

Tolerances (max abs):
- K5 plain vs ``segment_sum_pallas``: 1e-3 + 1e-5 relative, the JAX test's
  own; both sum the same f32 values of the same (bf16 or f32) inputs, in
  other orders.
- K6 plain vs ``adjoint_pool_stage``: the JAX test's, 5e-5 of the largest
  value in f32; in bf16 0.15 of it with rtol 0.02.
- K6 walk vs plain: f32 1e-5 of the largest value (order of the sums); bf16
  2^-8 of each element's mass (the sum of its |terms|) + that 1e-5: the
  f32 sums of the weights of p_h are formed in another order and may round
  to bf16 values one ulp apart, which moves a term by up to 2^-8 of it.
- K5's backward (``segment_sum_bwd``) vs ``jax.vjp`` of the dense one-hot
  sum: bitwise (a selection).
- K8's plain version vs torch.autograd of K6's plain version: f32 1e-6 of
  the largest value, bf16 one bf16 ulp (f32 sums of the same rounded p_h in
  another order); vs ``jax.vjp`` of JAX's einsum form of a stage, f32, 1e-5
  of the largest value.  K8's walk: its p_h bitwise K6's; its result vs
  the plain version 1e-6 of each element's sum of |terms| (+ one bf16 ulp
  in bf16).
- K7 and its gradient vs ``pool_pallas``: bitwise (max and zero-padding
  round nothing; the backward replays the same composition).
- Gated backbone vs JAX: the taps' tolerance of
  ``tests/test_torch_port_model.py`` (2e-4 abs, 1e-4 rel); gated vs ungated
  gradients in f64: 1e-9 of the largest.
- Forwards vs JAX: f32 2e-4 on probabilities and the painted map, 2e-3 on
  features; bf16 3e-2, the model test's limits.  Measured on this input:
  f32 6.0e-8 / 6.0e-8 / 1.6e-7, bf16 3.6e-5 / 0 / 4.3e-4 (adjoint) and
  2.4e-5 / 0 / 3.5e-4 (fullres).
- Predict steps vs JAX: f32 2e-4, rounded masks 99.9% equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import vgg as j_vgg  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.ops import pool_pallas as j_pool  # noqa: E402
from wesup_tpu.ops import resize as j_resize  # noqa: E402
from wesup_tpu.ops import segments as j_segments  # noqa: E402
from wesup_tpu.ops.adjoint_pallas import adjoint_pool_stage as j_adjoint  # noqa: E402
from wesup_tpu.ops.pooling_pallas import segment_sum_pallas  # noqa: E402
from wesup_tpu.ops.slic import make_plan as j_make_plan  # noqa: E402
from wesup_tpu.ops.slic import slic as j_slic  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import steps, vgg, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
from wesup_tpu_torch.ops import adjoint, pool, pooling, resize  # noqa: E402
from wesup_tpu_torch.ops import segments  # noqa: E402
from wesup_tpu_torch.ops.slic import make_plan  # noqa: E402

FC_WIDTH = 64
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def weights():
    params = j_wesup.init_params(jax.random.PRNGKey(0), fc_width=FC_WIDTH)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return params, model.eval()


@pytest.fixture(scope="module")
def batch():
    """bench.py-style images, ragged validity, and the JAX SLIC seg."""
    B, H, W = 2, 64, 160
    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(
        np.uint8).astype(np.float32) / 255.0
    valid = np.ones((B, H, W), bool)
    valid[:, -5:] = False
    valid[:, :, -7:] = False
    seg = np.array(jax.vmap(lambda i, v: j_slic(i, v, sp_area=200,
                                                update_stride=3))(
        jnp.asarray(img), jnp.asarray(valid)))
    return img, valid, seg


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """x rounded to ``dtype`` and back to f32 (what both packages read)."""
    return np.array(jnp.asarray(x, getattr(jnp, dtype)), np.float32)


# ---------------------------------------------------------------------------
# resizes and one-hot segment ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_resize_w_only_and_fused_upsample_sum_match_jax(dtype):
    rng = np.random.default_rng(0)
    maps = [_round(rng.standard_normal((2, h, 7, 5)), dtype)
            for h in (8, 4, 2, 1)]
    tol = 1e-6 if dtype == "float32" else 2e-2
    got_w = resize.resize_w_only(torch.from_numpy(maps[0]).to(
        getattr(torch, dtype)), 20)
    want_w = j_resize.resize_w_only(jnp.asarray(maps[0], getattr(jnp, dtype)),
                                    20)
    assert got_w.dtype == getattr(torch, dtype) and got_w.shape == (2, 8, 20, 5)
    np.testing.assert_allclose(got_w.float().numpy(),
                               np.asarray(want_w, np.float32), atol=tol)
    got = resize.fused_upsample_sum(
        [torch.from_numpy(m).to(getattr(torch, dtype)) for m in maps], 16)
    want = j_resize.fused_upsample_sum(
        [jnp.asarray(m, getattr(jnp, dtype)) for m in maps], 16)
    assert got.shape == (2, 16, 7, 5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 * tol)


def test_segment_mean_and_paint_match_jax():
    rng = np.random.default_rng(1)
    B, H, W, K, C = 2, 12, 10, 9, 3
    seg = rng.integers(0, K, (B, H, W)).astype(np.int32)
    valid = rng.random((B, H, W)) > 0.2
    feat = rng.standard_normal((B, H * W, C)).astype(np.float32)
    oh = segments.one_hot_assignment(torch.from_numpy(seg), K,
                                     torch.from_numpy(valid))
    got = segments.segment_mean(torch.from_numpy(feat), oh, oh.sum(1))
    j_oh = jax.vmap(lambda s, v: j_segments.one_hot_assignment(s, K, v))(
        jnp.asarray(seg), jnp.asarray(valid))
    want = jax.vmap(j_segments.segment_mean)(jnp.asarray(feat), j_oh,
                                             j_oh.sum(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    vals = rng.standard_normal((B, K, C)).astype(np.float32)
    for v in (vals, vals[..., 0]):
        np.testing.assert_array_equal(
            segments.paint(torch.from_numpy(seg), torch.from_numpy(v)).numpy(),
            np.asarray(jax.vmap(j_segments.paint)(jnp.asarray(seg),
                                                  jnp.asarray(v))))


# ---------------------------------------------------------------------------
# K5: segment sum
# ---------------------------------------------------------------------------

def _k5_inputs(dtype, B=2, P=5000, C=70, K=37):
    """test_pooling_pallas.py's shapes, every 17th id -1, per image."""
    rng = np.random.default_rng(0)
    seg = rng.integers(0, K, (B, P)).astype(np.int32)
    seg[:, ::17] = -1
    feat = _round(rng.standard_normal((B, P, C)), dtype)
    return seg, feat, K


@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_sum_plain_matches_pallas(dtype):
    seg, feat, K = _k5_inputs(dtype)
    got = pooling.segment_sum(torch.from_numpy(seg), torch.from_numpy(
        feat).to(getattr(torch, dtype)), K)
    assert got.dtype == torch.float32 and got.shape == (2, K, 70)
    for b in range(2):
        want = np.asarray(segment_sum_pallas(
            jnp.asarray(seg[b]), jnp.asarray(feat[b], getattr(jnp, dtype)),
            K, block_p=1024, c_tile=128))
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-3,
                                   rtol=1e-5)
    counts = torch.from_numpy(((seg[..., None] == np.arange(K)).sum(1))
                              .astype(np.float32))
    mean = pooling.segment_mean(torch.from_numpy(seg),
                                torch.from_numpy(feat), K, counts)
    np.testing.assert_allclose(mean.numpy(), (got / counts[..., None]
                                              .clamp_min(1)).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_segment_lists_and_the_k5_walk():
    """The lists hold each segment's pixels in pixel order and nothing
    else; the K5 kernel's walk over them (V-wide loads by G strided thread
    groups, partials added in group order) gives the plain sums."""
    seg, feat, K = _k5_inputs("float32", P=3000, C=24)
    lists = pooling.segment_lists(torch.from_numpy(seg), K)
    order, start = lists.order.numpy(), lists.start.numpy()
    assert start.shape == (2 * K + 1,) and start[0] == 0
    assert start[-1] == (seg >= 0).sum()
    for b in range(2):
        for k in range(K):
            g = b * K + k
            np.testing.assert_array_equal(order[start[g]:start[g + 1]],
                                          np.flatnonzero(seg[b] == k))
    want = pooling.segment_sum_plain(torch.from_numpy(seg),
                                     torch.from_numpy(feat), K).numpy()
    n_grp = 256 // 8                         # C=24, V=4: 6 vectors, TX=8
    got = np.zeros_like(want)
    for g in range(2 * K):
        b, k = divmod(g, K)
        rows = feat[b, order[start[g]:start[g + 1]]]
        parts = [rows[q::n_grp].sum(0, dtype=np.float32)
                 for q in range(n_grp)]
        got[b, k] = np.sum(parts, axis=0, dtype=np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# K6: adjoint stage pooling
# ---------------------------------------------------------------------------

def _k6_inputs(dtype, B=2, H=32, W=48, K=37, Hs=16, Ws=24, C=12, seed=0):
    """test_adjoint_pallas.py's shapes: random ids, two invalid rows."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, K, (B, H, W)).astype(np.int32)
    seg[0, :2] = -1
    taps = rng.standard_normal((B, Hs, Ws, C)).astype(np.float32)
    A_h = j_resize._interp_matrix(Hs, H, True)
    A_w = j_resize._interp_matrix(Ws, W, True)
    tapsH_T = _round(np.einsum("hu,buvc->bchv", A_h, taps), dtype)
    return seg, tapsH_T, A_w.T.copy(), K


@pytest.mark.parametrize("dtype", DTYPES)
def test_adjoint_pool_stage_plain_matches_pallas(dtype):
    seg, tapsH_T, A_wT, K = _k6_inputs(dtype)
    tdt = getattr(torch, dtype)
    got = adjoint.adjoint_pool_stage(
        torch.from_numpy(seg), torch.from_numpy(tapsH_T).to(tdt),
        torch.from_numpy(A_wT), K).numpy()
    want = np.asarray(j_adjoint(jnp.asarray(seg),
                                jnp.asarray(tapsH_T, getattr(jnp, dtype)),
                                jnp.asarray(A_wT, getattr(jnp, dtype)), K))
    assert got.shape == want.shape == (2, 12, K)
    tol = 5e-5 if dtype == "float32" else 0.15
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                               rtol=0.02 if dtype == "bfloat16" else 1e-5)


def _k6_walk(seg, tapsH_T, A_wT, K, dtype):
    """Python replay of the K6 walk in one pass: the pixel lists, the
    column table, the two running sums of p_h and the rounding at each
    flush, each flush added into the sums at once.  The kernel's two-phase
    form (``_k6_entries``, then the sum) must equal it bitwise."""
    tdt = getattr(torch, dtype)
    lists = pooling.segment_lists(torch.from_numpy(seg), K)
    v0, a0, a1 = (t.numpy() for t in adjoint.column_table(
        torch.from_numpy(A_wT), tdt, torch.device("cpu"))[:3])
    order, start = lists.order.numpy(), lists.start.numpy()
    B, H, W = seg.shape
    C, Ws = tapsH_T.shape[1], tapsH_T.shape[3]

    def rnd(p):
        return float(torch.tensor(p, dtype=torch.float32).to(tdt).float())

    out = np.zeros((B, K, C), np.float32)
    for g in range(B * K):
        b, k = divmod(g, K)
        acc = np.zeros(C, np.float32)

        def flush(h, v, p):
            if p != 0 and v < Ws:
                acc[:] += np.float32(rnd(p)) * tapsH_T[b, :, h, v]

        cur_h = cur_v = -1
        pa = pb = np.float32(0)
        for pix in order[start[g]:start[g + 1]]:
            h, w = divmod(int(pix), W)
            v = int(v0[w])
            if (h, v) != (cur_h, cur_v):
                if cur_v >= 0 and h == cur_h and v == cur_v + 1:
                    flush(cur_h, cur_v, pa)
                    pa, pb = pb, np.float32(0)
                elif cur_v >= 0:
                    flush(cur_h, cur_v, pa)
                    flush(cur_h, cur_v + 1, pb)
                    pa = pb = np.float32(0)
                cur_h, cur_v = h, v
            pa = np.float32(pa + a0[w])
            pb = np.float32(pb + a1[w])
        if cur_v >= 0:
            flush(cur_h, cur_v, pa)
            flush(cur_h, cur_v + 1, pb)
        out[b, k] = acc
    return out.transpose(0, 2, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Ws,W", [(24, 48), (7, 48), (1, 20)])
def test_adjoint_kernel_walk_matches_plain(dtype, Ws, W):
    seg, tapsH_T, _, K = _k6_inputs(dtype, B=1, H=6, W=W, K=9, Hs=3, Ws=Ws,
                                    C=5, seed=Ws)
    # SLIC-like ids: contiguous blobs with some fragments
    rng = np.random.default_rng(W)
    seg = (np.arange(W)[None, None, :] * 3 // W
           + 3 * (np.arange(6)[None, :, None] // 2)).astype(np.int32)
    seg = np.where(rng.random(seg.shape) < 0.15,
                   rng.integers(-1, K, seg.shape), seg).astype(np.int32)
    A_wT = j_resize._interp_matrix(Ws, W, True).T.copy()
    want = adjoint.adjoint_pool_stage_plain(
        torch.from_numpy(seg), torch.from_numpy(tapsH_T), torch.from_numpy(
            A_wT), K).numpy()
    got = _k6_walk(seg, tapsH_T, A_wT, K, dtype)
    lim = 1e-5 * max(1.0, np.abs(want).max())
    if dtype == "bfloat16":
        mass = adjoint.adjoint_pool_stage_plain(
            torch.from_numpy(seg), torch.from_numpy(np.abs(tapsH_T)),
            torch.from_numpy(A_wT), K).numpy()
        lim = lim + 2.0 ** -8 * mass
    assert (np.abs(got - want) <= lim).all()


def _k6_entries(seg, A_wT, K, dtype, ncl, win):
    """Phase 1 of the K6 kernel replayed: blocks of ``ncl`` consecutive
    lists, their pixels in windows of ``win``, one walk per list whose open
    sums carry across windows.  Returns each list's (h, v, T(p_h[v]))
    entries in the order the kernel streams them."""
    tdt = getattr(torch, dtype)
    lists = pooling.segment_lists(torch.from_numpy(seg), K)
    v0, a0, a1 = (t.numpy() for t in adjoint.column_table(
        torch.from_numpy(A_wT), tdt, torch.device("cpu"))[:3])
    order, start = lists.order.numpy(), lists.start.numpy()
    B, H, W = seg.shape
    Ws = A_wT.shape[0]

    def rnd(p):
        return float(torch.tensor(p, dtype=torch.float32).to(tdt).float())

    entries = [[] for _ in range(B * K)]
    for g0 in range(0, B * K, ncl):
        n_lists = min(ncl, B * K - g0)
        walks = [{"h": -1, "v": -1, "pa": np.float32(0), "pb": np.float32(0)}
                 for _ in range(n_lists)]
        r0, r1 = start[g0], start[g0 + n_lists]
        for ws in range(r0, r1, win):
            n = min(win, r1 - ws)
            for l, st in enumerate(walks):
                lo, hi = start[g0 + l], start[g0 + l + 1]
                jb, je = max(lo, ws), min(hi, ws + n)
                out = []

                def flush(h, v, p):
                    if p != 0 and v < Ws:
                        out.append((h, v, rnd(p)))

                for pix in order[jb:je]:
                    h, w = divmod(int(pix), W)
                    v = int(v0[w])
                    if (h, v) != (st["h"], st["v"]) and st["v"] >= 0:
                        flush(st["h"], st["v"], st["pa"])
                        if h == st["h"] and v == st["v"] + 1:
                            st["pa"], st["pb"] = st["pb"], np.float32(0)
                        else:
                            flush(st["h"], st["v"] + 1, st["pb"])
                            st["pa"] = st["pb"] = np.float32(0)
                    st["h"], st["v"] = h, v
                    st["pa"] = np.float32(st["pa"] + a0[w])
                    st["pb"] = np.float32(st["pb"] + a1[w])
                if jb < je and je == hi and st["v"] >= 0:
                    flush(st["h"], st["v"], st["pa"])
                    flush(st["h"], st["v"] + 1, st["pb"])
                # the list's share of the window's entry buffer
                assert len(out) <= 2 * max(je - jb, 0) + 2
                entries[g0 + l] += out
    return entries


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Ws", [24, 7])
@pytest.mark.parametrize("ncl,win", [(8, 1024), (1, 7), (3, 5)])
def test_adjoint_two_phase_walk_equals_the_walk(dtype, Ws, ncl, win):
    """Entries first, then the sum in entry order: bitwise the one-pass
    walk of ``_k6_walk``, with lists that cross windows (``win`` 5 and 7
    against lists of about 30 pixels) and rows in which v jumps by more
    than one (the fragments)."""
    W, K = 48, 9
    seg, tapsH_T, _, _ = _k6_inputs(dtype, B=2, H=6, W=W, K=K, Hs=3, Ws=Ws,
                                    C=5, seed=Ws)
    rng = np.random.default_rng(Ws + ncl)
    seg = (np.arange(W)[None, None, :] * 3 // W
           + 3 * (np.arange(6)[None, :, None] // 2)).astype(np.int32)
    seg = np.broadcast_to(seg, (2, 6, W)).copy()
    seg = np.where(rng.random(seg.shape) < 0.2,
                   rng.integers(-1, K, seg.shape), seg).astype(np.int32)
    A_wT = j_resize._interp_matrix(Ws, W, True).T.copy()
    entries = _k6_entries(seg, A_wT, K, dtype, ncl, win)
    jumps = sum(1 for es in entries for (h0, v0_, _), (h1, v1, _) in
                zip(es, es[1:]) if h0 == h1 and v1 > v0_ + 1)
    assert jumps > 0
    got = np.zeros((2, K, 5), np.float32)
    for g, es in enumerate(entries):
        b, k = divmod(g, K)
        for h, v, p in es:
            got[b, k] += np.float32(p) * tapsH_T[b, :, h, v]
    want = _k6_walk(seg, tapsH_T, A_wT, K, dtype)
    assert np.array_equal(got.transpose(0, 2, 1), want)


def test_adjoint_column_table_rejects_other_matrices():
    A = j_resize._interp_matrix(6, 20, True).T.copy()      # (6, 20)
    v0, a0, a1 = adjoint.column_table(torch.from_numpy(A), torch.float32,
                                       torch.device("cpu"))[:3]
    assert (np.diff(v0.numpy()) >= 0).all()
    np.testing.assert_allclose((a0 + a1).numpy(), 1.0, rtol=1e-6)
    bad = A.copy()
    bad[0, 5] = 0.1                                           # a third nonzero
    with pytest.raises(ValueError):
        adjoint.column_table(torch.from_numpy(bad), torch.float32,
                              torch.device("cpu"))
    with pytest.raises(ValueError):                           # decreasing rows
        adjoint.column_table(torch.from_numpy(A[:, ::-1].copy()),
                              torch.float32, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the backward of K5 (on K3's kernel) and of K6 (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_sum_bwd_plain_matches_jax(dtype):
    """K5's backward against ``jax.vjp`` of the dense one-hot form that
    JAX's fullres pooling differentiates (``pool_one``), with ids -1 and
    ids >= K present: a selection, so bitwise in either dtype.  Through
    the autograd Function too."""
    seg, feat, K = _k5_inputs(dtype, P=3000, C=24)
    seg[:, 5::23] = K + 3                                   # ids past K
    dsums = np.random.default_rng(1).standard_normal(
        (2, K, 24)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def dense(f, s):
        oh = (s[:, None] == jnp.arange(K)).astype(jdt)
        return jnp.einsum("pk,pc->kc", oh, f,
                          preferred_element_type=jnp.float32)

    want = np.stack([np.asarray(jax.vjp(
        lambda f: dense(f, jnp.asarray(seg[b])),
        jnp.asarray(feat[b], jdt))[1](jnp.asarray(dsums[b]))[0], np.float32)
        for b in range(2)])
    tdt = getattr(torch, dtype)
    got = pooling.segment_sum_bwd(torch.from_numpy(seg),
                                  torch.from_numpy(dsums), tdt)
    assert got.dtype == tdt and got.shape == feat.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    f = torch.from_numpy(feat).to(tdt).requires_grad_(True)
    pooling.segment_sum(torch.from_numpy(seg), f, K).backward(
        torch.from_numpy(dsums))
    assert torch.equal(f.grad, got)


def _k6_stage(jax_dtype, taps, A_h, A_w, seg, K):
    """JAX's einsum form of one adjoint stage (models/wesup.py's
    ``t_cat``, ``M`` and sums), as a function of the native taps."""
    oh = (seg[..., None] == jnp.arange(K)).astype(jax_dtype)
    t_cat = jnp.einsum("hu,bhwk->buwk", jnp.asarray(A_h, jax_dtype), oh)
    M = jnp.einsum("wv,buwk->buvk", jnp.asarray(A_w, jax_dtype), t_cat)
    return jnp.einsum("buvk,buvc->bkc", M, taps,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Ws,W", [(24, 48), (7, 48), (1, 20)])
def test_adjoint_pool_stage_bwd_plain_matches_autograd_and_jax(dtype, Ws, W):
    """K8's plain version against torch.autograd of K6's plain version (the
    same rounded p_h, f32 sums in another order: f32 to 1e-6 of the largest
    value, bf16 within one bf16 ulp), through the autograd Function
    (bitwise: the same plain version), and in f32 against ``jax.vjp`` of
    JAX's einsum form of the stage, composed with the H-upsample, to 1e-5
    of the largest value (sums in other orders)."""
    H, Hs, C, K = 6, 3, 5, 9
    seg, _, _, _ = _k6_inputs(dtype, B=2, H=H, W=W, K=K, Hs=Hs, Ws=Ws, C=C,
                              seed=Ws)
    rng = np.random.default_rng(W + Ws)
    taps = _round(rng.standard_normal((2, Hs, Ws, C)), dtype)
    dsums = rng.standard_normal((2, K, C)).astype(np.float32)
    A_h = j_resize._interp_matrix(Hs, H, True)
    A_w = j_resize._interp_matrix(Ws, W, True)
    A_wT = torch.from_numpy(A_w.T.copy())
    tdt = getattr(torch, dtype)
    tseg = torch.from_numpy(seg)
    tapsH_T = torch.einsum("hu,buvc->bchv", torch.from_numpy(A_h),
                           torch.from_numpy(taps)).to(tdt)

    got = adjoint.adjoint_pool_stage_bwd_plain(tseg, torch.from_numpy(dsums),
                                               A_wT, K, tdt)
    assert got.dtype == tdt and got.shape == (2, C, H, Ws)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    x = tapsH_T.detach().requires_grad_(True)
    adjoint.adjoint_pool_stage_plain(tseg, x, A_wT, K).backward(
        torch.from_numpy(dsums).transpose(1, 2))
    err = (got.float() - x.grad.float()).abs()
    if dtype == "float32":
        assert err.max().item() <= 1e-6 * x.grad.abs().max().item()
    else:
        ulp = torch.from_numpy(_bf16_ulp(x.grad.float().numpy()))
        assert (err <= ulp).all()
    y = tapsH_T.detach().requires_grad_(True)
    adjoint.adjoint_pool_stage(tseg, y, A_wT, K).backward(
        torch.from_numpy(dsums).transpose(1, 2))
    assert torch.equal(y.grad, got)

    if dtype == "float32":
        _, vjp = jax.vjp(lambda t: _k6_stage(jnp.float32, t, A_h, A_w,
                                             jnp.asarray(seg), K),
                         jnp.asarray(taps))
        want = np.asarray(vjp(jnp.asarray(dsums))[0])         # (B, Hs, Ws, C)
        mine = np.einsum("hu,bchv->buvc", A_h, got.numpy())
        np.testing.assert_allclose(mine, want,
                                   atol=1e-5 * np.abs(want).max())


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return (2.0 ** (np.floor(np.log2(x)) - 7)).astype(np.float32)


def _k8_walk(seg, dsums, A_wT, K, dtype):
    """Python replay of the K8 kernel: per output row (b, h, v), phase 1
    walks the column range [lo[v], hi[v]) of the table in ascending w,
    merges the weights of equal ids into terms (first appearance order),
    rounds each merged p_h to ``dtype`` and drops the zeros; phase 2 sums
    p * dsums[b, k] over the terms in order in f32 and rounds to
    ``dtype``.  Returns ((B, H, Ws, C) output, {(b, k): [(h, v, p)]})."""
    tdt = getattr(torch, dtype)
    table = adjoint.column_table(torch.from_numpy(A_wT), tdt,
                                 torch.device("cpu"))
    v0, a0, a1, lo, hi = (t.numpy() for t in table[:5])
    B, H, W = seg.shape
    Ws, C = A_wT.shape[0], dsums.shape[-1]

    def rnd(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            tdt).float().numpy()

    out = np.zeros((B, H, Ws, C), np.float32)
    by_list = {}
    for b in range(B):
        for h in range(H):
            for v in range(Ws):
                assert hi[v] - lo[v] <= table.cap
                ks, ps = [], []
                for w in range(lo[v], hi[v]):
                    k = int(seg[b, h, w])
                    if k < 0 or k >= K:
                        continue
                    wgt = a0[w] if v0[w] == v else a1[w]
                    if k not in ks:
                        ks.append(k)
                        ps.append(np.float32(0))
                    j = ks.index(k)
                    ps[j] = np.float32(ps[j] + wgt)
                acc = np.zeros(C, np.float32)
                for k, p in zip(ks, rnd(ps)):
                    if p != 0:
                        acc = acc + np.float32(p) * dsums[b, k]
                        by_list.setdefault((b, k), []).append((h, v, float(p)))
                out[b, h, v] = rnd(acc)
    return out, by_list


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Ws,W", [(24, 48), (7, 48), (1, 20)])
def test_k8_walk_p_is_the_forward_p(dtype, Ws, W):
    """K8's walk finds, for every (b, k), exactly the (h, v, T(p_h)) terms
    that K6's phase 1 streams (``_k6_entries``), bitwise: each p_h is the
    sum from 0 of its pixels' weights in ascending w in both.  Against the
    plain version it is not bitwise: the dense einsums sum p_h's weights
    and the terms in another order (about one f32 output in eight differs,
    by up to 3.3e-6 of itself), so f32 is held to 1e-6 of each element's
    mass (the sum of its |terms|, 1-4 of them) and bf16 within one bf16
    ulp plus that (the f32 sums may round to neighbouring bf16 values)."""
    H, K = 6, 9
    rng = np.random.default_rng(W + 7 * Ws)
    seg = (np.arange(W)[None, None, :] * 3 // W
           + 3 * (np.arange(H)[None, :, None] // 2)).astype(np.int32)
    seg = np.broadcast_to(seg, (2, H, W)).copy()
    seg = np.where(rng.random(seg.shape) < 0.2,
                   rng.integers(-1, K + 2, seg.shape), seg).astype(np.int32)
    dsums = rng.standard_normal((2, K, 5)).astype(np.float32)
    A_wT = j_resize._interp_matrix(Ws, W, True).T.copy()
    got, by_list = _k8_walk(seg, dsums, A_wT, K, dtype)
    entries = _k6_entries(np.where(seg < K, seg, -1).astype(np.int32), A_wT,
                          K, dtype, 8, 1024)
    for g, es in enumerate(entries):
        assert sorted(by_list.get(divmod(g, K), [])) == sorted(es), g
    def plain(ds, dt):
        return adjoint.adjoint_pool_stage_bwd_plain(
            torch.from_numpy(seg), torch.from_numpy(ds),
            torch.from_numpy(A_wT), K, dt).permute(0, 2, 3, 1).float().numpy()

    want = plain(dsums, getattr(torch, dtype))
    lim = 1e-6 * plain(np.abs(dsums), torch.float32)
    if dtype == "bfloat16":
        lim = lim + _bf16_ulp(want)
    assert (np.abs(got - want) <= lim).all()


def test_adjoint_bwd_receives_bf16_cotangents(weights, batch, monkeypatch):
    """The forward casts each stage's sums to the compute dtype before the
    projection, so in bf16 the cotangent K8 receives is bf16-representable
    (no cast is needed before the kernel).  The backward of the adjoint
    forward calls K8 once per stage 1-4 and K5's backward once; fullres
    calls K5's backward twice."""
    _, model = weights
    img, valid, seg = batch
    K = make_plan(*img.shape[1:3], 200).n_clusters
    seen = {"k8": [], "k5": []}
    real_k8, real_k5 = adjoint.adjoint_pool_stage_bwd, pooling.segment_sum_bwd

    def k8(seg_, dsums, *args, **kwargs):
        seen["k8"].append(dsums.clone())
        return real_k8(seg_, dsums, *args, **kwargs)

    def k5(seg_, dsums, dtype):
        seen["k5"].append(dtype)
        return real_k5(seg_, dsums, dtype)

    monkeypatch.setattr(adjoint, "adjoint_pool_stage_bwd", k8)
    monkeypatch.setattr(pooling, "segment_sum_bwd", k5)
    for pooling_, n_k8, n_k5 in (("adjoint", 4, 1), ("fullres", 0, 2)):
        seen["k8"].clear()
        seen["k5"].clear()
        model.zero_grad(set_to_none=True)
        out = wesup.forward_superpixel(
            model, torch.from_numpy(img), torch.from_numpy(seg), K,
            torch.from_numpy(valid), torch.bfloat16, pooling=pooling_)
        (out.sp_pred[..., 1].sum() + out.sp_features.sum()).backward()
        assert len(seen["k8"]) == n_k8 and seen["k5"] == [torch.bfloat16] * n_k5
        for d in seen["k8"]:
            assert d.dtype == torch.float32
            assert torch.equal(d, d.to(torch.bfloat16).float())
        assert all(torch.isfinite(q.grad).all() for q in model.parameters())
    model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# K7: fused relu + pool + pad, and the gated backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cout", [64, 128])
def test_fused_pool_matches_pallas(dtype, cout):
    rng = np.random.default_rng(0)
    pre = _round(rng.standard_normal((2, 32, 64, 64)), dtype)
    got = pool.fused_relu_pool_pad(torch.from_numpy(pre).to(
        getattr(torch, dtype)), cout)
    want = j_pool.fused_relu_pool_pad(jnp.asarray(pre, getattr(jnp, dtype)),
                                      cout)
    assert tuple(got.shape) == (2, 16, 32, cout)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # odd H and W: VALID pooling drops the last row and column (JAX takes
    # its reference composition there)
    odd = _round(rng.standard_normal((1, 33, 65, 64)), dtype)
    got = pool.fused_relu_pool_pad(torch.from_numpy(odd).to(
        getattr(torch, dtype)), cout)
    want = j_pool.fused_relu_pool_pad(jnp.asarray(odd, getattr(jnp, dtype)),
                                      cout)
    assert tuple(got.shape) == (1, 16, 32, cout)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_pool_grad_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    pre = _round(rng.standard_normal((1, 32, 64, 64)), dtype)
    w = rng.standard_normal((128,)).astype(np.float32)

    g_jax = jax.grad(lambda p: jnp.sum(
        (j_pool.fused_relu_pool_pad(p, 128).astype(jnp.float32) ** 2)
        * jnp.asarray(w)))(jnp.asarray(pre, getattr(jnp, dtype)))
    p = torch.from_numpy(pre).to(getattr(torch, dtype)).requires_grad_(True)
    loss = ((pool.fused_relu_pool_pad(p, 128).float() ** 2)
            * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(loss, p)
    assert g.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(g.float().numpy(),
                                  np.asarray(g_jax, np.float32))
    p2 = p.detach().requires_grad_(True)
    loss2 = ((pool.reference(p2, 128).float() ** 2)
             * torch.from_numpy(w)).sum()
    (g_ref,) = torch.autograd.grad(loss2, p2)
    assert torch.equal(g, g_ref)


def _gate_on(monkeypatch):
    """Turn both packages' fused-pool gates on; count the port's K7 calls."""
    monkeypatch.setattr(j_vgg, "_fused_pool1_ok",
                        lambda pre: pre.shape[-1] == 64
                        and j_pool.supports(pre.shape))
    monkeypatch.setenv("WESUP_FUSED_POOL1", "1")
    calls = []
    real = vgg.fused_relu_pool_pad

    def spy(pre, out_channels):
        calls.append((tuple(pre.shape), out_channels))
        return real(pre, out_channels)

    monkeypatch.setattr(vgg, "fused_relu_pool_pad", spy)
    return calls


def test_backbone_with_fused_pool1_matches_jax(weights, monkeypatch):
    params, model = weights
    img = np.random.default_rng(3).random((1, 32, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        plain = vgg.backbone_features(model.backbone, torch.from_numpy(img))
    calls = _gate_on(monkeypatch)
    want = j_vgg.backbone_features(params["backbone"], jnp.asarray(img))
    with torch.inference_mode():
        got = vgg.backbone_features(model.backbone, torch.from_numpy(img))
    assert calls == [((1, 32, 64, 64), 128)]
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_backbone_fused_pool1_grad_f64(weights, monkeypatch):
    """Gradients are invariant to the gate (conv2_1's zero-widened input
    adds exact zeros; f64 keeps the reassociation from flipping a relu or
    a max)."""
    _, model = weights
    img = torch.from_numpy(np.random.default_rng(3).random(
        (1, 32, 64, 3))).to(torch.float64)

    def grads():
        bb = model.backbone.double()
        bb.zero_grad(set_to_none=True)
        taps = vgg.backbone_features(bb, img, torch.float64)
        sum((t ** 2).sum() for t in taps).backward()
        return [q.grad.clone() for q in bb.parameters()]

    try:
        g_ref = grads()
        calls = _gate_on(monkeypatch)
        g_fused = grads()
    finally:
        model.backbone.float()
    assert len(calls) == 1
    for a, b in zip(g_fused, g_ref):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= 1e-9 * scale


# ---------------------------------------------------------------------------
# the forwards and the predict steps
# ---------------------------------------------------------------------------

TOLS = {"float32": {"sp_pred": 2e-4, "pred": 2e-4, "sp_features": 2e-3},
        "bfloat16": {"sp_pred": 3e-2, "pred": 3e-2, "sp_features": 3e-2}}
CASES = [("adjoint", True), ("adjoint", False), ("fullres", False)]


def _forwards(params, model, img, valid, seg, dtype, pooling_, with_plan):
    H, W = img.shape[1:3]
    jplan = j_make_plan(H, W, 200)
    K = jplan.n_clusters
    want = jax.jit(lambda p, i, s, v: j_wesup.forward_superpixel(
        p, i, s, K, v, getattr(jnp, dtype), pooling=pooling_,
        plan=jplan if with_plan else None))(
        params, jnp.asarray(img), jnp.asarray(seg), jnp.asarray(valid))
    with torch.inference_mode():
        got = wesup.forward_superpixel(
            model, torch.from_numpy(img), torch.from_numpy(seg), K,
            torch.from_numpy(valid), getattr(torch, dtype), pooling=pooling_,
            plan=make_plan(H, W, 200) if with_plan else None)
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pooling_,with_plan", CASES)
def test_forward_superpixel_matches_jax(weights, batch, dtype, pooling_,
                                        with_plan):
    params, model = weights
    got, want = _forwards(params, model, *batch, dtype, pooling_, with_plan)
    for name, tol in TOLS[dtype].items():
        g, w = getattr(got, name), np.asarray(getattr(want, name), np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)


def test_onehot_counts_round_as_jax_above_256(weights, batch):
    """A superpixel of 301 valid pixels: the plan-less and fullres forwards
    count it as JAX's bf16 one-hot sum does (301 rounds to 300 in bf16),
    the plan's cell counts exactly."""
    params, model = weights
    img, valid, seg = batch
    seg = seg.copy()
    seg[0][seg[0] == 5] = 6
    seg[0, :7, :43] = 5                               # 7 x 43 = 301 pixels
    assert valid[0, :7, :43].all()
    K = j_make_plan(*img.shape[1:3], 200).n_clusters
    seg_m = np.where(valid, seg, -1)
    for dt in DTYPES:
        got = wesup._onehot_counts(torch.from_numpy(seg_m), K,
                                   getattr(torch, dt)).numpy()
        oh = (jnp.asarray(seg)[..., None] == jnp.arange(K)).astype(
            getattr(jnp, dt)) * jnp.asarray(valid)[..., None].astype(
                getattr(jnp, dt))
        want = np.asarray(oh.sum(axis=(1, 2)).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
        assert got[0, 5] == (301 if dt == "float32" else 300)
    plan = make_plan(*img.shape[1:3], 200)
    from wesup_tpu_torch.ops import cellgrid

    exact = cellgrid.cell_counts(plan, torch.from_numpy(seg),
                                 torch.from_numpy(valid))
    assert exact[0, 5].item() == 301
    for pooling_ in ("adjoint", "fullres"):
        got, want = _forwards(params, model, img, valid, seg, "bfloat16",
                              pooling_, False)
        for name, tol in TOLS["bfloat16"].items():
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name),
                                                  np.float32), atol=tol)


def _bench_batch(B, H, W, content, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(np.uint8)
    valid = np.zeros((B, H, W), bool)
    valid[:, :content[0], :content[1]] = True
    return imgs, valid


@pytest.mark.parametrize("pooling_,gated", [("adjoint", False),
                                            ("fullres", False),
                                            ("local", True)])
def test_make_predict_step_matches_jax(weights, monkeypatch, pooling_, gated):
    params, model = weights
    canvas = (64, 160)
    imgs, valid = _bench_batch(2, *canvas, (58, 141))
    calls = _gate_on(monkeypatch) if gated else []
    cfg = dict(compute_dtype="float32", pooling=pooling_)
    want = np.asarray(j_steps.make_predict_step(
        JConfig(**cfg), canvas, "superpixel")(
            params, jnp.asarray(imgs), jnp.asarray(valid)))
    step = steps.make_predict_step(WESUPConfig(**cfg), canvas, "superpixel",
                                   device="cpu")
    got = step(model, torch.from_numpy(imgs), torch.from_numpy(valid)).numpy()
    assert len(calls) == int(gated)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert (np.round(got) == np.round(want)).mean() >= 0.999


@pytest.mark.parametrize("pooling_", ["adjoint", "fullres"])
def test_scaled_and_eval_steps_match_jax(weights, pooling_):
    """The scaled predict step (the server's) and the eval step take the
    configured pooling as JAX's do: uint8 masks and rounded predictions
    99.9% equal, f32 predictions to 2e-4, eval metric sums to 1e-3."""
    params, model = weights
    cfg = dict(compute_dtype="float32", pooling=pooling_)
    content, target, canvas = (70, 150), (35, 75), (96, 160)
    imgs, _ = _bench_batch(2, *canvas, content, seed=1)
    want = np.asarray(j_steps.make_scaled_predict_step(
        JConfig(**cfg), content, target, canvas, "superpixel")(
            params, jnp.asarray(imgs)))
    got = steps.make_scaled_predict_step(
        WESUPConfig(**cfg), content, target, canvas, "superpixel",
        device="cpu")(model, torch.from_numpy(imgs)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2,) + content
    assert (got == want).mean() >= 0.999

    H, W = 64, 160
    imgs, valid = _bench_batch(2, H, W, (58, 141), seed=2)
    rng = np.random.default_rng(3)
    batch = {"image": imgs, "valid": valid,
             "pixel_mask": np.where(valid, rng.integers(0, 2, (2, H, W)),
                                    -1).astype(np.int32),
             "points": np.zeros((2, 4, 3), np.int32),
             "point_valid": np.zeros((2, 4), bool),
             "use_mask_as_points": np.zeros((2,), bool),
             "sample_valid": np.ones((2,), bool)}
    jacc = j_steps.init_metric_acc(j_steps.EVAL_METRIC_KEYS)
    jpred, jacc = j_steps.make_eval_step(JConfig(**cfg), (H, W))(
        params, jacc, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    pred, acc = steps.make_eval_step(WESUPConfig(**cfg), (H, W),
                                     device="cpu")(
        model, steps.init_metric_acc(steps.EVAL_METRIC_KEYS, "cpu"), batch)
    assert (np.abs(pred.numpy() - np.asarray(jpred)) <= 2e-4).mean() >= 0.999
    for k in steps.EVAL_METRIC_KEYS:
        np.testing.assert_allclose(acc["sums"][k].item(),
                                   float(jacc["sums"][k]), atol=1e-3)
