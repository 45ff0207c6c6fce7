"""The port's train step against the JAX package, on the CPU: forward,
loss, backward and SGD, and the whole train, eval and predict steps.

The split-off second half of tests/test_torch_port_train.py, whose
docstring gives every tolerance used here (the f32 and bf16 train-step
limits, the preprocessing and SLIC limits) and their reasons; its
fixtures and helpers are imported from there.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))

from test_torch_port_train import (B, FC_WIDTH, H, W, _affines,  # noqa: E402
                                   _gap_threshold, _point_sup,
                                   _replay_appearance, _replay_elastic, _t,
                                   seg_setup)
from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.ops import segments as j_segments  # noqa: E402
from wesup_tpu.ops import slic as j_slic  # noqa: E402
from wesup_tpu_torch import tracing  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import steps, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
from wesup_tpu_torch.ops import kernels  # noqa: E402
from wesup_tpu_torch.ops import slic as t_slic  # noqa: E402
from wesup_tpu_torch.utils import prng  # noqa: E402


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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for key in prng.split(prng.PRNGKey(0)):
            acc = step(model, optimizer, acc, batch, key)
    first = next(s for s in tracing.spans() if s.name == "wesup.step.train")
    # the phases in order (augment is two spans: the draws, then the
    # augmentation)
    phases = [name for name, _ in itertools.groupby(
        s.name.removeprefix("wesup.step.") for s in tracing.spans()
        if s.parent is first)]
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
    kernels._const_cache.clear()
    t_slic._GRID_CACHE.clear()
    batch = _batch(seed=20)
    cfgs = [WESUPConfig(**_CFG, pooling=p) for p in ("local", "adjoint")]
    model = wesup.WESUP(fc_width=FC_WIDTH)
    for cfg in cfgs:
        steps.make_predict_step(cfg, (H, W), device="cpu")(
            model, batch["image"], batch["valid"])
    cached = [t for v in list(kernels._const_cache.values())
              + list(t_slic._GRID_CACHE.values())
              for t in (v if isinstance(v, tuple) else (v,))
              for t in (t if isinstance(t, tuple) else (t,))
              if isinstance(t, torch.Tensor)]
    assert cached and not any(t.is_inference() for t in cached)
    assert any(k[0] == "adjoint_table" for k in kernels._const_cache)
    for cfg in cfgs:
        step = steps.make_train_step(cfg, (H, W), point_mode=True,
                                     device="cpu")
        acc = step(model, steps.make_optimizer(cfg, model),
                   steps.init_metric_acc(device="cpu"), batch,
                   prng.PRNGKey(1))
        assert np.isfinite(acc["sums"]["loss"].item()), cfg.pooling


def test_later_slice_wire_formats_raise():
    """The trainer's wire formats, taken since the trainer slice, raise
    where they are misused: ``img_idx`` without the device-resize cache,
    ``rng_idx`` with an int seed or a generator in place of the base key
    (tests/test_torch_port_trainer_fit.py holds their results)."""
    cfg = WESUPConfig(**_CFG)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    step = steps.make_train_step(cfg, (H, W), point_mode=True, device="cpu")
    for key, rng, error, match in (
            ("img_idx", prng.PRNGKey(0), ValueError, "cache"),
            ("rng_idx", 7, TypeError, "must be a key"),
            ("rng_idx", torch.Generator(), TypeError, "must be a key")):
        batch = dict(_batch(), **{key: np.zeros((B, 2), np.int32)})
        with pytest.raises(error, match=match):
            step(model, steps.make_optimizer(cfg, model),
                 steps.init_metric_acc(device="cpu"), batch, rng)


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
