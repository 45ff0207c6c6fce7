"""The port's augmentation draws are the JAX train step's, on the CPU.

``utils/prng.py`` holds the numpy copy of ``jax.random``; the train step
folds (epoch, phase, batch) into the trainer's base key and draws each
image's parameters from JAX's key splits (``models/steps.py``,
``ops/augment.py``).  Held against the installed JAX:

- ``split``, ``fold_in``, ``random_bits``, ``uniform``, ``bernoulli`` and
  ``normal`` over many keys against ``jax.vmap`` of JAX's, bitwise;
- for B in {1, 3}, point and mask supervision and a few (epoch, phase,
  batch) triples, every drawn parameter against the JAX step's chain
  (``wesup_tpu/models/steps.py`` ``_batch_rng_key``, ``step``,
  ``_preprocess_sample``; ``wesup_tpu/ops/augment.py``), compiled as the
  step compiles it: the uniforms, the bernoullis and the normals bitwise
  (XLA folds the divisions by constants and the elastic field's scale into
  f32 constants; the port folds them alike).  The affine matrices against
  JAX's ``random_affine`` within 1e-4, as in test_torch_port_train.py;
- ``WESUPTrainer(seed=s)``'s base key and its (epoch, batch) keys and
  draws against the JAX trainer's, for seeds 0, 1 and 7;
- one train step of each package on one batch and one key, augmentation
  on, at a 64x64 canvas: the metric sums (the loss to 1e-4) and the first
  gradients within the f32 train-step limits of test_torch_port_train.py
  (1e-3 of each tensor's largest |grad|, the backbone convs' 5e-3, for
  the reason given there: a ReLU or max-pool decision that f32 sums in
  another order flip).  The canvas is the smallest whose coarse stages
  keep one position a small share of a weight's gradient: at 32x64 (a
  4x8 map at stage 4) one max-pool route that flips at stage 2 carries
  1.6% of conv 14's largest weight gradient, on JAX's own preprocessed
  batch as well as on the port's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import initialize_trainer as j_init  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.ops import augment as j_aug  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer  # noqa: E402
from wesup_tpu_torch.models import steps, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
from wesup_tpu_torch.utils import prng  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401

HW = (64, 160)
APP = ("dh", "ds", "dv", "contrast", "brightness", "clahe", "blur")
AFF = ("hflip", "vflip", "ssr", "angle", "scale", "shift_x", "shift_y")


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


def _assert_bitwise(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


# ---------------------------------------------------------------------------
# the primitives over many keys
# ---------------------------------------------------------------------------

def test_primitives_over_many_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    mine = np.asarray(keys)
    vm = jax.vmap
    _assert_bitwise(prng.split(mine, 7), vm(lambda k: jax.random.split(
        k, 7))(keys), "split")
    data = np.arange(6) * 1000 + 3
    _assert_bitwise(prng.fold_in(mine, data), vm(jax.random.fold_in)(
        keys, jnp.asarray(data, jnp.uint32)), "fold_in")
    _assert_bitwise(prng.fold_in(mine, 9), vm(lambda k: jax.random.fold_in(
        k, 9))(keys), "fold_in, one datum")
    _assert_bitwise(prng.random_bits(mine, (4, 3)), vm(
        lambda k: jax.random.bits(k, (4, 3), jnp.uint32))(keys), "bits")
    lo = np.linspace(-3, -0.1, 6).astype(np.float32)
    _assert_bitwise(prng.uniform(mine, (), lo, -lo), vm(
        lambda k, a: jax.random.uniform(k, (), minval=a, maxval=-a))(
            keys, jnp.asarray(lo)), "uniform, a limit per key")
    _assert_bitwise(prng.uniform(mine, (50,)), vm(
        lambda k: jax.random.uniform(k, (50,)))(keys), "uniform")
    _assert_bitwise(prng.bernoulli(mine, 0.3, (40,)), vm(
        lambda k: jax.random.bernoulli(k, 0.3, (40,)))(keys), "bernoulli")
    _assert_bitwise(prng.normal(mine, (8, 8, 2)), vm(
        lambda k: jax.random.normal(k, (8, 8, 2)))(keys), "normal")
    # keys with two leading axes
    nested = mine.reshape(2, 3, 2)
    _assert_bitwise(prng.split(nested, 3),
                    prng.split(mine, 3).reshape(2, 3, 3, 2), "nested split")
    with pytest.raises(TypeError, match="key"):
        prng.split(np.zeros(3, np.uint32))


# ---------------------------------------------------------------------------
# the train step's draws against JAX's chain
# ---------------------------------------------------------------------------

def _jax_chain(point_mode, elastic_p, hw):
    """The JAX train step's draws from a batch key, compiled: its split per
    image and per transform (``wesup_tpu/models/steps.py``) and the draws
    of ``random_appearance``, ``random_affine`` and ``random_elastic``."""
    app, pos = steps._aug_configs(point_mode)
    u = jax.random.uniform
    H, W = hw

    def one(rng):
        k_app, k_aff, k_el = jax.random.split(rng, 3)
        k_h, k_s, k_v, k_b, k_c, k_clahe, k_blur = jax.random.split(k_app, 7)
        a = (u(k_h, (), minval=-app.hue_shift_limit,
               maxval=app.hue_shift_limit) / 180.0,
             u(k_s, (), minval=-app.sat_shift_limit,
               maxval=app.sat_shift_limit) / 255.0,
             u(k_v, (), minval=-app.val_shift_limit,
               maxval=app.val_shift_limit) / 255.0,
             u(k_c, (), minval=-app.contrast_limit,
               maxval=app.contrast_limit),
             u(k_b, (), minval=-app.brightness_limit,
               maxval=app.brightness_limit),
             jax.random.bernoulli(k_clahe, app.clahe_p),
             jax.random.bernoulli(k_blur, app.blur_p))
        k_hf, k_vf, k_p, k_ang, k_sc, k_sx, k_sy = jax.random.split(k_aff, 7)
        f = (jax.random.bernoulli(k_hf, pos.hflip_p),
             jax.random.bernoulli(k_vf, pos.vflip_p),
             jax.random.bernoulli(k_p, pos.ssr_p),
             u(k_ang, (), minval=-pos.rotate_limit, maxval=pos.rotate_limit),
             u(k_sc, (), minval=-pos.scale_limit, maxval=pos.scale_limit),
             u(k_sx, (), minval=-pos.shift_limit, maxval=pos.shift_limit),
             u(k_sy, (), minval=-pos.shift_limit, maxval=pos.shift_limit))
        A = j_aug.random_affine(k_aff, hw, pos)
        el = (jax.random.bernoulli(jax.random.fold_in(k_el, 0), elastic_p),
              jax.random.normal(jax.random.split(k_el)[0], (8, 8, 2))
              * 34.0 / max(H, W) * min(H, W))
        return a, f, A, el

    @jax.jit
    def chain(key, B):
        return jax.vmap(one)(jax.random.split(key, B.shape[0]))

    return lambda key, B: chain(key, jnp.zeros(B))


@pytest.fixture(scope="module")
def jax_chains():
    return {pm: _jax_chain(pm, 0.5, HW) for pm in (True, False)}


TRIPLES = [(0, 0, 0), (3, 0, 5), (7, 1, 2)]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("point_mode", [True, False], ids=["points", "mask"])
def test_draws_equal_the_jax_steps(jax_chains, B, point_mode):
    cfg = WESUPConfig(elastic_p=0.5)
    base = jax.random.PRNGKey(11)
    for epoch, phase, idx in TRIPLES:
        # JAX's fold chain (the step's _batch_rng_key) and the port's
        jkey = j_steps._batch_rng_key(base, {"rng_idx": jnp.asarray(
            [[epoch, idx]] * B, jnp.int32)}, phase)
        key = steps.batch_key(prng.PRNGKey(11), epoch, phase, idx)
        _assert_bitwise(key, jkey, "batch key")
        (ja, jf, jA, (japply, jnoise)) = jax_chains[point_mode](jkey, B)
        app, aff, el = steps.draw_augmentation(cfg, B, HW, point_mode, key)
        for name, want in zip(APP, ja):
            _assert_bitwise(getattr(app, name), want, name)
        for name, want in zip(AFF, jf):
            _assert_bitwise(getattr(aff, name), want, name)
        if point_mode:
            assert el is None
        else:
            _assert_bitwise(el.apply, japply, "elastic apply")
            _assert_bitwise(el.coarse, jnoise, "elastic field")
        # the tensors the step applies: the same values, on the device
        params = steps.sample_augmentation(cfg, B, HW, point_mode, key,
                                           "cpu")
        for name in APP:
            _assert_bitwise(getattr(params.appearance, name).numpy(),
                            getattr(app, name), name)
        np.testing.assert_allclose(params.affine.numpy(), np.asarray(jA),
                                   atol=1e-4, rtol=1e-6)
        if not point_mode:
            _assert_bitwise(params.elastic.apply.numpy(), el.apply)
            _assert_bitwise(params.elastic.coarse.numpy(), el.coarse)


# ---------------------------------------------------------------------------
# the trainer's keys against the JAX trainer's
# ---------------------------------------------------------------------------

TCFG = dict(canvas_size=(48, 64), slic_iters=3, compute_dtype="float32",
            sp_area=100, fc_width=64)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_trainer_draws_equal_the_jax_trainers(jax_chains, seed):
    jt = j_init("wesup", seed=seed, **TCFG)
    pt = initialize_trainer("wesup", seed=seed, device="cpu", **TCFG)
    _assert_bitwise(pt._rng, jt._rng, "base key")
    for epoch in (1, 2, 5):
        jt._epoch_idx = epoch
        for i in range(3):
            jkey = jt._batch_rng("train", i)
            wire = {"rng_idx": np.tile(np.int32([epoch, i]), (2, 1))}
            key = steps.step_key(pt._rng, wire, "train")
            _assert_bitwise(key, jkey, (epoch, i))
            ja, jf, _, _ = jax_chains[True](jkey, 1)
            app, aff, _ = steps.draw_augmentation(pt.config, 1, HW, True,
                                                  key)
            for name, want in zip(APP + AFF, ja + jf):
                got = getattr(app if name in APP else aff, name)
                _assert_bitwise(got, want, (epoch, i, name))
    # predict_probs advances the base key as JAX's (_next_rng)
    pt.predict_probs(np.full((40, 56, 3), 200, np.uint8))
    jt._next_rng()
    _assert_bitwise(pt._rng, jt._rng, "base key after predict_probs")


# ---------------------------------------------------------------------------
# one train step of each package, augmentation on
# ---------------------------------------------------------------------------

SH, SW = 64, 64


def _batch(seed=21, B=2, P=12):
    rng = np.random.default_rng(seed)
    batch = {
        "image": np.clip(rng.normal(180, 40, (B, SH, SW, 3)), 0,
                         255).astype(np.uint8),
        "valid": np.zeros((B, SH, SW), bool),
        "pixel_mask": rng.integers(0, 2, (B, SH, SW)).astype(np.int32),
        "points": np.zeros((B, P, 3), np.int32),
        "point_valid": np.zeros((B, P), bool),
        "use_mask_as_points": np.zeros((B,), bool),
        "sample_valid": np.ones((B,), bool),
    }
    batch["valid"][:, :SH - 2, :SW - 7] = True
    batch["pixel_mask"][~batch["valid"]] = -1
    for b in range(B):
        for i in range(8):
            x, y = rng.integers(8, SW - 14), rng.integers(6, SH - 6)
            batch["points"][b, i] = (x, y, batch["pixel_mask"][b, y, x])
            batch["point_valid"][b, i] = True
    return batch


def test_train_step_with_augmentation_matches_jax():
    kw = dict(compute_dtype="float32", slic_iters=4, sp_area=100, lr=1.0,
              weight_decay=0.0, fc_width=64)
    jcfg, tcfg = JConfig(**kw), WESUPConfig(**kw)
    batch = _batch()
    params = j_wesup.init_params(jax.random.PRNGKey(3), fc_width=64)
    tx = j_steps.make_optimizer(jcfg)
    jstep = jax.jit(j_steps.make_train_step(jcfg, (SH, SW), point_mode=True,
                                            tx=tx))
    base = jax.random.PRNGKey(8)
    wire = dict(batch, rng_idx=np.tile(np.int32([4, 1]), (2, 1)))
    jparams, _, jacc = jstep(params, tx.init(params),
                             j_steps.init_metric_acc(),
                             {k: jnp.asarray(v) for k, v in wire.items()},
                             base)

    model = wesup.WESUP(fc_width=64)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    before = {k: v.clone() for k, v in model.named_parameters()}
    step = steps.make_train_step(tcfg, (SH, SW), point_mode=True,
                                 device="cpu")
    acc = step(model, steps.make_optimizer(tcfg, model),
               steps.init_metric_acc(device="cpu"), wire,
               np.asarray(base))
    assert acc["count"].item() == float(jacc["count"]) == 2
    for k in steps.TRAIN_METRIC_KEYS:
        np.testing.assert_allclose(acc["sums"][k].item(),
                                   float(jacc["sums"][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # lr 1, no weight decay, a fresh momentum: the update is the gradient
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        jgrad = before[name] - want[name]
        rel = 5e-3 if name.startswith("backbone.") else 1e-3
        lim = rel * jgrad.abs().max().item() + 1e-7
        err = (p.grad - jgrad).abs().max().item()
        assert err <= lim, (name, err, lim)
