"""The port's trainer and checkpoints, on the CPU.

- history.csv is byte-equal to the JAX package's for the same metrics;
- a JAX trainer's msgpack checkpoint loads into the port (weights bitwise
  ``from_jax_params``; one SGD step from the loaded momentum equals
  optax's update on the same gradient within 1e-6: both compute
  ``m = 0.9 m + g + wd p; p -= lr m`` in f32, in another order), and the
  port's ``.pth`` loads into the JAX trainer bitwise;
- the NaN abort and the refusal of an unknown metric name; the default
  val phase reads no prediction map back, ``metrics=`` one per batch;
- the slice against JAX: one epoch of both trainers from one JAX
  checkpoint with ``lr=0`` (the weights cannot move, so the augmentation
  cannot matter) gives the same
  validation metrics, the host GlaS metrics among them, within the
  tolerance derived in :func:`test_one_epoch_matches_jax_trainer`.

Sizes follow tests/test_train_smoke.py: 64x80 images, canvas 48x64, 3
SLIC iterations, sp_area 100, f32.  ``fit``, resume and the steps' wire
formats are in tests/test_torch_port_trainer_fit.py.
"""

import csv
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
from make_dataset import make_dataset  # noqa: E402

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import initialize_trainer as j_init  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.utils.history import HistoryTracker as JTracker  # noqa: E402
from wesup_tpu_torch.data import datasets as t_datasets  # noqa: E402
from wesup_tpu_torch.models import convert, steps  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer  # noqa: E402
from wesup_tpu_torch.ops.slic import slic  # noqa: E402
from wesup_tpu_torch.utils.history import HistoryTracker  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401

CFG = dict(canvas_size=(48, 64), slic_iters=3, compute_dtype="float32",
           sp_area=100)
METRICS = ("accuracy", "dice", "detection_f1", "object_dice",
           "object_hausdorff")
PKG = Path(__file__).parent.parent / "wesup_tpu_torch"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("port_trainer_ds"),
                        n_train=3, n_val=2, hw=(64, 80))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rows(path):
    with open(path) as fp:
        return list(csv.reader(fp))


# ---------------------------------------------------------------------------
# history
# ---------------------------------------------------------------------------

def test_history_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = {"port": tmp_path / "p.csv", "jax": tmp_path / "j.csv"}
    trackers = {"port": HistoryTracker(paths["port"]),
                "jax": JTracker(paths["jax"])}
    logs = {k: [] for k in trackers}
    for epoch in range(3):
        for name, tr in trackers.items():
            tr.start_new_epoch(5e-5)
        for phase, keys in (("train", steps.TRAIN_METRIC_KEYS),
                            ("eval", steps.EVAL_METRIC_KEYS)):
            for _ in range(4):
                metrics = {k: float(rng.random()) for k in keys}
                for name, tr in trackers.items():
                    getattr(tr, phase)()
                    logs[name].append(tr.step(metrics))
                    logs[name].append(tr.log())
        for tr in trackers.values():
            tr.save()
    assert logs["port"] == logs["jax"]
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert trackers["port"].report() == trackers["jax"].report()


# ---------------------------------------------------------------------------
# checkpoints in and out
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX trainer's checkpoint with a nonzero momentum trace (one optax
    update on a seeded gradient), epoch 0."""
    jt = j_init("wesup", **CFG)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                     _np_tree(jt.params))
    _, jt.opt_state = jt.tx.update(g, jt.opt_state, jt.params)
    path = (tmp_path_factory.mktemp("jax_ckpt") / "rec" / "checkpoints"
            / "ckpt.0000.msgpack")
    jt.save_checkpoint(path, epoch=0)
    return path, _np_tree(jt.params), jt.opt_state


@pytest.fixture(scope="module")
def balanced_ckpt(jax_ckpt, dataset, tmp_path_factory):
    """``jax_ckpt`` with a classifier whose val masks hold both classes and
    no probability near 0.5: its weights and bias scaled so that the val
    superpixels' logits spread with standard deviation 2, then its
    foreground bias lowered to the middle of the widest gap between those
    logits in their middle half.  Unchanged, the random head puts every
    pixel within about 0.01 of 0.5 and on one side of it, so that the host
    metrics of an all-background mask (0) would be all they compared."""
    import jax.numpy as jnp

    path, params, opt_state = jax_ckpt
    pt = initialize_trainer("wesup", device="cpu", metrics=METRICS, **CFG)
    pt.model.load_state_dict(convert.from_jax_params(params))
    pt.setup_dataloaders(dataset / "train", dataset / "val")
    spec = pt.dataloaders["val"].spec
    step = pt._get_step("eval", (spec.height, spec.width))
    logits = []
    for batch in pt.dataloaders["val"]:
        pred, _ = step(pt.model, steps.init_metric_acc(
            steps.EVAL_METRIC_KEYS, "cpu"), pt._put_batch(batch))
        p = pred.numpy()[batch["valid"]].astype(np.float64)
        logits.append(np.log(p) - np.log1p(-p))
    z = np.unique(np.concatenate(logits))
    scale = 2.0 / z.std()
    mid = np.sort(z * scale)[len(z) // 4: 3 * len(z) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    shift = (mid[i] + mid[i + 1]) / 2
    params = jax.tree.map(np.array, params)
    params["cls"]["w"] = (params["cls"]["w"] * scale).astype(np.float32)
    params["cls"]["b"] = (params["cls"]["b"] * scale - np.array(
        [0.0, shift])).astype(np.float32)
    jt = j_init("wesup", **CFG)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = opt_state
    out = (tmp_path_factory.mktemp("balanced_ckpt") / "rec" / "checkpoints"
           / "ckpt.0000.msgpack")
    jt.save_checkpoint(out, epoch=0)
    return out


def _copy_ckpt(path, root):
    dst = Path(root) / "rec" / "checkpoints" / path.name
    dst.parent.mkdir(parents=True)
    shutil.copy(path, dst)
    return dst


def test_jax_checkpoint_loads_into_the_port(jax_ckpt, tmp_path):
    path, params, opt_state = jax_ckpt
    lr = 1.0   # an update of order one, so 1e-6 is a tight bound
    pt = initialize_trainer("wesup", device="cpu", lr=lr, **CFG)
    pt.load_checkpoint(_copy_ckpt(path, tmp_path))
    assert pt.initial_epoch == 1
    want = convert.from_jax_params(params)
    got = pt.model.state_dict()
    for name, t in want.items():
        assert torch.equal(got[name], t), name

    # one step on a seeded gradient: optax's chain at lr vs torch SGD
    rng = np.random.default_rng(2)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                     params)
    tx = j_steps.make_optimizer(JConfig(lr=lr))
    updates, _ = tx.update(g, opt_state, params)
    new = convert.from_jax_params(_np_tree(optax.apply_updates(params,
                                                               updates)))
    grads = convert.from_jax_params(g)
    for name, p in pt.model.named_parameters():
        p.grad = grads[name].clone()
    pt.optimizer.step()
    for name, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_port_checkpoint_loads_into_jax(tmp_path):
    pt = initialize_trainer("wesup", device="cpu", **CFG)
    path = tmp_path / "ckpt.0003.pth"
    pt.save_checkpoint(path, epoch=3)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "model_state_dict",
                            "optimizer_state_dict"}
    jt = j_init("wesup", **CFG)
    jt._load_torch_checkpoint(path)
    assert jt.initial_epoch == 4
    back = convert.from_jax_params(_np_tree(jt.params))
    for name, t in pt.model.state_dict().items():
        assert torch.equal(back[name], t), name

    # a reference checkpoint without the port's optimizer state loads too
    ref = tmp_path / "rec" / "checkpoints" / "ref.pth"
    ref.parent.mkdir(parents=True)
    torch.save({"epoch": 5, "model_state_dict": pt.model.state_dict()}, ref)
    other = initialize_trainer("wesup", device="cpu", **CFG)
    other.load_checkpoint(ref)
    assert other.initial_epoch == 6 and not other.optimizer.state
    for name, t in pt.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[name], t), name


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_nan_abort_and_unported_metrics_raise(dataset, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path))
    trainer = initialize_trainer("wesup", device="cpu", **CFG)
    with torch.no_grad():
        trainer.model.classifier[0].bias.fill_(float("nan"))
    with pytest.raises(ValueError, match="Loss is nan"):
        trainer.train(dataset, epochs=1)
    # every host metric of the JAX package is ported: only a name that is
    # none of them is refused, before any step runs
    for metrics in ("object_dcie", ("accuracy", "dice", "f1_score")):
        trainer = initialize_trainer("wesup", device="cpu", metrics=metrics,
                                     **CFG)
        with pytest.raises(ValueError, match="unknown metric"):
            trainer.train(dataset, epochs=1)
        assert not trainer.phase_stats


def test_default_path_fetches_no_predictions(dataset, tmp_path, monkeypatch):
    """Without host metrics the val phase never reads a prediction map
    back; with them it reads each val batch's map once, and history.csv
    gains the metric's column (port of tests/test_train_smoke.py::
    test_default_path_fetches_no_predictions)."""
    from wesup_tpu_torch.models.trainer import WESUPTrainer

    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "records"))
    calls = []
    orig = WESUPTrainer._fetch_pred
    monkeypatch.setattr(WESUPTrainer, "_fetch_pred",
                        lambda self, pred: calls.append(1) or orig(self, pred))

    trainer = initialize_trainer("wesup", device="cpu", **CFG)
    trainer.train(dataset, epochs=1)
    assert calls == [], "default path fetched prediction maps"

    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "records2"))
    trainer2 = initialize_trainer("wesup", device="cpu",
                                  metrics=("object_dice",), **CFG)
    trainer2.train(dataset, epochs=1)
    n_val_batches = len(trainer2.dataloaders["val"])
    assert len(calls) == n_val_batches, (len(calls), n_val_batches)
    # the host metrics read the host batch: the val phase's device-resize
    # cache is off
    assert trainer2._resize_cache["val"] is None
    header, row = _rows(trainer2.record_dir / "history.csv")
    assert "val_object_dice" in header
    assert 0.0 <= float(row[header.index("val_object_dice")]) <= 1.0


# ---------------------------------------------------------------------------
# the slice against the JAX trainer
# ---------------------------------------------------------------------------

def test_one_epoch_matches_jax_trainer(balanced_ckpt, dataset, tmp_path,
                                       monkeypatch):
    """One epoch of each trainer from one JAX checkpoint at ``lr=0``.

    The weights do not move, so the val phase of both runs evaluates the
    same weights on the same canvases (the datasets, loader and device
    resize are bitwise equal, tests/test_torch_port_data.py).  A val
    pixel's rounded prediction can then differ only (a) where SLIC gives
    it another superpixel, which may happen to 1e-3 of the pixels
    (tests/test_torch_port_ops.py::test_slic_seg_matches_jax; 0 measured
    there), or (b) where its probability lies within the f32 forward limit
    2e-4 of 0.5 (PERF.md §2).  The test asserts both empty on these
    canvases, with JAX's SLIC and the port's on the val batches and the
    port's probabilities, so every rounded prediction is the same and the
    two packages' metrics are the same per-image means summed in f32 in
    another order: they must agree to 1e-6.  The host metrics
    (``metrics=``: detection F1, object Dice, object Hausdorff) score
    those same rounded maps, each through its package's native library,
    in f64: they must agree to 1e-6 too."""
    import jax.numpy as jnp
    from wesup_tpu.ops.slic import slic as j_slic

    jpath = balanced_ckpt
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "records"))
    jt = j_init("wesup", lr=0.0, metrics=METRICS, **CFG)
    jt.train(dataset, epochs=1, checkpoint=str(_copy_ckpt(jpath,
                                                          tmp_path / "j")))
    pt = initialize_trainer("wesup", device="cpu", lr=0.0, metrics=METRICS,
                            **CFG)
    pt.train(dataset, epochs=1, checkpoint=str(_copy_ckpt(jpath,
                                                          tmp_path / "p")))
    j_rows = _rows(jt.record_dir / "history.csv")
    p_rows = _rows(pt.record_dir / "history.csv")
    assert p_rows[0] == j_rows[0] and len(p_rows) == len(j_rows) == 2
    got = dict(zip(p_rows[0], map(float, p_rows[1])))
    want = dict(zip(j_rows[0], map(float, j_rows[1])))
    assert got["lr"] == want["lr"] == 0.0

    cfg = pt.config
    spec = pt.dataloaders["val"].spec
    for batch in pt.dataloaders["val"]:
        image, valid, _ = steps._batch_inputs(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            pt._resize_cache["val"], spec.height, spec.width)
        img = image.to(torch.float32) / 255.0
        seg = slic(img, valid, sp_area=cfg.sp_area,
                   compactness=cfg.sp_compactness, n_iters=cfg.slic_iters,
                   update_stride=cfg.slic_update_stride).numpy()
        j_seg = jax.vmap(lambda i, v: j_slic(
            i, v, sp_area=cfg.sp_area, compactness=cfg.sp_compactness,
            n_iters=cfg.slic_iters, update_stride=cfg.slic_update_stride))(
            jnp.asarray(img.numpy()), jnp.asarray(valid.numpy()))
        assert np.array_equal(seg, np.asarray(j_seg))                  # (a)
    val = t_datasets.SegmentationDataset(dataset / "val", rescale_factor=0.5,
                                         train=False)
    for i in range(len(val)):
        probs = pt.predict_probs(val[i]["image"])
        assert (np.abs(probs - 0.5) > 2e-4).all()                      # (b)
    # (b) on the val phase's own maps, which hold both classes
    step = pt._get_step("eval", (spec.height, spec.width))
    for batch in pt.dataloaders["val"]:
        pred, _ = step(pt.model, steps.init_metric_acc(
            steps.EVAL_METRIC_KEYS, "cpu"), pt._put_batch(batch))
        probs = pred.numpy()[batch["valid"]]
        assert (np.abs(probs - 0.5) > 2e-4).all()                      # (b)
        assert 0.05 < (probs > 0.5).mean() < 0.95
    assert {"val_detection_f1", "val_object_dice",
            "val_object_hausdorff"} <= set(got)
    assert got["val_object_dice"] > 0 and got["val_object_hausdorff"] > 0
    for key in ("val_accuracy", "val_dice", "val_detection_f1",
                "val_object_dice", "val_object_hausdorff"):
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
