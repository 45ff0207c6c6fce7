"""The port's trainer on the CPU: ``fit``, resume and the steps' wire
formats.

- ``python -m wesup_tpu_torch.train``'s ``fit`` writes the reference
  record layout and resumes: epoch numbering continues, every train
  batch of both runs draws from the JAX trainer's key for its (epoch,
  batch), and the restored weights and momentum are bitwise what was
  saved;
- the steps take ``rng_idx`` (a batch's draws do not depend on the batches
  that ran before it) and ``img_idx`` with ``cache=`` (bitwise the host
  wire format's result).

Split off tests/test_torch_port_trainer.py (history, checkpoints, errors
and the slice against the JAX trainer); sizes as there.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
from make_dataset import make_dataset  # noqa: E402

from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu.models import initialize_trainer as j_init  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.data import datasets as t_datasets  # noqa: E402
from wesup_tpu_torch.data import loader as t_loader  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer  # noqa: E402
from wesup_tpu_torch.models import steps, wesup  # noqa: E402
from wesup_tpu_torch.ops import train_resize  # noqa: E402
from wesup_tpu_torch.train import fit  # noqa: E402
from wesup_tpu_torch.utils import prng  # noqa: E402

CFG = dict(canvas_size=(48, 64), slic_iters=3, compute_dtype="float32",
           sp_area=100)
PKG = Path(__file__).parent.parent / "wesup_tpu_torch"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("port_trainer_fit_ds"),
                        n_train=3, n_val=2, hw=(64, 80))


def _rows(path):
    with open(path) as fp:
        return list(csv.reader(fp))


# ---------------------------------------------------------------------------
# fit: record layout, checkpoints, resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def key_log():
    """Every key the train steps draw from: ((epoch, phase, batch), key),
    in order."""
    calls = []
    real = steps.step_key

    def recording(rng, batch, phase):
        key = real(rng, batch, phase)
        if "rng_idx" in batch:
            epoch, idx = steps._rng_idx(batch["rng_idx"])
            calls.append(((epoch, steps.PHASE_IDS[phase], idx), key))
        return key

    steps.step_key = recording
    yield calls
    steps.step_key = real


@pytest.fixture(scope="module")
def fitted(dataset, tmp_path_factory, key_log):
    """A 2-epoch fit on the CPU (with the package's build directory, which
    the source snapshot must leave out; it is git-ignored and left in
    place, as other test processes may be building the native library
    into it)."""
    root = tmp_path_factory.mktemp("port_fit")
    (PKG / "_build").mkdir(exist_ok=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("RECORD_ROOT", str(root / "records"))
    try:
        trainer = fit(dataset, epochs=2, device="cpu",
                      profile_dir=str(root / "trace"), **CFG)
    finally:
        mp.undo()
    return trainer, list(key_log)


def test_fit_smoke(fitted):
    trainer, _ = fitted
    rd = trainer.record_dir
    for name in ("history.csv", "train.log", "params/0.json"):
        assert (rd / name).exists(), name
    assert (rd / "source" / "wesup_tpu_torch" / "ops" / "slic.py").exists()
    assert not (rd / "source" / "wesup_tpu_torch" / "_build").exists()
    assert not list((rd / "source").rglob("__pycache__"))
    ckpts = sorted(p.name for p in (rd / "checkpoints").iterdir())
    assert ckpts == ["ckpt.0002.pth"]   # latest-only retention
    # profile_dir=: the first epoch's train phase, as a Chrome trace
    assert (Path(trainer.kwargs["profile_dir"]) / "trace.epoch1.json").exists()
    rows = _rows(rd / "history.csv")
    assert len(rows) == 3
    assert rows[0] == ["accuracy", "dice", "labeled_sp_ratio", "loss",
                       "propagate_loss", "propagated_labels", "val_accuracy",
                       "val_dice", "lr"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    # every batch of every phase stepped, none raised
    assert sorted(trainer.phase_stats) == [(e, p) for e in (1, 2)
                                           for p in ("train", "val")]
    for key, stats in trainer.phase_stats.items():
        assert stats["batches"] > 0 and stats["failed"] == 0, key
        assert stats["samples"] > 0 and stats["seconds"] > 0, key
    assert trainer.phase_stats[(1, "train")]["batches"] == 3


def test_resume_continues_and_reproduces_the_seeds(fitted, dataset,
                                                   key_log):
    """The resumed run continues the numbering and restores the weights
    and momentum bitwise; every train batch of both runs draws from the
    key the JAX trainer derives for its (epoch, batch) from the same seed
    (``_batch_rng``, a function of the seed, the epoch and the batch
    alone), so that the resumed epoch draws what a straight run draws."""
    trainer, first = fitted
    ckpt = trainer.record_dir / "checkpoints" / "ckpt.0002.pth"
    saved = torch.load(ckpt, weights_only=True)
    restored = initialize_trainer("wesup", device="cpu", **CFG)
    restored.load_checkpoint(ckpt)
    assert restored.initial_epoch == 3
    for name, t in saved["model_state_dict"].items():
        assert torch.equal(restored.model.state_dict()[name], t), name
    state = restored.optimizer.state_dict()["state"]
    assert state.keys() == saved["optimizer_state_dict"]["state"].keys()
    for k, v in saved["optimizer_state_dict"]["state"].items():
        assert torch.equal(state[k]["momentum_buffer"], v["momentum_buffer"])

    del key_log[:]
    fit(dataset, epochs=1, device="cpu", checkpoint=str(ckpt), **CFG)
    resumed = list(key_log)
    ckpts = sorted(p.name for p in (trainer.record_dir
                                    / "checkpoints").iterdir())
    assert ckpts == ["ckpt.0003.pth"]
    assert len(_rows(trainer.record_dir / "history.csv")) == 4

    # only train batches draw, each from its own (epoch, batch) key
    assert [c[0] for c in first + resumed] == [
        (e, 0, i) for e in (1, 2, 3) for i in range(3)]
    jt = j_init("wesup", **CFG)
    for (epoch, _, i), key in first + resumed:
        jt._epoch_idx = epoch
        assert np.array_equal(key, np.asarray(jt._batch_rng("train", i)))
    assert len({k.tobytes() for _, k in first + resumed}) == 9


# ---------------------------------------------------------------------------
# the steps' wire formats
# ---------------------------------------------------------------------------

def _host_batches(dataset, device_resize, n=2):
    ds = t_datasets.PointSupervisionDataset(
        dataset / "train", multiscale_range=(0.3, 0.6), seed=3)
    ds.device_resize = device_resize
    bat = t_loader.CanvasBatcher(ds, t_loader.CanvasSpec(48, 64),
                                 batch_size=2)
    cache = None
    if device_resize:
        cache = {k: torch.from_numpy(v)
                 for k, v in train_resize.build_cache(ds).items()}
    return list(bat.epoch_iter(0))[:n], cache


def _fresh(model0, cfg):
    model = wesup.WESUP()
    model.load_state_dict(model0.state_dict())
    return model, steps.make_optimizer(cfg, model)


@pytest.fixture(scope="module")
def model0():
    return wesup.WESUP(generator=torch.Generator().manual_seed(5))


def test_rng_idx_draws_do_not_depend_on_earlier_batches(dataset, model0):
    cfg = WESUPConfig(**CFG)
    (batch, val_batch), _ = _host_batches(dataset, False)
    train = steps.make_train_step(cfg, (48, 64), point_mode=True,
                                  device="cpu")
    evaluate = steps.make_eval_step(cfg, (48, 64), device="cpu")
    base = prng.PRNGKey(7)

    def run(n_before, rng_idx=(2, 1), rng=base):
        model, opt = _fresh(model0, cfg)
        acc = steps.init_metric_acc(device="cpu")
        eacc = steps.init_metric_acc(steps.EVAL_METRIC_KEYS, device="cpu")
        for i in range(n_before):
            _, eacc = evaluate(model, eacc, dict(val_batch, rng_idx=(2, i)))
        b = batch if rng_idx is None else dict(batch, rng_idx=rng_idx)
        acc = train(model, opt, acc, b, rng)
        return acc["sums"]["loss"], model.state_dict()

    loss, sd = run(0)
    # after val batches, and with the batch's own key and no rng_idx
    for other in (run(3), run(0, rng=steps.batch_key(base, 2, 0, 1),
                              rng_idx=None)):
        assert torch.equal(other[0], loss)
        assert all(torch.equal(other[1][k], v) for k, v in sd.items())
    assert not torch.equal(run(0, rng_idx=(2, 2))[0], loss)


def test_img_idx_with_cache_equals_the_host_wire_format(dataset, model0):
    cfg = WESUPConfig(**CFG)
    host, _ = _host_batches(dataset, False, n=1)
    dev, cache = _host_batches(dataset, True, n=1)
    assert "img_idx" in dev[0] and "image" not in dev[0]
    train = steps.make_train_step(cfg, (48, 64), point_mode=True,
                                  device="cpu")
    evaluate = steps.make_eval_step(cfg, (48, 64), device="cpu")
    out = []
    for batch, c in ((host[0], None), (dev[0], cache)):
        model, opt = _fresh(model0, cfg)
        pred, eacc = evaluate(model, steps.init_metric_acc(
            steps.EVAL_METRIC_KEYS, device="cpu"), batch, cache=c)
        acc = train(model, opt, steps.init_metric_acc(device="cpu"),
                    dict(batch, rng_idx=(1, 0)), prng.PRNGKey(11),
                    cache=c)
        out.append((pred, eacc["sums"], acc["sums"], model.state_dict()))
    (p0, e0, a0, s0), (p1, e1, a1, s1) = out
    assert torch.equal(p0, p1)
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    for k in e0:
        assert torch.equal(e0[k], e1[k]), k
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
