"""The trainer's staging chain on the CPU (``models/trainer.py``,
``_start_staged``, as ``wesup_tpu.models.trainer`` stages batches).

- lookahead: epoch 2's first train batch is loaded while epoch 1's val
  phase runs, and epoch 2's train phase claims the chain with its batches
  staged;
- cancel: a nonstandard epoch sequence cancels the pre-warmed chain and
  starts cold, and after ``train()`` no staging or loader thread is
  alive;
- errors: a loader error reaches the consumer (``train()`` raises it, and
  leaves no thread behind); a ``RuntimeError`` in staging one batch is
  counted failed and the run goes on (the 2-rank form is in
  ``tests/test_torch_port_parallel.py``);
- key: the base key is read when a batch is staged, so a
  ``predict_probs`` between epochs leaves the batch staged before it
  with the old key, as JAX's chain (which queues ``self._rng`` with each
  batch) leaves it.

The existing history and key tests (``test_torch_port_trainer_fit.py``,
``test_torch_port_trainer.py``, ``test_torch_port_parallel.py``) run
through the chain unchanged.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from make_dataset import make_dataset  # noqa: E402

from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch.data import datasets as t_datasets  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer, steps  # noqa: E402

CFG = dict(canvas_size=(48, 64), slic_iters=2, compute_dtype="float32",
           sp_area=100, fc_width=64, device="cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("staging_ds"), n_train=3,
                        n_val=2, hw=(48, 64))


@pytest.fixture
def records(tmp_path, monkeypatch):
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "records"))


def _chain_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith(("wesup-stage-", "wesup-loader-"))}


@pytest.fixture
def ours_alive():
    """The staging and loader threads that the test started and that are
    still alive (another module's, in the same worker process, is not
    the test's)."""
    before = _chain_threads()
    return lambda: sorted(t.name for t in _chain_threads() - before)


def _train(dataset, epochs=2, **kw):
    trainer = initialize_trainer("wesup", epochs=epochs, **CFG, **kw)
    trainer.train(dataset, epochs=epochs)
    return trainer


def test_next_epoch_loads_during_the_val_phase(dataset, records,
                                               monkeypatch, ours_alive):
    loads, spans = [], {}
    real_load = t_datasets.PointSupervisionDataset.load

    def slow_load(self, idx, target=None):
        time.sleep(0.1)
        out = real_load(self, idx, target)
        loads.append(time.perf_counter())
        return out

    monkeypatch.setattr(t_datasets.PointSupervisionDataset, "load",
                        slow_load)
    trainer = initialize_trainer("wesup", epochs=2, batch_size=1, **CFG)
    real_val = trainer._run_val_phase

    def timed_val():
        t0 = time.perf_counter()
        time.sleep(0.5)
        out = real_val()
        spans[trainer._epoch_idx] = (t0, time.perf_counter())
        return out

    monkeypatch.setattr(trainer, "_run_val_phase", timed_val)
    trainer.train(dataset, epochs=2)
    # 3 train batches of 1 an epoch: epochs 1 and 2, and some of the
    # chain pre-warmed for epoch 3 before train() cancelled it
    assert len(loads) >= 6
    start, end = spans[1]
    # epoch 2's first batch (the 4th train load) ended inside epoch 1's
    # val phase, on the staging chain started when its train phase ended
    assert start < loads[3] < end
    first, second = (trainer.phase_stats[e, "train"] for e in (1, 2))
    assert not first["lookahead"] and second["lookahead"]
    assert second["staged_at_start"] >= 1
    assert second["batches"] == 3 and second["failed"] == 0
    assert not ours_alive()


def test_nonstandard_epoch_sequence_cancels_the_chain(dataset, records,
                                                       ours_alive):
    trainer = _train(dataset, epochs=1)
    assert trainer._lookahead is None          # train() cancelled it
    assert not ours_alive()
    # epoch 1 again: the chain pre-warmed for epoch 2 is cancelled and a
    # cold one serves epoch 7
    trainer._epoch_idx = 1
    trainer.train_one_epoch(no_val=True)
    assert trainer._lookahead[0] == 2
    chain = trainer._lookahead[2]
    trainer._epoch_idx = 7
    trainer.train_one_epoch(no_val=True)
    assert not chain.thread.is_alive()
    assert not trainer.phase_stats[7, "train"]["lookahead"]
    assert trainer.phase_stats[7, "train"]["batches"] == 3
    trainer._cancel_lookahead()
    assert not ours_alive()


def test_loader_error_reaches_the_consumer(dataset, records, monkeypatch,
                                           ours_alive):
    real_load = t_datasets.PointSupervisionDataset.load
    calls = []

    def failing(self, idx, target=None):
        calls.append(idx)
        if len(calls) == 5:            # epoch 2's second batch
            raise ValueError("unreadable image")
        return real_load(self, idx, target)

    monkeypatch.setattr(t_datasets.PointSupervisionDataset, "load", failing)
    trainer = initialize_trainer("wesup", epochs=2, batch_size=1, **CFG)
    with pytest.raises(ValueError, match="unreadable image"):
        trainer.train(dataset, epochs=2)
    assert trainer.phase_stats[1, "train"]["failed"] == 0
    assert not ours_alive()


def test_staging_error_is_counted_failed(dataset, records, ours_alive):
    trainer = initialize_trainer("wesup", epochs=1, batch_size=1, **CFG)
    put = trainer._put_batch

    def failing(batch, rng_idx=None):
        if rng_idx == (1, 1) and not failing.done:    # train batch 1
            failing.done = True
            raise RuntimeError("copy to the device failed")
        return put(batch, rng_idx)

    failing.done = False

    trainer._put_batch = failing
    trainer.train(dataset, epochs=1)
    stats = trainer.phase_stats[1, "train"]
    assert stats["batches"] == 3 and stats["failed"] == 1
    assert trainer.phase_stats[1, "val"]["failed"] == 0
    assert not ours_alive()


def test_staged_batch_keeps_the_key_it_was_staged_with(dataset, records,
                                                       monkeypatch,
                                                       ours_alive):
    """One train batch an epoch: epoch 2's batch is staged at the end of
    epoch 1's train phase, before ``predict_probs`` advances the base
    key, and its step draws from the old base key (the key the JAX
    trainer's chain queued with it); epoch 3's batch, staged after, from
    the new one."""
    used = []
    real = steps.step_key

    def recording(rng, batch, phase):
        if "rng_idx" in batch:
            used.append((steps._rng_idx(batch["rng_idx"]), np.array(rng)))
        return real(rng, batch, phase)

    monkeypatch.setattr(steps, "step_key", recording)
    trainer = initialize_trainer("wesup", epochs=3, batch_size=4, **CFG)
    keys = {}

    def hook(epoch):
        if epoch == 1:
            chain = trainer._lookahead[2]
            t0 = time.perf_counter()
            while chain.queue.empty() and time.perf_counter() - t0 < 30:
                time.sleep(0.01)
            keys["before"] = np.array(trainer._rng)
            trainer.predict_probs(np.zeros((40, 50, 3), np.uint8))
            keys["after"] = np.array(trainer._rng)

    trainer.post_epoch_hook = hook
    trainer.train(dataset, epochs=3)
    assert not np.array_equal(keys["before"], keys["after"])
    by_idx = dict((idx, k) for idx, k in used)
    assert sorted(by_idx) == [(1, 0), (2, 0), (3, 0)]
    np.testing.assert_array_equal(by_idx[2, 0], keys["before"])
    np.testing.assert_array_equal(by_idx[3, 0], keys["after"])
    assert not ours_alive()
