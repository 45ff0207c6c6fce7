"""Trainer framework of the port: epoch loop, checkpointing, records,
logging (a port of ``wesup_tpu.models.base``).

Behavioral parity with the reference's ``BaseTrainer`` (models/base.py:39-360):
same record-dir layout, same history.csv, same per-epoch checkpoint cadence
with latest-only retention (models/base.py:323-331), same resume semantics
(``--checkpoint`` restores epoch+1 / params / optimizer state,
models/base.py:124-148), same exception policy (RuntimeError per-iteration
swallow, models/base.py:234-237; NaN-loss ValueError abort,
models/base.py:202-203).

State is the model and its ``torch.optim.SGD``; checkpoints are torch
files in the reference's layout, ``checkpoints/ckpt.{epoch:04d}.pth``
holding ``{"epoch", "model_state_dict", "optimizer_state_dict"}``.  A
checkpoint of the JAX trainer (``.msgpack``) loads too, with its weights
and momentum converted (``convert.load_jax_checkpoint``).

In a job of several processes only the main one (:meth:`is_main`)
writes the record directory: params, history, curves, log file and
checkpoints; the others read its path from it (:meth:`agree_on`) and
take part in every collective (``state_dict`` is one).
"""

from __future__ import annotations

import logging
import threading
from abc import ABC, abstractmethod
from pathlib import Path

import torch

from ..utils import record, underline
from . import convert
from ..utils.history import HistoryTracker


class _RecordWorker:
    """Latest-wins background writer for per-epoch records.

    The reference saves a checkpoint and re-plots learning curves EVERY
    epoch (models/base.py:219-222, 323-331) — invisible behind its
    ~10-minute CPU epochs, but an epoch on the card takes seconds while a
    ~150 MB checkpoint write and a matplotlib render take about as long
    again.

    So each job kind ("ckpt", "plot") has a single LATEST slot: the main
    thread deposits work and continues; one daemon thread drains slots.
    If epochs outpace the disk, intermediate checkpoints are simply never
    written — observationally equivalent to the reference's latest-only
    retention (it deletes them anyway), except a crash can lose a few
    epochs of resume progress.  ``flush()`` at the end of training (and at
    every ``train()`` return) guarantees the FINAL checkpoint and curves
    are always written.
    """

    def __init__(self, logger):
        self.logger = logger
        self._slots = {}
        self._cv = threading.Condition()
        self._busy = False
        self._thread = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def submit(self, kind, fn):
        with self._cv:
            self._slots[kind] = fn
            self._ensure_thread()
            self._cv.notify_all()

    def flush(self):
        with self._cv:
            self._cv.wait_for(lambda: not self._slots and not self._busy)

    def _run(self):
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._slots)
                kind, fn = next(iter(self._slots.items()))
                del self._slots[kind]
                self._busy = True
            try:
                fn()
            except Exception as ex:  # a failed plot/write must not kill training
                self.logger.warning(f"record worker ({kind}): {ex}")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()


class BaseTrainer(ABC):
    def __init__(self, **kwargs):
        self.kwargs = kwargs

        if kwargs.get("logger"):
            self.logger = kwargs["logger"]
        else:
            self.logger = logging.getLogger("Train")
            self.logger.setLevel(logging.DEBUG)
            if not self.logger.handlers:
                self.logger.addHandler(logging.StreamHandler())

        self.initial_epoch = 1
        self.record_dir = None
        self.tracker = HistoryTracker()
        self.metric_names = ["accuracy", "dice"]
        self._record_worker = _RecordWorker(self.logger)

    # ------------------------------------------------------------------
    # subclass interface
    # ------------------------------------------------------------------

    @abstractmethod
    def get_default_dataset(self, root_dir, train=True, proportion=1.0):
        ...

    @abstractmethod
    def state_dict(self) -> dict:
        """Training state on the host: ``model_state_dict`` and
        ``optimizer_state_dict``, copies that later steps do not change."""

    @abstractmethod
    def load_state_dict(self, state: dict):
        ...

    @abstractmethod
    def train_one_epoch(self, no_val: bool):
        ...

    def is_main(self) -> bool:
        """Whether this process writes the record (rank 0 of a job)."""
        return True

    def agree_on(self, obj):
        """The main process's ``obj`` on every process."""
        return obj

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def load_checkpoint(self, ckpt_path=None):
        if ckpt_path is not None:
            ckpt_path = Path(ckpt_path)
            self.record_dir = ckpt_path.parent.parent
            self.logger.info(f"Loading checkpoint from {ckpt_path}.")
            if ckpt_path.suffix == ".pth":
                payload = torch.load(ckpt_path, map_location="cpu",
                                     weights_only=True)
                self.initial_epoch = int(payload.get("epoch", 0)) + 1
                self.load_state_dict(payload)
            else:
                epoch, state, momentum = convert.load_jax_checkpoint(
                    ckpt_path)
                self.initial_epoch = epoch + 1
                self.load_jax_state(state, momentum)
        else:
            record_dir = None
            if self.is_main():
                record_dir = str(record.prepare_record_dir())
                record.copy_source_files(Path(record_dir))
            self.record_dir = Path(self.agree_on(record_dir))

    def load_jax_state(self, state_dict, momentum):
        raise NotImplementedError

    def save_checkpoint(self, ckpt_path, **extra):
        """Public snapshot API: writes ONE checkpoint, touches nothing else
        (the latest-only retention is a train-loop policy, not a side effect
        of every write)."""
        state = self.state_dict()
        if self.is_main():
            self._write_checkpoint({**state, **extra}, ckpt_path,
                                   retain_latest_only=False)

    def _write_checkpoint(self, payload, ckpt_path, retain_latest_only=True):
        """Serialize + atomically write one checkpoint; the train loop also
        applies the reference's latest-only retention (delete every older
        ckpt.*, reference models/base.py:323-331)."""
        ckpt_path = Path(ckpt_path)
        ckpt_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = ckpt_path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(ckpt_path)
        if retain_latest_only:
            for old in sorted(ckpt_path.parent.glob("ckpt.*"))[:-1]:
                old.unlink()

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------

    def train(self, data_root, **kwargs):
        self.kwargs = {**self.kwargs, **kwargs}

        self.load_checkpoint(self.kwargs.get("checkpoint"))
        if not self.is_main():
            return self._train_epochs(data_root)
        log_file = logging.FileHandler(self.record_dir / "train.log")
        self.logger.addHandler(log_file)
        try:
            self._train_epochs(data_root)
        finally:
            self.logger.removeHandler(log_file)
            log_file.close()

    def _train_epochs(self, data_root):
        serializable = {
            k: v for k, v in self.kwargs.items()
            if isinstance(v, (int, float, str, tuple, bool))
        }
        main = self.is_main()
        if main:
            record.save_params(self.record_dir, serializable)
        self.logger.info(str(serializable) + "\n")
        self.tracker.save_path = self.record_dir / "history.csv"

        data_root = Path(data_root)
        train_path = data_root / "train"
        val_path = data_root / "val"
        self.setup_dataloaders(train_path,
                               val_path if val_path.exists() else None,
                               proportion=self.kwargs.get("proportion", 1))

        self.logger.info(underline("\nTraining Stage", "="))
        epochs = int(self.kwargs.get("epochs"))
        total_epochs = epochs + self.initial_epoch - 1

        for epoch in range(self.initial_epoch, total_epochs + 1):
            self.logger.info(
                underline("\nEpoch {}/{}".format(epoch, total_epochs), "-"))
            self.tracker.start_new_epoch(self.current_lr())
            self._epoch_idx = epoch  # drives per-batch rng derivation
            self.train_one_epoch(no_val=not val_path.exists())
            self.post_epoch_hook(epoch)

            if main:
                self.tracker.save()
                self._record_worker.submit(
                    "plot", lambda p=self.tracker.save_path:
                    record.plot_learning_curves(p))

            # the state is copied to the host HERE (the next epoch's steps
            # update the weights in place); the slow disk write happens on
            # the record worker, latest checkpoint wins
            period = int(self.kwargs.get("checkpoint_period", 1) or 0)
            if period and (epoch % period == 0 or epoch == total_epochs):
                state = {**self.state_dict(), "epoch": epoch}
                ckpt_path = (self.record_dir / "checkpoints"
                             / f"ckpt.{epoch:04d}.pth")
                if not main:
                    continue
                self._record_worker.submit(
                    "ckpt",
                    lambda s=state, p=ckpt_path: self._write_checkpoint(s, p))

        self._record_worker.flush()
        self.logger.info(self.tracker.report())

    def post_epoch_hook(self, epoch):
        # reference builds an LR scheduler then discards it
        # (models/wesup.py:452-455), so this is intentionally a no-op
        pass

    def current_lr(self) -> float:
        return float(self.kwargs.get("lr", 0.0))

    @abstractmethod
    def setup_dataloaders(self, train_path, val_path, proportion=1.0):
        ...

