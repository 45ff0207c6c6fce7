"""WESUPTrainer: config, data, steps and records on one device.

Port of ``wesup_tpu.models.trainer``.  Parity targets (reference
models/wesup.py:403-547): dataset selection by ``points/`` presence,
SGD(lr=5e-5, momentum, weight_decay) over trainable params, loss = CE +
0.5 * propagation CE, tracked metrics (loss/accuracy/dice/
labeled_sp_ratio/propagated_labels/propagate_loss), per-epoch history +
checkpoints.

The initial weights are the JAX trainer's for the same ``seed``, drawn
from JAX's bits on the host (``models/jax_init.py``) at the model's first
use, so that a trainer that loads a checkpoint first draws none.

Preprocessing (device resize, augmentation, SLIC) runs inside the steps
on the device.  The batches reach the steps through a staging chain, as
in JAX (``_start_staged``): a worker thread advances the loader's
iterator (whose producer thread builds the numpy batches), copies each
batch to the card from pinned memory on a side stream, records an event,
and queues (batch, device batch, base key, event) ``_STAGE_DEPTH`` deep;
the main thread makes its stream wait on the event, marks the tensors as
used there (``record_stream``) and launches the step.  On the CPU the
worker only builds the tensors.  At the end of each train phase the chain
for the next epoch starts, so that its first batches are built and on the
card while the metrics drain, the val phase runs and the record is
written; the next train phase claims it if it is that epoch's (a
nonstandard sequence cancels it), ``train()`` cancels the last one, and a
resumed or new trainer starts cold.  Nothing is read back per batch: the
metric sums stay on the device until the end of the phase.  Each train
batch carries ``rng_idx`` = (epoch, batch index), which the step folds
into the base key ``PRNGKey(seed + 1)`` (``steps.batch_key``): the
augmentation draws are the JAX trainer's, bit for bit, for the same seed.
The base key is read when the batch is staged, as JAX's chain reads it:
a batch staged before ``predict_probs`` advances the key keeps the old
one.  A batch whose copy raised is queued as ``steps.FailedBatch``: the
step fails on it, on every rank of a data-parallel job, and the batch is
counted failed.

``metrics=`` (names from ``utils.metrics.HOST_METRICS`` or functions)
adds host metrics to the val phase: accuracy and dice stay on the device;
for any other metric each val batch's probability map is read back, at
most ``_PENDING_WINDOW`` steps behind the step in flight, cropped to its
content, rounded and scored on the host, and ``history.csv`` gains a
``val_<name>`` column per metric.  Without such a name nothing is read
back per batch.

Parallelism, as in JAX: the trainer lays the job's processes out on a
('data', 'model') mesh (``parallel.make_mesh(num_devices,
model_parallel)``, JAX's size rule; one process and no process group
make a (1, 1) mesh and nothing is communicated).  Each data shard's
loader emits its rows of every global batch (the same batches, order,
padding and keys as one process; ``shard_multiple`` pads every batch to
the data size, the val loader takes ``max(1, data)`` images a batch) and
loads only the samples in them; the steps sum the gradients and the loss
normaliser over the data axis (``steps.make_train_step``) and the phase
end sums the metric accumulators, so the history is the one process's.
A model axis above 1 splits fc1 and fc2 (``parallel.shard_params``);
``state_dict`` gathers them and their momentum to full tensors and
``load_state_dict`` cuts a full state to the rank's shards, so a
checkpoint written at any layout loads at any other.  Only rank 0 writes
the record directory (every rank reads its path from rank 0).  A
per-batch ``RuntimeError`` is counted failed on every rank, since the
steps agree on a failure flag.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import WESUPConfig, merge_config
from ..data.datasets import Digest2019PointDataset, SegmentationDataset
from ..data.loader import (CanvasBatcher, CanvasSpec, infer_canvas,
                           place_on_canvas)
from ..parallel import (collectives, gather_state_dict, make_mesh,
                        shard_params, shard_state_dict)
from ..parallel.mesh import gather_tensor
from ..runtime import resolve_device
from ..tracing import profiled, span
from ..utils import prng
from . import jax_init, steps, wesup
from .base import BaseTrainer


def _host_copy(obj):
    """``obj`` with every tensor copied to the host (checkpoint snapshot)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _counts() -> dict:
    return {"batches": 0, "samples": 0, "failed": 0}


def _waited(chain, phase: str, epoch: int):
    """A staging chain's items, the wait for batch i in a
    ``wesup.stage.wait`` span with trace id (phase, epoch, i)."""
    items = iter(chain)
    try:
        for i in itertools.count():
            with span("wesup.stage.wait", trace=(phase, epoch, i)):
                item = next(items, None)
            if item is None:
                return
            yield item
    finally:
        items.close()


class _Chain:
    """A staging chain's queue, its cancel event and its thread; iterating
    it yields the staged items until the worker's end, and re-raises a
    loader error."""

    END = object()

    def __init__(self, depth: int):
        self.queue = queue.Queue(maxsize=depth)
        self.cancel = threading.Event()
        self.thread = None

    def put(self, item) -> bool:
        """Queue ``item``, unless the chain is cancelled first."""
        while not self.cancel.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        try:
            while True:
                item = self.queue.get()
                if item is _Chain.END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.stop()     # also where the consumer leaves early

    def ready(self) -> int:
        """The staged items whose copies are complete (all, on the CPU)."""
        with self.queue.mutex:
            items = list(self.queue.queue)
        return sum(1 for it in items if isinstance(it, tuple)
                   and (it[3] is None or it[3].query()))

    def stop(self) -> None:
        """Cancel the chain and wait for its thread (which closes the
        loader's iterator, and so its producer)."""
        self.cancel.set()
        if self.thread is not None:
            self.thread.join()


class WESUPTrainer(BaseTrainer):
    """``device=None`` trains on the card (and raises without one);
    ``device="cpu"`` trains on the host with the kernels' plain versions."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.config = merge_config(WESUPConfig(), **kwargs)
        # reference merges config defaults into kwargs (models/wesup.py:430)
        # so the record dir's params/<n>.json snapshots the full effective
        # configuration, not just the CLI overrides
        self.kwargs = {**self.config.to_dict(), **self.kwargs}
        self.device = resolve_device(kwargs.get("device"))
        self.mesh = make_mesh(self.config.num_devices,
                              int(kwargs.get("model_parallel", 1)))

        # undrawn until `model` is first read or a state is loaded; fc1
        # and fc2 split over the model axis
        self._model = shard_params(wesup.empty(
            self.device, n_classes=self.config.n_classes,
            D=self.config.sp_feature_dim, fc_width=self.config.fc_width),
            self.mesh)
        self._drawn = False
        self.optimizer = steps.make_optimizer(self.config, self._model)
        # base of the per-batch keys, the JAX trainer's PRNGKey(seed + 1);
        # predict_probs advances it, as the JAX trainer's does
        self._rng = prng.PRNGKey(self.config.seed + 1)
        self._epoch_idx = 0  # set per epoch by BaseTrainer.train
        self._step_cache = {}
        self._resize_cache = {}
        self._predictor = None
        self._profiled = False
        # (epoch, loader, _Chain) started at the end of the last train
        # phase; none in a new or resumed trainer
        self._lookahead = None
        self.dataloaders = {}
        # (epoch, phase) -> the phase's wall "seconds" (the device drained,
        # as the metrics are read at its end), its "batches", the valid
        # "samples" in them and the batches whose step "failed"
        self.phase_stats = {}

    # ------------------------------------------------------------------
    # state management
    # ------------------------------------------------------------------

    @property
    def model(self):
        """The module; read first, it gets the JAX trainer's starting
        weights, so that seed s names the same model in both packages."""
        if not self._drawn:
            c = self.config
            self._load_weights(jax_init.init_params(
                c.seed, n_classes=c.n_classes, D=c.sp_feature_dim,
                fc_width=c.fc_width))
        return self._model

    def is_main(self) -> bool:
        return self.mesh.rank == 0

    def agree_on(self, obj):
        return collectives.broadcast_object(obj, self.mesh)

    def _load_weights(self, state_dict):
        """Load a full state dict (this rank's shards of it)."""
        self._model.load_state_dict(shard_state_dict(state_dict, self.mesh))
        self._drawn = True

    def _optimizer_names(self) -> list:
        """The parameter names in the optimizer's order."""
        names = {id(p): n for n, p in self._model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def _map_momentum(self, opt_state, fn) -> dict:
        """An optimizer state dict with ``fn(name, buffer)`` in place of
        each momentum buffer (the optimizer's own state is not touched)."""
        names = self._optimizer_names()
        state = {}
        for i, st in opt_state["state"].items():
            buf = st.get("momentum_buffer")
            state[i] = (st if buf is None or i >= len(names) else
                        dict(st, momentum_buffer=fn(names[i], buf)))
        return dict(opt_state, state=state)

    def state_dict(self):
        """The full state on the host: fc1, fc2 and their momentum are
        gathered from the model shards (a collective: every rank calls
        it)."""
        model = gather_state_dict(self.model.state_dict(), self.mesh)
        opt = self._map_momentum(
            self.optimizer.state_dict(),
            lambda name, buf: gather_tensor(name, buf, self.mesh))
        return {"model_state_dict": _host_copy(model),
                "optimizer_state_dict": _host_copy(opt)}

    def load_state_dict(self, state):
        self._load_weights(state["model_state_dict"])
        self.optimizer = steps.make_optimizer(self.config, self.model)
        if "optimizer_state_dict" in state:
            opt = self._map_momentum(
                state["optimizer_state_dict"],
                lambda name, buf: shard_state_dict({name: buf},
                                                   self.mesh)[name])
            try:
                self.optimizer.load_state_dict(opt)
            except ValueError as ex:  # another optimizer's parameter groups
                self.logger.info(f"Optimizer state reinitialized: {ex}")

    def load_jax_state(self, state_dict, momentum):
        """Weights and optax's momentum trace from a JAX checkpoint: the
        trace is SGD's ``momentum_buffer`` (both update
        ``buf = momentum * buf + g + weight_decay * p; p -= lr * buf``)."""
        self._load_weights(state_dict)
        self.optimizer = steps.make_optimizer(self.config, self.model)
        momentum = shard_state_dict(momentum, self.mesh)
        trained = {p for g in self.optimizer.param_groups for p in g["params"]}
        for name, p in self.model.named_parameters():
            if name in momentum and p in trained:
                self.optimizer.state[p]["momentum_buffer"] = (
                    momentum[name].to(p.device).clone())

    def current_lr(self):
        return float(self.config.lr)

    # ------------------------------------------------------------------
    # data (reference get_default_dataset, models/wesup.py:436-443)
    # ------------------------------------------------------------------

    def get_default_dataset(self, root_dir, train=True, proportion=1.0):
        root_dir = Path(root_dir)
        if train:
            if (root_dir / "points").exists():
                return Digest2019PointDataset(
                    root_dir, proportion=proportion,
                    multiscale_range=self.config.multiscale_range,
                    seed=self.config.seed)
            return SegmentationDataset(
                root_dir, proportion=proportion,
                multiscale_range=self.config.multiscale_range,
                seed=self.config.seed)
        return SegmentationDataset(
            root_dir, rescale_factor=self.config.rescale_factor, train=False)

    def _resolve_extra_metric_fns(self):
        """The host metrics of ``metrics=`` (reference train.py:26-27 and
        models/base.py:335-360 take metric functions; the CLI passes names,
        e.g. ``metrics=accuracy,dice,object_dice``).

        accuracy and dice already run on the device in the eval step, so
        they are dropped; any other name must be one of
        ``utils.metrics.HOST_METRICS``, or this raises ``ValueError``."""
        from ..utils.metrics import HOST_METRICS

        spec = self.kwargs.get("metrics")
        if spec is None:
            return []
        if isinstance(spec, str) or callable(spec):
            spec = [spec]
        fns = []
        for m in spec:
            fn = m if callable(m) else HOST_METRICS.get(str(m))
            if fn is None:
                raise ValueError(f"unknown metric: {m!r} (known: "
                                 f"{', '.join(HOST_METRICS)})")
            if fn.__name__ not in ("accuracy", "dice"):
                fns.append(fn)
        return fns

    def setup_dataloaders(self, train_path, val_path, proportion=1.0):
        self._resolve_extra_metric_fns()  # an unknown name fails here
        bs = int(self.kwargs.get("batch_size", self.config.batch_size))
        # any batch size works over any mesh: the loader pads every batch
        # with sample_valid=False blanks to a multiple of the data size,
        # and each data shard is handed its rows (blanks contribute
        # nothing to the loss, the metrics or the gradients)
        n_data = self.mesh.shape["data"]
        shard = self.mesh.data_rank if self.mesh.distributed else None

        train_ds = self.get_default_dataset(train_path, proportion=proportion)
        train_ds.summary(logger=self.logger)
        self._point_mode = (Path(train_path) / "points").exists()
        self._setup_resize_cache("train", train_ds)
        canvas = self.config.canvas_size
        if canvas is not None:
            spec = CanvasSpec(canvas[0], canvas[1],
                              n_classes=self.config.n_classes)
            bucket = False
        else:
            spec = infer_canvas(train_ds, n_classes=self.config.n_classes)
            # per-sample 32-aligned canvas buckets: ~25% less padding compute
            # at multiscale (0.3, 0.4) for a few more step shapes
            bucket = True
        self.logger.info(f"Train canvas: {spec.height}x{spec.width}"
                         + (" (bucketed)" if bucket else ""))
        self.dataloaders = {
            "train": CanvasBatcher(train_ds, spec, batch_size=bs,
                                   shuffle=True, seed=self.config.seed,
                                   bucket=bucket, shard_multiple=n_data,
                                   shard=shard)
        }
        self._train_spec = spec
        # shuffle-epoch counter of the train loader; it restarts at 0 in a
        # new process (so a resumed run shuffles as epoch 1 did), as the
        # JAX trainer's does
        self._train_iters = 0

        if val_path is not None:
            val_ds = self.get_default_dataset(val_path, train=False)
            val_ds.summary(logger=self.logger)
            self._setup_resize_cache("val", val_ds)
            vspec = infer_canvas(val_ds, n_classes=self.config.n_classes)
            self.logger.info(f"Val canvas: {vspec.height}x{vspec.width}")
            self.dataloaders["val"] = CanvasBatcher(
                val_ds, vspec, batch_size=max(1, n_data),
                shard_multiple=n_data, shard=shard)

    # device-resize cache size cap ("auto" mode falls back to host resize
    # above this): GlaS-85 is ~140 MB; 4 GB leaves the card's memory to
    # the model
    _RESIZE_CACHE_CAP = 4 << 30

    def _setup_resize_cache(self, phase: str, dataset):
        """Enable the device-resize path (ops/train_resize.py) for a phase.

        Ships the dataset's full-resolution decode to the device ONCE; the
        per-epoch cv2-exact resize then runs inside the step, which takes
        the host's per-epoch resize and canvas work off the loader thread
        and cuts the bytes per batch from ~2.3 MB to ~80 KB."""
        mode = str(self.config.device_resize).lower()
        self._resize_cache[phase] = None
        if mode in ("off", "false", "0", "none"):
            return
        if phase == "val" and self.kwargs.get("metrics"):
            # the host metrics read each sample's mask and validity from
            # the host batch (_collect_host_eval); keep the host wire format
            return
        from ..ops.train_resize import build_cache

        host = build_cache(dataset, max_bytes=self._RESIZE_CACHE_CAP)
        if host is None:
            if mode in ("on", "true", "1"):
                raise ValueError(
                    f"device_resize='on' but the {phase} dataset cannot be "
                    "cached losslessly (missing/over-range masks or above "
                    "the size cap)")
            return
        self._resize_cache[phase] = {
            k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        dataset.device_resize = True
        self.logger.info(
            f"Device resize ({phase}): {host['imgs'].shape[0]} images "
            f"cached on {self.device} ({host['imgs'].nbytes / 1e6:.0f} MB)")

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _get_step(self, kind: str, hw):
        key = (kind, hw)
        if key not in self._step_cache:
            if kind == "train":
                self._step_cache[key] = steps.make_train_step(
                    self.config, hw, point_mode=self._point_mode,
                    device=self.device, mesh=self.mesh)
            else:
                self._step_cache[key] = steps.make_eval_step(
                    self.config, hw, device=self.device, mesh=self.mesh)
        return self._step_cache[key]

    @staticmethod
    def _batch_hw(batch) -> tuple:
        """Canvas (H, W) of a batch in either wire format (device-resize
        batches carry no image; the vector lengths ARE the canvas)."""
        if "image" in batch:
            hw = batch["image"].shape[1:3]
        else:
            hw = (batch["rsz_iy"].shape[1], batch["rsz_ix"].shape[1])
        return (int(hw[0]), int(hw[1]))

    @staticmethod
    def wire(batch) -> dict:
        """The host arrays of a batch that travel to the device: the
        (B, H, W) bool validity mask is always a stack of top-left content
        rectangles (loader.place_on_canvas), so only the (B, 2) extents
        travel and the step rebuilds it; pixel_mask travels as int8 where
        that is lossless."""
        wire = {k: v for k, v in batch.items() if k != "valid"}
        if "content_hw" not in wire and "valid" in batch:
            wire["content_hw"] = np.stack(
                [batch["valid"].any(axis=2).sum(axis=1).astype(np.int32),
                 batch["valid"].any(axis=1).sum(axis=1).astype(np.int32)],
                axis=-1)
        pm = batch.get("pixel_mask")  # absent on device-resize batches
        if (pm is not None and pm.dtype != np.int8
                and -128 <= pm.min() and pm.max() <= 127):
            # lossless downcast only: a mask with class values > 127 keeps
            # its dtype rather than silently wrapping
            wire["pixel_mask"] = pm.astype(np.int8)
        return wire

    def _put_batch(self, batch, rng_idx=None) -> dict:
        """The batch on the device; on the card each array is pinned and
        copied without blocking, on the current stream, which the step's
        kernels then follow.  ``rng_idx`` stays on the host."""
        pin = self.device.type == "cuda"
        out = {}
        for k, v in self.wire(batch).items():
            t = torch.from_numpy(np.asarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        if rng_idx is not None:
            out["rng_idx"] = rng_idx
        return out

    # ------------------------------------------------------------------
    # staging chain
    # ------------------------------------------------------------------

    # staged batches: the copies of batches i+1..i+depth overlap step i on
    # the card, and hold at most that many canvas batches more
    _STAGE_DEPTH = 2

    def _stage(self, batch, rng_idx, stream):
        """(device batch, event) of one host batch: copied on ``stream``
        (the card) with an event after the copy, or built on the CPU (no
        event)."""
        if stream is None:
            return self._put_batch(batch, rng_idx), None
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            dev_batch = self._put_batch(batch, rng_idx)
            event = torch.cuda.Event()
            event.record(stream)
        return dev_batch, event

    def _start_staged(self, batch_iter, epoch: int,
                      phase: str = "train") -> "_Chain":
        """Start the staging chain over ``batch_iter`` now: a thread that
        advances it (the loader's producer thread builds the batches),
        copies each batch to the device with ``rng_idx`` = (epoch, batch
        index) and queues (batch, device batch, base key, event),
        ``_STAGE_DEPTH`` deep, until the chain is cancelled.  Loader errors
        surface in the consumer.  The worker's ``next()`` on the iterator
        is a ``wesup.stage.load`` span, each copy a ``wesup.stage.put``
        span, with trace id (``phase``, epoch, batch index)."""
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        chain = _Chain(self._STAGE_DEPTH)

        def worker():
            try:
                items = iter(batch_iter)
                for i in itertools.count():
                    with span("wesup.stage.load", trace=(phase, epoch, i)):
                        batch = next(items, None)
                    if batch is None or chain.cancel.is_set():
                        return
                    try:
                        with span("wesup.stage.put",
                                  trace=(phase, epoch, i)):
                            dev_batch, event = self._stage(batch, (epoch, i),
                                                           stream)
                    except RuntimeError as ex:
                        # the step fails on it on every rank (a rank that
                        # skipped it would leave its peers in the step's
                        # collectives)
                        self.logger.exception(ex)
                        dev_batch = steps.FailedBatch(ex,
                                                      batch["sample_valid"])
                        event = None
                    # the base key as it is now (predict_probs advances it)
                    if not chain.put((batch, dev_batch, self._rng, event)):
                        return
            except BaseException as ex:  # loader errors reach the consumer
                chain.put(ex)
            finally:
                close = getattr(batch_iter, "close", None)
                if close is not None:
                    close()       # stops the loader's producer thread
                chain.put(_Chain.END)

        chain.thread = threading.Thread(target=worker, daemon=True,
                                        name=f"wesup-stage-{epoch}")
        chain.thread.start()
        return chain

    def _ready(self, dev_batch, event):
        """Order the current stream after a staged batch's copy, and tell
        the caching allocator that its tensors are used there."""
        if event is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for v in dev_batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(current)

    def _staged_batches(self, loader):
        """One phase's staged batches at the current epoch (the val
        phase; the train phase takes the lookahead path)."""
        return self._start_staged(iter(loader), self._epoch_idx, "val")

    def _take_lookahead(self, loader):
        """The pre-warmed chain if it is this loader's at this epoch; any
        other is cancelled."""
        la, self._lookahead = self._lookahead, None
        if la is None:
            return None
        epoch, ldr, chain = la
        if ldr is loader and epoch == self._epoch_idx:
            return chain
        chain.stop()
        return None

    def _cancel_lookahead(self):
        la, self._lookahead = self._lookahead, None
        if la is not None:
            la[2].stop()

    def train(self, data_root, **kwargs):
        try:
            return super().train(data_root, **kwargs)
        finally:
            # the last epoch's chain must not keep staging while
            # inference or evaluation uses the card after training
            self._cancel_lookahead()

    # ------------------------------------------------------------------
    # epoch loop
    # ------------------------------------------------------------------

    def train_one_epoch(self, no_val=False):
        phases = ["train"] if no_val else ["train", "val"]
        for phase in phases:
            self.logger.info(f"{phase.capitalize()} phase:")
            start = time.perf_counter()
            with span("wesup.train.phase", trace=(phase, self._epoch_idx)):
                if phase == "train":
                    self.tracker.train()
                    counts = self._run_train_phase()
                else:
                    self.tracker.eval()
                    counts = self._run_val_phase()
            seconds = time.perf_counter() - start
            self.logger.info(f"Took {seconds:.2f}s.")
            self.phase_stats[(self._epoch_idx, phase)] = dict(
                counts, seconds=seconds)
            self.logger.info(self.tracker.log())

    def _run_train_phase(self):
        loader = self.dataloaders["train"]
        # profile_dir=...: the first epoch's train phase under
        # torch.profiler, written as a Chrome trace
        profile_dir = self.kwargs.get("profile_dir")
        if not profile_dir or self._profiled:
            return self._train_phase_loop(loader)
        self._profiled = True
        path = Path(profile_dir) / f"trace.epoch{self._epoch_idx}.json"
        counts = profiled(lambda: self._train_phase_loop(loader), path,
                          self.device)
        self.logger.info(f"Profiler trace written to {path}")
        return counts

    def _train_phase_loop(self, loader):
        # metrics accumulate ON DEVICE and are read once at phase end, where
        # the NaN abort is checked (reference aborts mid-epoch,
        # models/base.py:202-203 -- observationally equivalent since the
        # epoch's history would be discarded either way)
        acc = steps.init_metric_acc(steps.TRAIN_METRIC_KEYS, self.device)
        chain = self._take_lookahead(loader)
        counts = _counts()
        # whether the chain was the pre-warmed one, and how many of its
        # batches were already on the device when the phase began
        counts["lookahead"] = chain is not None
        if chain is None:
            chain = self._start_staged(loader.epoch_iter(self._train_iters),
                                       self._epoch_idx)
        counts["staged_at_start"] = chain.ready()
        self._train_iters += 1
        cache = self._resize_cache.get("train")
        model = self.model
        for batch, dev_batch, rng, event in _waited(chain, "train",
                                                      self._epoch_idx):
            counts["batches"] += 1
            counts["samples"] += int(batch["sample_valid"].sum())
            try:
                self._ready(dev_batch, event)
                step = self._get_step("train", self._batch_hw(batch))
                acc = step(model, self.optimizer, acc, dev_batch, rng,
                           cache=cache if "img_idx" in batch else None)
            except RuntimeError as ex:  # parity: swallow per-iteration errors
                counts["failed"] += 1
                self.logger.exception(ex)
        # epoch e+1's chain starts now: its batches are built and copied
        # while this epoch's metrics drain, the val phase runs and the
        # record is written
        self._lookahead = (self._epoch_idx + 1, loader, self._start_staged(
            loader.epoch_iter(self._train_iters), self._epoch_idx + 1))
        with span("wesup.train.drain"):
            self._track_acc(acc)
        return counts

    # device prediction maps kept in flight on the host-metrics path:
    # reading step i's map back only after step i + W is queued keeps the
    # card busy while the host waits for it, and holds W extra maps
    _PENDING_WINDOW = 2

    def _fetch_pred(self, pred):
        """Read one batch's probability map back to the host (host-metrics
        path only: the default path never calls this per step,
        tests/test_torch_port_trainer.py::
        test_default_path_fetches_no_predictions)."""
        return pred.cpu().numpy()

    def _collect_host_eval(self, pred_np, batch, host_preds, host_targets):
        """Crop one fetched batch to each sample's valid content, rounded,
        for the host metrics; samples without a mask are skipped."""
        for b in range(pred_np.shape[0]):
            if not batch["sample_valid"][b]:
                continue
            if not (batch["pixel_mask"][b] >= 0).any():
                continue
            h = int(batch["valid"][b].any(axis=1).sum())
            w = int(batch["valid"][b].any(axis=0).sum())
            host_preds.append(
                np.round(pred_np[b, :h, :w]).astype(np.int32))
            host_targets.append(batch["pixel_mask"][b, :h, :w])

    def _drain_one(self, pending, host_preds, host_targets):
        pred, batch = pending.pop(0)
        try:
            pred_np = self._fetch_pred(pred)
        except RuntimeError as ex:  # the step loop's per-batch swallow
            self.logger.exception(ex)
            return
        self._collect_host_eval(pred_np, batch, host_preds, host_targets)

    def _run_val_phase(self):
        loader = self.dataloaders["val"]
        spec = loader.spec
        step = self._get_step("eval", (spec.height, spec.width))
        acc = steps.init_metric_acc(steps.EVAL_METRIC_KEYS, self.device)
        cache = self._resize_cache.get("val")
        extra_fns = self._resolve_extra_metric_fns()
        pending = []  # (device map, host batch), at most W + 1 long
        host_preds, host_targets = [], []
        counts = _counts()
        model = self.model
        for batch, dev_batch, _, event in _waited(
                self._staged_batches(loader), "val", self._epoch_idx):
            counts["batches"] += 1
            counts["samples"] += int(batch["sample_valid"].sum())
            try:
                self._ready(dev_batch, event)
                pred, acc = step(model, acc, dev_batch,
                                 cache=cache if "img_idx" in batch else None)
                if extra_fns:
                    pending.append((pred, batch))
                    if len(pending) > self._PENDING_WINDOW:
                        self._drain_one(pending, host_preds, host_targets)
            except RuntimeError as ex:  # parity: swallow per-iteration errors
                counts["failed"] += 1
                self.logger.exception(ex)
        while pending:
            self._drain_one(pending, host_preds, host_targets)
        self._track_acc(acc)
        if extra_fns:
            self.tracker.step(
                self.evaluate_host(extra_fns, host_preds, host_targets))
        return counts

    def evaluate_host(self, metric_funcs, preds, targets) -> dict:
        """Each host metric's mean over the (prediction, target) pairs of
        every data shard, keyed by the function's name (none without
        pairs): each rank scores the masks it decoded, and one all-reduce
        over the data axis (none in one process) sums the values and
        their count.  ``np.sum`` / count is ``np.mean`` bit for bit."""
        sums = [np.sum([func(p, g) for p, g in zip(preds, targets)],
                       dtype=np.float64) for func in metric_funcs]
        t = torch.tensor(sums + [len(preds)], dtype=torch.float64,
                         device=self.device)
        t = collectives.all_reduce(t, self.mesh.data_group).tolist()
        if not t[-1]:
            return {}
        return {func.__name__: t[i] / t[-1]
                for i, func in enumerate(metric_funcs)}

    def _track_acc(self, acc):
        """Read the device accumulator once (summed over the data axis)
        and record phase means."""
        names = list(acc["sums"])
        packed = torch.stack([acc["count"], acc["nan"].to(torch.float32)]
                             + [acc["sums"][k] for k in names])
        host = collectives.all_reduce(packed,
                                      self.mesh.data_group).cpu().tolist()
        if host[1]:
            raise ValueError("Loss is nan!")
        n = max(host[0], 1.0)
        self.tracker.step({k: v / n for k, v in zip(names, host[2:])})

    # ------------------------------------------------------------------
    # inference-facing API (used by infer CLIs)
    # ------------------------------------------------------------------

    def predict_probs(self, image_u8: np.ndarray) -> np.ndarray:
        """Superpixel-wise foreground probability map for one RGB image.

        Each call advances the base key as the JAX trainer's does (its
        eval step takes a subkey it does not draw from), so that the
        epochs after it draw what the JAX trainer's draw."""
        from ..inference import Predictor

        self._rng = prng.split(self._rng)[0]
        h, w = image_u8.shape[:2]
        H = ((h + 31) // 32) * 32
        W = ((w + 31) // 32) * 32
        item = place_on_canvas({"image": image_u8, "pixel_mask": None,
                                "points": None, "use_mask_as_points": False},
                               CanvasSpec(H, W,
                                          n_classes=self.config.n_classes))
        if self._predictor is None:
            self._predictor = Predictor(self.model, self.config,
                                        device=self.device, mesh=self.mesh)
        pred = self._predictor.predict_canvas(item["image"][None],
                                              item["valid"][None])
        return pred[0, :h, :w]
