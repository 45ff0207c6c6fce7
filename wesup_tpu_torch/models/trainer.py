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
on the device.  The loader's prefetch thread builds numpy batches; the
main thread copies each batch to the device (from pinned memory, without
blocking, on the current stream) and launches the step, so nothing is
read back per batch: the metric sums stay on the device until the end of
the phase.  Each train batch carries ``rng_idx`` = (epoch, batch index),
which the step folds into the base key ``PRNGKey(seed + 1)``
(``steps.batch_key``): the augmentation draws are the JAX trainer's, bit
for bit, for the same seed.

``metrics=`` (names from ``utils.metrics.HOST_METRICS`` or functions)
adds host metrics to the val phase: accuracy and dice stay on the device;
for any other metric each val batch's probability map is read back, at
most ``_PENDING_WINDOW`` steps behind the step in flight, cropped to its
content, rounded and scored on the host, and ``history.csv`` gains a
``val_<name>`` column per metric.  Without such a name nothing is read
back per batch.

The port runs on one device: there is no mesh, so ``num_devices`` and
``model_parallel`` do nothing yet (data parallelism is ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import WESUPConfig, merge_config
from ..data.datasets import Digest2019PointDataset, SegmentationDataset
from ..data.loader import (CanvasBatcher, CanvasSpec, infer_canvas,
                           place_on_canvas)
from ..runtime import resolve_device
from ..utils import prng
from . import jax_init, steps, wesup
from .base import BaseTrainer, timed_phase


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

        # undrawn until `model` is first read or a state is loaded
        self._model = wesup.empty(
            self.device, n_classes=self.config.n_classes,
            D=self.config.sp_feature_dim, fc_width=self.config.fc_width)
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

    def _load_weights(self, state_dict):
        self._model.load_state_dict(state_dict)
        self._drawn = True

    def state_dict(self):
        return {"model_state_dict": _host_copy(self.model.state_dict()),
                "optimizer_state_dict": _host_copy(
                    self.optimizer.state_dict())}

    def load_state_dict(self, state):
        self._load_weights(state["model_state_dict"])
        self.optimizer = steps.make_optimizer(self.config, self.model)
        if "optimizer_state_dict" in state:
            try:
                self.optimizer.load_state_dict(state["optimizer_state_dict"])
            except ValueError as ex:  # another optimizer's parameter groups
                self.logger.info(f"Optimizer state reinitialized: {ex}")

    def load_jax_state(self, state_dict, momentum):
        """Weights and optax's momentum trace from a JAX checkpoint: the
        trace is SGD's ``momentum_buffer`` (both update
        ``buf = momentum * buf + g + weight_decay * p; p -= lr * buf``)."""
        self._load_weights(state_dict)
        self.optimizer = steps.make_optimizer(self.config, self.model)
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
                                   bucket=bucket)
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
            self.dataloaders["val"] = CanvasBatcher(val_ds, vspec,
                                                    batch_size=1)

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
                    device=self.device)
            else:
                self._step_cache[key] = steps.make_eval_step(
                    self.config, hw, device=self.device)
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
    # epoch loop
    # ------------------------------------------------------------------

    def train_one_epoch(self, no_val=False):
        phases = ["train"] if no_val else ["train", "val"]
        for phase in phases:
            with timed_phase(self.logger, phase) as timer:
                if phase == "train":
                    self.tracker.train()
                    counts = self._run_train_phase()
                else:
                    self.tracker.eval()
                    counts = self._run_val_phase()
            self.phase_stats[(self._epoch_idx, phase)] = dict(
                counts, seconds=timer.seconds)
            self.logger.info(self.tracker.log())

    def _run_train_phase(self):
        loader = self.dataloaders["train"]
        # profile_dir=...: the first epoch's train phase under
        # torch.profiler, written as a Chrome trace
        profile_dir = self.kwargs.get("profile_dir")
        if not profile_dir or self._profiled:
            return self._train_phase_loop(loader)
        from torch.profiler import ProfilerActivity, profile

        self._profiled = True
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            counts = self._train_phase_loop(loader)
        path = Path(profile_dir) / f"trace.epoch{self._epoch_idx}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        self.logger.info(f"Profiler trace written to {path}")
        return counts

    def _train_phase_loop(self, loader):
        # metrics accumulate ON DEVICE and are read once at phase end, where
        # the NaN abort is checked (reference aborts mid-epoch,
        # models/base.py:202-203 -- observationally equivalent since the
        # epoch's history would be discarded either way)
        acc = steps.init_metric_acc(steps.TRAIN_METRIC_KEYS, self.device)
        batches = loader.epoch_iter(self._train_iters)
        self._train_iters += 1
        cache = self._resize_cache.get("train")
        counts = _counts()
        for i, batch in enumerate(batches):
            counts["batches"] += 1
            counts["samples"] += int(batch["sample_valid"].sum())
            try:
                step = self._get_step("train", self._batch_hw(batch))
                acc = step(self.model, self.optimizer, acc,
                           self._put_batch(batch, (self._epoch_idx, i)),
                           self._rng,
                           cache=cache if "img_idx" in batch else None)
            except RuntimeError as ex:  # parity: swallow per-iteration errors
                counts["failed"] += 1
                self.logger.exception(ex)
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
        for batch in loader:
            counts["batches"] += 1
            counts["samples"] += int(batch["sample_valid"].sum())
            try:
                pred, acc = step(self.model, acc, self._put_batch(batch),
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
        if extra_fns and host_preds:
            self.tracker.step(
                self.evaluate_host(extra_fns, host_preds, host_targets))
        return counts

    def _track_acc(self, acc):
        """Read the device accumulator once and record phase means."""
        names = list(acc["sums"])
        host = torch.stack([acc["count"], acc["nan"].to(torch.float32)]
                           + [acc["sums"][k] for k in names]).cpu().tolist()
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
                                        device=self.device)
        pred = self._predictor.predict_step((H, W))(
            self.model, item["image"][None], item["valid"][None])
        return pred[0, :h, :w].cpu().numpy()
