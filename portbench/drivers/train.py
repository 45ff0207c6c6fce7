"""Training epochs back to back through the trainer's staging chain.

Set-up makes the training set from the seed (images with gland masks and
about ``points_p`` of their pixels as point labels), writes it as a GlaS
point-supervision directory under the temporary directory, builds one
``WESUPTrainer`` holding the seed's weights, calls
``setup_dataloaders`` and runs ``warm_epochs`` epochs through
``train_one_epoch(no_val=True)``, the call the window makes, which
also warms up the canvas shapes the multiscale draws give.  The same
trainer then trains in the window, epoch after epoch, as
``BaseTrainer.train`` drives it.  A unit is one epoch; the rate counts
the valid images of every step that completed.

Two observers of the benchmark's own wrap the trainer's staging
(``_start_staged``: each host batch's canvas and valid rows) and its
steps (``_get_step``: each step's valid images).  Two epochs are
recorded for the check: the first (``start``: the first ``check_steps``
steps from the seed's weights) and the window's first (``window``: the
first ``check_steps`` steps from the state that the warm-up epochs
left).  Of each: the host batches with their key indices, the weights
and the optimizer's momentum buffers before its first step, each step's
loss and propagated labels, each leaf's first gradient as the optimizer
holds it, and each leaf after the last of the steps.  The check replays
both with the plain reference (``reference/train.py``), the window's
from the program's own weights and buffers at that point.
"""

from __future__ import annotations

import functools
import logging
import statistics
import sys
import tempfile

import numpy as np
import torch

from ..gen import dataset, glands
from .common import DriverBase, check


class Driver(DriverBase):
    def setup(self):
        from wesup_tpu_torch.models.trainer import WESUPTrainer

        p = self.config["protocol"]
        t = self.traffic
        imgs, masks = glands.make_images(int(p["n_train"]), *p["image_hw"],
                                         self.generator(1), self.device)
        points = glands.sample_points(masks, float(p["points_p"]),
                                      self.generator(2))
        self.images = imgs.cpu().numpy()
        self.masks = masks.cpu().numpy()
        self.phase("data")
        self.tmp = tempfile.TemporaryDirectory(prefix="portbench-train-")
        train_dir = dataset.write_point_set(self.tmp.name, self.images,
                                            self.masks, points)
        self.phase("files")
        logger = logging.getLogger("portbench.trainer")
        logger.setLevel(logging.WARNING)
        logger.propagate = False
        if not logger.handlers:
            logger.addHandler(logging.StreamHandler(sys.stderr))
        # the trainer's own draws (shuffle, multiscale sizes, augmentation)
        # come from the traffic's seed, so that every run's steps have the
        # same sizes; --seed makes the images, points and weights
        self.trainer_seed = int(t["trainer_seed"])
        self.n_check = int(t["check_steps"])
        tr = WESUPTrainer(**self.config["model"], batch_size=t["batch_size"],
                          checkpoint_period=0, seed=self.trainer_seed,
                          logger=logger, device=self.device)
        self.phase("trainer object")
        tr.load_state_dict({"model_state_dict": self.weights()})
        self.phase("trainer")
        tr.setup_dataloaders(train_dir, None)
        self.phase("loaders")
        self.trainer = tr
        self.epoch = 0
        self.staged = {}          # epoch -> [(H, W, rows, content sizes)]
        warm = int(t["warm_epochs"])
        # the epochs whose first steps the check replays
        self.records = {1: Record("start"), warm + 1: Record("window")}
        tr._start_staged = functools.partial(self._observe_staging,
                                             tr._start_staged)
        tr._get_step = functools.partial(self._observe_steps, tr._get_step)
        for _ in range(warm):
            self.unit()
            self.phase(f"epoch {self.epoch}")
        self.attempted = self.failed = 0

    # observers --------------------------------------------------------
    def _observe_staging(self, start, batch_iter, epoch):
        return start(self._record(batch_iter, epoch), epoch)

    def _record(self, batch_iter, epoch):
        log = self.staged.setdefault(epoch, [])
        try:
            for i, b in enumerate(batch_iter):
                hw = (b["rsz_iy"].shape[1], b["rsz_ix"].shape[1]) \
                    if "rsz_iy" in b else b["image"].shape[1:3]
                ok = np.asarray(b["sample_valid"], bool)
                content = [tuple(int(x) for x in c) for c in
                           np.asarray(b["content_hw"])[ok]] \
                    if "content_hw" in b else [tuple(hw)] * int(ok.sum())
                log.append((int(hw[0]), int(hw[1]), len(ok), content))
                rec = self.records.get(epoch)
                if rec is not None and len(rec.plan) < self.n_check:
                    host = {k: np.array(v, copy=True) for k, v in b.items()}
                    host["rng_idx"] = np.array([epoch, i])
                    rec.plan.append(host)
                yield b
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()

    def _observe_steps(self, get_step, kind, hw):
        step = get_step(kind, hw)
        if kind != "train":
            return step
        return functools.partial(self._step, step, hw)

    def _step(self, step, hw, model, optimizer, acc, batch, rng, **kw):
        H, W, rows, content = self.staged[self.epoch][self.epoch_steps]
        n_valid = len(content)
        rec = self.records.get(self.epoch) \
            if self.epoch_steps < self.n_check else None
        if rec is not None and self.epoch_steps == 0:
            rec.begin(model, optimizer)
        self.epoch_steps += 1
        self.attempted += n_valid
        try:
            out = step(model, optimizer, acc, batch, rng, **kw)
        except RuntimeError:
            self.failed += n_valid
            raise
        self.trained += n_valid
        self.log_work(kind="train", rows=rows, H=H, W=W, content=content)
        if rec is not None:
            m = self.config["model"]
            rec.after(model, optimizer, acc, out, float(m["weight_decay"]),
                      float(m["momentum"]), last=self.epoch_steps
                      == self.n_check)
        return out

    # the harness's interface ------------------------------------------
    def unit(self) -> int:
        tr = self.trainer
        self.epoch += 1
        self.epoch_steps = 0
        self.trained = 0
        tr.tracker.start_new_epoch(tr.current_lr())
        tr._epoch_idx = self.epoch
        tr.train_one_epoch(no_val=True)
        return self.trained

    def release(self):
        self.trainer._cancel_lookahead()
        self.trainer = None

    def close(self):
        if getattr(self, "trainer", None) is not None:
            self.trainer._cancel_lookahead()
        if getattr(self, "tmp", None) is not None:
            self.tmp.cleanup()

    def readings(self, quant=None, fault=None) -> dict:
        """The numbers compared for the recorded steps, the window's with
        the suffix ``_w``; with ``quant`` or a ``fault``, of the reference
        computed so in the program's place."""
        if getattr(self, "_ref", None) is None:
            self._ref = {n: self.replay(n) for n in self.records}
        out = {}
        for n, rec in self.records.items():
            got = rec.result() if quant is None and fault is None else \
                self.replay(n, quant=quant, fault=fault)
            suffix = "" if rec.name == "start" else "_w"
            out.update({k + suffix: v
                        for k, v in compare(got, self._ref[n]).items()})
        return out

    def check(self) -> dict:
        got = self.readings()
        checks = {k: check(got[k], v) for k, v in self.limits.items()}
        checks["failed"] = check(self.failed, 0)
        return checks

    def replay(self, epoch: int, quant=None, fault=None) -> dict:
        """The reference over the recorded steps of ``epoch``, from the
        seed's weights (the first epoch) or the program's weights and
        momentum buffers before them."""
        from ..reference import train

        rec = self.records[epoch]
        if rec.p0 is None:
            return {"loss": []}
        state0 = self.weights() if rec.name == "start" else rec.p0
        return train.replay(state0, self.images, self.masks, rec.plan,
                            self.config["model"], self.trainer_seed,
                            quant=quant, fault=fault, momentum=rec.b0)


class Record:
    """What the program did over the first steps of one epoch: the
    weights and momentum buffers before them, each step's loss and
    propagated labels, the first gradient as the optimizer got it and
    the weights after the last step."""

    def __init__(self, name: str):
        self.name = name
        self.plan = []            # host batches with their key indices
        self.p0 = self.b0 = None
        self.loss, self.prop = [], []
        self.grad_t = self.param_t = None

    def begin(self, model, optimizer):
        with torch.no_grad():
            named = dict(model.named_parameters())
            self.p0 = {n: p.detach().clone() for n, p in named.items()}
            self.b0 = {n: optimizer.state[p]["momentum_buffer"].clone()
                       for n, p in named.items()
                       if optimizer.state[p].get("momentum_buffer")
                       is not None}

    def after(self, model, optimizer, acc, out, wd: float, momentum: float,
              last: bool):
        with torch.no_grad():
            sums = out["sums"]
            self.loss.append(((sums["loss"] - acc["sums"]["loss"]).clone(),
                              (out["count"] - acc["count"]).clone()))
            self.prop.append((sums["propagated_labels"]
                              - acc["sums"]["propagated_labels"]).clone())
            named = dict(model.named_parameters())
            if self.grad_t is None:
                # the first gradient as the optimizer got it, from its
                # buffer: buf1 = momentum * buf0 + grad + wd * p0; no
                # buffer: no gradient reached the optimizer's state
                self.grad_t = {}
                for n, p in named.items():
                    buf = optimizer.state[p].get("momentum_buffer")
                    if buf is None:
                        self.grad_t[n] = torch.zeros_like(p)
                        continue
                    g = buf - wd * self.p0[n]
                    if n in self.b0:
                        g = g - momentum * self.b0[n]
                    self.grad_t[n] = g
            if last:
                self.param_t = {n: p.detach().clone()
                                for n, p in named.items()}

    def result(self) -> dict:
        if self.param_t is None:
            return {"loss": []}
        return {"loss": [float(a) / float(c) for a, c in self.loss],
                "prop": [float(n) for n in self.prop],
                "grad_t": self.grad_t, "param_t": self.param_t}


def _relative(gaps: dict, want: dict, leaves) -> list:
    """Each leaf's gap against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    med = statistics.median(want[n] for n in leaves)
    return [gaps[n] / max(want[n], med, 1e-30) for n in leaves]


def compare(got: dict, ref: dict) -> dict:
    """The numbers of the first steps; ``cells/<cell>.json`` names those
    a cell compares.

    The norm of the difference between the program's first gradient and
    the reference's, leaf by leaf, for the worst leaf (``grad_diff``) and
    the median leaf (``grad_diff_med``); the same for the parameters
    after the last step (``change_diff``, ``change_diff_med``; leaves
    whose reference gradient is under a thousandth of the median leaf's
    left out); each against the larger of the leaf's and the median
    leaf's reference norm.  The worst step's and the first step's
    relative loss gap (``loss_gap``, ``loss_gap1``).  Beside them, for the
    record: the worst leaf's gap between the norms (``grad_gap``,
    ``change_gap``) and the labels propagated at each step on both
    sides."""
    if not ref.get("loss") or len(got.get("loss", [])) < len(ref["loss"]) \
            or "param_t" not in got:
        return dict.fromkeys(("grad_diff", "grad_diff_med", "change_diff",
                              "change_diff_med", "loss_gap", "loss_gap1"),
                             float("inf"))
    rel = [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])]
    p0 = ref["p0"]
    leaves = sorted(ref["grad_t"])
    norm = lambda d: {n: float(d(n).norm()) for n in leaves}  # noqa: E731
    g_ref = norm(lambda n: ref["grad_t"][n])
    med = statistics.median(g_ref.values())
    moving = [n for n in leaves if g_ref[n] >= 1e-3 * med]
    c_ref = norm(lambda n: ref["param_t"][n] - p0[n])
    g_got = norm(lambda n: got["grad_t"][n])
    c_got = norm(lambda n: got["param_t"][n] - p0[n])
    grad = _relative(norm(lambda n: got["grad_t"][n] - ref["grad_t"][n]),
                     g_ref, leaves)
    change = _relative(norm(lambda n: got["param_t"][n]
                            - ref["param_t"][n]), c_ref, moving)
    return {
        "grad_diff": max(grad), "grad_diff_med": statistics.median(grad),
        "change_diff": max(change),
        "change_diff_med": statistics.median(change),
        "loss_gap": max(rel), "loss_gap1": rel[0],
        "grad_gap": max(_relative({n: abs(g_got[n] - g_ref[n])
                                   for n in leaves}, g_ref, leaves)),
        "change_gap": max(_relative({n: abs(c_got[n] - c_ref[n])
                                     for n in moving}, c_ref, moving)),
        "prop": got.get("prop"), "prop_ref": ref.get("prop")}
