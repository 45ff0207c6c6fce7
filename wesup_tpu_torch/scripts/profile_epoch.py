"""End-to-end training-epoch profiler at GlaS scale (85 images, B=8).

Port of ``scripts/profile_epoch.py``.  The metric is images/sec as a
user's wall clock sees it: a full epoch including host decode, resize and
canvas prep, the copy to the card, the launches and the device step, not
the device step alone.  This script measures both side by side and splits
the per-batch host path so the gap is attributable.  The instrumented
epoch is the production loop (``trainer._train_phase_loop``) under a
``torch.profiler`` session, its stages read from the program's spans
(``wesup_tpu_torch.tracing``):

  wait_host   the loop waiting on the staging chain's queue for each
              batch (``wesup.stage.wait``: decode + resize + canvas +
              copy, where the chain has not kept ahead)
  load        the staging worker's waits on the loader for each batch
              (``wesup.stage.load``, on the worker's thread: decode +
              resize + canvas where the loader has not kept ahead)
  rng         the batch's key chain and its augmentation draws on the
              host (``wesup.step.rng``, inside the step)
  put         the staging worker's pinned, non-blocking copies
              (``wesup.stage.put``, on the worker's thread)
  dispatch    the step calls (``wesup.step.train``), less their ``rng``
              time (the launches)
  drain       the phase-end read of the metric accumulator
              (``wesup.train.drain``)

Its staging chain starts inside the session (a pre-warmed one is
cancelled), so that every batch's load and copy is traced.  Beside them
it prints each epoch's img/s, the production loop's without the profiler
and the step-only rate (one batch staged on the device, 10 steps between
two synchronisations).

Usage:
    python -m wesup_tpu_torch.scripts.profile_epoch [epochs] [batch]
        [n_images] [fixed|bucket] [instrument|pipeline|both]
        [auto|on|off] [--device cpu]

Defaults: 4 epochs, B=8, 85 images (the GlaS train set's size) at 522x775
(GlaS's image size), a fixed 224x320 canvas (the 0.4-scale multiscale
maximum); ``bucket`` uses the bucketed canvases of the trainer's default.
The dataset is made once with the port's ``scripts/make_dataset.py`` (no
OpenCV) under ``wesup_glas85/<n_images>`` in the temporary directory.
The last line is the report as JSON, with the JAX tool's keys and, per
instrumented epoch, ``rng_ms_per_batch``.  :func:`profile` takes the
image size and the canvas as arguments, for a run at another size.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

GLAS_HW = (522, 775)


def ensure_dataset(n_images, hw=GLAS_HW):
    root = Path(tempfile.gettempdir()) / "wesup_glas85" / str(n_images)
    if tuple(hw) != GLAS_HW:
        root = root.with_name(f"{n_images}_{hw[0]}x{hw[1]}")
    marker = root / ".complete"
    if marker.exists():
        return root
    from .make_dataset import make_dataset

    print(f"[dataset] generating {n_images} x {tuple(hw)} images at {root} "
          "...", file=sys.stderr)
    t0 = time.time()
    make_dataset(root, n_train=n_images, n_val=0, hw=tuple(hw),
                 with_points=True)
    marker.touch()
    print(f"[dataset] done in {time.time() - t0:.0f}s", file=sys.stderr)
    return root


def build_trainer(batch, mode, resize="auto", device=None, canvas=None):
    from ..models import initialize_trainer

    kwargs = dict(batch_size=batch, checkpoint_period=0, device_resize=resize,
                  device=device)
    if mode == "fixed":
        # the 0.4-scale maximum of 522x775 content, 32-aligned: one shape
        kwargs["canvas_size"] = canvas or (224, 320)
    return initialize_trainer("wesup", **kwargs)


def _sync(trainer):
    import torch

    if trainer.device.type == "cuda":
        torch.cuda.synchronize()


def instrumented_epoch(trainer, loader, epoch_idx):
    """The production train-phase loop under a profiler, each stage's
    seconds summed from the program's spans."""
    from torch.profiler import ProfilerActivity, profile

    from .. import tracing

    trainer._cancel_lookahead()
    trainer._epoch_idx = epoch_idx
    trainer.tracker.start_new_epoch(trainer.current_lr())
    trainer.tracker.train()
    _sync(trainer)
    with profile(activities=[ProfilerActivity.CPU]):
        t_epoch = time.time()
        counts = trainer._train_phase_loop(loader)
        _sync(trainer)
        wall = time.time() - t_epoch
    spans = tracing.spans()

    def seconds(name):
        # the next epoch's chain stages its first batches in the session
        return 1e-9 * sum(s.duration_ns for s in spans if s.name == name
                          and s.end_ns is not None
                          and (name == "wesup.train.drain"
                               or s.trace[:2] == ("train", epoch_idx)))

    rng = seconds("wesup.step.rng")
    t = {"wait_host": seconds("wesup.stage.wait"),
         "load": seconds("wesup.stage.load"), "rng": rng,
         "put": seconds("wesup.stage.put"),
         "dispatch": seconds("wesup.step.train") - rng,
         "drain": seconds("wesup.train.drain")}
    return wall, t, counts["batches"], counts["samples"]


def pipelined_epoch(trainer, loader, epoch_idx):
    """The production train-phase loop."""
    trainer._epoch_idx = epoch_idx
    trainer.tracker.start_new_epoch(trainer.current_lr())
    trainer.tracker.train()
    _sync(trainer)
    t_epoch = time.time()
    trainer._train_phase_loop(loader)
    return time.time() - t_epoch


def step_only_throughput(trainer, loader):
    """Steady-state step wall time at the loader's canvas, the batch
    staged on the device beforehand."""
    from ..models import steps

    batch = next(iter(loader))
    hw = trainer._batch_hw(batch)
    step = trainer._get_step("train", hw)
    dev_batch = trainer._put_batch(batch, (0, 0))
    cache = (trainer._resize_cache.get("train")
             if "img_idx" in batch else None)
    acc = steps.init_metric_acc(steps.TRAIN_METRIC_KEYS, trainer.device)

    def run(acc):
        return step(trainer.model, trainer.optimizer, acc, dev_batch,
                    trainer._rng, cache=cache)

    acc = run(acc)
    _sync(trainer)
    n = 10
    t0 = time.time()
    for _ in range(n):
        acc = run(acc)
    _sync(trainer)
    return (time.time() - t0) / n, hw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("epochs", type=int, nargs="?", default=4)
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("n_images", type=int, nargs="?", default=85)
    ap.add_argument("mode", nargs="?", default="fixed",
                    choices=("fixed", "bucket"))
    ap.add_argument("loop", nargs="?", default="both",
                    choices=("instrument", "pipeline", "both"))
    ap.add_argument("resize", nargs="?", default="auto",
                    choices=("auto", "on", "off"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return profile(args.epochs, args.batch, args.n_images, args.mode,
                   args.loop, args.resize, args.device)


def _epochs(trainer, loader, epochs, loop, n_images, report):
    """The instrumented and production-loop epochs, into ``report``."""
    for e in range(1, epochs + 1):
        if loop in ("instrument", "both"):
            wall, parts, n_batches, n_valid = instrumented_epoch(
                trainer, loader, e)
            ips = n_valid / wall
            print(f"[epoch {e}] instrumented wall {wall:.2f}s "
                  f"({n_batches} batches, {n_valid} imgs) -> {ips:.1f} "
                  "img/s | " + " ".join(f"{k}={v:.3f}s"
                                        for k, v in parts.items()),
                  file=sys.stderr)
            report["epochs"].append({
                "epoch": e, "loop": "instrument", "wall_s": round(wall, 3),
                "img_per_s": round(ips, 1), "batches": n_batches,
                **{k: round(v, 4) for k, v in parts.items()},
                "rng_ms_per_batch": round(
                    1e3 * parts["rng"] / max(n_batches, 1), 4)})
        if loop in ("pipeline", "both"):
            wall = pipelined_epoch(trainer, loader, e)
            ips = n_images / wall
            print(f"[epoch {e}] production loop wall {wall:.2f}s -> "
                  f"{ips:.1f} img/s", file=sys.stderr)
            report["epochs"].append({"epoch": e, "loop": "pipeline",
                                     "wall_s": round(wall, 3),
                                     "img_per_s": round(ips, 1)})


def profile(epochs=4, batch=8, n_images=85, mode="fixed", loop="both",
            resize="auto", device=None, hw=GLAS_HW, canvas=None):
    """Run the profile, print each stage and the report's JSON line, and
    return the report.  ``hw`` is the dataset's image size, ``canvas`` the
    fixed canvas (default 224x320)."""
    root = ensure_dataset(n_images, hw)
    trainer = build_trainer(batch, mode, resize, device, canvas)
    print(f"device: {trainer.device}", file=sys.stderr)
    trainer.setup_dataloaders(root / "train", None)
    loader = trainer.dataloaders["train"]
    trainer.tracker.start_new_epoch(trainer.current_lr())
    trainer.tracker.train()

    report = {"batch": batch, "n_images": n_images,
              "mode": mode, "resize": resize, "epochs": []}
    try:
        _epochs(trainer, loader, epochs, loop, n_images, report)
    finally:
        # the production loop pre-warms the next epoch's staging chain, as
        # train() does; nothing claims the last one
        trainer._cancel_lookahead()

    dt, step_hw = step_only_throughput(trainer, loader)

    step_ips = batch / dt
    print(f"[step-only] {dt * 1e3:.1f} ms/step at {step_hw} B={batch} -> "
          f"{step_ips:.1f} img/s", file=sys.stderr)
    report["step_only"] = {"ms_per_step": round(dt * 1e3, 1),
                           "img_per_s": round(step_ips, 1),
                           "canvas": list(step_hw)}
    steady = [ep for ep in report["epochs"] if ep["epoch"] > 1]
    if steady:
        best = max(ep["img_per_s"] for ep in steady)
        report["wall_over_step"] = round(best / step_ips, 3)
        print(f"[ratio] best steady epoch wall {best:.1f} img/s = "
              f"{100 * best / step_ips:.0f}% of step-only {step_ips:.1f}",
              file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
