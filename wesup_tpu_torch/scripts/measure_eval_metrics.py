"""Time the trainer's val phase with and without host metrics.

Port of ``scripts/measure_eval_metrics.py``.  The default val phase keeps
accuracy and dice on the device and reads nothing back per batch;
``metrics=object_dice`` must read every batch's probability map back to
the host and score it there.  ``WESUPTrainer._run_val_phase`` reads step
i's map only after step i + ``_PENDING_WINDOW`` is queued, so the card
keeps working while the host waits.  This times the val phase three ways:

  default            device metrics only (no read-back)
  object_dice        deferred reads + host metric (the trainer's path)
  object_dice-eager  each step's map read back at once inside the loop
                     (the naive placement, for comparison)

and checks that the deferred and eager host metrics are equal.

Usage:
    python -m wesup_tpu_torch.scripts.measure_eval_metrics [--n-val 8]
        [--hw 522 775] [--root DIR] [--device cpu]

It runs on the card unless ``--device cpu`` is given; the dataset (GlaS-
shaped synthetic PNGs, written with ``data/codec.py``) is made under
``--root`` (a temporary directory by default) from seed 0 unless it is
there.
"""

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

VARIANTS = (("default (device metrics)", None, False),
            ("object_dice deferred", "object_dice", False),
            ("object_dice eager", "object_dice", True))


def synthetic_pair(rng, hw=(522, 775)):
    """One GlaS-like (RGB image, gland mask) of size ``hw``, drawn from
    ``rng``: 4-8 elliptic glands (radii 30-89 px at GlaS's 522 rows,
    scaled with the shorter side), purple on pink, with noise."""
    H, W = hw
    yy, xx = np.mgrid[:H, :W]
    mask = np.zeros((H, W), np.uint8)
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        ry, rx = np.maximum(rng.integers(30, 90, 2) * min(H, W) // 522, 1)
        mask[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = 1
    tone = np.where(mask[..., None] == 1, rng.normal([160, 110, 170], 8),
                    rng.normal([225, 205, 220], 6))
    img = np.clip(tone + rng.normal(0, 12, (H, W, 3)), 0, 255).astype(
        np.uint8)
    return img, mask


def write_dataset(root, n_train=2, n_val=8, hw=(522, 775), seed=0):
    """``root/{train,val}/{images,masks}`` PNGs and ``train/points`` CSVs
    (3 points per class), made with numpy from ``seed``."""
    from wesup_tpu_torch.data.codec import write_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for d in ("images", "masks") + (("points",) if split == "train"
                                        else ()):
            (root / split / d).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = synthetic_pair(rng, hw)
            name = f"{split}_{i:02d}"
            write_png(root / split / "images" / f"{name}.png", img)
            write_png(root / split / "masks" / f"{name}.png", mask)
            if split == "train":
                rows = []
                for cls in (0, 1):
                    ys, xs = np.nonzero(mask == cls)
                    for j in rng.choice(len(ys), min(3, len(ys)),
                                        replace=False):
                        rows.append(f"{xs[j]},{ys[j]},{cls}\n")
                (root / split / "points" / f"{name}.csv").write_text(
                    "".join(rows))
    return root


def eager_val_phase(trainer):
    """The trainer's val phase with each step's map read back at once
    inside the loop, reusing the trainer's own host-eval helpers."""
    from wesup_tpu_torch.models import steps

    loader = trainer.dataloaders["val"]
    spec = loader.spec
    step = trainer._get_step("eval", (spec.height, spec.width))
    acc = steps.init_metric_acc(steps.EVAL_METRIC_KEYS, trainer.device)
    extra_fns = trainer._resolve_extra_metric_fns()
    host_preds, host_targets = [], []
    for batch in loader:
        pred, acc = step(trainer.model, acc, trainer._put_batch(batch))
        if extra_fns:
            trainer._collect_host_eval(trainer._fetch_pred(pred), batch,
                                       host_preds, host_targets)
    trainer._track_acc(acc)
    if extra_fns and host_preds:
        trainer.tracker.step(
            trainer.evaluate_host(extra_fns, host_preds, host_targets))


def time_val_phase(root, metrics, eager, repeats=3, device=None, **config):
    """(min s, median s, the last run's host metrics, reads per run) of
    ``repeats`` val phases after one warm-up, for a trainer with
    ``metrics`` and ``config`` on ``device``."""
    from wesup_tpu_torch.models import initialize_trainer

    trainer = initialize_trainer("wesup", epochs=1, seed=0, metrics=metrics,
                                 device=device, **config)
    trainer.setup_dataloaders(Path(root) / "train", Path(root) / "val")
    host, reads = [], []
    real_eval, real_fetch = trainer.evaluate_host, trainer._fetch_pred

    def evaluate_host(*args):
        host.append(real_eval(*args))
        return host[-1]

    def fetch(pred):
        reads.append(1)
        return real_fetch(pred)

    trainer.evaluate_host, trainer._fetch_pred = evaluate_host, fetch
    run = ((lambda: eager_val_phase(trainer)) if eager
           else trainer._run_val_phase)
    trainer._epoch_idx = 1
    times = []
    for i in range(repeats + 1):  # the first is the warm-up
        trainer.tracker.start_new_epoch(trainer.current_lr())
        trainer.tracker.eval()
        reads.clear()
        t0 = time.perf_counter()
        run()
        if i:
            times.append(time.perf_counter() - t0)
    return (min(times), sorted(times)[len(times) // 2],
            host[-1] if host else {}, len(reads))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(522, 775))
    ap.add_argument("--root", default=None,
                    help="dataset directory (made there if absent; a "
                         "temporary one by default)")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs on the host")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="eval_metrics_") as tmp:
        root = Path(args.root or tmp)
        if not (root / "val" / "images").exists():
            write_dataset(root, n_val=args.n_val, hw=tuple(args.hw))
        results = {}
        for label, metrics, eager in VARIANTS:
            best, med, host, reads = time_val_phase(root, metrics, eager,
                                                    device=args.device)
            results[label] = host
            print(f"{label:28s}  min {best * 1e3:8.1f} ms   med "
                  f"{med * 1e3:8.1f} ms   reads {reads}   {host}")
    deferred, eager = (results[v[0]] for v in VARIANTS[1:])
    if deferred != eager:
        raise SystemExit(f"deferred and eager host metrics differ: "
                         f"{deferred} vs {eager}")
    return results


if __name__ == "__main__":
    main()
