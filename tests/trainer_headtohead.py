"""The JAX trainer against the port's over many epochs.

Both trainers start from one JAX checkpoint (seed 0, f32) and train on
one synthetic dataset (``tests/make_dataset.py``, point supervision, or
the masks with ``--masks``).  By default the augmentation draws are
replaced by the identity in both packages (no appearance change, an
identity affine), so no random bits enter a train step: the data order,
the multiscale draws, SLIC, the forward, the loss with its label
propagation, SGD with momentum and weight decay and the constant learning
rate are all that is left, and the two trainers must follow the same
history up to float noise.  With ``--replay`` the augmentation stays on:
the JAX trainer draws it from its keys as always, and the port's train
step takes the parameters that JAX drew for the same (epoch, batch), so
that the augmented path (appearance, elastic, affine warp of the image,
mask and points) is held too, and only the two packages' random streams
are left out.

Usage:
    python tests/trainer_headtohead.py [--epochs 150] [--hw 96 128]
        [--n-train 12] [--n-val 4] [--masks] [--replay] [--elastic-p P]
        [--root DIR] [--out FILE.json]

It prints one line per epoch (loss, propagated labels and val Dice of
each trainer) and writes both histories and the first epoch at which val
Dice exceeds 0 and 0.9 to ``--out``.
"""

import argparse
import contextlib
import csv
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

CFG = dict(compute_dtype="float32", seed=0, checkpoint_period=0)


def _rows(path):
    with open(path, newline="") as fp:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(fp)]


def _first(rows, above):
    return next((i + 1 for i, r in enumerate(rows) if r["val_dice"] > above),
                None)


def run(root, epochs, hw=(96, 128), n_train=12, n_val=4, masks=False,
        replay=False, elastic_p=0.0, overrides=None):
    """{"jax": rows, "port": rows} of both trainers' history.csv, and
    "weights": the initial and both trainers' final parameters, as the
    port's state dicts of numpy arrays.  ``masks`` trains on the masks
    (no ``points/``: the mask-supervised path, with elastic deformation
    at probability ``elastic_p``) instead of points.  ``replay`` keeps the
    augmentation on and gives the port JAX's draws
    (``tests/jax_stream_replay.py``); otherwise both packages draw the
    identity.  ``overrides`` go to both trainers' configs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from make_dataset import make_dataset
    from wesup_tpu.models import initialize_trainer as j_init
    from wesup_tpu.ops import augment as j_aug
    from wesup_tpu_torch.models import convert, initialize_trainer
    from wesup_tpu_torch.ops import augment as t_aug

    def state(trainer):
        if hasattr(trainer, "model"):
            sd = trainer.model.state_dict()
        else:
            sd = convert.from_jax_params(jax.tree.map(np.asarray,
                                                      trainer.params))
        return {k: np.asarray(v, np.float64) for k, v in sd.items()}

    root = Path(root)
    data = make_dataset(root / "data", n_train=n_train, n_val=n_val,
                        hw=tuple(hw), seed=0, with_points=not masks)
    init = root / "init" / "rec" / "checkpoints" / "ckpt.0000.msgpack"
    first = j_init("wesup", **CFG)
    first.save_checkpoint(init, epoch=0)
    weights = {"init": state(first)}

    def identity_affine(draws, hw):
        eye = torch.eye(3, device=draws.angle.device)
        return eye.expand(draws.angle.shape[0], 3, 3).clone()

    if replay:
        from jax_stream_replay import dump, replaying

        draws = np.load(dump(root / "draws", epochs, n_train, masks=masks,
                             elastic_p=elastic_p) / "draws.npz")
        patches = [replaying(dict(draws))]
    else:
        patches = [mock.patch.object(j_aug, "random_appearance",
                                     lambda key, img, cfg=None: img),
                   mock.patch.object(j_aug, "random_affine",
                                     lambda key, hw, cfg=None: jnp.eye(3)),
                   mock.patch.object(t_aug, "random_appearance",
                                     lambda img, params: img),
                   mock.patch.object(t_aug, "random_affine",
                                     identity_affine)]
    out = {}
    old_root = os.environ.get("RECORD_ROOT")
    try:
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            for side in ("jax", "port"):
                ckpt = root / side / "rec" / "checkpoints" / init.name
                ckpt.parent.mkdir(parents=True)
                shutil.copy(init, ckpt)
                os.environ["RECORD_ROOT"] = str(root / side / "records")
                cfg = dict(CFG, **(overrides or {}))
                if masks:
                    cfg["elastic_p"] = elastic_p
                trainer = (j_init("wesup", **cfg) if side == "jax" else
                           initialize_trainer("wesup", device="cpu", **cfg))
                trainer.train(str(data), epochs=epochs, checkpoint=str(ckpt))
                out[side] = _rows(trainer.record_dir / "history.csv")
                weights[side] = state(trainer)
    finally:
        if old_root is None:
            os.environ.pop("RECORD_ROOT", None)
        else:
            os.environ["RECORD_ROOT"] = old_root
    out["weights"] = weights
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--n-train", type=int, default=12)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--masks", action="store_true",
                    help="train on the masks (the mask-supervised path)")
    ap.add_argument("--replay", action="store_true",
                    help="augmentation on, the port replaying JAX's draws")
    ap.add_argument("--elastic-p", type=float, default=0.0,
                    help="elastic probability of the mask-supervised path")
    ap.add_argument("--set", action="append", default=[],
                    help="config override of both trainers, e.g. --set "
                         "lr=2e-4 (value parsed as JSON)")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    root = args.root or tempfile.mkdtemp(prefix="trainer_headtohead_")
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)
    hist = run(root, args.epochs, args.hw, args.n_train, args.n_val,
               args.masks, args.replay, args.elastic_p, overrides)
    hist.pop("weights")
    for e, (j, t) in enumerate(zip(hist["jax"], hist["port"])):
        print(f"epoch {e + 1}: loss {j['loss']:.6f} / {t['loss']:.6f}, "
              f"propagated {j['propagated_labels']:.3f} / "
              f"{t['propagated_labels']:.3f}, val Dice "
              f"{j['val_dice']:.4f} / {t['val_dice']:.4f}", flush=True)
    summary = {side: {"val_dice_above_0": _first(rows, 0.0),
                      "val_dice_above_0.9": _first(rows, 0.9),
                      "best_val_dice": max(r["val_dice"] for r in rows),
                      "history": rows}
               for side, rows in hist.items()}
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print({s: {k: v for k, v in d.items() if k != "history"}
           for s, d in summary.items()})
    return summary


if __name__ == "__main__":
    main()
