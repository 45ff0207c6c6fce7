"""The port's trainer on the JAX trainer's random streams.

The two packages draw their initial weights and their augmentation from
different generators (threefry keys against torch generators) by design,
so a run of each from one seed differs in both streams.  This script takes
them out of the comparison:

- ``dump`` (needs JAX; runs on the CPU) writes the JAX trainer's initial
  weights for ``--seed`` (as the port's state dict) and the augmentation
  parameters its train step draws for every (epoch, batch) of a run at
  batch size 1, to ``init.npz`` and ``draws.npz`` in ``--out``;
- ``train`` (needs no JAX) trains the port on a dataset from those weights
  with those draws and writes the run's ablation row
  (``quality_ablation.summarize``) and its history;
- ``protocol`` (needs no JAX) runs ``quality_protocol`` with those weights
  and draws and writes its summary.

What is left between such a run and the JAX run on the same data is the
arithmetic of the two devices.

Usage:
    python tests/jax_stream_replay.py dump --out DIR [--epochs 120]
        [--n-train 20] [--seed 0] [--masks] [--elastic-p 0.5]
    python tests/jax_stream_replay.py protocol --draws DIR [--init F]
        [quality_protocol's flags]
    python tests/jax_stream_replay.py train --draws DIR --data ROOT
        [--epochs 120] [--set key=value ...] [--device cpu] [--init F]
        [--hw 522 775] [--n-val 4] [--own-init] [--own-draws]
        [--out F.json]
"""

import argparse
import csv
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

APP_FIELDS = ("dh", "ds", "dv", "contrast", "brightness", "clahe", "blur")
AFF_FIELDS = ("hflip", "vflip", "ssr", "angle", "scale", "shift_x",
              "shift_y")
GRID = 8


def dump(out, epochs, n_batches, seed=0, masks=False, elastic_p=0.5):
    """Write ``init.npz`` and ``draws.npz`` for ``epochs`` epochs (indices
    0 to ``epochs``) of ``n_batches`` batches of one image."""
    import jax

    from wesup_tpu.config import WESUPConfig as JConfig
    from wesup_tpu.models import wesup as j_wesup
    from wesup_tpu_torch.models import convert
    from wesup_tpu_torch.models import steps as t_steps

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = JConfig(seed=seed)
    # the JAX trainer's initial weights (wesup_tpu/models/trainer.py)
    params = j_wesup.init_params(jax.random.PRNGKey(seed),
                                 n_classes=cfg.n_classes,
                                 D=cfg.sp_feature_dim, fc_width=cfg.fc_width)
    state = convert.from_jax_params(jax.tree.map(np.asarray, params))
    np.savez(out / "init.npz", **{k: np.asarray(v) for k, v in state.items()})

    app, pos = t_steps._aug_configs(not masks)
    u = jax.random.uniform

    def draw(key):
        # the train step's key chain and splits (wesup_tpu/models/steps.py
        # _batch_rng_key, step, _preprocess_sample; ops/augment.py)
        k_app, k_aff, k_el = jax.random.split(jax.random.split(key, 1)[0], 3)
        k_h, k_s, k_v, k_b, k_c, k_clahe, k_blur = jax.random.split(k_app, 7)
        a = (u(k_h, (), minval=-app.hue_shift_limit,
               maxval=app.hue_shift_limit) / 180.0,
             u(k_s, (), minval=-app.sat_shift_limit,
               maxval=app.sat_shift_limit) / 255.0,
             u(k_v, (), minval=-app.val_shift_limit,
               maxval=app.val_shift_limit) / 255.0,
             u(k_c, (), minval=-app.contrast_limit,
               maxval=app.contrast_limit),
             u(k_b, (), minval=-app.brightness_limit,
               maxval=app.brightness_limit),
             jax.random.bernoulli(k_clahe, app.clahe_p),
             jax.random.bernoulli(k_blur, app.blur_p))
        k_hf, k_vf, k_p, k_ang, k_sc, k_sx, k_sy = jax.random.split(k_aff, 7)
        f = (jax.random.bernoulli(k_hf, pos.hflip_p),
             jax.random.bernoulli(k_vf, pos.vflip_p),
             jax.random.bernoulli(k_p, pos.ssr_p),
             u(k_ang, (), minval=-pos.rotate_limit, maxval=pos.rotate_limit),
             u(k_sc, (), minval=-pos.scale_limit, maxval=pos.scale_limit),
             u(k_sx, (), minval=-pos.shift_limit, maxval=pos.shift_limit),
             u(k_sy, (), minval=-pos.shift_limit, maxval=pos.shift_limit))
        apply = jax.random.bernoulli(jax.random.fold_in(k_el, 0), elastic_p)
        noise = jax.random.normal(jax.random.split(k_el)[0], (GRID, GRID, 2))
        return a, f, apply, noise

    base = jax.random.PRNGKey(seed + 1)
    keys = [jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(base, e), 0), i)
        for e in range(epochs + 1) for i in range(n_batches)]
    a, f, apply, noise = jax.jit(jax.vmap(draw))(jax.numpy.stack(keys))
    shape = (epochs + 1, n_batches)
    arrays = {"point_mode": np.asarray(not masks),
              "apply": np.asarray(apply).reshape(shape),
              "noise": np.asarray(noise).reshape(shape + (GRID, GRID, 2))}
    for name, v in zip(APP_FIELDS + AFF_FIELDS, a + f):
        arrays[name] = np.asarray(v).reshape(shape)
    np.savez(out / "draws.npz", **arrays)
    return out


def replaying(draws):
    """Context that makes the port's train step apply ``draws`` (the
    arrays of ``draws.npz``) in place of its own."""
    from unittest import mock

    import torch

    from wesup_tpu_torch.models import steps
    from wesup_tpu_torch.ops import augment as aug

    def generator(rng, batch, phase, device):
        return steps._rng_idx(batch["rng_idx"])

    def sample(config, B, hw, point_mode, where, device):
        if B != 1 or bool(draws["point_mode"]) != point_mode:
            raise ValueError(f"the draws are for batch size 1 and "
                             f"point_mode={bool(draws['point_mode'])}")

        def col(name, dtype=torch.float32):
            return torch.tensor([draws[name][where]], dtype=dtype,
                                device=device)

        app = aug.AppearanceParams(
            *(col(n, torch.bool if n in ("clahe", "blur") else torch.float32)
              for n in APP_FIELDS))
        pos = aug.AffineDraws(
            *(col(n, torch.bool if n in ("hflip", "vflip", "ssr")
                  else torch.float32) for n in AFF_FIELDS))
        elastic = None
        if not point_mode and config.elastic_p > 0:
            H, W = hw
            noise = torch.from_numpy(draws["noise"][where][None]).to(device)
            elastic = aug.ElasticParams(col("apply", torch.bool),
                                        noise * 34.0 / max(H, W) * min(H, W))
        return steps.AugParams(app, aug.random_affine(pos, hw), elastic)

    return mock.patch.multiple(steps, batch_generator=generator,
                               sample_augmentation=sample)


def train(draws_dir, data, epochs, overrides, device=None, init=None,
          hw=(522, 775), n_val=4, own_init=False, own_draws=False):
    """The ablation row of a port run on the dumped weights (``init``, by
    default ``init.npz`` beside the draws) and draws, with its
    ``history.csv`` rows under ``history`` and, on the card, ``card``.
    ``own_init`` keeps the port's own initial weights and ``own_draws``
    its own augmentation draws, so that each stream can be swapped alone.
    Without ``data/train/images`` it first makes the dataset as
    ``quality_ablation`` does (seed 0, ``hw``, ``n_val``, one train image
    per batch of the draws, points in point mode).  ``overrides`` go to
    the config (``seed`` 0 unless they set it: the data order and the
    port's own streams follow it)."""
    import contextlib
    import time

    import torch

    from wesup_tpu_torch.models import initialize_trainer
    from wesup_tpu_torch.scripts.make_dataset import make_dataset
    from wesup_tpu_torch.scripts.quality_ablation import summarize
    from wesup_tpu_torch.scripts.quality_protocol import card_line

    draws_dir = Path(draws_dir)
    draws = dict(np.load(draws_dir / "draws.npz"))
    init = None if own_init else np.load(init or draws_dir / "init.npz")
    if not (Path(data) / "train" / "images").exists():
        make_dataset(data, n_train=draws["apply"].shape[1], n_val=n_val,
                     hw=tuple(hw), seed=0,
                     with_points=bool(draws["point_mode"]))
    with tempfile.TemporaryDirectory(prefix="jax_stream_replay_") as tmp:
        old_root = os.environ.get("RECORD_ROOT")
        os.environ["RECORD_ROOT"] = tmp
        try:
            t0 = time.time()
            kwargs = dict(epochs=epochs, seed=0, checkpoint_period=0)
            kwargs.update(overrides)
            trainer = initialize_trainer("wesup", device=device, **kwargs)
            if init is not None:
                trainer.load_state_dict({"model_state_dict": {
                    k: torch.from_numpy(v) for k, v in init.items()}})
            with (contextlib.nullcontext() if own_draws
                  else replaying(draws)):
                trainer.train(str(data), epochs=epochs)
            history = trainer.record_dir / "history.csv"
            row = summarize("replay", history, round(time.time() - t0, 1))
            if trainer.device.type == "cuda":
                row["card"] = card_line()
            with open(history, newline="") as fp:
                row["history"] = [{k: float(v) for k, v in r.items()}
                                  for r in csv.DictReader(fp)]
        finally:
            if old_root is None:
                os.environ.pop("RECORD_ROOT", None)
            else:
                os.environ["RECORD_ROOT"] = old_root
    return row


def protocol(draws_dir, argv, init=None):
    """``quality_protocol`` (its flags in ``argv``) on the dumped weights
    (``init``, by default ``init.npz`` beside the draws) and draws; the
    summary is written to its ``--out`` and returned."""
    from unittest import mock

    import torch

    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.scripts import quality_protocol as qp

    draws_dir = Path(draws_dir)
    draws = dict(np.load(draws_dir / "draws.npz"))
    state = {k: torch.from_numpy(v)
             for k, v in np.load(init or draws_dir / "init.npz").items()}

    def reset_parameters(model, generator):
        model.load_state_dict(state)

    args = qp.parse_args(argv)
    with mock.patch.object(wesup.WESUP, "reset_parameters",
                           reset_parameters), replaying(draws):
        summary, _ = qp.run(args)
    Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", required=True)
    d.add_argument("--epochs", type=int, default=120)
    d.add_argument("--n-train", type=int, default=20)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--masks", action="store_true")
    d.add_argument("--elastic-p", type=float, default=0.5)
    t = sub.add_parser("train")
    t.add_argument("--draws", required=True)
    t.add_argument("--data", required=True)
    t.add_argument("--epochs", type=int, default=120)
    t.add_argument("--set", action="append", default=[],
                   help="config override, e.g. --set elastic_p=0.0")
    t.add_argument("--device", default=None)
    t.add_argument("--init", default=None,
                   help="init.npz of the weights (default: beside the draws)")
    t.add_argument("--hw", type=int, nargs=2, default=(522, 775))
    t.add_argument("--n-val", type=int, default=4)
    t.add_argument("--own-init", action="store_true",
                   help="the port's own initial weights")
    t.add_argument("--own-draws", action="store_true",
                   help="the port's own augmentation draws")
    t.add_argument("--out", default=None)
    q = sub.add_parser("protocol", help="quality_protocol on the dumped "
                       "streams; other flags go to quality_protocol")
    q.add_argument("--draws", required=True)
    q.add_argument("--init", default=None)
    args, rest = ap.parse_known_args(argv)
    if args.cmd == "protocol":
        return protocol(args.draws, rest, args.init)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd == "dump":
        import jax

        jax.config.update("jax_platforms", "cpu")
        dump(args.out, args.epochs, args.n_train, args.seed, args.masks,
             args.elastic_p)
        return None
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)
    row = train(args.draws, args.data, args.epochs, overrides, args.device,
                args.init, args.hw, args.n_val, args.own_init,
                args.own_draws)
    print(json.dumps({k: v for k, v in row.items() if k != "history"}))
    if args.out:
        Path(args.out).write_text(json.dumps(row, indent=1))
    return row


if __name__ == "__main__":
    main()
