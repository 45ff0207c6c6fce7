"""Hyperparameter sweep over the hard quality protocol, on the card.

Port of ``scripts/quality_sweep.py``.  It runs ``python -m
wesup_tpu_torch.scripts.quality_protocol --hard`` once per config, one
after another (one training process at a time on the card), each with
``--reuse-record auto`` so that a config whose training finished skips
straight to the test protocol, and tabulates best-val/test Dice for the
method's own knobs (propagate_threshold, sp_area; reference
models/wesup.py:158-165).

The JAX script's ``wait_for_tpu`` probe, and the retries with smaller
inference chunks that followed it, are gone: they waited out a remote
TPU worker that restarted after a kernel fault.  A local CUDA card has
no such worker, so a failed config is recorded with its exit code and
the sweep goes on.

Its default ``--out`` lies outside ``artifacts/`` so that it never
overwrites the JAX package's record (``artifacts/qp_hard_sweep.json``):
``--root`` and ``--out`` default to the temporary directory (``$TMPDIR``),
and each config's summary is written beside ``--out``.

Usage:
    python -m wesup_tpu_torch.scripts.quality_sweep [--epochs 250]
        [--out F] [--device cpu]
        [--configs "propagate_threshold=0.6;propagate_threshold=0.7;..."]

Each config is a ';'-separated list of comma-separated key=value overrides.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

DEFAULT_CONFIGS = [
    "propagate_threshold=0.6",
    "propagate_threshold=0.7",
    "propagate_threshold=0.9",
    "sp_area=100",
    "sp_area=400",
]


def run_one(config: str, epochs: int, root: str, out_dir,
            device=None) -> dict:
    """One config's protocol summary; it is written in ``out_dir``."""
    tag = config.replace("=", "").replace(",", "_").replace(".", "")
    out = str(Path(out_dir) / f"torch_qp_sweep_{tag}.json")
    cmd = [sys.executable, "-m", "wesup_tpu_torch.scripts.quality_protocol",
           "--hard", "--epochs", str(epochs), "--root", root, "--out", out,
           "--reuse-record", "auto"]
    if device is not None:
        cmd += ["--device", device]
    for kv in config.split(","):
        cmd += ["--set", kv]
    print(f"[sweep] {config}: {' '.join(cmd)}", file=sys.stderr, flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    if proc.returncode != 0:
        print(proc.stdout[-2000:], file=sys.stderr)
        print(proc.stderr[-2000:], file=sys.stderr)
        return {"config": config, "error": proc.returncode}
    summary = json.loads(Path(out).read_text())
    summary["config"] = config
    summary["sweep_wall_s"] = round(time.time() - t0, 1)
    print(f"[sweep] {config}: best val {summary['best_val_dice']:.4f} "
          f"test Dice A/B "
          f"{summary['splits'].get('testA', {}).get('Dice', float('nan')):.4f}/"
          f"{summary['splits'].get('testB', {}).get('Dice', float('nan')):.4f} "
          f"({summary['sweep_wall_s']:.0f}s)", file=sys.stderr, flush=True)
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--configs", default=";".join(DEFAULT_CONFIGS))
    tmp = Path(tempfile.gettempdir())
    ap.add_argument("--root", default=str(tmp / "torch_quality_protocol_hard"))
    ap.add_argument("--out", default=str(tmp / "torch_qp_hard_sweep.json"))
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs on the host")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    results = []
    for config in args.configs.split(";"):
        config = config.strip()
        if not config:
            continue
        results.append(run_one(config, args.epochs, args.root,
                               Path(args.out).parent, args.device))
        # write the sweep after every run so that a crash loses nothing
        Path(args.out).write_text(json.dumps(
            {"epochs": args.epochs, "runs": results}, indent=2))
    print(json.dumps({"epochs": args.epochs, "runs": results}, indent=2))
    return results


if __name__ == "__main__":
    main()
