"""GlaS test-set inference entry point of the port (parity with the
repository's test_glas.py): a checkpoint through multi-scale superpixel
inference over testA and testB.

Usage:
    python -m wesup_tpu_torch.test_glas -c <ckpt> [--data-root DIR]
        [--scales 0.6,0.55,0.5,0.45,0.4] [--input-size H,W] [-m wesup]
        [--device cpu]

Multi-scale runs write ``<record dir>/results-<n>scale/{testA,testB}/``,
fixed-size runs ``<record dir>/results/...``.  ``--data-root`` holds
``testA/`` and ``testB/`` (default ``~/data/GLAS_all``); ``--device``
as ``device=`` in ``infer.py``.
"""

import argparse
from pathlib import Path

from wesup_tpu_torch.infer import infer
from wesup_tpu_torch.models import initialize_trainer

DEFAULT_DATA_ROOT = Path.home() / "data" / "GLAS_all"
SPLITS = ("testA", "testB")


def test(ckpt_path, model_type="wesup", input_size=None, scales=(0.5,),
         data_root=None, **kwargs):
    """Returns the results directory."""
    ckpt_path = Path(ckpt_path)
    trainer = initialize_trainer(model_type, **kwargs)
    trainer.load_checkpoint(ckpt_path)

    # fixed-size runs land in results/, multi-scale in results-<n>scale/
    # (reference test_glas.py:22-27)
    record_dir = ckpt_path.parent.parent
    suffix = "" if input_size is not None else f"-{len(scales)}scale"
    results_dir = record_dir / f"results{suffix}"
    results_dir.mkdir(exist_ok=True)

    data_root = Path(data_root) if data_root else DEFAULT_DATA_ROOT
    for split in SPLITS:
        print(f"\nTesting on test set {split[-1]} ...")
        infer(trainer, data_root / split, results_dir / split,
              input_size=input_size, scales=scales)
    return results_dir


def _cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", default="wesup")
    parser.add_argument("--input-size")
    parser.add_argument("--scales", default="0.6,0.55,0.5,0.45,0.4")
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--data-root", default=None,
                        help="GlaS root with testA/ and testB/ "
                             "(default ~/data/GLAS_all)")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs on the host")
    args = parser.parse_args(argv)

    size = [int(s) for s in args.input_size.split(",")] \
        if args.input_size is not None else None
    return args, size, tuple(float(s) for s in args.scales.split(","))


def main(argv=None):
    args, input_size, scales = _cli(argv)
    return test(args.checkpoint, model_type=args.model, input_size=input_size,
                scales=scales, data_root=args.data_root, device=args.device)


if __name__ == "__main__":
    main()
