"""Readings for the limits of a cell's comparison, on the chip, in one
process.

    python3 -m portbench.control --workload <cell> --seeds 11,12,...
        [--control-seeds 3] [--faults half] [--fault-seeds N] [--units 2]
        [--out FILE]

For each seed: the cell's set-up, ``--units`` units of its timed path,
then the numbers its check compares (``readings()``), printed as one JSON
line.  For the first ``--control-seeds`` seeds also the control's numbers
(the plain reference computed in float8 e4m3 in the program's place, the
precision below the configuration's bfloat16); for the first
``--fault-seeds`` seeds (as many as ``--control-seeds`` unless given)
each ``--faults`` planted in the reference put in the program's place
(training cells: ``half``, half of each batch's images left out).  The limit of each
number lies between the largest sound reading and the smallest of the
control's and the faults'.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import spec
from .reference.model import fp8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = cell["driver"].Driver(cell["config"], cell["traffic"], seed,
                                    "cuda", cell["limits"])
        drv.setup()
        for _ in range(args.units):
            drv.unit()
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"cell": args.workload, "seed": seed,
               "program": drv.readings(), "failed": drv.failed}
        if n < args.control_seeds:
            row["control_fp8"] = drv.readings(quant=fp8)
        fault_seeds = args.control_seeds if args.fault_seeds is None \
            else args.fault_seeds
        if n < fault_seeds:
            for fault in filter(None, args.faults.split(",")):
                row[f"fault_{fault}"] = drv.readings(fault=fault)
        row["seconds"] = time.perf_counter() - t0
        drv.close()
        del drv
        gc.collect()
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
