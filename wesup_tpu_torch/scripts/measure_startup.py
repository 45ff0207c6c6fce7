"""Seconds from the imports to a model ready to predict, in the entry
points that load a checkpoint.

Two start-ups, each timed ``--repeats`` times in one process after the
imports and a CUDA context are up (they are the same whatever the model
does):

  trainer  ``initialize_trainer("wesup")`` then ``load_checkpoint``, as
           ``infer.main``, ``pixel_infer.main``, ``test_glas`` and
           ``test_dp2019_pipeline`` start; ends with the weights on the
           device (``trainer.model``'s first parameter synchronised);
  server   ``serve.create_server(checkpoint=...)``, without a warm-up.

The checkpoint is a full-width (fc_width 1024) state written from the
imported package's ``WESUP`` under ``--root`` (a temporary directory by
default).

Usage:
    python -m wesup_tpu_torch.scripts.measure_startup [--repeats 5]
        [--root DIR] [--package-root DIR] [--device cpu]

``--package-root`` imports ``wesup_tpu_torch`` from another checkout (an
unpacked ``git archive`` of another commit), so that two versions are
timed by the same script.  It prints one JSON line per start-up and runs
on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def _time(fn, repeats, sync):
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--root", default=None)
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
        for name in [m for m in sys.modules if m.startswith("wesup_tpu_torch")]:
            del sys.modules[name]

    import torch

    import wesup_tpu_torch
    from wesup_tpu_torch import serve
    from wesup_tpu_torch.models import initialize_trainer, wesup

    dev = torch.device(args.device or "cuda")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    torch.zeros(1, device=dev)
    root = Path(args.root or tempfile.mkdtemp())
    root.mkdir(parents=True, exist_ok=True)
    ckpt = root / "checkpoints" / "ckpt.0001.pth"
    ckpt.parent.mkdir(exist_ok=True)
    state = wesup.WESUP(generator=torch.Generator().manual_seed(0))
    torch.save({"epoch": 1, "model_state_dict": state.state_dict()}, ckpt)
    want = state.classifier[0].bias.detach().clone()

    def trainer():
        t = initialize_trainer("wesup", device=args.device)
        t.load_checkpoint(ckpt)
        got = t.model.classifier[0].bias.detach().cpu()
        assert torch.equal(got, want), "checkpoint not loaded"

    def server():
        s = serve.create_server(checkpoint=str(ckpt), port=0,
                                device=args.device)
        s.server_close()

    where = str(Path(wesup_tpu_torch.__file__).parent)
    for name, fn in (("trainer", trainer), ("server", server)):
        secs = _time(fn, args.repeats, sync)
        print(json.dumps({"startup": name, "package": where,
                          "seconds": secs,
                          "median": sorted(secs)[len(secs) // 2]}),
              flush=True)


if __name__ == "__main__":
    main()
