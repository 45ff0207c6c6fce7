#!/usr/bin/env python3
"""Time kernels K1, K2, K3, K4, K6 and K8 at the main-path shapes, to
compare two trees of the port on one card.

    python3 kernel_times.py [--repo DIR] [--label NAME] [--check FILE]

``DIR`` holds a ``wesup_tpu_torch/`` package (a checkout, or an unpacked
``git archive`` of another commit); the default is this checkout.  On
bench.py's images (B=8, 288x416, SLIC seg, WESUPConfig defaults, bf16) it
times K1 (``cell_pool0``, C=128), K3 (``cell_pool0_bwd``, C=128 and
C=1024, beside a ``zero_()`` of its output: the card's plain store rate)
and, per stage 1-4, K2
(``cell_pool_stage``), K4 (``cell_pool_stage_bwd``, its cast of dsums to
bf16 included), K6 (``adjoint_pool_stage``) and K8
(``adjoint_pool_stage_bwd``, beside a ``zero_()`` of its output) as the
mean of 20 launches between CUDA events, after 3 warm-up launches
(``chip_smoke.cuda_ms``), and the host's time to launch one call of each
wrapper, and prints one JSON line with the card's name and power limit.
A tree without K8 reports none.  To compare two trees, run them in turns
in one call on one card: parent, change, change, parent.

With ``--check FILE`` it also runs K1, K3 (C=128 and C=1024), K4, K5
(C=128 and C=1024), K6 and K8 (every stage), in bf16 and f32, on one set
of inputs: the first tree to run saves the inputs and its outputs (K3's,
K5's, K6's and K8's as the SHA-256 of their bytes) to FILE, and each later
tree prints whether its outputs equal them bitwise (``"bitwise"`` in the
JSON line; ``"absent"`` for a kernel the tree does not have, whose output
the first tree that has it saves).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke


def host_ms(torch, fn, n=20) -> float:
    """Host milliseconds per call of ``fn``, taken while the card spins so
    that no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def digest(torch, t) -> str:
    """SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          ).hexdigest()


STAGE_C = {1: 256, 2: 768, 3: 1536, 4: 1536}


def check_outputs(torch, path: Path, plan, seg, valid, gen) -> dict:
    """K1's, K3's, K4's, K5's, K6's and K8's outputs on the inputs saved in
    ``path`` (made and saved, with these outputs, when it does not exist
    yet): per output, whether it equals the saved one bitwise."""
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.ops import adjoint, cellgrid, cellpool, pooling
    from wesup_tpu_torch.ops.resize import _interp_matrix

    H, W = plan.H, plan.W
    K = plan.n_clusters
    saved = torch.load(path) if path.exists() else None
    if saved is None:
        B, dev = seg.shape[0], seg.device
        inputs = {"seg": seg, "valid": valid, "taps0": torch.randn(
            seg.shape + (128,), generator=gen, device=dev)}
        for C in (128, 1024):
            inputs[f"dsums0 {C}"] = torch.randn((B, K, C), generator=gen,
                                                device=dev)
            inputs[f"feat5 {C}"] = torch.randn((B, H * W, C), generator=gen,
                                               device=dev)
        for s, C in STAGE_C.items():
            inputs[f"dsums{s}"] = torch.randn((B, K, C), generator=gen,
                                              device=dev)
            inputs[f"taps6 {s}"] = torch.randn((B, H >> s, W >> s, C),
                                               generator=gen, device=dev)
            inputs[f"dsums8 {s}"] = torch.randn((B, K, C), generator=gen,
                                                device=dev)
    else:
        inputs = saved["inputs"]
    seg, valid = inputs["seg"], inputs["valid"]
    seg_m = torch.where(valid, seg, -1).contiguous()
    seg_p = seg_m.reshape(seg_m.shape[0], H * W)
    has_k8 = hasattr(adjoint, "adjoint_pool_stage_bwd")
    outs, digests = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        outs[f"k1 {dt}"] = cellpool.cell_pool0(plan, seg_m,
                                               inputs["taps0"].to(dt))
        for C in (128, 1024):
            digests[f"k3 C={C} {dt}"] = digest(torch, cellpool.cell_pool0_bwd(
                plan, seg_m, inputs[f"dsums0 {C}"], dt))
            digests[f"k5 C={C} {dt}"] = digest(torch, pooling.segment_sum(
                seg_p, inputs[f"feat5 {C}"].to(dt), K))
        e9 = cellgrid.offset_masks(plan, seg, valid, dt)
        for s in range(1, 5):
            spp = cellgrid.make_stage_pool_plan(plan, H >> s, W >> s, True)
            mc = cellgrid.stage_window_weights(spp, e9)
            outs[f"k4 stage {s} {dt}"] = cellpool.cell_pool_stage_bwd(
                spp, mc, inputs[f"dsums{s}"])
            A_wT = torch.from_numpy(_interp_matrix(W >> s, W, True)).t()
            tapsH_T = wesup._upsample_h(inputs[f"taps6 {s}"].to(dt),
                                        H).permute(0, 3, 1, 2)
            digests[f"k6 stage {s} {dt}"] = digest(
                torch, adjoint.adjoint_pool_stage(seg_m, tapsH_T, A_wT, K))
            digests[f"k8 stage {s} {dt}"] = digest(
                torch, adjoint.adjoint_pool_stage_bwd(
                    seg_m, inputs[f"dsums8 {s}"], A_wT, K, dt)
            ) if has_k8 else "absent"
    torch.cuda.synchronize()
    if saved is None:
        torch.save({"inputs": inputs, "outs": outs, "digests": digests}, path)
        return {key: "saved" for key in [*outs, *digests]}
    same = {key: bool(torch.equal(got, saved["outs"][key]))
            for key, got in outs.items()}
    fresh = False
    for key, got in digests.items():
        want = saved["digests"].get(key, "absent")
        if want == "absent" and got != "absent":
            # the first tree that has this kernel saves its output
            saved["digests"][key] = got
            fresh = True
        same[key] = ("absent" if got == "absent"
                     else "saved" if want == "absent" else got == want)
    if fresh:
        torch.save(saved, path)
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--check", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.ops import adjoint, cellgrid, cellpool, pooling
    from wesup_tpu_torch.ops.resize import _interp_matrix
    from wesup_tpu_torch.ops.slic import make_plan, slic

    dev = torch.device("cuda")
    config = WESUPConfig()
    H, W = chip_smoke.CANVAS
    B = chip_smoke.BATCH
    plan = make_plan(H, W, config.sp_area)
    K = plan.n_clusters
    imgs_u8, valid_np = chip_smoke.bench_images(B)
    imgs = torch.from_numpy(imgs_u8).to(dev).float() / 255.0
    valid = torch.from_numpy(valid_np).to(dev)
    seg = slic(imgs, valid, sp_area=config.sp_area,
               compactness=config.sp_compactness, n_iters=config.slic_iters,
               update_stride=config.slic_update_stride)
    seg_m = torch.where(valid, seg, -1).contiguous()
    cd = torch.bfloat16
    e9 = cellgrid.offset_masks(plan, seg, valid, cd)
    lists = pooling.segment_lists(seg_m, K)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"label": args.label, "card": chip_smoke.card_line()}
    if args.check is not None:
        gen7 = torch.Generator(device=dev).manual_seed(7)
        out["bitwise"] = check_outputs(torch, args.check, plan, seg, valid,
                                       gen7)
    has_k8 = hasattr(adjoint, "adjoint_pool_stage_bwd")
    names = ("k2", "k4", "k6") + (("k8",) if has_k8 else ())
    for name in names:
        out[f"{name}_ms"], out[f"{name}_host_ms"] = {}, {}
    if has_k8:
        out["k8_zero_ms"] = {}

    taps0 = torch.randn((B, H, W, 128), generator=gen, device=dev).to(cd)
    k1 = lambda: cellpool.cell_pool0(plan, seg_m, taps0)  # noqa: E731
    out["k1_ms"] = chip_smoke.cuda_ms(torch, k1)
    out["k1_host_ms"] = host_ms(torch, k1)
    del taps0
    for C in (128, 1024):
        dsums = torch.randn((B, K, C), generator=gen, device=dev)

        def k3():
            return cellpool.cell_pool0_bwd(plan, seg_m, dsums, cd)

        out[f"k3_ms C={C}"] = chip_smoke.cuda_ms(torch, k3)
        out[f"k3_host_ms C={C}"] = host_ms(torch, k3)
        dtaps = k3()
        out[f"k3_zero_ms C={C}"] = chip_smoke.cuda_ms(torch, dtaps.zero_)
        del dsums, dtaps
    for s, C in STAGE_C.items():
        Hs, Ws = H >> s, W >> s
        spp = cellgrid.make_stage_pool_plan(plan, Hs, Ws, True)
        mc = cellgrid.stage_window_weights(spp, e9)
        taps = torch.randn((B, Hs, Ws, C), generator=gen, device=dev).to(cd)
        dsums = torch.randn((B, K, C), generator=gen, device=dev)
        tapsH_T = wesup._upsample_h(taps, H).permute(0, 3, 1, 2)
        A_wT = torch.from_numpy(_interp_matrix(Ws, W, True)).t()
        table = adjoint.column_table(A_wT, cd, dev)
        fns = [("k2", lambda: cellpool.cell_pool_stage(spp, mc, taps)),
               ("k4", lambda: cellpool.cell_pool_stage_bwd(spp, mc, dsums)),
               ("k6", lambda: adjoint.adjoint_pool_stage(
                   seg_m, tapsH_T, A_wT, K, lists, table))]
        if has_k8:
            fns.append(("k8", lambda: adjoint.adjoint_pool_stage_bwd(
                seg_m, dsums, A_wT, K, cd, table)))
        for name, fn in fns:
            out[f"{name}_ms"][s] = chip_smoke.cuda_ms(torch, fn)
            out[f"{name}_host_ms"][s] = host_ms(torch, fn)
        if has_k8:
            dtaps = fns[-1][1]()
            out["k8_zero_ms"][s] = chip_smoke.cuda_ms(torch, dtaps.zero_)
            del dtaps
        del mc, taps, dsums, tapsH_T
    for name in names:
        out[f"{name}_total_ms"] = float(np.sum(list(
            out[f"{name}_ms"].values())))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
