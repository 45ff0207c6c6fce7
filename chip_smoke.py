#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wesup_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (a failed phase is a non-zero exit):

1. build the CUDA kernels from ``wesup_tpu_torch/csrc`` with nvcc;
2. hold K1 (``cell_pool0``) against its plain version at the main-path
   shape (8, 288, 416, 128), in bf16 and f32;
3. hold K2 (``cell_pool_stage``) against its plain version at the four
   downsampled stages' shapes, in bf16 and f32;
4. forward parity: the superpixel forward at f32 on the card (kernels) and
   on the CPU (plain versions), same weights and seg;
5. the main path: ``make_predict_step`` at B=8 on the 288x416 canvas in
   bf16 with full-width WESUP, launch counts per step, step time and a
   per-phase breakdown from CUDA events;
6. serving: a ``Predictor`` answering GlaS-sized requests at scale 0.5,
   and the HTTP server's health endpoint;
7. per-kernel times against the plain version, a library call and the
   card's bound (for K1 and K2 also the achieved share of the HBM rate);
8. training: K3 (``cell_pool0_bwd``) and K4 (``cell_pool_stage_bwd``)
   against their plain versions at the main-path shapes (K3 also at
   C = 1024, the width of fullres training's K5 backward); one f32
   forward + backward on the card against the CPU; SLIC on the card
   against the CPU at 288x416; ``make_train_step`` at B=8 on the 288x416
   canvas in bf16 with full-width WESUP (point supervision), launch counts
   per step, step time, peak memory, a per-phase breakdown and a profiler
   window; two mask-supervised steps (elastic path); K3/K4 times (K3 at
   C = 128 and C = 1024, K4 per stage and over stages 1-4, each with its
   share of the HBM rate; K4's also with the bytes of dsums rows its
   stream re-reads, and their rate);
9. the adjoint, fullres and fused-pool paths: K5 (``segment_sum``), K6
   (``adjoint_pool_stage``) and K7 (``fused_relu_pool_pad``, and its
   gradient) against their plain versions at the main-path shapes; the f32
   forward on the card against the CPU for ``pooling="adjoint"`` with and
   without a plan, ``"fullres"`` and ``"local"`` under
   ``WESUP_FUSED_POOL1=1``; ``make_predict_step`` at B=8 on the 288x416
   canvas in bf16 for each of them beside phase 5's step, with launch
   counts, step times and per-phase breakdowns; one gated bf16 train step;
   K5/K6/K7 times against their plain versions, a library call and the
   bound; K6 beside two ``bmm``s, of the dense P (B, K, H * Ws) by its own
   input tapsH (the library time in the JSON line) and of JAX's dense M by
   the native-resolution stage taps, and its share of the HBM rate;
10. training through the adjoint and fullres pools: K8
   (``adjoint_pool_stage_bwd``, K6's backward) against its plain version
   at the four stage shapes and ``segment_sum_bwd`` (K5's backward, on
   K3's kernel) against the plain gather at C = 128 and C = 1024, in bf16
   and f32; one f32 forward + backward on the card against the CPU for
   ``pooling="adjoint"`` (with a plan) and ``"fullres"``;
   ``make_train_step`` at B=8 on the 288x416 canvas in bf16 with
   full-width WESUP (point supervision) through each, with launch counts
   per step, step time, peak memory, a per-phase breakdown and a profiler
   window; K8's and ``segment_sum_bwd``'s times against their plain
   versions, a ``bmm`` and the bound, with their share of the HBM rate;
11. training from a dataset directory: a synthetic GlaS-shaped dataset
   (85 train and 8 val 522x775 PNGs whose rows cycle through the five
   filters, masks, point CSVs; made from ``--seed``) trained by
   ``wesup_tpu_torch.train.fit`` at full width for 2 epochs at B=8 with
   the defaults (device resize, bucketed canvases), then resumed for 1
   epoch from ``ckpt.0002.pth``: every batch of every phase stepped and
   none raised or logged an error, epoch numbering, latest-only
   retention, 3 history rows and the per-batch generator seeds of all
   three epochs in a straight schedule's order; decode ms, epoch seconds
   (the trainer's ``phase_stats``), epoch 2's img/s against the step-only
   rate, val seconds, bytes per batch (device against host resize), the
   device resize's time and its bitwise equality with the CPU, launches
   per train step (K1-K4), device busy share over epoch 3 (the trainer's
   ``profile_dir`` trace), peak memory; one bucketed train step's K1-K4
   outputs against their plain versions on the step's own inputs;
12. the pixel head and inference: the f32 pixel forward on the card
   against the CPU (full width, 2x96x128); ``make_predict_step(...,
   "pixel")`` at B=8 on the 288x416 canvas in bf16, with no kernel launched
   per step, and under ``WESUP_FUSED_POOL1=1`` with K7 once (on the step's
   own input bitwise its plain version; the probabilities within 3e-2 of
   the ungated step's), step times in two rounds, img/s, peak memory,
   breakdowns (backbone, proj, upsample, head) and the device busy share;
   the five CLIs (``test_glas`` at its five scales, ``infer_tile`` at
   patch 464, ``pixel_infer`` at 0.5, ``pixel_infer_tile`` at patch 400)
   from a random-weight ``.pth`` on a synthetic GlaS-shaped test set
   (testA and testB of 8 522x775 BMPs each, made from ``--seed``): every
   mask written with the right name, format and shape in {0, 255}, ms per
   image, K1 once and K2 four times per superpixel forward (the first
   forward's K1/K2 held against their plain versions on its inputs) and no
   kernel in the pixel CLIs; ``POST /predict`` of a PNG to a superpixel and
   a pixel server, which must answer with masks (and a JPEG with 400).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the line before that the
kernels' JSON.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent

# main-path shapes: GlaS 775x522 images at scale 0.5 -> 261x388 content on
# a 288x416 canvas, batch 8
CANVAS = (288, 416)
CONTENT = (261, 388)
BATCH = 8
GLAS_HW = (522, 775)
METRIC = "GlaS 0.5x superpixel inference (SLIC+VGG16+aggregation fused)"

# NVIDIA H100 SXM data sheet: HBM rate, and the peak operation rate for
# each input type (f32 outside the tensor cores, dense bf16 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bench_images(batch, seed=0):
    """bench.py's inputs: normal(200, 25) uint8 on the canvas, 261x388 valid."""
    rng = np.random.default_rng(seed)
    imgs = np.clip(rng.normal(200, 25, (batch,) + CANVAS + (3,)), 0,
                   255).astype(np.uint8)
    valid = np.zeros((batch,) + CANVAS, bool)
    valid[:, :CONTENT[0], :CONTENT[1]] = True
    return imgs, valid


def cuda_ms(torch, fn, n=20, warmup=3):
    """Mean device milliseconds per call of ``fn`` over ``n`` calls.

    The calls are queued behind a spin of the card (about 10 ms), so the
    events time the card's work and not the host's launch rate: a wrapper
    can take longer on the host than its kernel on the card (K2 at stages
    3-4 does), and the card would idle between back-to-back calls.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float, dtype):
    """(least milliseconds, what bounds it) for moving ``nbytes`` and
    doing ``flops`` operations on inputs of ``dtype`` on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(nbytes: float, ms: float) -> str:
    """The achieved byte rate of a call and its share of the card's peak."""
    rate = nbytes / (ms * 1e-3)
    return (f"{rate / 1e12:.3f} TB/s, {rate / HBM_BYTES_PER_S:.3f} of the "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s bound")


class PhaseTimer:
    """``mark(name)`` callback recording a CUDA event after each phase."""

    def __init__(self, torch):
        self.torch = torch
        self.events = []

    def start(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events = [("start", ev)]

    def __call__(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def durations(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def device_busy(prof):
    """(kernel records, busy us, span us) of a profiler window: the span
    runs from the first kernel's start to the last one's end."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return kern, 0.0, 0.0
    busy = sum(e.time_range.elapsed_us() for e in kern)
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    return kern, busy, span


def profile_steps(torch, run_step, n=5, top=12, tag="profile") -> None:
    """Device busy share and top kernels over ``n`` steps, from the
    profiler's kernel records (the span runs from the first kernel's start
    to the last one's end; host work under the profiler is slower than
    without it, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
    kern, busy, span = device_busy(prof)
    if not kern:
        log(f"[{tag}] no device kernels recorded: busy share not measured")
        return
    log(f"[{tag}] {n} steps: {len(kern) / n:.0f} kernels/step, device busy "
        f"{busy / n / 1e3:.3f} ms/step of a {span / n / 1e3:.3f} ms/step "
        f"span, idle share {1 - busy / span:.3f}")
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[{tag}]   {us / n / 1e3:8.3f} ms/step  {name[:110]}")


def train_batch(batch, point_mode=True):
    """A train batch on bench.py's images: a checkerboard of 32-pixel class
    squares inside the content (-1 outside) and, with point supervision,
    the first 32 of 256 point slots valid, at positions drawn inside the
    content and labelled with the mask's class there."""
    n_slots, n_valid = 256, 32
    imgs, valid = bench_images(batch)
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:CANVAS[0], :CANVAS[1]]
    mask = np.where(valid, (yy // 32 + xx // 32) % 2, -1).astype(np.int32)
    points = np.zeros((batch, n_slots, 3), np.int32)
    point_valid = np.zeros((batch, n_slots), bool)
    if point_mode:
        xs = rng.integers(0, CONTENT[1], (batch, n_valid))
        ys = rng.integers(0, CONTENT[0], (batch, n_valid))
        # every image has the same mask
        points[:, :n_valid] = np.stack([xs, ys, mask[0][ys, xs]], -1)
        point_valid[:, :n_valid] = True
    return {"image": imgs, "valid": valid, "pixel_mask": mask,
            "points": points, "point_valid": point_valid,
            "use_mask_as_points": np.zeros((batch,), bool),
            "sample_valid": np.ones((batch,), bool)}


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(2.0 ** -126))) - 7)


def train_phase(torch, card, imgs, valid, seg, seg_m, gen) -> list:
    """Phase 8: the train path.  Returns the K3 and K4 entries of the
    kernels' JSON line."""
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import steps, wesup
    from wesup_tpu_torch.ops import cellgrid, cellpool
    from wesup_tpu_torch.ops.slic import make_plan, slic

    dev = torch.device("cuda")
    config = WESUPConfig()
    H, W = CANVAS
    plan = make_plan(H, W, config.sp_area)
    K = plan.n_clusters
    stage_c = {1: 256, 2: 768, 3: 1536, 4: 1536}
    stage_hw = {s: (H >> s, W >> s) for s in stage_c}
    errs = {}

    # ---- 8a. K3 / K4 against their plain versions ------------------------
    # K3 at the main path's C = 128 and at C = 1024, the width at which
    # fullres training will call it as K5's backward
    C0 = 128
    for C in (C0, 1024):
        for dt in (torch.bfloat16, torch.float32):
            dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
            got = cellpool.cell_pool0_bwd(plan, seg_m, dsums, dt)
            want = cellpool.cell_pool0_bwd_plain(plan, seg_m, dsums, dt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            log(f"[K3] {tuple(got.shape)} {dt}: max_abs_err {err:.3e} "
                f"(limit 0: a pure selection)")
            if not torch.equal(got, want):
                fail(f"K3 disagrees with its plain version at C={C}, {dt}")
            errs[("K3", C, dt)] = err
            del dsums, got, want
    e9 = {dt: cellgrid.offset_masks(plan, seg, valid, dt)
          for dt in (torch.bfloat16, torch.float32)}
    for s, C in stage_c.items():
        spp = cellgrid.make_stage_pool_plan(plan, *stage_hw[s], True)
        for dt in (torch.bfloat16, torch.float32):
            mc = cellgrid.stage_window_weights(spp, e9[dt])
            dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
            got = cellpool.cell_pool_stage_bwd(spp, mc, dsums)
            want = cellpool.cell_pool_stage_bwd_plain(spp, mc, dsums, dt)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if dt == torch.float32:
                lim = 1e-5 * max(1.0, want.abs().max().item())
                ok = err <= lim
                what = f"limit {lim:.3e}"
            else:
                # the two f32 sums differ by their order (1e-5 of the sum
                # of |terms|), then each rounds to bf16 (one ulp)
                mass = cellpool.cell_pool_stage_bwd_plain(
                    spp, mc.abs(), dsums.abs(), torch.float32)
                ulp = bf16_ulp(torch, want)
                ok = bool((diff <= ulp + 1e-5 * mass).all())
                beyond = (diff > ulp).float().mean().item()
                what = ("limit one bf16 ulp + 1e-5 of the sum of |terms|; "
                        f"{beyond:.2e} of the values beyond one ulp")
                del mass, ulp
            log(f"[K4] stage {s} {tuple(got.shape)} {dt}: max_abs_err "
                f"{err:.3e} ({what})")
            if not ok:
                fail(f"K4 disagrees with its plain version at stage {s}, "
                     f"{dt}")
            errs[("K4", s, dt)] = err
            del mc, dsums, got, want, diff
    del e9

    # ---- 8b. one f32 train step's gradients: card vs CPU -----------------
    tb = parity_train_batch(torch)
    ph, pw = tb["image"].shape[1:3]
    pplan = make_plan(ph, pw, config.sp_area)
    cfg32 = WESUPConfig(compute_dtype="float32")
    prep = steps._preprocess_sample(
        None, tb["image"], tb["valid"], tb["pixel_mask"], tb["points"],
        tb["point_valid"], tb["use_mask_as_points"], config=cfg32,
        train=False, point_mode=True)
    res = {}
    for d in ("cpu", "cuda"):
        model = wesup.WESUP(generator=torch.Generator().manual_seed(3)).to(d)
        p = steps.Preprocessed(*(t.to(d) for t in prep))
        cellpool.reset_launches()
        loss, _ = steps._forward_and_loss(model, p, pplan.n_clusters, cfg32,
                                          tb["sample_valid"].to(d), pplan)
        loss.backward()
        if d == "cuda":
            torch.cuda.synchronize()
            bwd = dict(cellpool.LAUNCHES)
        res[d] = (loss.item(), {n: q.grad.cpu()
                                for n, q in model.named_parameters()})
        del model
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    worst = {"backbone": 0.0, "rest": 0.0}
    for name, want in res["cpu"][1].items():
        group = "backbone" if name.startswith("backbone.") else "rest"
        rel = ((res["cuda"][1][name] - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        worst[group] = max(worst[group], rel)
    log(f"[train f32 {ph}x{pw}] loss {res['cuda'][0]:.6f} (card) vs "
        f"{res['cpu'][0]:.6f} (CPU), rel err {loss_err:.2e} (limit 1e-4); "
        f"largest grad error / the tensor's max |grad|: backbone "
        f"{worst['backbone']:.2e} (limit 1e-2), rest {worst['rest']:.2e} "
        f"(limit 1e-3); launches {bwd}")
    if not (loss_err <= 1e-4 and worst["backbone"] <= 1e-2
            and worst["rest"] <= 1e-3):
        fail("the f32 train step on the card disagrees with the CPU")
    if bwd["cell_pool0_bwd"] != 1 or bwd["cell_pool_stage_bwd"] != 4:
        fail(f"the f32 backward did not run K3 once and K4 four times: {bwd}")
    del res, prep

    # ---- 8c. SLIC: card vs CPU at 288x416 --------------------------------
    seg_cpu = slic(imgs.cpu(), valid.cpu(), sp_area=config.sp_area,
                   compactness=config.sp_compactness,
                   n_iters=config.slic_iters,
                   update_stride=config.slic_update_stride)
    same = (seg.cpu() == seg_cpu).float().mean().item()
    log(f"[slic] card vs CPU at B={BATCH} {H}x{W} (bench images): "
        f"{same:.6f} of the seg pixels equal")

    # ---- 8d. the train path at full width --------------------------------
    model = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(dev)
    optimizer = steps.make_optimizer(config, model)
    step = steps.make_train_step(config, CANVAS, point_mode=True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(BATCH).items()}
    tgen = torch.Generator(device=dev).manual_seed(7)
    acc = steps.init_metric_acc()
    for _ in range(3):
        acc = step(model, optimizer, acc, batch, tgen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cellpool.reset_launches()
    acc = step(model, optimizer, acc, batch, tgen)
    torch.cuda.synchronize()
    launches = dict(cellpool.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] launches in one step: {launches}")
    if launches != {"cell_pool0": 1, "cell_pool_stage": 4,
                    "cell_pool0_bwd": 1, "cell_pool_stage_bwd": 4}:
        fail(f"expected K1, K3 once and K2, K4 four times per train step, "
             f"got {launches}")
    step_ms = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        acc = step(model, optimizer, acc, batch, tgen)
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    ms = statistics.median(step_ms)
    log(f"[train] train step, WESUPConfig defaults, point supervision: "
        f"{ms:.3f} ms/step, {BATCH / ms * 1e3:.2f} img/s (B={BATCH}, "
        f"{H}x{W}, bf16, median of {len(step_ms)}; min {min(step_ms):.3f} "
        f"max {max(step_ms):.3f}; peak {peak_gb:.2f} GiB; {card})")
    timer = PhaseTimer(torch)
    phases = []
    for _ in range(10):
        timer.start()
        acc = step(model, optimizer, acc, batch, tgen, mark=timer)
        phases.append(timer.durations())
    breakdown = {k: statistics.median(p[k] for p in phases)
                 for k in phases[0]}
    log("[train] breakdown (median ms of 10 marked steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in breakdown.items())
        + f"; sum {sum(breakdown.values()):.3f}")
    holder = [acc]

    def run_step():
        holder[0] = step(model, optimizer, holder[0], batch, tgen)

    profile_steps(torch, run_step)
    acc = holder[0]
    count = acc["count"].item()
    means = {k: v.item() / count for k, v in acc["sums"].items()}
    log(f"[train] metric means over {count:.0f} images: " + ", ".join(
        f"{k} {v:.4f}" for k, v in means.items()))
    if acc["nan"].item() or not all(np.isfinite(v) for v in means.values()):
        fail("the train step's metrics are not finite")
    if not all(torch.isfinite(q).all() for q in model.parameters()):
        fail("the weights are not finite after training")

    # ---- 8e. two mask-supervised steps (elastic path) --------------------
    mstep = steps.make_train_step(config, CANVAS, point_mode=False)
    mbatch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(
        BATCH, point_mode=False).items()}
    macc = steps.init_metric_acc()
    torch.cuda.reset_peak_memory_stats()
    cellpool.reset_launches()
    t0 = time.perf_counter()
    for _ in range(2):
        macc = mstep(model, optimizer, macc, mbatch, tgen)
    torch.cuda.synchronize()
    mlaunch = dict(cellpool.LAUNCHES)
    log(f"[train mask] 2 steps in {(time.perf_counter() - t0) * 1e3:.1f} ms "
        f"(the first includes its set-up); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{mlaunch}; loss mean {macc['sums']['loss'].item() / 2 / BATCH:.4f}")
    if macc["nan"].item() or mlaunch["cell_pool_stage_bwd"] != 8:
        fail("the mask-supervised train steps")
    del model, optimizer, step, mstep, batch, mbatch
    torch.cuda.empty_cache()

    # ---- 8f. K3 / K4 times at the main-path shapes -----------------------
    # K3 at C = 128 (the train step's) and C = 1024 (fullres training's K5
    # backward, through the same wrapper and plan); the bmm yardstick is
    # the one-hot by the bf16 dsums
    cd = torch.bfloat16
    out = []
    oh = (seg_m[..., None] == torch.arange(K, device=dev, dtype=seg_m.dtype)
          ).to(cd).reshape(BATCH, H * W, K)                     # (B, HW, K)
    k3 = {}
    for C in (C0, 1024):
        dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
        ds_cd = dsums.to(cd)
        t_k = cuda_ms(torch, lambda: cellpool.cell_pool0_bwd(plan, seg_m,
                                                             dsums, cd))
        t_p = cuda_ms(torch, lambda: cellpool.cell_pool0_bwd_plain(
            plan, seg_m, dsums, cd), n=3, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(oh, ds_cd))
        nbytes = seg_m.numel() * 4 + dsums.numel() * 4 + BATCH * H * W * C * 2
        b_ms, b_by = bound(nbytes, 0.0, cd)
        log(f"[K3 time] C={C}: kernel {t_k:.4f} ms, plain {t_p:.4f}, bmm "
            f"{t_l:.4f}, bound {b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); "
            f"{share(nbytes, t_k)}; bitwise equal to the plain version: "
            f"{errs[('K3', C, cd)] == 0.0}")
        k3[C] = (t_k, t_p, t_l, b_ms, b_by)
        del dsums, ds_cd
    del oh
    t_k, t_p, t_l, b_ms, b_by = k3[C0]
    out.append({
        "name": "cell_pool0_bwd (K3)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/cellpool.cu",
        "replaces": "wesup_tpu/ops/cellpool_pallas.py:213",
        "launches": launches["cell_pool0_bwd"],
        "max_abs_err": errs[("K3", C0, cd)],
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": t_l, "ms_c1024": k3[1024][0],
        "plain_ms_c1024": k3[1024][1], "library_ms_c1024": k3[1024][2],
        "bound_ms_c1024": k3[1024][3],
        "max_abs_err_c1024": errs[("K3", 1024, cd)]})

    e9 = cellgrid.offset_masks(plan, seg, valid, cd)
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0,
           "reread": 0.0}
    for s, C in stage_c.items():
        spp = cellgrid.make_stage_pool_plan(plan, *stage_hw[s], True)
        Hs, Ws = stage_hw[s]
        mc = cellgrid.stage_window_weights(spp, e9)
        dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
        ds_cd = dsums.to(cd)
        Md = cellgrid.expand_window_weights(spp, mc)   # (B, Hs, Kh, Ws, Kw)
        Mq = Md.permute(0, 1, 3, 2, 4).reshape(BATCH, Hs * Ws, K).contiguous()
        del Md
        # the kernel's terms: nonzero weights of clusters in the grid; the
        # stream reads one bf16 dsums row per term (from L2)
        terms = int((Mq != 0).sum().item())
        t_k = cuda_ms(torch, lambda: cellpool.cell_pool_stage_bwd(spp, mc,
                                                                  dsums))
        t_p = cuda_ms(torch, lambda: cellpool.cell_pool_stage_bwd_plain(
            spp, mc, dsums, cd), n=5, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(Mq, ds_cd))
        del Mq
        nbytes = mc.numel() * 2 + dsums.numel() * 4 + BATCH * Hs * Ws * C * 2
        flops = 2.0 * int((mc != 0).sum().item()) * C
        reread = terms * C * 2.0
        per_pix = terms / (BATCH * Hs * Ws)
        b_ms, b_by = bound(nbytes, flops, cd)
        log(f"[K4 time] stage {s} {Hs}x{Ws}x{C}: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f}, bmm {t_l:.4f}, bound {b_ms:.4f} ({b_by}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"{share(nbytes, t_k)}; the stream re-reads "
            f"{reread / 1e6:.1f} MB of dsums rows ({per_pix:.2f} terms per "
            f"stage pixel) at {reread / (t_k * 1e-3) / 1e12:.3f} TB/s")
        tot["ms"] += t_k
        tot["plain"] += t_p
        tot["lib"] += t_l
        tot["bytes"] += nbytes
        tot["flops"] += flops
        tot["reread"] += reread
    b_ms, b_by = bound(tot["bytes"], tot["flops"], cd)
    log(f"[K4 time] stages 1-4: kernel {tot['ms']:.4f} ms, bmm "
        f"{tot['lib']:.4f}, bound {b_ms:.4f}; "
        f"{share(tot['bytes'], tot['ms'])}; the stream re-reads "
        f"{tot['reread'] / 1e6:.1f} MB at "
        f"{tot['reread'] / (tot['ms'] * 1e-3) / 1e12:.3f} TB/s")
    out.append({
        "name": "cell_pool_stage_bwd (K4, stages 1-4 summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/cellpool.cu",
        "replaces": "wesup_tpu/ops/cellpool_pallas.py:470",
        "launches": launches["cell_pool_stage_bwd"],
        "max_abs_err": max(v for k, v in errs.items()
                           if k[0] == "K4" and k[-1] == cd),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})
    return out


def parity_train_batch(torch) -> dict:
    """The f32 train parity batch: one 96x256 image with ragged validity, a
    random mask and 16 valid points, as CPU tensors."""
    ph, pw = 96, 256
    rng = np.random.default_rng(6)
    pb = {"image": np.clip(rng.normal(200, 25, (1, ph, pw, 3)), 0,
                           255).astype(np.uint8),
          "valid": np.ones((1, ph, pw), bool),
          "pixel_mask": rng.integers(0, 2, (1, ph, pw)).astype(np.int32),
          "points": np.stack([rng.integers(0, pw - 13, (1, 16)),
                              rng.integers(0, ph - 9, (1, 16)),
                              rng.integers(0, 2, (1, 16))], -1).astype(
                                  np.int32),
          "point_valid": np.ones((1, 16), bool),
          "use_mask_as_points": np.zeros((1,), bool),
          "sample_valid": np.ones((1,), bool)}
    pb["valid"][:, -9:] = False
    pb["valid"][:, :, -13:] = False
    return {k: torch.from_numpy(v) for k, v in pb.items()}


def parity_inputs(torch, config):
    """Phase 4's f32 parity inputs: one 96x256 image with ragged validity,
    its SLIC seg and plan (on the CPU)."""
    from wesup_tpu_torch.ops.slic import make_plan, slic

    ph, pw = 96, 256
    pplan = make_plan(ph, pw, config.sp_area)
    prng = np.random.default_rng(2)
    pimg = torch.from_numpy(prng.random((1, ph, pw, 3), dtype=np.float32))
    pvalid = torch.ones((1, ph, pw), dtype=torch.bool)
    pvalid[:, -9:] = False
    pvalid[:, :, -13:] = False
    pseg = slic(pimg, pvalid, sp_area=config.sp_area,
                compactness=config.sp_compactness, n_iters=config.slic_iters,
                update_stride=config.slic_update_stride)
    return pimg, pvalid, pseg, pplan


@contextlib.contextmanager
def fused_pool1(on: bool = True):
    """Run the block with ``WESUP_FUSED_POOL1=1`` (when ``on``)."""
    old = os.environ.get("WESUP_FUSED_POOL1")
    if on:
        os.environ["WESUP_FUSED_POOL1"] = "1"
    try:
        yield
    finally:
        os.environ.pop("WESUP_FUSED_POOL1", None)
        if old is not None:
            os.environ["WESUP_FUSED_POOL1"] = old


def expected(nonzero: dict) -> dict:
    """Every kernel's launch count: ``nonzero``'s, 0 for the others."""
    from wesup_tpu_torch.ops import launch_counts

    return {name: nonzero.get(name, 0) for name in launch_counts()}


def step_times(torch, run, n=25):
    """Median, min and max device ms of ``n`` calls of ``run``."""
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out), min(out), max(out)


def breakdown(torch, run, n=10) -> dict:
    """Median ms of each marked phase over ``n`` steps; ``run(mark)``."""
    timer = PhaseTimer(torch)
    phases = []
    for _ in range(n):
        timer.start()
        run(timer)
        phases.append(timer.durations())
    return {k: statistics.median(p[k] for p in phases) for k in phases[0]}


def pooling_phase(torch, card, imgs_u8, valid, seg_m, gen) -> list:
    """Phase 9: the adjoint, fullres and fused-pool paths.  Returns the K5,
    K6 and K7 entries of the kernels' JSON line."""
    import torch.nn.functional as F

    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import steps, wesup
    from wesup_tpu_torch.ops import (adjoint, launch_counts, pool, pooling,
                                     reset_launches)
    from wesup_tpu_torch.ops.resize import _interp_matrix
    from wesup_tpu_torch.ops.slic import make_plan

    dev = torch.device("cuda")
    config = WESUPConfig()
    H, W = CANVAS
    P = H * W
    K = make_plan(H, W, config.sp_area).n_clusters
    stage_c = {1: 256, 2: 768, 3: 1536, 4: 1536}
    stage_hw = {s: (H >> s, W >> s) for s in stage_c}
    seg_p = seg_m.reshape(BATCH, P)
    lists = pooling.segment_lists(seg_m, K)
    errs = {}

    def stage_inputs(s, dt):
        """Random stage taps, upsampled along H as the forward does: the
        channels-last (B, H, Ws, C) tensor viewed as (B, C, H, Ws)."""
        taps = torch.randn((BATCH,) + stage_hw[s] + (stage_c[s],),
                           generator=gen, device=dev).to(dt)
        A_wT = torch.from_numpy(_interp_matrix(stage_hw[s][1], W, True)).t()
        return taps, wesup._upsample_h(taps, H).permute(0, 3, 1, 2), A_wT

    # ---- 9a. K5 / K6 / K7 against their plain versions -------------------
    for C in (128, 1024):
        for dt in (torch.bfloat16, torch.float32):
            feat = torch.randn((BATCH, P, C), generator=gen,
                               device=dev).to(dt)
            got = pooling.segment_sum(seg_p, feat, K)
            want = pooling.segment_sum_plain(seg_p, feat, K)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lim = 1e-5 * max(1.0, want.abs().max().item())
            log(f"[K5] {tuple(feat.shape)} {dt}: max_abs_err {err:.3e} "
                f"(limit {lim:.3e})")
            if not err <= lim:
                fail(f"K5 disagrees with its plain version at C={C}, {dt}")
            errs[("K5", C, dt)] = err
            del feat, got, want
    for s in stage_c:
        for dt in (torch.bfloat16, torch.float32):
            _, tapsH_T, A_wT = stage_inputs(s, dt)
            got = adjoint.adjoint_pool_stage(seg_m, tapsH_T, A_wT, K)
            want = adjoint.adjoint_pool_stage_plain(seg_m, tapsH_T, A_wT, K)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            lim = 1e-5 * max(1.0, want.abs().max().item())
            if dt == torch.float32:
                ok = err <= lim
                what = f"limit {lim:.3e}"
            else:
                # p_h's f32 weight sums, in another order, may round to bf16
                # values one ulp apart: 2^-8 of the element's mass
                mass = adjoint.adjoint_pool_stage_plain(
                    seg_m, tapsH_T.abs(), A_wT, K)
                ok = bool((diff <= lim + 2.0 ** -8 * mass).all())
                beyond = (diff > lim).float().mean().item()
                what = (f"limit {lim:.3e} + 2^-8 of the mass; {beyond:.2e} "
                        f"of the values beyond {lim:.3e}")
                del mass
            log(f"[K6] stage {s} {tuple(tapsH_T.shape)} {dt}: max_abs_err "
                f"{err:.3e} ({what})")
            if not ok:
                fail(f"K6 disagrees with its plain version at stage {s}, {dt}")
            errs[("K6", s, dt)] = err
            del tapsH_T, got, want, diff
    for cout in (64, 128):
        for dt in (torch.bfloat16, torch.float32):
            pre = torch.randn((BATCH, 64, H, W), generator=gen,
                              device=dev).to(dt).contiguous(
                memory_format=torch.channels_last).permute(0, 2, 3, 1)
            p = pre.detach().requires_grad_(True)
            got = pool.fused_relu_pool_pad(p, cout)
            want = pool.reference(pre, cout)
            w = torch.randn(got.shape, generator=gen, device=dev)
            (g,) = torch.autograd.grad((got.float() * w).sum(), p)
            p2 = pre.detach().requires_grad_(True)
            (g_ref,) = torch.autograd.grad(
                (pool.reference(p2, cout).float() * w).sum(), p2)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            log(f"[K7] {tuple(pre.shape)} -> {cout} {dt}: max_abs_err "
                f"{err:.3e}, gradient equal {torch.equal(g, g_ref)} "
                f"(limit: equal)")
            if not (torch.equal(got, want) and torch.equal(g, g_ref)):
                fail(f"K7 or its gradient differs from the plain version at "
                     f"{cout} channels, {dt}")
            del pre, p, got, want, w, g, g_ref, p2
    torch.cuda.empty_cache()

    # ---- 9b. f32 forward: card vs CPU ------------------------------------
    pimg, pvalid, pseg, pplan = parity_inputs(torch, config)
    cases = [("adjoint, plan", "adjoint", True, False,
              {"segment_sum": 1, "adjoint_pool_stage": 4}),
             ("adjoint, no plan", "adjoint", False, False,
              {"segment_sum": 1, "adjoint_pool_stage": 4}),
             ("fullres", "fullres", False, False, {"segment_sum": 2}),
             ("local, WESUP_FUSED_POOL1=1", "local", True, True,
              {"cell_pool0": 1, "cell_pool_stage": 4,
               "fused_relu_pool_pad": 1})]
    model_cpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).eval()
    model_gpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).to(
        dev).eval()
    for label, pooling_, with_plan, gated, launches in cases:
        plan = pplan if with_plan else None
        with fused_pool1(gated), torch.inference_mode():
            ref = wesup.forward_superpixel(model_cpu, pimg, pseg,
                                           pplan.n_clusters, pvalid,
                                           torch.float32, pooling=pooling_,
                                           plan=plan)
            reset_launches()
            out = wesup.forward_superpixel(model_gpu, pimg.to(dev),
                                           pseg.to(dev), pplan.n_clusters,
                                           pvalid.to(dev), torch.float32,
                                           pooling=pooling_, plan=plan)
            torch.cuda.synchronize()
        counts = launch_counts()
        errs_f = {name: (getattr(out, name).cpu()
                         - getattr(ref, name)).abs().max().item()
                  for name in ("sp_pred", "pred", "sp_features")}
        log(f"[forward f32 96x256, {label}] " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs_f.items())
            + " (limits 2e-4, 2e-4, 2e-3); launches "
            + str({k: v for k, v in counts.items() if v}))
        if not (errs_f["sp_pred"] <= 2e-4 and errs_f["pred"] <= 2e-4
                and errs_f["sp_features"] <= 2e-3):
            fail(f"forward ({label}) on the card disagrees with the CPU")
        if counts != expected(launches):
            fail(f"forward ({label}) launched {counts}")
    del model_cpu, model_gpu

    # ---- 9c. the three configurations through make_predict_step ----------
    model = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(
        dev).eval()
    imgs_dev = torch.from_numpy(imgs_u8).to(dev)
    configs = [
        ("local (phase 5)", "local", False,
         {"cell_pool0": 1, "cell_pool_stage": 4}),
        ("local, WESUP_FUSED_POOL1=1", "local", True,
         {"cell_pool0": 1, "cell_pool_stage": 4, "fused_relu_pool_pad": 1}),
        ("adjoint", "adjoint", False,
         {"segment_sum": 1, "adjoint_pool_stage": 4}),
        ("fullres", "fullres", False, {"segment_sum": 2}),
    ]
    path_launches = {}
    step_fns = {}
    for label, pooling_, gated, launches in configs:
        step = make_gated(steps.make_predict_step(
            WESUPConfig(pooling=pooling_), CANVAS), gated)
        step_fns[label] = step
        for _ in range(3):
            step(model, imgs_dev, valid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        pred = step(model, imgs_dev, valid)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[step {label}] launches in one step: "
            + str({k: v for k, v in counts.items() if v})
            + f"; peak {peak:.2f} GiB")
        if counts != expected(launches):
            fail(f"the {label} predict step launched {counts}")
        if not (tuple(pred.shape) == (BATCH,) + CANVAS
                and torch.isfinite(pred).all() and pred.min() >= 0
                and pred.max() <= 1):
            fail(f"the {label} predict step's pred is not finite in [0, 1]")
        path_launches[label] = counts
    # two rounds in turns (forward, then reverse order) on one card
    times = {label: [] for label in step_fns}
    for order in (list(step_fns), list(reversed(step_fns))):
        for label in order:
            times[label].append(step_times(
                torch, lambda: step_fns[label](model, imgs_dev, valid)))
    for label, rounds in times.items():
        log(f"[step {label}] {' / '.join(f'{m:.3f}' for m, _, _ in rounds)} "
            f"ms/step (median of 25, two rounds; min "
            f"{min(r[1] for r in rounds):.3f} max "
            f"{max(r[2] for r in rounds):.3f}), "
            f"{BATCH / statistics.mean(r[0] for r in rounds) * 1e3:.2f} "
            f"img/s (B={BATCH}, {H}x{W}, bf16; {card})")
    for label, step in step_fns.items():
        parts = breakdown(torch, lambda mark: step(model, imgs_dev, valid,
                                                   mark=mark))
        log(f"[step {label}] breakdown (median ms of 10 marked steps): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.3f}")
        # device busy time: the comparison that host noise does not reach
        profile_steps(torch, lambda: step(model, imgs_dev, valid), top=6,
                      tag=f"profile {label}")
    del model, step_fns

    # one gated bf16 train step
    tmodel = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(dev)
    optimizer = steps.make_optimizer(config, tmodel)
    tstep = make_gated(steps.make_train_step(config, CANVAS,
                                             point_mode=True), True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(BATCH).items()}
    reset_launches()
    acc = tstep(tmodel, optimizer, steps.init_metric_acc(), batch,
                torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    counts = launch_counts()
    finite = all(torch.isfinite(q.grad).all() for q in tmodel.parameters()
                 if q.grad is not None)
    log(f"[train WESUP_FUSED_POOL1=1] one step: launches "
        + str({k: v for k, v in counts.items() if v})
        + f"; gradients finite {finite}; loss "
        f"{acc['sums']['loss'].item() / BATCH:.4f}")
    if counts["fused_relu_pool_pad"] != 1 or not finite or acc["nan"].item():
        fail("the gated train step")
    del tmodel, optimizer, tstep, batch
    torch.cuda.empty_cache()

    # ---- 9d. K5 / K6 / K7 times at the main-path shapes ------------------
    cd = torch.bfloat16
    out = []
    n_valid = int((seg_p >= 0).sum().item())
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0}
    t_sort = cuda_ms(torch, lambda: pooling.segment_lists(seg_m, K))
    oh_t = (seg_p[:, None, :] == torch.arange(K, device=dev, dtype=seg_p.dtype
                                              )[None, :, None]).to(cd)
    for C in (128, 1024):
        feat = torch.randn((BATCH, P, C), generator=gen, device=dev).to(cd)
        t_k = cuda_ms(torch, lambda: pooling.segment_sum(seg_p, feat, K,
                                                         lists))
        t_p = cuda_ms(torch, lambda: pooling.segment_sum_plain(seg_p, feat,
                                                               K),
                      n=5, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(oh_t, feat))
        # the rows of valid pixels are all the kernel needs to read
        nbytes = seg_p.numel() * 4 + n_valid * C * 2 + BATCH * K * C * 4
        flops = float(n_valid) * C
        b_ms, b_by = bound(nbytes, flops, cd)
        log(f"[K5 time] (8, {P}, {C}): kernel {t_k:.4f} ms (lists built "
            f"once, {t_sort:.4f} ms), plain {t_p:.4f}, bmm {t_l:.4f}, bound "
            f"{b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB)")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                         ("bytes", nbytes), ("flops", flops)):
            tot[key] += val
        del feat
    del oh_t
    b_ms, b_by = bound(tot["bytes"], tot["flops"], cd)
    out.append({
        "name": "segment_sum (K5; C=128 and C=1024 summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/pooling.cu",
        "replaces": "wesup_tpu/ops/pooling_pallas.py:91",
        "launches": (path_launches["adjoint"]["segment_sum"]
                     + path_launches["fullres"]["segment_sum"]),
        "max_abs_err": max(v for k, v in errs.items()
                           if k[0] == "K5" and k[-1] == cd),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})

    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "dense_m": 0.0, "bytes": 0.0,
           "flops": 0.0}
    oh = (seg_m[..., None] == torch.arange(K, device=dev, dtype=seg_m.dtype)
          ).to(cd)                                               # (B, H, W, K)
    for s, C in stage_c.items():
        Hs, Ws = stage_hw[s]
        taps, tapsH_T, A_wT = stage_inputs(s, cd)
        A_h = torch.as_tensor(_interp_matrix(Hs, H, True), dtype=cd,
                              device=dev)
        A_w = A_wT.t().to(device=dev, dtype=cd)
        M = torch.einsum("wv,buwk->buvk", A_w,
                         torch.einsum("hu,bhwk->buwk", A_h, oh))
        Mt = M.reshape(BATCH, Hs * Ws, K).transpose(1, 2).contiguous()
        awt = A_wT.to(device=dev, dtype=cd).float()
        p_h = torch.einsum("vw,bhwk->bhvk", awt, oh.float())
        p_nz = p_h != 0
        nnz = int(p_nz.sum().item())              # nonzero p_h[v, k]
        rows = int(p_nz.any(-1).sum().item())     # tapsH_T rows they meet
        # the one PyTorch call over K6's own inputs: the dense P (B, K,
        # H * Ws), p_h rounded to bf16 as the kernel rounds it, times tapsH
        P = p_h.to(cd).permute(0, 3, 1, 2).reshape(BATCH, K, H * Ws)
        tapsH = tapsH_T.permute(0, 2, 3, 1).reshape(BATCH, H * Ws, C)
        del M, p_h, p_nz
        table = adjoint.column_table(A_wT, cd, dev)
        t_k = cuda_ms(torch, lambda: adjoint.adjoint_pool_stage(
            seg_m, tapsH_T, A_wT, K, lists, table))
        t_p = cuda_ms(torch, lambda: adjoint.adjoint_pool_stage_plain(
            seg_m, tapsH_T, A_wT, K), n=3, warmup=1)
        t_m = cuda_ms(torch, lambda: torch.bmm(Mt, taps.reshape(
            BATCH, Hs * Ws, C)))
        t_l = cuda_ms(torch, lambda: torch.bmm(P, tapsH))
        del Mt, P
        # the tapsH_T rows (b, h, v) that meet a nonzero p_h are all the
        # kernel needs to read
        nbytes = (seg_m.numel() * 4 + rows * C * 2 + A_wT.numel() * 2
                  + BATCH * K * C * 4)
        flops = 2.0 * nnz * C
        b_ms, b_by = bound(nbytes, flops, cd)
        log(f"[K6 time] stage {s} (8, {C}, {H}, {Ws}): kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f}, bmm of the dense P by tapsH {t_l:.4f} (the "
            f"library call over K6's inputs), bmm of JAX's dense M by the "
            f"stage taps {t_m:.4f}, bound {b_ms:.4f} ({b_by}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP over {nnz} "
            f"nonzero p_h entries, {rows} of {BATCH * H * Ws} tapsH_T rows); "
            f"{share(nbytes, t_k)}")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                         ("dense_m", t_m), ("bytes", nbytes),
                         ("flops", flops)):
            tot[key] += val
        del taps, tapsH_T, tapsH
    del oh
    b_ms, b_by = bound(tot["bytes"], tot["flops"], cd)
    log(f"[K6 time] stages 1-4: kernel {tot['ms']:.4f} ms, bmm of the dense "
        f"P {tot['lib']:.4f}, bmm of the dense M {tot['dense_m']:.4f}, bound "
        f"{b_ms:.4f}; {share(tot['bytes'], tot['ms'])}")
    out.append({
        "name": "adjoint_pool_stage (K6, stages 1-4 summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/adjoint.cu",
        "replaces": "wesup_tpu/ops/adjoint_pallas.py:102",
        "launches": path_launches["adjoint"]["adjoint_pool_stage"],
        "max_abs_err": max(v for k, v in errs.items()
                           if k[0] == "K6" and k[-1] == cd),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})

    x = torch.randn((BATCH, 64, H, W), generator=gen, device=dev).to(
        cd).contiguous(memory_format=torch.channels_last)
    pre = x.permute(0, 2, 3, 1)
    with torch.no_grad():
        t_k = cuda_ms(torch, lambda: pool.fused_relu_pool_pad(pre, 128))
        t_p = cuda_ms(torch, lambda: pool.reference(pre, 128), n=5,
                      warmup=1)
        t_l = cuda_ms(torch, lambda: F.pad(F.max_pool2d(F.relu(x), 2, 2),
                                           (0, 0, 0, 0, 0, 64)))
    nbytes = pre.numel() * 2 + BATCH * (H // 2) * (W // 2) * 128 * 2
    b_ms, b_by = bound(nbytes, 4.0 * BATCH * (H // 2) * (W // 2) * 64, cd)
    log(f"[K7 time] (8, {H}, {W}, 64) -> 128: kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f}, pad(max_pool2d(relu)) {t_l:.4f}, bound {b_ms:.4f} "
        f"({b_by}, {nbytes / 1e6:.1f} MB)")
    out.append({
        "name": "fused_relu_pool_pad (K7)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/pool.cu",
        "replaces": "wesup_tpu/ops/pool_pallas.py:121",
        "launches": path_launches["local, WESUP_FUSED_POOL1=1"][
            "fused_relu_pool_pad"],
        "max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": t_l})
    return out


def adjoint_train_phase(torch, card, seg_m, gen) -> list:
    """Phase 10: training through the adjoint and fullres pools.  Returns
    the K8 and ``segment_sum_bwd`` entries of the kernels' JSON line."""
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import steps, wesup
    from wesup_tpu_torch.ops import (adjoint, launch_counts, pooling,
                                     reset_launches)
    from wesup_tpu_torch.ops.resize import _interp_matrix
    from wesup_tpu_torch.ops.slic import make_plan

    dev = torch.device("cuda")
    config = WESUPConfig()
    H, W = CANVAS
    P = H * W
    K = make_plan(H, W, config.sp_area).n_clusters
    stage_c = {1: 256, 2: 768, 3: 1536, 4: 1536}
    stage_ws = {s: W >> s for s in stage_c}
    seg_p = seg_m.reshape(BATCH, P)
    errs = {}

    def k8_limit(want, mass, dt):
        """f32: 1e-5 of each element's mass (p_h's weights and the terms
        are summed in another order); bf16 also 2^-8 of the mass (p_h's
        sums may round to bf16 values one ulp apart) and one bf16 ulp of
        the value (the output's rounding)."""
        lim = 1e-5 * mass
        if dt == torch.bfloat16:
            lim = lim + 2.0 ** -8 * mass + bf16_ulp(torch, want)
        return lim

    # ---- 10a. K8 and segment_sum_bwd against their plain versions --------
    for s, C in stage_c.items():
        A_wT = torch.from_numpy(_interp_matrix(stage_ws[s], W, True)).t()
        for dt in (torch.bfloat16, torch.float32):
            dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
            got = adjoint.adjoint_pool_stage_bwd(seg_m, dsums, A_wT, K, dt)
            want = adjoint.adjoint_pool_stage_bwd_plain(seg_m, dsums, A_wT,
                                                        K, dt)
            mass = adjoint.adjoint_pool_stage_bwd_plain(
                seg_m, dsums.abs(), A_wT, K, torch.float32)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= k8_limit(want, mass, dt)).all())
            log(f"[K8] stage {s} {tuple(got.shape)} {dt}: max_abs_err "
                f"{err:.3e} (limit 1e-5 of the mass"
                + (" + 2^-8 of it + one bf16 ulp)" if dt == torch.bfloat16
                   else ")"))
            if not ok or got.dtype != dt:
                fail(f"K8 disagrees with its plain version at stage {s}, {dt}")
            errs[("K8", s, dt)] = err
            del dsums, got, want, mass, diff
    for C in (128, 1024):
        for dt in (torch.bfloat16, torch.float32):
            dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
            got = pooling.segment_sum_bwd(seg_p, dsums, dt)
            want = pooling.segment_sum_bwd_plain(seg_p, dsums, dt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            log(f"[K5 bwd] {tuple(got.shape)} {dt}: max_abs_err {err:.3e} "
                f"(limit 0: a pure selection, on K3's kernel)")
            if not torch.equal(got, want):
                fail(f"segment_sum_bwd disagrees with its plain version at "
                     f"C={C}, {dt}")
            errs[("K5 bwd", C, dt)] = err
            del dsums, got, want
    torch.cuda.empty_cache()

    # ---- 10b. one f32 train step's gradients: card vs CPU ----------------
    cases = [("adjoint", {"segment_sum": 1, "adjoint_pool_stage": 4,
                          "segment_sum_bwd": 1, "adjoint_pool_stage_bwd": 4}),
             ("fullres", {"segment_sum": 2, "segment_sum_bwd": 2})]
    tb = parity_train_batch(torch)
    ph, pw = tb["image"].shape[1:3]
    pplan = make_plan(ph, pw, config.sp_area)
    for pooling_, launches in cases:
        cfg32 = WESUPConfig(compute_dtype="float32", pooling=pooling_)
        prep = steps._preprocess_sample(
            None, tb["image"], tb["valid"], tb["pixel_mask"], tb["points"],
            tb["point_valid"], tb["use_mask_as_points"], config=cfg32,
            train=False, point_mode=True)
        res = {}
        for d in ("cpu", "cuda"):
            model = wesup.WESUP(generator=torch.Generator().manual_seed(3)).to(
                d)
            p = steps.Preprocessed(*(t.to(d) for t in prep))
            reset_launches()
            loss, _ = steps._forward_and_loss(model, p, pplan.n_clusters,
                                              cfg32, tb["sample_valid"].to(d),
                                              pplan)
            loss.backward()
            if d == "cuda":
                torch.cuda.synchronize()
                counts = launch_counts()
            res[d] = (loss.item(), {n: q.grad.cpu()
                                    for n, q in model.named_parameters()})
            del model
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        worst = {"backbone": 0.0, "rest": 0.0}
        for name, want in res["cpu"][1].items():
            group = "backbone" if name.startswith("backbone.") else "rest"
            rel = ((res["cuda"][1][name] - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            worst[group] = max(worst[group], rel)
        log(f"[train f32 {ph}x{pw}, {pooling_}] loss {res['cuda'][0]:.6f} "
            f"(card) vs {res['cpu'][0]:.6f} (CPU), rel err {loss_err:.2e} "
            f"(limit 1e-4); largest grad error / the tensor's max |grad|: "
            f"backbone {worst['backbone']:.2e} (limit 1e-2), rest "
            f"{worst['rest']:.2e} (limit 1e-3); launches "
            + str({k: v for k, v in counts.items() if v}))
        if not (loss_err <= 1e-4 and worst["backbone"] <= 1e-2
                and worst["rest"] <= 1e-3):
            fail(f"the f32 {pooling_} train step on the card disagrees with "
                 f"the CPU")
        if counts != expected(launches):
            fail(f"the f32 {pooling_} forward + backward launched {counts}")
        del res, prep

    # ---- 10c. the train step at full width through each pool -------------
    path_launches = {}
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(BATCH).items()}
    for pooling_, launches in cases:
        cfg = WESUPConfig(pooling=pooling_)
        model = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(dev)
        optimizer = steps.make_optimizer(cfg, model)
        step = steps.make_train_step(cfg, CANVAS, point_mode=True)
        tgen = torch.Generator(device=dev).manual_seed(7)
        holder = [steps.init_metric_acc()]

        def run(mark=None):
            holder[0] = step(model, optimizer, holder[0], batch, tgen,
                             mark=mark)

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run()
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[train {pooling_}] launches in one step: "
            + str({k: v for k, v in counts.items() if v})
            + f"; peak {peak:.2f} GiB")
        if counts != expected(launches):
            fail(f"the {pooling_} train step launched {counts}")
        path_launches[pooling_] = counts
        med, lo, hi = step_times(torch, run, n=15)
        log(f"[train {pooling_}] train step, point supervision: {med:.3f} "
            f"ms/step, {BATCH / med * 1e3:.2f} img/s (B={BATCH}, {H}x{W}, "
            f"bf16, median of 15; min {lo:.3f} max {hi:.3f}; peak "
            f"{peak:.2f} GiB; {card})")
        parts = breakdown(torch, run)
        log(f"[train {pooling_}] breakdown (median ms of 10 marked steps): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.3f}")
        profile_steps(torch, run, top=8, tag=f"profile train {pooling_}")
        acc = holder[0]
        count = acc["count"].item()
        log(f"[train {pooling_}] metric means over {count:.0f} images: "
            + ", ".join(f"{k} {v.item() / count:.4f}"
                        for k, v in acc["sums"].items()))
        if acc["nan"].item() or not all(
                np.isfinite(v.item()) for v in acc["sums"].values()):
            fail(f"the {pooling_} train step's metrics are not finite")
        if not all(torch.isfinite(q).all() for q in model.parameters()):
            fail(f"the weights are not finite after {pooling_} training")
        del model, optimizer, step, holder
        torch.cuda.empty_cache()
    del batch

    # ---- 10d. K8 and segment_sum_bwd times at the main-path shapes -------
    cd = torch.bfloat16
    out = []
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0}
    oh = (seg_m[..., None] == torch.arange(K, device=dev, dtype=seg_m.dtype)
          ).to(torch.float32)                                    # (B, H, W, K)
    for s, C in stage_c.items():
        Ws = stage_ws[s]
        A_wT = torch.from_numpy(_interp_matrix(Ws, W, True)).t()
        # the cotangent the train path gives K8: f32 rows that are bf16 values
        dsums = torch.randn((BATCH, K, C), generator=gen, device=dev).to(
            cd).float()
        ds_cd = dsums.to(cd)
        table = adjoint.column_table(A_wT, cd, dev)
        awt = A_wT.to(device=dev, dtype=cd).float()
        p_h = torch.einsum("vw,bhwk->bhvk", awt, oh)
        nnz = int((p_h != 0).sum().item())          # the kernel's terms
        # the one PyTorch call for the same product: the dense P (B, H * Ws,
        # K), p_h rounded to bf16 as the kernel rounds it, by dsums
        Pd = p_h.to(cd).reshape(BATCH, H * Ws, K)
        del p_h
        t_k = cuda_ms(torch, lambda: adjoint.adjoint_pool_stage_bwd(
            seg_m, dsums, A_wT, K, cd, table))
        t_p = cuda_ms(torch, lambda: adjoint.adjoint_pool_stage_bwd_plain(
            seg_m, dsums, A_wT, K, cd), n=3, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(Pd, ds_cd))
        del Pd, ds_cd
        # each output row written once (zeros too), each dsums row and each
        # seg id read once, and the column table
        nbytes = (BATCH * H * Ws * C * 2 + dsums.numel() * 4
                  + seg_m.numel() * 4 + W * 12 + Ws * 8)
        flops = 2.0 * nnz * C
        b_ms, b_by = bound(nbytes, flops, cd)
        log(f"[K8 time] stage {s} (8, {C}, {H}, {Ws}): kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f}, bmm of the dense P by dsums {t_l:.4f}, bound "
            f"{b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP over {nnz} nonzero p_h entries); "
            f"{share(nbytes, t_k)}")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                         ("bytes", nbytes), ("flops", flops)):
            tot[key] += val
        del dsums
    del oh
    b_ms, b_by = bound(tot["bytes"], tot["flops"], cd)
    log(f"[K8 time] stages 1-4: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain']:.4f}, bmm of the dense P {tot['lib']:.4f}, bound "
        f"{b_ms:.4f} ({b_by}, {tot['bytes'] / 1e6:.1f} MB); "
        f"{share(tot['bytes'], tot['ms'])}")
    out.append({
        "name": "adjoint_pool_stage_bwd (K8, backward of K6, stages 1-4 "
                "summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/adjoint.cu",
        "replaces": "wesup_tpu/models/wesup.py:376",
        "launches": path_launches["adjoint"]["adjoint_pool_stage_bwd"],
        "max_abs_err": max(v for k, v in errs.items()
                           if k[0] == "K8" and k[-1] == cd),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})

    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0}
    oh = (seg_p[..., None] == torch.arange(K, device=dev, dtype=seg_p.dtype)
          ).to(cd)                                                # (B, P, K)
    for C in (128, 1024):
        dsums = torch.randn((BATCH, K, C), generator=gen, device=dev)
        ds_cd = dsums.to(cd)
        t_k = cuda_ms(torch, lambda: pooling.segment_sum_bwd(seg_p, dsums,
                                                             cd))
        t_p = cuda_ms(torch, lambda: pooling.segment_sum_bwd_plain(
            seg_p, dsums, cd), n=3, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(oh, ds_cd))
        nbytes = seg_p.numel() * 4 + dsums.numel() * 4 + BATCH * P * C * 2
        b_ms, b_by = bound(nbytes, 0.0, cd)
        log(f"[K5 bwd time] C={C}: kernel {t_k:.4f} ms (its -1 mapping "
            f"included), plain {t_p:.4f}, bmm {t_l:.4f}, bound {b_ms:.4f} "
            f"({b_by}, {nbytes / 1e6:.1f} MB); {share(nbytes, t_k)}")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                         ("bytes", nbytes)):
            tot[key] += val
        del dsums, ds_cd
    del oh
    b_ms, b_by = bound(tot["bytes"], 0.0, cd)
    out.append({
        "name": "segment_sum_bwd (K5's backward on K3's kernel; C=128 and "
                "C=1024 summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/cellpool.cu",
        "replaces": "wesup_tpu/models/wesup.py:438",
        "launches": (path_launches["adjoint"]["segment_sum_bwd"]
                     + path_launches["fullres"]["segment_sum_bwd"]),
        "max_abs_err": max(v for k, v in errs.items()
                           if k[0] == "K5 bwd" and k[-1] == cd),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})
    return out


# GlaS-shaped synthetic training data for phase 11: GlaS's 85 train images
# at its 522x775 size; its 80 test images cut to 8 val images
GLAS_SPLITS = {"train": 85, "val": 8}


def glas_image(rng):
    """One synthetic 522x775 GlaS-like (RGB image, gland mask), drawn from
    ``rng``: 4-8 elliptic glands, purple on pink, with noise."""
    H, W = GLAS_HW
    yy, xx = np.mgrid[:H, :W]
    mask = np.zeros((H, W), np.uint8)
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        ry, rx = rng.integers(30, 90, 2)
        mask[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = 1
    tone = np.where(mask[..., None] == 1, rng.normal([160, 110, 170], 8),
                    rng.normal([225, 205, 220], 6))
    img = np.clip(tone + rng.normal(0, 12, (H, W, 3)), 0, 255).astype(
        np.uint8)
    return img, mask


def write_glas_dataset(root: Path, seed: int) -> None:
    """A synthetic GlaS-shaped dataset under ``root``: 522x775 RGB PNGs
    (their rows cycle through the five PNG filters), gland masks, and
    ``points/*.csv`` (3 points per class) for the train split, made with
    numpy from ``seed``."""
    from wesup_tpu_torch.data.codec import write_png

    rng = np.random.default_rng(seed)
    for split, n in GLAS_SPLITS.items():
        dirs = {d: root / split / d for d in ("images", "masks", "points")}
        for d, path in dirs.items():
            if d != "points" or split == "train":
                path.mkdir(parents=True)
        for i in range(n):
            img, mask = glas_image(rng)
            name = f"{split}_{i:02d}"
            write_png(dirs["images"] / f"{name}.png", img)
            write_png(dirs["masks"] / f"{name}.png", mask)
            if split == "train":
                rows = []
                for cls in (0, 1):
                    ys, xs = np.nonzero(mask == cls)
                    for j in rng.choice(len(ys), 3, replace=False):
                        rows.append(f"{xs[j]},{ys[j]},{cls}\n")
                (dirs["points"] / f"{name}.csv").write_text("".join(rows))


def hold_step_kernels(torch, run_step, tag) -> None:
    """K1-K4 as one train step calls them, against their plain versions on
    the same inputs, with phases 2, 3 and 8a's limits; ``run_step()``
    runs the step."""
    from wesup_tpu_torch.ops import cellpool as cp

    calls = []

    def recording(name, fn):
        def run(*args):
            out = fn(*args)
            calls.append((name, args, out))
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name, attr in (("K1", "_pool0_fwd"), ("K2", "_stage_fwd"),
                           ("K3", "cell_pool0_bwd"),
                           ("K4", "cell_pool_stage_bwd")):
            stack.enter_context(mock.patch.object(
                cp, attr, new=recording(name, getattr(cp, attr))))
        run_step()
        torch.cuda.synchronize()
    counts = {k: sum(c[0] == k for c in calls) for k in ("K1", "K2", "K3",
                                                          "K4")}
    if counts != {"K1": 1, "K2": 4, "K3": 1, "K4": 4}:
        fail(f"the bucketed train step called {counts}")
    errs = {}
    for name, args, got in calls:
        if name == "K1":
            want = cp.cell_pool0_plain(*args)
            err = (got - want).abs().max().item()
            ok = err <= 0.02 * want.abs().max().item()
        elif name == "K2":
            want = cp.cell_pool_stage_plain(*args)
            err = (got - want).abs().max().item()
            ok = err <= 1e-4 * max(1.0, want.abs().max().item())
        elif name == "K3":
            want = cp.cell_pool0_bwd_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want)
        else:
            spp, mc, dsums = args
            want = cp.cell_pool_stage_bwd_plain(spp, mc, dsums, mc.dtype)
            mass = cp.cell_pool_stage_bwd_plain(spp, mc.abs(), dsums.abs(),
                                                torch.float32)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= bf16_ulp(torch, want) + 1e-5 * mass).all())
        if not ok:
            fail(f"{name} disagrees with its plain version in the bucketed "
                 f"train step ({tuple(got.shape)})")
        errs[name] = max(errs.get(name, 0.0), err)
    shape = tuple(calls[0][1][2].shape)
    log(f"[{tag}] one bucketed train step's K1-K4 (stage-0 taps {shape}, "
        f"{calls[0][1][2].dtype}) against their plain versions on the "
        "step's own inputs: max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in sorted(errs.items()))
        + " (limits of phases 2, 3, 8a: K1 0.02 of the max, K2 1e-4 of the "
        "max, K3 equal, K4 one bf16 ulp + 1e-5 of the sum of |terms|)")


def trace_busy(path):
    """(kernel count, busy us, span us) of the device kernels in a Chrome
    trace of ``torch.profiler``: the span runs from the first kernel's
    start to the last one's end."""
    with open(path) as fp:
        kern = [e for e in json.load(fp)["traceEvents"]
                if e.get("cat") == "kernel"]
    if not kern:
        return 0, 0.0, 0.0
    busy = sum(e["dur"] for e in kern)
    span = (max(e["ts"] + e["dur"] for e in kern)
            - min(e["ts"] for e in kern))
    return len(kern), busy, span


class ErrorRecords(logging.Handler):
    """Keeps the records at ERROR and above of the logger ``name`` (and its
    children), on the root logger, which they reach by propagation."""

    def __init__(self, name):
        super().__init__(logging.ERROR)
        self.addFilter(logging.Filter(name))
        self.records = []

    def emit(self, record):
        self.records.append(record)


def trainer_phase(torch, card, seed) -> None:
    """Phase 11: ``fit`` on a synthetic GlaS-shaped dataset made from
    ``seed``, at full width, 2 epochs and a resume, with the trainer's
    figures."""
    import tempfile

    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.models import steps
    from wesup_tpu_torch.models.trainer import WESUPTrainer
    from wesup_tpu_torch.ops import launch_counts, train_resize
    from wesup_tpu_torch.train import fit

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tag = "trainer"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase11_")
    root = Path(tmp.name) / "glas"
    t0 = time.perf_counter()
    write_glas_dataset(root, seed)
    log(f"[{tag}] wrote {sum(GLAS_SPLITS.values())} synthetic GlaS images "
        f"({GLAS_HW[0]}x{GLAS_HW[1]} PNG, all five row filters) in "
        f"{time.perf_counter() - t0:.2f} s")
    files = sorted((root / "train" / "images").iterdir())[:4]
    t0 = time.perf_counter()
    for f in files:
        codec.imread_rgb(f)
        codec.imread_mask(root / "train" / "masks" / f.name)
    dec_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    log(f"[{tag}] decode (data/codec.py, host): {dec_ms:.1f} ms per "
        f"{GLAS_HW[0]}x{GLAS_HW[1]} image + mask (mean of {len(files)}); "
        f"{card}")

    # every train step the trainer runs: its epoch, canvas, CUDA events
    # around it, the kernels it launched and its device batch
    step_log = []
    real_get = WESUPTrainer._get_step

    def get_step(self, kind, hw):
        step = real_get(self, kind, hw)
        if kind != "train":
            return step

        def run(model, optimizer, acc, batch, *args, **kwargs):
            before = launch_counts()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(model, optimizer, acc, batch, *args, **kwargs)
            b.record()
            after = launch_counts()
            step_log.append((self._epoch_idx, hw, a, b, {
                k: after[k] - before[k] for k in after}, dict(batch)))
            return out
        return run

    # a step that raises is logged and skipped by the trainer: catch it
    errors = ErrorRecords("Train")
    old_root = os.environ.get("RECORD_ROOT")
    os.environ["RECORD_ROOT"] = str(Path(tmp.name) / "records")
    logging.getLogger().addHandler(errors)
    try:
        with mock.patch.object(WESUPTrainer, "_get_step", new=get_step), \
                mock.patch.object(steps, "batch_seed",
                                  wraps=steps.batch_seed) as seeds:
            torch.cuda.reset_peak_memory_stats()
            trainer = fit(root, epochs=2, batch_size=BATCH, seed=seed)
            peak_fit = torch.cuda.max_memory_allocated() / 2**30
            cache = trainer._resize_cache
            if not all(c is not None and c["imgs"].is_cuda
                       for c in cache.values()):
                fail("the device-resize cache is not on the card")
            ckpt_dir = trainer.record_dir / "checkpoints"
            if sorted(p.name for p in ckpt_dir.iterdir()) != [
                    "ckpt.0002.pth"]:
                fail(f"checkpoints after 2 epochs: {list(ckpt_dir.iterdir())}")
            n_first = len(seeds.call_args_list)
            # the trainer's own profile_dir hook traces the resumed run's
            # first train phase, epoch 3
            resumed = fit(root, epochs=1, batch_size=BATCH, seed=seed,
                          checkpoint=str(ckpt_dir / "ckpt.0002.pth"),
                          profile_dir=str(Path(tmp.name) / "trace"))
            seed_args = [c.args for c in seeds.call_args_list]
    finally:
        logging.getLogger().removeHandler(errors)
        if old_root is None:
            os.environ.pop("RECORD_ROOT", None)
        else:
            os.environ["RECORD_ROOT"] = old_root

    # ---- 11a. every step ran; numbering, retention, history, seeds -------
    stats = {**trainer.phase_stats, **resumed.phase_stats}
    if sorted(stats) != [(e, p) for e in (1, 2, 3) for p in ("train", "val")]:
        fail(f"the fits ran the phases {sorted(stats)}")
    for (e, phase), st in sorted(stats.items()):
        n_steps = sum(s[0] == e for s in step_log)
        if (st["batches"] == 0 or st["failed"]
                or phase == "train" and n_steps != st["batches"]):
            fail(f"epoch {e} {phase}: {st['batches']} batches, "
                 f"{st['failed']} failed, {n_steps} train steps recorded")
    if errors.records:
        fail(f"the trainer logged {len(errors.records)} errors, the first: "
             f"{errors.records[0].getMessage()}")
    log(f"[{tag}] every batch of epochs 1-3 stepped, none raised: train "
        + ", ".join(f"{stats[(e, 'train')]['batches']}" for e in (1, 2, 3))
        + " batches, val " + ", ".join(
            f"{stats[(e, 'val')]['batches']}" for e in (1, 2, 3))
        + "; no error logged")
    names = sorted(p.name for p in ckpt_dir.iterdir())
    with open(trainer.record_dir / "history.csv") as fp:
        rows = list(csv.reader(fp))
    log(f"[{tag}] resumed at epoch {resumed.initial_epoch}; checkpoints "
        f"{names}; history.csv {len(rows) - 1} rows, columns {rows[0]}")
    if (resumed.initial_epoch != 3 or names != ["ckpt.0003.pth"]
            or len(rows) != 4):
        fail("the resume did not continue at epoch 3 with latest-only "
             "checkpoints and 3 history rows")
    if not all(np.isfinite(float(v)) for r in rows[1:] for v in r):
        fail("history.csv holds values that are not finite")
    # the schedule a straight 3-epoch run follows: (base, epoch, train
    # phase 0, batch i) for each train batch (tests/test_torch_port_
    # trainer.py holds the resumed seeds against a straight run's own)
    base = seed + 1
    want = [(base, e, 0, i) for e in (1, 2, 3)
            for i in range(stats[(e, "train")]["batches"])]
    log(f"[{tag}] per-batch generator seeds: epochs 1-2 and the resumed "
        f"epoch 3 derived from (seed + 1, epoch, 0, batch) in a straight "
        f"3-epoch schedule's order: {seed_args == want} ({n_first} + "
        f"{len(seed_args) - n_first} batches)")
    if seed_args != want:
        fail("the resumed run's generator seeds leave the straight "
             "3-epoch schedule")

    # ---- 11b. the epochs' figures ----------------------------------------
    torch.cuda.synchronize()
    for e in (1, 2, 3):
        what = {1: "warm-up", 2: "untraced", 3: "resumed, under the "
                "profiler's host and device tracing, its export included"}[e]
        tr, va = stats[(e, "train")]["seconds"], stats[(e, "val")]["seconds"]
        log(f"[{tag}] epoch {e} ({what}): train {tr:.3f} s, val {va:.3f} s "
            f"({stats[(e, 'val')]['samples']} images at B=1), epoch "
            f"{tr + va:.3f} s; {card}")
    st2 = stats[(2, "train")]
    steps2 = [(a.elapsed_time(b), n, hw) for e, hw, a, b, n, _ in step_log
              if e == 2]
    step_ms = [t for t, _, _ in steps2]
    seen1 = {hw for e, hw, *_ in step_log if e == 1}
    cold = sum(hw not in seen1 for *_, hw in steps2)
    rate = st2["samples"] / st2["seconds"]
    step_rate = st2["samples"] / (sum(step_ms) * 1e-3)
    shapes = sorted({hw for *_, hw in steps2})
    log(f"[{tag}] epoch 2 train phase: {st2['samples']} images in "
        f"{st2['batches']} batches at {len(shapes)} bucketed canvases "
        f"{shapes} ({cold} steps at a canvas epoch 1 did not see): "
        f"{rate:.2f} img/s (valid samples / wall s); train step median "
        f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), step-only {step_rate:.2f} img/s; ratio "
        f"{rate / step_rate:.3f}; {card}")
    bad = [n for _, n, _ in steps2 if n != expected({
        "cell_pool0": 1, "cell_pool_stage": 4, "cell_pool0_bwd": 1,
        "cell_pool_stage_bwd": 4})]
    log(f"[{tag}] launches per train step over epoch 2: "
        + str({k: v for k, v in steps2[0][1].items() if v})
        + f"; steps with other counts: {len(bad)}; {card}")
    if bad:
        fail(f"train steps launched other kernels than K1-K4: {bad[:2]}")
    n_kern, busy, span = trace_busy(Path(tmp.name) / "trace"
                                    / "trace.epoch3.json")
    if n_kern:
        log(f"[{tag}] device busy over epoch 3's train phase (the trainer's "
            f"profile_dir trace, host ops recorded too): {busy / 1e3:.3f} ms "
            f"of a {span / 1e3:.3f} ms span (first kernel to last), busy "
            f"share {busy / span:.3f}, {n_kern} kernels, "
            f"{n_kern / stats[(3, 'train')]['batches']:.0f} per step; {card}")
    else:
        log(f"[{tag}] the profiler recorded no device kernels: busy share "
            "not measured")
    log(f"[{tag}] peak memory over the 2-epoch fit: {peak_fit:.2f} GiB; "
        f"{card}")

    # ---- 11c. wire bytes, device resize: card vs CPU and its time --------
    gpu_batch = next(
        ({k: v for k, v in b.items() if isinstance(v, torch.Tensor)}
         for *_, b in step_log if bool(b["sample_valid"].all())), None)
    if gpu_batch is None:
        fail("no train step had a full batch")
    cache = resumed._resize_cache["train"]
    img_d, mask_d = train_resize.apply_resize(cache, gpu_batch)
    img_c, mask_c = train_resize.apply_resize(
        {k: v.cpu() for k, v in cache.items()},
        {k: v.cpu() for k, v in gpu_batch.items()})
    same = torch.equal(img_d.cpu(), img_c) and torch.equal(mask_d.cpu(),
                                                           mask_c)
    # the same samples in the host-resize wire format: canvas and mask
    host = {k: v.cpu().numpy() for k, v in gpu_batch.items()
            if k != "img_idx" and not k.startswith("rsz_")}
    host.update(image=img_c.numpy(), pixel_mask=mask_c.numpy())
    dev_bytes = sum(v.nbytes for v in gpu_batch.values())
    host_bytes = sum(np.asarray(v).nbytes
                     for v in WESUPTrainer.wire(host).values())
    hw = tuple(img_d.shape[1:3])
    log(f"[{tag}] host-to-device bytes per B={BATCH} batch at {hw}: device "
        f"resize {dev_bytes} B, host resize {host_bytes} B "
        f"({host_bytes / dev_bytes:.1f}x); {card}")
    rs_ms = cuda_ms(torch, lambda: train_resize.apply_resize(cache,
                                                             gpu_batch))
    log(f"[{tag}] device resize of one batch ({tuple(img_d.shape)}): "
        f"{rs_ms:.4f} ms on the card; bitwise equal to the CPU's: {same}; "
        f"{card}")
    if not same:
        fail("the device resize on the card differs from the CPU's")

    # ---- 11d. one bucketed train step's K1-K4 against plain -------------
    step = resumed._get_step("train", hw)
    hold_step_kernels(torch, lambda: step(
        resumed.model, resumed.optimizer, steps.init_metric_acc(device=dev),
        dict(gpu_batch, rng_idx=(4, 0)), resumed._base_seed, cache=cache),
        tag)
    del trainer, resumed, cache, gpu_batch, step, step_log
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 11 took {time.perf_counter() - t_phase:.1f} s")


# GlaS-shaped synthetic test set for phase 12: GlaS's testA (60 images)
# and testB (20) cut to 8 each, at its 522x775 size, BMP as GlaS ships them
GLAS_TEST = {"testA": 8, "testB": 8}
GLAS_SCALES = (0.6, 0.55, 0.5, 0.45, 0.4)


def write_glas_test_set(root: Path, seed: int) -> None:
    """``testA/images`` and ``testB/images`` of 522x775 BMPs under
    ``root``, made with numpy from ``seed``."""
    from wesup_tpu_torch.data.codec import write_bmp

    rng = np.random.default_rng(seed)
    for split, n in GLAS_TEST.items():
        (root / split / "images").mkdir(parents=True)
        for i in range(n):
            write_bmp(root / split / "images" / f"{split}_{i:02d}.bmp",
                      glas_image(rng)[0])


@contextlib.contextmanager
def recorded(module, attr, limit):
    """Record (args, output) of the first ``limit`` calls of
    ``module.attr`` in the block (later calls run unrecorded)."""
    calls = []
    real = getattr(module, attr)

    def run(*args):
        out = real(*args)
        if len(calls) < limit:
            calls.append((args, out))
        return out

    with mock.patch.object(module, attr, new=run):
        yield calls


def hold_pool_kernels(torch, k1_calls, k2_calls, tag) -> None:
    """K1 and K2 as a forward called them, against their plain versions
    on the same inputs, with phases 2-3's limits."""
    from wesup_tpu_torch.ops import cellpool as cp

    if len(k1_calls) != 1 or len(k2_calls) != 4:
        fail(f"{tag}: recorded {len(k1_calls)} K1 and {len(k2_calls)} K2 "
             "calls of one forward")
    errs = []
    for (args, got), plain, rel in (
            [(c, cp.cell_pool0_plain, 0.02) for c in k1_calls]
            + [(c, cp.cell_pool_stage_plain, 1e-4) for c in k2_calls]):
        want = plain(*args)
        err = (got - want).abs().max().item()
        lim = rel * (want.abs().max().item() if plain is cp.cell_pool0_plain
                     else max(1.0, want.abs().max().item()))
        if not err <= lim:
            fail(f"{tag}: {plain.__name__} disagrees on the forward's own "
                 f"inputs ({tuple(args[2].shape)}): {err:.3e} > {lim:.3e}")
        errs.append(f"{tuple(args[2].shape)} {err:.3e}")
    log(f"[{tag}] the first forward's K1 and K2 against their plain "
        "versions on its own inputs (limits of phases 2-3): max_abs_err "
        + ", ".join(errs))


def post(url, body: bytes):
    """(status, reply bytes, seconds, the server's X-Inference-Seconds or
    None) of ``POST url`` with ``body``."""
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            reply = resp.read()
            return (resp.status, reply, time.perf_counter() - t0,
                    resp.headers.get("X-Inference-Seconds"))
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0, None


def inference_phase(torch, card, imgs_u8, valid, seed) -> None:
    """Phase 12: the pixel head, the five inference CLIs on a synthetic
    GlaS-shaped test set made from ``seed``, and ``POST /predict`` to a
    superpixel and a pixel server."""
    import tempfile

    from wesup_tpu_torch import (infer_tile, pixel_infer, pixel_infer_tile,
                                 test_glas)
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.models import initialize_trainer, steps, wesup
    from wesup_tpu_torch.ops import cellpool, launch_counts, pool, \
        reset_launches
    from wesup_tpu_torch.serve import create_server

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    H, W = CANVAS

    # ---- 12a. f32 pixel forward: card vs CPU -----------------------------
    prng = np.random.default_rng(seed)
    pimg = torch.from_numpy(prng.random((2, 96, 128, 3), dtype=np.float32))
    model_cpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).eval()
    model_gpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).to(
        dev).eval()
    with torch.inference_mode():
        ref = wesup.forward_pixel(model_cpu, pimg)
        reset_launches()
        out = wesup.forward_pixel(model_gpu, pimg.to(dev))
        torch.cuda.synchronize()
    counts = launch_counts()
    err = (out.cpu() - ref).abs().max().item()
    log(f"[pixel f32 2x96x128] probabilities: max_abs_err {err:.3e} (limit "
        f"2e-4); launches {({k: v for k, v in counts.items() if v})}")
    if not (tuple(out.shape) == (2, 96, 128, 2) and err <= 2e-4):
        fail("the f32 pixel forward on the card disagrees with the CPU")
    if counts != expected({}):
        fail(f"the pixel forward launched {counts}")
    del model_cpu, model_gpu, ref, out

    # ---- 12b. the pixel predict step at full width -----------------------
    model = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(
        dev).eval()
    imgs_dev = torch.from_numpy(imgs_u8).to(dev)
    step = steps.make_predict_step(WESUPConfig(), CANVAS, "pixel")
    gated = make_gated(step, True)
    for run in (step, gated):
        for _ in range(2):
            run(model, imgs_dev, valid)
    probs, peaks = {}, {}
    for label, run, launches in (
            ("pixel", step, {}),
            ("pixel, WESUP_FUSED_POOL1=1", gated,
             {"fused_relu_pool_pad": 1})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recorded(pool, "_kernel", 1) as k7_calls:
            prob = run(model, imgs_dev, valid)
            torch.cuda.synchronize()
        counts = launch_counts()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[step {label}] launches in one step: "
            + str({k: v for k, v in counts.items() if v})
            + f"; peak {peaks[label]:.2f} GiB")
        if counts != expected(launches):
            fail(f"the {label} predict step launched {counts}")
        if not (tuple(prob.shape) == (BATCH,) + CANVAS
                and torch.isfinite(prob).all() and prob.min() >= 0
                and prob.max() <= 1):
            fail(f"the {label} step's probabilities are not finite in "
                 "[0, 1]")
        probs[label] = prob
        for (pre, oc), got in k7_calls:
            want = pool.reference(pre, oc)
            log(f"[step {label}] K7 on the step's own input "
                f"{tuple(pre.shape)}: equal to its plain version "
                f"{torch.equal(got, want)}")
            if not torch.equal(got, want):
                fail("K7 disagrees with its plain version in the pixel step")
    err = (probs["pixel"] - probs["pixel, WESUP_FUSED_POOL1=1"]).abs().max()
    log(f"[step pixel] gated against ungated probabilities: max_abs_err "
        f"{err.item():.3e} (bf16 limit 3e-2)")
    if not err.item() <= 3e-2:
        fail("the gated pixel step disagrees with the ungated one")
    del probs, prob
    # two rounds in turns (ungated, gated, gated, ungated) on one card
    fns = {"pixel": step, "pixel, WESUP_FUSED_POOL1=1": gated}
    times = {label: [] for label in fns}
    for order in (list(fns), list(reversed(fns))):
        for label in order:
            times[label].append(step_times(
                torch, lambda: fns[label](model, imgs_dev, valid)))
    for label, rounds in times.items():
        ms = statistics.mean(r[0] for r in rounds)
        log(f"[step {label}] {' / '.join(f'{m:.3f}' for m, _, _ in rounds)} "
            f"ms/step (median of 25, two rounds; min "
            f"{min(r[1] for r in rounds):.3f} max "
            f"{max(r[2] for r in rounds):.3f}), {BATCH / ms * 1e3:.2f} img/s "
            f"(B={BATCH}, {H}x{W}, bf16; peak {peaks[label]:.2f} GiB; "
            f"{card})")
    for label, run in fns.items():
        parts = breakdown(torch, lambda mark: run(model, imgs_dev, valid,
                                                  mark=mark))
        log(f"[step {label}] breakdown (median ms of 10 marked steps): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.3f}")
        profile_steps(torch, lambda: run(model, imgs_dev, valid), top=6,
                      tag=f"profile {label}")
    del model, step, gated, fns
    torch.cuda.empty_cache()

    # ---- 12c. the five CLIs on a GlaS-shaped test set --------------------
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase12_")
    root = Path(tmp.name)
    data = root / "glas"
    write_glas_test_set(data, seed)
    ckpt = root / "rec" / "checkpoints" / "ckpt.0001.pth"
    initialize_trainer("wesup", seed=seed).save_checkpoint(ckpt, epoch=1)
    names = {split: sorted(p.name for p in (data / split / "images").iterdir())
             for split in GLAS_TEST}
    tile_dir = root / "tile"

    def check_masks(out_dir, want_names, magic):
        got = sorted(p.name for p in out_dir.iterdir())
        if got != want_names:
            fail(f"{out_dir.name}: wrote {got[:3]}..., expected "
                 f"{want_names[:3]}...")
        for name in got:
            body = (out_dir / name).read_bytes()
            mask = codec.decode(body, gray=True, name=name)
            if not (body.startswith(magic) and mask.shape == GLAS_HW
                    and set(np.unique(mask).tolist()) <= {0, 255}):
                fail(f"{out_dir / name}: {body[:4]!r}, {mask.shape}, "
                     f"values {np.unique(mask)[:4]}")

    def stems_png(split):
        return sorted(Path(n).stem + ".png" for n in names[split])

    clis = [
        ("test_glas, 5 scales", True, lambda: test_glas.test(
            ckpt, scales=GLAS_SCALES, data_root=data),
         [(root / "rec" / "results-5scale" / split, stems_png(split),
           b"\x89PNG") for split in GLAS_TEST]),
        ("infer_tile, patch 464", True, lambda: infer_tile.main(
            str(data / "testA"), patch_size=464, checkpoint=str(ckpt),
            output_dir=str(tile_dir)),
         [(tile_dir, names["testA"], b"BM")]),
        ("pixel_infer, scale 0.5", False, lambda: pixel_infer.main(
            str(data / "testA"), checkpoint=str(ckpt), scales=0.5),
         [(root / "rec" / "results-pixel-0.5" / "testA", names["testA"],
           b"BM")]),
        ("pixel_infer_tile, patch 400", False, lambda: pixel_infer_tile.main(
            str(data / "testA"), checkpoint=str(ckpt), patch_size=400),
         [(root / "rec" / "results-pixel-tile-400" / "testA",
           names["testA"], b"BM")]),
    ]
    for label, superpixel, run, outputs in clis:
        forward = "forward_superpixel" if superpixel else "forward_pixel"
        n_images = sum(len(o[1]) for o in outputs)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(wesup, forward,
                               wraps=getattr(wesup, forward)) as fwd, \
                recorded(cellpool, "_pool0_fwd", 1) as k1_calls, \
                recorded(cellpool, "_stage_fwd", 4) as k2_calls:
            run()
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        n = fwd.call_count
        want = ({"cell_pool0": n, "cell_pool_stage": 4 * n} if superpixel
                else {})
        log(f"[cli {label}] {n_images} masks in {sec:.2f} s, "
            f"{sec * 1e3 / n_images:.1f} ms per 522x775 image (wall: "
            f"decode, predict, write); {n} forwards, launches "
            + str({k: v for k, v in counts.items() if v})
            + (f" = K1 {counts['cell_pool0'] / max(n, 1):g} and K2 "
               f"{counts['cell_pool_stage'] / max(n, 1):g} per forward"
               if superpixel else "")
            + f"; {card}")
        if n == 0 or counts != expected(want):
            fail(f"{label}: {n} forwards launched {counts}")
        for out_dir, want_names, magic in outputs:
            check_masks(out_dir, want_names, magic)
        if superpixel:
            hold_pool_kernels(torch, k1_calls, k2_calls, f"cli {label}")
        del k1_calls, k2_calls

    # ---- 12d. POST /predict to a superpixel and a pixel server -----------
    # the same image as a PNG (decoded by the numpy PNG decoder) and as a
    # BMP (a copy); the server's X-Inference-Seconds is its predict alone
    request_img = codec.imread_rgb(data / "testA" / "images"
                                   / names["testA"][0])
    bodies = {"PNG": codec.encode_png(request_img),
              "BMP": codec.encode_bmp(request_img)}
    for mode, per_request in (("superpixel", {"cell_pool0": 1,
                                              "cell_pool_stage": 4}),
                              ("pixel", {})):
        server = create_server(port=0, host="127.0.0.1", mode=mode,
                               seed=seed)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_port}/predict"
            reset_launches()
            replies = {kind: [post(url, body) for _ in range(3)]
                       for kind, body in bodies.items()}
            torch.cuda.synchronize()
            counts = launch_counts()
            bad = post(url, b"\xff\xd8\xff\xe0 a JPEG")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        n_requests = 0
        for kind, kind_replies in replies.items():
            for status, reply, _, _ in kind_replies:
                mask = (codec.decode(reply, gray=True) if status == 200
                        else np.zeros(0))
                if not (status == 200 and mask.shape == GLAS_HW
                        and set(np.unique(mask).tolist()) <= {0, 255}):
                    fail(f"POST /predict ({mode}, {kind}): {status} "
                         f"{reply[:200]!r}")
                n_requests += 1
            log(f"[serve {mode}] POST /predict of a 522x775 {kind} (scale "
                f"0.5): {len(kind_replies)} masks {GLAS_HW[0]}x{GLAS_HW[1]} "
                "in {0, 255}; latency ms (the server's predict ms) "
                + ", ".join(f"{r[2] * 1e3:.1f} ({float(r[3]) * 1e3:.0f})"
                            for r in kind_replies) + f"; {card}")
        log(f"[serve {mode}] launches over {n_requests} requests "
            + str({k: v for k, v in counts.items() if v})
            + f"; a JPEG body: {bad[0]}")
        if counts != expected({k: v * n_requests
                               for k, v in per_request.items()}):
            fail(f"the {mode} server launched {counts}")
        if bad[0] != 400:
            fail(f"the {mode} server answered a JPEG with {bad[0]}")
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[pixel] phase 12 took {time.perf_counter() - t_phase:.1f} s")


def make_gated(step, gated: bool):
    """``step`` run under ``WESUP_FUSED_POOL1=1`` when ``gated``."""
    def run(*args, **kwargs):
        with fused_pool1(gated):
            return step(*args, **kwargs)

    return run


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=11,
                        help="seed of phases 11-12's synthetic datasets, "
                             "weights and shuffles")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "wesup_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(wesup_tpu_torch/ not found)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))

    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.inference import Predictor, predict_multiscale_batch
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.models.steps import make_predict_step
    from wesup_tpu_torch.ops import (_build, cellgrid, cellpool,
                                     launch_counts, reset_launches)
    from wesup_tpu_torch.ops.slic import make_plan, slic
    from wesup_tpu_torch.serve import create_server

    dev = torch.device("cuda")
    # f32 parity needs full-f32 matmuls and convs (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.info.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.info.seconds:.2f} s)")
    for line in _build.info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")

    config = WESUPConfig()
    H, W = CANVAS
    plan = make_plan(H, W, config.sp_area)
    K = plan.n_clusters
    imgs_u8, valid_np = bench_images(BATCH)
    imgs = torch.from_numpy(imgs_u8).to(dev).float() / 255.0
    valid = torch.from_numpy(valid_np).to(dev)
    seg = slic(imgs, valid, sp_area=config.sp_area,
               compactness=config.sp_compactness, n_iters=config.slic_iters,
               update_stride=config.slic_update_stride)
    seg_m = torch.where(valid, seg, -1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    # ---- 2. K1 against its plain version ---------------------------------
    C0 = 128
    for dt, tol in ((torch.bfloat16, 0.02), (torch.float32, 1e-5)):
        taps = torch.randn((BATCH, H, W, C0), generator=gen, device=dev).to(dt)
        got = cellpool.cell_pool0(plan, seg_m, taps)
        want = cellpool.cell_pool0_plain(plan, seg_m, taps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = tol * want.abs().max().item()
        log(f"[K1] {tuple(taps.shape)} {dt}: max_abs_err {err:.3e} "
            f"(limit {lim:.3e})")
        if not err <= lim:
            fail(f"K1 disagrees with its plain version at {dt}")
        results.setdefault("K1", {})[str(dt)] = err

    # ---- 3. K2 against its plain version, stages 1-4 ---------------------
    stage_c = {1: 256, 2: 768, 3: 1536, 4: 1536}
    stage_hw = {s: (H >> s, W >> s) for s in stage_c}
    e9 = {dt: cellgrid.offset_masks(plan, seg, valid, dt)
          for dt in (torch.bfloat16, torch.float32)}
    for s, C in stage_c.items():
        spp = cellgrid.make_stage_pool_plan(plan, *stage_hw[s], True)
        for dt in (torch.bfloat16, torch.float32):
            mc = cellgrid.stage_window_weights(spp, e9[dt])
            taps = torch.randn((BATCH,) + stage_hw[s] + (C,), generator=gen,
                               device=dev).to(dt)
            got = cellpool.cell_pool_stage(spp, mc, taps)
            want = cellpool.cell_pool_stage_plain(spp, mc, taps)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lim = 1e-4 * max(1.0, want.abs().max().item())
            log(f"[K2] stage {s} {tuple(taps.shape)} Ih={spp.Ih} Jw={spp.Jw} "
                f"{dt}: max_abs_err {err:.3e} (limit {lim:.3e})")
            if not err <= lim:
                fail(f"K2 disagrees with its plain version at stage {s}, {dt}")
            results.setdefault("K2", {})[f"s{s} {dt}"] = err

    # ---- 4. forward parity: card (kernels) vs CPU (plain versions) -------
    pimg, pvalid, pseg, pplan = parity_inputs(torch, config)
    ph, pw = pimg.shape[1:3]
    model_cpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).eval()
    model_gpu = wesup.WESUP(generator=torch.Generator().manual_seed(3)).to(
        dev).eval()
    with torch.inference_mode():
        ref = wesup.forward_superpixel(model_cpu, pimg, pseg,
                                       pplan.n_clusters, pvalid,
                                       torch.float32, pooling="local",
                                       plan=pplan)
        out = wesup.forward_superpixel(model_gpu, pimg.to(dev), pseg.to(dev),
                                       pplan.n_clusters, pvalid.to(dev),
                                       torch.float32, pooling="local",
                                       plan=pplan)
    for name, tol in (("sp_pred", 2e-4), ("pred", 2e-4),
                      ("sp_features", 2e-3)):
        err = (getattr(out, name).cpu() - getattr(ref, name)).abs().max().item()
        log(f"[forward f32 {ph}x{pw}] {name}: max_abs_err {err:.3e} "
            f"(limit {tol:g})")
        if not err <= tol:
            fail(f"forward {name} on the card disagrees with the CPU")
    del model_cpu, model_gpu

    # ---- 5. the main path: predict step at full width --------------------
    model = wesup.WESUP(generator=torch.Generator().manual_seed(0)).to(
        dev).eval()
    step = make_predict_step(config, CANVAS, "superpixel")
    imgs_dev = torch.from_numpy(imgs_u8).to(dev)
    for _ in range(3):
        step(model, imgs_dev, valid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pred = step(model, imgs_dev, valid)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[step] launches in one step: {launches}")
    if launches != expected({"cell_pool0": 1, "cell_pool_stage": 4}):
        fail(f"expected K1 once, K2 four times and no other kernel per "
             f"step, got {launches}")
    if tuple(pred.shape) != (BATCH,) + CANVAS:
        fail(f"pred shape {tuple(pred.shape)}")
    if not (torch.isfinite(pred).all() and pred.min() >= 0
            and pred.max() <= 1):
        fail("pred is not finite in [0, 1]")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    step_ms = []
    for _ in range(25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(model, imgs_dev, valid)
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    ms = statistics.median(step_ms)
    log(f"[step] {METRIC}: {ms:.3f} ms/step, {BATCH / ms * 1e3:.2f} img/s "
        f"(B={BATCH}, {H}x{W}, bf16, median of {len(step_ms)}; "
        f"min {min(step_ms):.3f} max {max(step_ms):.3f}; peak "
        f"{peak_gb:.2f} GiB; {card})")
    timer = PhaseTimer(torch)
    phases = []
    for _ in range(10):
        timer.start()
        step(model, imgs_dev, valid, mark=timer)
        phases.append(timer.durations())
    breakdown = {k: statistics.median(p[k] for p in phases)
                 for k in phases[0]}
    log("[step] breakdown (median ms of 10 marked steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in breakdown.items())
        + f"; sum {sum(breakdown.values()):.3f}")
    profile_steps(torch, lambda: step(model, imgs_dev, valid))

    # ---- 6. serving ------------------------------------------------------
    predictor = Predictor(model, config)
    rng = np.random.default_rng(4)
    reqs = [np.clip(rng.normal(200, 25, GLAS_HW + (3,)), 0, 255).astype(
        np.uint8) for _ in range(4)]
    lat = []
    reset_launches()
    for img in reqs:
        t0 = time.perf_counter()
        (mask,) = predict_multiscale_batch(predictor, [img], scales=(0.5,))
        lat.append((time.perf_counter() - t0) * 1e3)
        if mask.shape != GLAS_HW or not set(np.unique(mask)) <= {0.0, 1.0}:
            fail(f"serving returned {mask.shape} {np.unique(mask)[:4]}")
    serve_launches = launch_counts()
    log(f"[serve] per-request latency ms (GlaS {GLAS_HW[0]}x{GLAS_HW[1]}, "
        f"scale 0.5): first {lat[0]:.1f}, then "
        + ", ".join(f"{x:.1f}" for x in lat[1:])
        + f"; launches over {len(reqs)} requests: {serve_launches}")
    if serve_launches != expected({"cell_pool0": len(reqs),
                                   "cell_pool_stage": 4 * len(reqs)}):
        fail(f"expected K1 once and K2 four times per request, got "
             f"{serve_launches}")
    server = create_server(port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/healthz"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[serve] /healthz: {health}")
    if health.get("status") != "ok":
        fail("health endpoint")

    # ---- 7. per-kernel times at the main-path shapes ---------------------
    cd = torch.bfloat16
    kernels = []
    taps0 = torch.randn((BATCH, H, W, C0), generator=gen, device=dev).to(cd)
    n_valid = int(valid.sum().item())
    oh = (seg_m[..., None] == torch.arange(K, device=dev, dtype=seg_m.dtype)
          ).to(cd).reshape(BATCH, H * W, K).transpose(1, 2)     # (B, K, HW)
    t_k = cuda_ms(torch, lambda: cellpool.cell_pool0(plan, seg_m, taps0))
    t_p = cuda_ms(torch, lambda: cellpool.cell_pool0_plain(plan, seg_m, taps0),
                  n=5, warmup=1)
    t_l = cuda_ms(torch, lambda: torch.bmm(oh, taps0.reshape(BATCH, H * W, C0)))
    del oh
    # the taps of valid pixels are all the kernel needs to read
    nbytes = seg_m.numel() * 4 + n_valid * C0 * 2 + BATCH * K * C0 * 4
    b_ms, b_by = bound(nbytes, n_valid * C0, cd)
    log(f"[K1 time] kernel {t_k:.4f} ms, plain {t_p:.4f}, bmm {t_l:.4f}, "
        f"bound {b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); "
        f"{share(nbytes, t_k)}")
    kernels.append({
        "name": "cell_pool0 (K1)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/cellpool.cu",
        "replaces": "wesup_tpu/ops/cellpool_pallas.py:145",
        "launches": launches["cell_pool0"],
        "max_abs_err": results["K1"][str(cd)],
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": t_l})

    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0}
    for s, C in stage_c.items():
        spp = cellgrid.make_stage_pool_plan(plan, *stage_hw[s], True)
        mc = cellgrid.stage_window_weights(spp, e9[cd])
        taps = torch.randn((BATCH,) + stage_hw[s] + (C,), generator=gen,
                           device=dev).to(cd)
        Md = cellgrid.expand_window_weights(spp, mc)   # (B, Hs, Kh, Ws, Kw)
        Hs, Ws = stage_hw[s]
        Mt = Md.permute(0, 2, 4, 1, 3).reshape(BATCH, K, Hs * Ws).contiguous()
        del Md
        t_k = cuda_ms(torch, lambda: cellpool.cell_pool_stage(spp, mc, taps))
        t_p = cuda_ms(torch, lambda: cellpool.cell_pool_stage_plain(
            spp, mc, taps), n=5, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.bmm(Mt, taps.reshape(
            BATCH, Hs * Ws, C)))
        del Mt
        nbytes = mc.numel() * 2 + taps.numel() * 2 + BATCH * K * C * 4
        flops = 2.0 * int((mc != 0).sum().item()) * C
        b_ms, b_by = bound(nbytes, flops, cd)
        log(f"[K2 time] stage {s} {Hs}x{Ws}x{C}: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f}, bmm {t_l:.4f}, bound {b_ms:.4f} ({b_by}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"{share(nbytes, t_k)}")
        tot["ms"] += t_k
        tot["plain"] += t_p
        tot["lib"] += t_l
        tot["bytes"] += nbytes
        tot["flops"] += flops
    b_ms, b_by = bound(tot["bytes"], tot["flops"], cd)
    log(f"[K2 time] stages 1-4: kernel {tot['ms']:.4f} ms, bmm "
        f"{tot['lib']:.4f}, bound {b_ms:.4f}; "
        f"{share(tot['bytes'], tot['ms'])}")
    kernels.append({
        "name": "cell_pool_stage (K2, stages 1-4 summed)", "route": "cuda",
        "source": "wesup_tpu_torch/csrc/cellpool.cu",
        "replaces": "wesup_tpu/ops/cellpool_pallas.py:422",
        "launches": launches["cell_pool_stage"],
        "max_abs_err": max(v for k, v in results["K2"].items()
                           if k.endswith(str(cd))),
        "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": tot["lib"]})
    del taps0, taps
    torch.cuda.empty_cache()

    # ---- 8. training -----------------------------------------------------
    kernels += train_phase(torch, card, imgs, valid, seg, seg_m, gen)

    # ---- 9. the adjoint, fullres and fused-pool paths --------------------
    kernels += pooling_phase(torch, card, imgs_u8, valid, seg_m, gen)

    # ---- 10. training through the adjoint and fullres pools --------------
    kernels += adjoint_train_phase(torch, card, seg_m, gen)

    # ---- 11. training from a dataset directory ---------------------------
    trainer_phase(torch, card, args.seed)

    # ---- 12. the pixel head, the inference CLIs and /predict -------------
    inference_phase(torch, card, imgs_u8, valid, args.seed)
    log("[kernels] " + ", ".join(
        f"{k['name']}: launches {k['launches']}, pass" for k in kernels))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
