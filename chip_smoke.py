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
   per-phase breakdown from the CUDA events of the program's spans;
6. serving: a ``Predictor`` answering GlaS-sized requests at scale 0.5,
   and the HTTP server's health endpoint;
7. per-kernel times against the plain version, a library call and the
   card's bound (for K1 and K2 also the achieved share of the HBM rate);
   then the tile cut and stitch (``csrc/tile.cu``) at the tile cell's
   shapes, a 1512x1516 uint8 slide cut into patches of 400: every cut in
   chunks of 8 and 16 and the stitch of the 16 patches (float32 raw and
   rounded, uint8) bitwise their plain versions on the card, launches
   counted (one cut per chunk, one stitch per slide), and each kernel's
   time beside its plain version's and the HBM bound; then the pixel
   head's ``hypercol_upsample`` (``csrc/hypercol.cu``) at the tile cell's
   chunk (B=8, 416x416, C=1024, bf16): within ``tests/torch_hypercol.py``'s
   limits of its plain version (the composition it replaces: W-resize
   einsums, concatenation, dense H-upsample GEMM, bias add, ReLU), one
   launch, and its time beside the plain version's and the
   HBM bound (the five stage maps read once, the map written once); then
   the pixel head's ``pixel_head`` (``csrc/pixhead.cu``) at the same
   chunk: within ``tests/torch_pixhead.py``'s intervals, as its plain
   version (the composition it replaces: fc2's bias add and ReLU, fc3,
   its bias and ReLU, the classifier, the softmax) must be too, one
   launch, and its time beside the plain version's and the HBM bound
   (fc2's output read once, 2.835 GB);
8. training: K3 (``cell_pool0_bwd``) and K4 (``cell_pool_stage_bwd``)
   against their plain versions at the main-path shapes (K3 also at
   C = 1024, the width of fullres training's K5 backward); one f32
   forward + backward on the card against the CPU; SLIC on the card
   against the CPU at 288x416; the augmentation drawn from one key (JAX's
   bits, on the host) equal for the card and the CPU, in both supervision
   modes; ``make_train_step`` at B=8 on the 288x416
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
   ``wesup_tpu_torch.train.fit`` at full width for 3 epochs at B=8 with
   the defaults (device resize, bucketed canvases), then resumed for 1
   epoch from ``ckpt.0003.pth``: every batch of every phase stepped and
   none raised or logged an error, epoch numbering, latest-only
   retention, 4 history rows and the per-batch keys of all four epochs
   in a straight schedule's order; the staging chain: epochs 2 and 3
   claimed the chain pre-warmed by the train phase before them, with
   batches already copied to the card when their train phase began,
   epochs 1 and 4 (resumed) start cold, epoch 2's first staged batch read
   back equals its host batch, and no staging or loader thread is alive
   after ``fit`` returns; decode ms, epoch seconds
   (the trainer's ``phase_stats``), epoch 2's img/s against the step-only
   rate, val seconds, bytes per batch (device against host resize), the
   device resize's time and its bitwise equality with the CPU, launches
   per train step (K1-K4), device busy share over epoch 4 (the trainer's
   ``profile_dir`` trace), peak memory; one bucketed train step's K1-K4
   outputs against their plain versions on the step's own inputs;
12. the pixel head and inference: the f32 pixel forward on the card
   against the CPU (full width, 2x96x128); ``make_predict_step(...,
   "pixel")`` at B=8 on the 288x416 canvas in bf16, with
   ``hypercol_upsample`` and ``pixel_head`` launched once per step, and
   under
   ``WESUP_FUSED_POOL1=1`` with K7 once too (on the step's
   own input bitwise its plain version; the probabilities within 3e-2 of
   the ungated step's), step times in two rounds, img/s, peak memory,
   breakdowns (backbone, proj, upsample, head) and the device busy share;
   the five CLIs (``test_glas`` at its five scales, ``infer_tile`` at
   patch 464, ``pixel_infer`` at 0.5, ``pixel_infer_tile`` at patch 400)
   from a random-weight ``.pth`` on a synthetic GlaS-shaped test set
   (testA and testB of 8 522x775 BMPs each, made from ``--seed``): every
   mask written with the right name, format and shape in {0, 255}, ms per
   image, K1 once and K2 four times per superpixel forward (the first
   forward's K1/K2 held against their plain versions on its inputs) and
   ``hypercol_upsample`` and ``pixel_head`` once per forward in the pixel
   CLIs; ``POST
   /predict`` of a PNG to a superpixel and a pixel server, which must
   answer with masks (and a malformed JPEG with 400);
13. the GlaS protocol as a user runs it on this machine: a raw set in
   GlaS's own layout (85 train images, testA and testB cut to 8 + 8,
   522x775 BMPs with gland-id annotations, ``Grade.csv`` with two grades;
   made from ``--seed``) through ``python -m wesup_tpu_torch.prepare_glas``
   (split counts held) and ``scripts.generate_points -p 1e-4 --seed 0``;
   ``train.fit`` for 1 epoch at B=8 with ``metrics=accuracy,dice,
   detection_f1,object_dice,object_hausdorff`` (every batch stepped, the
   host metrics finite in history.csv, one read-back per val batch, K1 1
   and K2 4 launches per val batch, the first val step's K1/K2 held
   against their plain versions); ``test_glas`` at its five scales from
   that checkpoint and ``scripts.evaluate_glas`` on its masks and on the
   ground truths shifted by (5, -4) px with 0.2% of pixels flipped: every
   CSV value equal to the plain versions' (scipy labelling,
   ``directed_hausdorff``; 1e-12, object Hausdorff 1e-6), the native
   region flip equal to scipy's, and each metric's ms per image native
   against plain; the raw set written again with its images as 32-bit
   ``BI_BITFIELDS`` and its annotations as RLE8 BMPs
   (``tests/torch_bmp_writer.py``), through ``prepare_glas`` (masks
   byte-equal to the uncompressed run's, images read equal) and
   ``test_glas`` (masks equal, the same K1/K2 launches); the val phase
   three ways
   (``scripts.measure_eval_metrics``: default, deferred and eager reads;
   the deferred and eager host metrics equal); seconds per step. Its
   lines start with ``[protocol``;
14. the quality protocol on the card: ``python -m
   wesup_tpu_torch.scripts.quality_protocol`` at its defaults (the easy
   synthetic task drawn without OpenCV from data seed 0: 20 train, 4 val,
   6 + 6 test 522x775 images; points; 150 epochs of the trainer at the
   defaults; ``test_glas`` at five scales; ``evaluate_glas``), run in this
   process: the first train step's K1-K4 held against their plain
   versions, K1-K4 and no other kernel launched, no error logged, the
   summary's keys; gates: best val Dice >= 0.95 and a breakthrough (val
   Dice > 0.9) within the 150 epochs; per-split Accuracy, Dice, Detection
   F1, Object Dice and Object Hausdorff beside the JAX package's (README),
   train seconds per epoch, the device busy share over epoch 2 (profiler)
   and the seconds of each protocol step.  Its lines start with
   ``[quality``;
15. JPEG and the DigestPath2019 pipeline: the port's JPEG library
   (``csrc/jpeg.cpp``, built with the host's C++ compiler) against its
   plain versions (``data/jpeg.py``) on files made from integer
   arithmetic in every sampling mode (4:4:4, 4:2:2, 4:2:0, 4:4:0, gray)
   and the eight EXIF orientations in both byte orders, colour and gray
   reads, and by SHA-256 against ``cv2.imdecode``'s decodes of the same
   files (constants computed with OpenCV 5.0.0); the library's and the
   plain version's decode and encode ms per 1000x1000 patch; ``python -m
   wesup_tpu_torch.test_dp2019_pipeline`` (run in this process, so its
   launches are counted) on two synthetic 2300x3100 JPEG slides
   (``make_image_hard`` from ``--seed``), patch 1000, superpixel at
   400x400 (K1 once and K2 four times per forward, the first forward's
   held against their plain versions) and ``--pixel`` at 0.4 under
   ``WESUP_FUSED_POOL1=1`` (K7, ``hypercol_upsample`` and ``pixel_head``
   once per forward,
   K7 bitwise its plain version), each from a checkpoint of a fresh
   trainer (the seconds of its JAX-bit weight draw timed) whose
   classifier reads one fc3 feature
   against a threshold, so that every combined mask is 5-95% foreground;
   every combined mask equal to its patch masks stitched in numpy, and
   the printed Accuracy and Dice equal to numpy's on them; one JPEG
   ``POST /predict`` (200, K1 1 and K2 4) and the same JPEG cut in half
   (400); then JPEG beyond baseline (15e), files made by
   ``tests/torch_jpeg_writer.py`` from the same integer-arithmetic image
   (progressive 4:2:0, 4:4:4 and gray with restarts, no DHT, sequential
   and progressive arithmetic with DAC and restarts, CMYK, YCCK): the
   library's colour and gray decodes equal the plain versions' and, by
   SHA-256, cv2's (``JPEG_BEYOND_SHA256``), each transcode's decode its
   baseline source's; the files of slice 12 (``slice12_cases``:
   progressive files that libjpeg block-smooths, from six scripts,
   Huffman and arithmetic; lossless gray and RGB files, predictors 1, 4,
   5, 6, 7, a point transform, restarts; files without their EOI), each
   read four ways (bytes as ``cv2.imdecode``, a file as ``cv2.imread``;
   colour, gray), the library's reads equal to the plain version's and,
   by SHA-256, to cv2's or refused where cv2 returns None
   (``JPEG_SLICE12_SHA256``); ms to decode a 1000x1000 patch of each
   kind, library and plain, smoothed progressive and lossless gray among
   them, and of an RLE8 BMP mask (the writer runs in spawned processes
   beside 15b-15c); the pipeline (superpixel) again on both slides
   transcoded to progressive and on one transcoded to arithmetic, each
   combined mask bitwise the baseline slides', on both transcoded to a
   smoothed progressive script (each slide's library decode equal to
   its plain decode, the foreground shares within ``SMOOTHED_FG_BOUND``
   of the baseline's), and with the ground truths as lossless gray JPEG
   (the printed scores the PNG masks'); ``POST /predict`` with a
   progressive and a CMYK body (200, the mask equal to the
   ``Predictor``'s on ``codec.decode`` of the body, K1 1 and K2 4).
   Its lines start with ``[jpeg``, ``[jpeg beyond`` and ``[serve jpeg``.

16. the tools of slice 9: ``scripts.profile_train_step`` at B=8 on the
   288x416 canvas in train, predict and pixel (under
   ``WESUP_FUSED_POOL1=1``) modes, each with its top-10 table, busy share
   and K1-K8 launches per step (train K1 1, K2 4, K3 1, K4 4; predict K1
   1, K2 4; pixel K7 1; else it fails); ``scripts.profile_epoch`` for 2
   epochs at B=8 on 16 synthetic 522x775 images, with the ``rng`` stage's
   ms a batch (the host key chain and draws); ``scripts.
   generate_spl_masks`` and ``scripts.measure_connectivity`` on 4
   synthetic images on the card against their CPU runs, the latter with
   phase 14's trained model (masks and segs equal on >= 0.999 of their
   values; where the segs are equal, the island statistics equal, both
   probability maps of the A/B within 3e-2, the CPU's A/B moving a pixel
   by more than 6e-2, and the mean move within 10% of the CPU's; K5 once
   and K6 four times per adjoint forward).  Its lines start with
   ``[tools``.
17. data and tensor parallelism over ``torch.distributed``, each job's
   ranks child processes of this script with a hard timeout: DP over 2
   ranks on the card over gloo (full-width WESUP, global B=8 on the
   288x416 canvas, 4 rows a rank, local pooling, points): one f32 train
   step (TF32 off, cuDNN deterministic) from the same weights, batch and
   key, its gradients equal on both ranks and held against each rank's
   rows stepped alone and summed (every tensor within 1e-5 of its
   largest value) and against this process's B=8 step (per tensor
   cosine >= 0.99, norms within 1%; the B=8 step without cuDNN is
   logged beside as the spread of another f32 order), K1-K4
   held against their plain versions on each rank's own inputs and
   launched K1 1, K2 4, K3 1, K4 4 times a rank, then 5 bf16 steps timed
   and the gradient all-reduce alone (ms, bytes); TP over 2 ranks (model
   2, fc1 split 2112x512 in JAX's layout): the f32 pixel forward at B=2
   against the single process (1e-4) and the bf16 superpixel predict
   step at B=8 (K1 1, K2 4 a rank, held; within 3e-2); one NCCL rank:
   ``train.fit`` with ``num_devices=1`` for one epoch on 4 + 1 synthetic
   522x775 images (its collectives counted); ``plot_tsne`` on phase 14's
   checkpoint for one synthetic val image on the card against the CPU
   (given the card's superpixels): features within 1e-4, labels equal, P
   within 1e-12, 20 descent iterations within 1e-6, the final KL within
   the range of CPU runs from starts scaled by 1 + 1e-15..1e-13, widened
   by its width (the descent is chaotic), and the seconds.  Its lines
   start with ``[parallel``.
18. the head-to-head: ``scripts.quality_headtohead`` on the card at the
   JAX record's setting (12 train / 4 val synthetic images at 96x128,
   K=63, data seed 0, eval every 10, ``H2H_EPOCHS`` epochs, f32 with TF32
   off): the port's ``forward_superpixel`` (adjoint) + ``wesup_loss`` +
   SGD against the reference replica from JAX's initial weights; held:
   loss MAE < 1e-3, final val Dice within 0.005 of the replica's, both
   sides above 0, and K5 1, K6 4, K3 (``segment_sum_bwd``) 1 and K8 4
   launches per train step (K5 1, K6 4 per val forward) over the run;
   both final Dice beside JAX's 0.93435, the propagation counts' first
   and last values, seconds per epoch for each side.  Its lines start
   with ``[h2h``.
19. damaged files: 72 JPEGs made without cv2 (``damage_cases``: one
   40x56 image encoded by ``data/jpeg.encode_plain``, whose bytes are
   ``cv2.imencode``'s, in nine kinds by ``tests/torch_jpeg_writer.py``,
   each damaged once by each of the eight seeded edits of
   ``tests/torch_jpeg_damage.py``: a byte replaced, bits flipped, a cut
   with and without an EOI, an RST removed, two RSTs swapped, bytes
   before an RST, a marker inserted), each read four ways by the library
   (bytes as ``cv2.imdecode``, a file as ``cv2.imread``; colour, gray):
   every third file's reads equal the plain version's, and each kind's
   reads equal cv2's by SHA-256 (``JPEG_DAMAGE_SHA256``, computed with
   OpenCV 5.0.0; regenerate with ``reads_sha256`` on cv2's
   imdecode/imread if the cases change); the library's and the plain
   version's ms to decode a whole and a byte-damaged 1000x1000 patch;
   ``python -m wesup_tpu_torch.train`` (``cli.run`` of ``train.fit``, in
   this process) for one epoch at ``pooling=adjoint`` and one at
   ``fullres`` over a GlaS-shaped directory (8 train, 2 val 522x775
   JPEG images) whose train images 0-2 have a byte replaced, are cut
   mid-scan and lost a restart marker, and whose mask 3 holds a tEXt
   chunk with a bad CRC: every file read by the codec (the damaged
   images equal to the plain version's reads), no error logged, every
   batch stepped, the losses in ``history.csv`` finite, the first train
   step's K5, K3 (``segment_sum_bwd``), K6 and K8 held against their
   plain versions (phases 9-10's limits), and each train step's launches
   PERF.md's (adjoint K5 1, K6 4, K3 1, K8 4; fullres K5 2, K3 2); a
   superpixel server's ``POST /predict`` of a byte-damaged JPEG (200, K1
   once and K2 four times) and of a PNG without its IEND (400, the
   codec's reason).  Its lines start with ``[damage`` and ``[serve
   damage``.

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
import math
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


STEP_SPANS = ("wesup.step.train", "wesup.step.eval", "wesup.step.predict")


def phase_times(spans) -> list:
    """Each step's device ms by phase, from the program's spans: every
    ``wesup.step.*`` span's device time less its children's, summed by
    name (without the prefix; the step's own work outside its phases
    under its kind), in the order the phases first ran."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    steps = {}
    for s in spans:
        root, up = None, s
        while up is not None:
            if up.name in STEP_SPANS:
                root = up
            up = up.parent
        if root is None or not s.name.startswith("wesup.step."):
            continue
        own = s.device_ms - sum(c.device_ms for c in kids.get(s, ()))
        phases = steps.setdefault(root, {})
        name = s.name.removeprefix("wesup.step.")
        phases[name] = phases.get(name, 0.0) + own
    return list(steps.values())


def breakdown(torch, tag, run, n=10) -> None:
    """Log the median device ms of each phase over ``n`` steps
    (``phase_times``); ``run()`` runs one step.  The spans record while a
    torch profiler does: the steps run under ``emit_itt``, which records
    no op (a ``torch.profiler`` session's per-op records slow the host,
    and with it every host-paced phase).  Beside the phases' sum the line
    gives the median of ``n`` untraced steps, each between two CUDA
    events, and their ratio: what the tracing still adds."""
    from wesup_tpu_torch import tracing

    untraced = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        untraced.append(a.elapsed_time(b))
    start = time.time_ns()      # an earlier session's spans are older
    with torch.autograd.profiler.emit_itt():
        for _ in range(n):
            run()
    phases = phase_times([s for s in tracing.spans()
                          if s.start_ns >= start])
    if len(phases) != n:
        fail(f"{len(phases)} steps traced of {n}")
    parts = {k: statistics.median(p.get(k, 0.0) for p in phases)
             for k in phases[0]}
    total, step_ms = sum(parts.values()), statistics.median(untraced)
    log(f"{tag} breakdown (median ms of {n} traced steps): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {total:.3f}, untraced step {step_ms:.3f} "
        f"(x{total / step_ms:.2f})")


def profile_steps(torch, run_step, n=5, top=12, tag="profile") -> None:
    """Device busy share and top kernels over ``n`` steps, from
    ``scripts/profile_ops``: the span runs from the first kernel's start
    to the last one's end (host work under the profiler is slower than
    without it, so the idle share is an upper bound)."""
    from wesup_tpu_torch.scripts import profile_ops

    events = profile_ops.profile(run_step, n)
    kern, _ = profile_ops.device_events(events)
    if not any(e["cat"] == profile_ops.KERNEL for e in kern):
        log(f"[{tag}] no device kernels recorded: busy share not measured")
        return
    count, busy, span = profile_ops.busy_share(kern)
    log(f"[{tag}] {n} steps: {count / n:.0f} kernels/step, device busy "
        f"{busy / n / 1e3:.3f} ms/step of a {span / n / 1e3:.3f} ms/step "
        f"span, idle share {1 - busy / span:.3f}")
    for name, (us, _) in list(profile_ops.op_table(kern).items())[:top]:
        log(f"[{tag}]   {us / n / 1e3:8.3f} ms/step  {name[:110]}")


HYPERCOL_CHUNK = (8, 416, 416, 1024)   # the tile cell's chunk, fc1's width


def hypercol_phase(torch) -> list:
    """Phase 7, the pixel head's upsample (``csrc/hypercol.cu``) at the tile
    cell's chunk in bf16: the kernel against its plain version with the
    card tests' limits, its launch, and its time beside the plain
    version's and the HBM bound; returns the kernels' JSON entry."""
    jpeg_writer()                  # puts tests/ on the path
    import torch_hypercol
    from wesup_tpu_torch.ops import hypercol, launch_counts, reset_launches

    dev = torch.device("cuda")
    B, H, W, C = HYPERCOL_CHUNK
    dt = torch.bfloat16
    maps, bias = torch_hypercol.stage_maps(B, H, W, C, dt, dev, seed=23)
    reset_launches()
    got = hypercol.upsample(maps, bias)
    torch.cuda.synchronize()
    launches = launch_counts()["hypercol_upsample"]
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False   # the kernel's f32
    beyond, worst, err = 0, 0.0, 0.0
    try:
        for i in range(B):        # an image at a time: the limits' memory
            one = [m[i:i + 1] for m in maps]
            want = hypercol.upsample_plain(one, bias)
            n, w = torch_hypercol.gap(got[i:i + 1], one, bias, want)
            beyond, worst = beyond + n, max(worst, w)
            err = max(err, (got[i].float() - want[0].float()).abs().max()
                      .item())
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    del got, want
    log(f"[hypercol] {B}x{H}x{W}x{C} {dt}: {beyond} values beyond the "
        f"limits of tests/torch_hypercol.py from the plain version's "
        f"(widest {worst:.3f} of its limit), max_abs_err {err:.3e}; "
        f"launches {launches}")
    if beyond or launches != 1:
        fail("hypercol_upsample disagrees with its plain version")
    nbytes = (sum(m.numel() for m in maps) + B * H * W * C + C) * 2
    t_k = cuda_ms(torch, lambda: hypercol.upsample(maps, bias))
    t_p = cuda_ms(torch, lambda: hypercol.upsample_plain(maps, bias), n=5,
                  warmup=1)
    b_ms, b_by = bound(nbytes, 0.0, dt)
    log(f"[hypercol time] {B}x{H}x{W}x{C} {dt}: kernel {t_k:.4f} ms, plain "
        f"(the composition it replaces) {t_p:.4f}, bound {b_ms:.4f} "
        f"({b_by}, {nbytes / 1e9:.3f} GB); {share(nbytes, t_k)}")
    return [{"name": "hypercol_upsample", "route": "cuda",
             "source": "wesup_tpu_torch/csrc/hypercol.cu",
             "replaces": "none: dense einsums in wesup_tpu/ops/resize.py",
             "launches": launches, "max_abs_err": err, "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by}]


def pixel_head_phase(torch) -> list:
    """Phase 7, the pixel head after fc2 (``csrc/pixhead.cu``) at the tile
    cell's chunk in bf16: the kernel and its plain version within the
    card tests' intervals, its launch, and its time beside the plain
    version's and the HBM bound; returns the kernels' JSON entry."""
    jpeg_writer()                  # puts tests/ on the path
    import torch_pixhead
    from wesup_tpu_torch.ops import launch_counts, pixhead, reset_launches

    dev = torch.device("cuda")
    B, H, W, C = HYPERCOL_CHUNK
    dt = torch.bfloat16
    z, params = torch_pixhead.head_inputs(B * H * W, C, 32, 2, dt, dev,
                                          seed=25)
    z = z.view(B, H, W, C)
    reset_launches()
    got = pixhead.head(z, *params)
    torch.cuda.synchronize()
    launches = launch_counts()["pixel_head"]
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False   # the kernel's f32
    try:
        beyond, worst, width = torch_pixhead.gap(got, z, params)
        want = pixhead.head_plain(z, *params)
        plain_beyond = torch_pixhead.gap(want, z, params)[0]
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    err = (got - want).abs().max().item()
    same = (got == want).all(dim=-1).float().mean().item()
    del got, want
    log(f"[pixel_head] {B}x{H}x{W}x{C} {dt}: {beyond} probabilities outside "
        f"the intervals of tests/torch_pixhead.py (widest {width:.3e}), the "
        f"plain version {plain_beyond}; max_abs_err {err:.3e}, rows equal "
        f"{same:.4f}; launches {launches}")
    if beyond or plain_beyond or launches != 1:
        fail("pixel_head disagrees with its plain version")
    nbytes = z.numel() * 2 + B * H * W * 2 * 4 + sum(
        p.numel() for p in params) * 2
    flops = 2.0 * B * H * W * C * 32
    t_k = cuda_ms(torch, lambda: pixhead.head(z, *params))
    t_p = cuda_ms(torch, lambda: pixhead.head_plain(z, *params), n=5,
                  warmup=1)
    b_ms, b_by = bound(nbytes, flops, dt)
    log(f"[pixel_head time] {B}x{H}x{W}x{C} {dt}: kernel {t_k:.4f} ms, "
        f"plain (the composition it replaces) {t_p:.4f}, bound {b_ms:.4f} "
        f"({b_by}, {nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP); "
        f"{share(nbytes, t_k)}")
    return [{"name": "pixel_head", "route": "cuda",
             "source": "wesup_tpu_torch/csrc/pixhead.cu",
             "replaces": "none: _mlp_head's tail, left to XLA in "
                         "wesup_tpu/models/wesup.py",
             "launches": launches, "max_abs_err": err, "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by}]


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
    from wesup_tpu_torch.ops import cellgrid, cellpool, reset_launches
    from wesup_tpu_torch.ops.slic import make_plan, slic
    from wesup_tpu_torch.utils import prng

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
        reset_launches()
        loss, _ = steps._forward_and_loss(model, p, pplan.n_clusters, cfg32,
                                          tb["sample_valid"].to(d), pplan)
        loss.backward()
        if d == "cuda":
            torch.cuda.synchronize()
            bwd = launched(*CELLPOOL)
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
    tkey = prng.PRNGKey(7)
    # the draws are host arithmetic: the same key draws the same
    # parameters for the card as for the CPU (the affine matrices are
    # computed from them on each device)
    for point_mode in (True, False):
        drawn = [steps.sample_augmentation(config, BATCH, CANVAS, point_mode,
                                           tkey, d) for d in (dev, "cpu")]
        same = all(torch.equal(getattr(drawn[0].appearance, f).cpu(),
                               getattr(drawn[1].appearance, f))
                   for f in drawn[1].appearance._fields)
        if not point_mode:
            same = same and all(torch.equal(a.cpu(), b) for a, b in zip(
                drawn[0].elastic, drawn[1].elastic))
        a_err = (drawn[0].affine.cpu() - drawn[1].affine).abs().max().item()
        log(f"[train] augmentation drawn from one key for the card and the "
            f"CPU ({'points' if point_mode else 'masks'}, B={BATCH}): "
            f"parameters equal {same}, affine matrices max_abs_err "
            f"{a_err:.3e} (limit 1e-4)")
        if not same or not a_err <= 1e-4:
            fail("the card's augmentation draws differ from the CPU's")
    acc = steps.init_metric_acc()
    for _ in range(3):
        acc = step(model, optimizer, acc, batch, tkey)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    acc = step(model, optimizer, acc, batch, tkey)
    torch.cuda.synchronize()
    launches = launched(*CELLPOOL)
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
        acc = step(model, optimizer, acc, batch, tkey)
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    ms = statistics.median(step_ms)
    log(f"[train] train step, WESUPConfig defaults, point supervision: "
        f"{ms:.3f} ms/step, {BATCH / ms * 1e3:.2f} img/s (B={BATCH}, "
        f"{H}x{W}, bf16, median of {len(step_ms)}; min {min(step_ms):.3f} "
        f"max {max(step_ms):.3f}; peak {peak_gb:.2f} GiB; {card})")
    holder = [acc]

    def run_step():
        holder[0] = step(model, optimizer, holder[0], batch, tkey)

    breakdown(torch, "[train]", run_step)
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
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(2):
        macc = mstep(model, optimizer, macc, mbatch, tkey)
    torch.cuda.synchronize()
    mlaunch = launched(*CELLPOOL)
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


CELLPOOL = ("cell_pool0", "cell_pool_stage", "cell_pool0_bwd",
            "cell_pool_stage_bwd")


def launched(*names) -> dict:
    """The launch counts of the kernels ``names``."""
    from wesup_tpu_torch.ops import launch_counts

    counts = launch_counts()
    return {name: counts[name] for name in names}


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
    from wesup_tpu_torch.utils import prng

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
        breakdown(torch, f"[step {label}]",
                  lambda: step(model, imgs_dev, valid))
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
                prng.PRNGKey(7))
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


TILE_SLIDE, TILE_PATCH = (1512, 1516), 400   # the tile cell's slides


def tile_phase(torch, seed) -> list:
    """Phase 7, the tile cut and stitch: both kernels bitwise their plain
    versions at the tile cell's shapes, their launches, and their times
    beside the plain versions' and the HBM bound; returns the two entries
    of the kernels' JSON line.

    The plain versions are held on the CPU, as the tests hold them: on the
    card PyTorch divides by a scalar as a multiply by its reciprocal, so
    the plain cut there is not numpy's IEEE division.  They are timed on
    the card."""
    from wesup_tpu_torch.inference import _round_up, patch_grid
    from wesup_tpu_torch.ops import reset_launches, tile

    dev = torch.device("cuda")
    (H0, W0), P = TILE_SLIDE, TILE_PATCH
    rng = np.random.default_rng(seed)
    slide = torch.from_numpy(rng.integers(0, 256, (H0, W0, 3),
                                          dtype=np.uint8)).to(dev)
    tops, lefts = (torch.from_numpy(a.astype(np.int32)).to(dev)
                   for a in patch_grid(H0, W0, P))
    n = tops.numel() * lefts.numel()
    patch_hw, canvas_hw = (P, P), (_round_up(P), _round_up(P))
    probs = rng.random((n, P, P), dtype=np.float32)
    probs[:, 0, :3] = [0.5, 1.5, 2.5]                    # ties to even
    probs = torch.from_numpy(probs).to(dev)
    probs_u8 = torch.round(probs).to(torch.uint8)

    def cut_args(first, chunk, on=dev):
        return (slide.to(on), tops.to(on), lefts.to(on), first,
                min(chunk, n - first), chunk, patch_hw, canvas_hw)

    def stitch_plain(p, rounded):
        return tile.stitch_plain(p.cpu(), tops.cpu(), lefts.cpu(), (H0, W0),
                                 rounded)

    def same_bits(got, want, view):
        return torch.equal(got.cpu().view(view), want.view(view))

    # one slide of the tile cell (chunks of 8), then the other cases
    reset_launches()
    cell = [(f"cut chunk 8 at {first}",
             tile.cut(*cut_args(first, 8)),
             tile.cut_plain(*cut_args(first, 8, "cpu")), torch.int32)
            for first in range(0, n, 8)]
    cell.append(("stitch float32", tile.stitch(probs, tops, lefts, (H0, W0)),
                 stitch_plain(probs, False), torch.int64))
    torch.cuda.synchronize()
    launches = launched("tile_cut", "tile_stitch")
    want = {"tile_cut": -(-n // 8), "tile_stitch": 1}
    if launches != want:
        fail(f"one slide launched {launches}, expected {want}")
    cases = cell + [
        (f"cut chunk 16 at {first}", tile.cut(*cut_args(first, 16)),
         tile.cut_plain(*cut_args(first, 16, "cpu")), torch.int32)
        for first in range(0, n, 16)] + [
        (f"stitch {label}", tile.stitch(p, tops, lefts, (H0, W0), rounded),
         stitch_plain(p, rounded), torch.int64)
        for label, p, rounded in (("float32 rounded", probs, True),
                                  ("uint8", probs_u8, False))]
    for label, got, want_t, view in cases:
        if not same_bits(got, want_t, view):
            fail(f"tile {label} on {H0}x{W0} at {P} differs from its plain "
                 f"version")
    log(f"[tile] {H0}x{W0} slide, patches of {P}: {len(cases)} cuts and "
        f"stitches bitwise their plain versions; one slide's launches "
        f"{launches}")
    del cases, cell

    out = []
    for name, call, plain, nbytes in (
            ("tile_cut", lambda: tile.cut(*cut_args(0, 8)),
             lambda: tile.cut_plain(*cut_args(0, 8)),
             8 * P * P * 3 + 8 * canvas_hw[0] * canvas_hw[1] * 3 * 4),
            ("tile_stitch", lambda: tile.stitch(probs, tops, lefts, (H0, W0)),
             lambda: tile.stitch_plain(probs, tops, lefts, (H0, W0), False),
             probs.numel() * 4 + H0 * W0 * 8)):
        t_k = cuda_ms(torch, call)
        t_p = cuda_ms(torch, plain, n=5, warmup=1)
        b_ms, b_by = bound(nbytes, 0.0, torch.float32)
        log(f"[{name} time] {H0}x{W0} at {P}: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f}, bound {b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); "
            f"{share(nbytes, t_k)}")
        out.append({
            "name": name, "route": "cuda",
            "source": "wesup_tpu_torch/csrc/tile.cu",
            "replaces": "none: numpy in wesup_tpu/inference.py",
            "launches": launches[name], "max_abs_err": 0.0, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by})
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
    from wesup_tpu_torch.utils import prng

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
        tkey = prng.PRNGKey(7)
        holder = [steps.init_metric_acc()]

        def run():
            holder[0] = step(model, optimizer, holder[0], batch, tkey)

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
        breakdown(torch, f"[train {pooling_}]", run)
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
    ``rng``: 4-8 elliptic glands, purple on pink, with noise
    (``scripts.measure_eval_metrics.synthetic_pair``)."""
    from wesup_tpu_torch.scripts.measure_eval_metrics import synthetic_pair

    return synthetic_pair(rng, GLAS_HW)


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
    trace of ``torch.profiler`` (``scripts/profile_ops``)."""
    from wesup_tpu_torch.scripts import profile_ops

    events = profile_ops.load_trace(path)
    return profile_ops.busy_share(
        [e for e in events if e.get("cat") == profile_ops.KERNEL])


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
    ``seed``, at full width, 3 epochs and a resume, with the trainer's
    figures and its staging chain's checks."""
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

    # the first batch the staging chain copied for epoch 2: host batch,
    # device batch, event
    staged = {}
    real_stage = WESUPTrainer._stage

    def stage(self, batch, rng_idx, stream):
        dev_batch, event = real_stage(self, batch, rng_idx, stream)
        if rng_idx == (2, 0) and "train" not in staged and \
                "img_idx" in batch:
            staged["train"] = (batch, dev_batch, event)
        return dev_batch, event

    # a step that raises is logged and skipped by the trainer: catch it
    errors = ErrorRecords("Train")
    old_root = os.environ.get("RECORD_ROOT")
    os.environ["RECORD_ROOT"] = str(Path(tmp.name) / "records")
    logging.getLogger().addHandler(errors)
    try:
        with mock.patch.object(WESUPTrainer, "_get_step", new=get_step), \
                mock.patch.object(WESUPTrainer, "_stage", new=stage), \
                mock.patch.object(steps, "batch_key",
                                  wraps=steps.batch_key) as keys:
            torch.cuda.reset_peak_memory_stats()
            trainer = fit(root, epochs=3, batch_size=BATCH, seed=seed)
            alive = [t.name for t in threading.enumerate()
                     if t.name.startswith(("wesup-stage-", "wesup-loader-"))]
            peak_fit = torch.cuda.max_memory_allocated() / 2**30
            cache = trainer._resize_cache
            if not all(c is not None and c["imgs"].is_cuda
                       for c in cache.values()):
                fail("the device-resize cache is not on the card")
            ckpt_dir = trainer.record_dir / "checkpoints"
            if sorted(p.name for p in ckpt_dir.iterdir()) != [
                    "ckpt.0003.pth"]:
                fail(f"checkpoints after 3 epochs: {list(ckpt_dir.iterdir())}")
            n_first = len(keys.call_args_list)
            # the trainer's own profile_dir hook traces the resumed run's
            # first train phase, epoch 4
            resumed = fit(root, epochs=1, batch_size=BATCH, seed=seed,
                          checkpoint=str(ckpt_dir / "ckpt.0003.pth"),
                          profile_dir=str(Path(tmp.name) / "trace"))
            key_args = [(tuple(int(v) for v in c.args[0]),) + c.args[1:]
                        for c in keys.call_args_list]
    finally:
        logging.getLogger().removeHandler(errors)
        if old_root is None:
            os.environ.pop("RECORD_ROOT", None)
        else:
            os.environ["RECORD_ROOT"] = old_root

    # ---- 11a. every step ran; numbering, retention, history, keys --------
    stats = {**trainer.phase_stats, **resumed.phase_stats}
    epochs = (1, 2, 3, 4)
    if sorted(stats) != [(e, p) for e in epochs for p in ("train", "val")]:
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
    log(f"[{tag}] every batch of epochs 1-4 stepped, none raised: train "
        + ", ".join(f"{stats[(e, 'train')]['batches']}" for e in epochs)
        + " batches, val " + ", ".join(
            f"{stats[(e, 'val')]['batches']}" for e in epochs)
        + "; no error logged")
    # the staging chain: epochs 2 and 3 claimed the chain that the train
    # phase before them started, with batches already copied to the card
    # when their train phase began; epoch 1 and the resumed epoch 4 start
    # cold; no staging or loader thread outlives fit
    chain = {e: (stats[(e, "train")]["lookahead"],
                 stats[(e, "train")]["staged_at_start"]) for e in epochs}
    log(f"[{tag}] staging chain (claimed from the lookahead, batches on the "
        f"card at the train phase's start) by epoch: {chain}; staging or "
        f"loader threads alive after fit: {alive}")
    if not all(chain[e][0] and chain[e][1] >= 1 for e in (2, 3)) or \
            chain[1][0] or chain[4][0]:
        fail(f"the staging chain: {chain}")
    if alive:
        fail(f"threads outlive fit: {alive}")
    if "train" not in staged:
        fail("no staged batch of epoch 2 was recorded")
    host_b, dev_b, event = staged["train"]
    event.synchronize()
    wire = WESUPTrainer.wire(host_b)
    diff = [k for k, v in dev_b.items() if k != "rng_idx" and not (
        v.is_cuda and torch.equal(v.cpu(), torch.from_numpy(
            np.asarray(wire[k]))))]
    log(f"[{tag}] epoch 2's first staged batch ({len(dev_b) - 1} tensors, "
        f"copied on the side stream) read back equals its host batch: "
        f"{not diff}")
    if diff:
        fail(f"staged tensors differ from the host batch: {diff}")
    names = sorted(p.name for p in ckpt_dir.iterdir())
    with open(trainer.record_dir / "history.csv") as fp:
        rows = list(csv.reader(fp))
    log(f"[{tag}] resumed at epoch {resumed.initial_epoch}; checkpoints "
        f"{names}; history.csv {len(rows) - 1} rows, columns {rows[0]}")
    if (resumed.initial_epoch != 4 or names != ["ckpt.0004.pth"]
            or len(rows) != 5):
        fail("the resume did not continue at epoch 4 with latest-only "
             "checkpoints and 4 history rows")
    if not all(np.isfinite(float(v)) for r in rows[1:] for v in r):
        fail("history.csv holds values that are not finite")
    # the schedule a straight 3-epoch run follows: the base key
    # PRNGKey(seed + 1), epoch, train phase 0, batch i for each train batch
    # (tests/test_torch_port_trainer_fit.py holds the keys against the JAX
    # trainer's own)
    base = (0, seed + 1)
    want = [(base, e, 0, i) for e in epochs
            for i in range(stats[(e, "train")]["batches"])]
    log(f"[{tag}] per-batch keys: epochs 1-3 and the resumed epoch 4 "
        f"folded from (PRNGKey(seed + 1), epoch, 0, batch) in a straight "
        f"4-epoch schedule's order: {key_args == want} ({n_first} + "
        f"{len(key_args) - n_first} batches)")
    if key_args != want:
        fail("the resumed run's batch keys leave the straight 4-epoch "
             "schedule")

    # ---- 11b. the epochs' figures ----------------------------------------
    torch.cuda.synchronize()
    for e in epochs:
        what = {1: "warm-up", 2: "untraced, chain pre-warmed", 3: "untraced, "
                "chain pre-warmed", 4: "resumed, cold chain, under the "
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
                                    / "trace.epoch4.json")
    if n_kern:
        log(f"[{tag}] device busy over epoch 4's train phase (the trainer's "
            f"profile_dir trace, host ops recorded too): {busy / 1e3:.3f} ms "
            f"of a {span / 1e3:.3f} ms span (first kernel to last), busy "
            f"share {busy / span:.3f}, {n_kern} kernels, "
            f"{n_kern / stats[(4, 'train')]['batches']:.0f} per step; {card}")
    else:
        log(f"[{tag}] the profiler recorded no device kernels: busy share "
            "not measured")
    log(f"[{tag}] peak memory over the 3-epoch fit: {peak_fit:.2f} GiB; "
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
        dict(gpu_batch, rng_idx=(4, 0)), resumed._rng, cache=cache),
        tag)
    del trainer, resumed, cache, gpu_batch, step, step_log, staged
    del host_b, dev_b
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
    if counts != expected({"hypercol_upsample": 1, "pixel_head": 1}):
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
            ("pixel", step, {"hypercol_upsample": 1, "pixel_head": 1}),
            ("pixel, WESUP_FUSED_POOL1=1", gated,
             {"fused_relu_pool_pad": 1, "hypercol_upsample": 1,
              "pixel_head": 1})):
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
        breakdown(torch, f"[step {label}]",
                  lambda: run(model, imgs_dev, valid))
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
                else {"hypercol_upsample": n, "pixel_head": n})
        if "_tile" in label:
            # GLAS_HW at patch 400 or 464: one chunk of 4 patches an image
            want.update(tile_cut=n_images, tile_stitch=n_images)
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
                              ("pixel", {"hypercol_upsample": 1,
                                         "pixel_head": 1})):
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
            + f"; a malformed JPEG body: {bad[0]}")
        if counts != expected({k: v * n_requests
                               for k, v in per_request.items()}):
            fail(f"the {mode} server launched {counts}")
        if bad[0] != 400:
            fail(f"the {mode} server answered a malformed JPEG with "
                 f"{bad[0]}")
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[pixel] phase 12 took {time.perf_counter() - t_phase:.1f} s")


# GlaS's raw layout for phase 13: its 85 train images with two grades,
# its testA (60) and testB (20) cut to 8 + 8, 522x775 BMPs
GLAS_RAW = {"train": 85, "testA": 8, "testB": 8}
HOST_METRICS = ("accuracy", "dice", "detection_f1", "object_dice",
                "object_hausdorff")
OBJECT_METRICS = ("detection_f1", "object_dice", "object_hausdorff")


def write_raw_glas(root: Path, seed: int, kinds: bool = False) -> None:
    """GlaS as it ships, under ``root``: ``<split>_<i>.bmp`` images,
    ``<split>_<i>_anno.bmp`` masks holding a gland id per gland, and
    ``Grade.csv`` (name, patient ID, two grade columns; the last one has
    the grades "adenomatous" and "healthy"), made with numpy from ``seed``.
    With ``kinds``, the same pixels in other BMP kinds: the images as
    32-bit ``BI_BITFIELDS``, the masks as RLE8 with a gray palette."""
    from scipy import ndimage

    from wesup_tpu_torch.data.codec import write_bmp

    bw = bmp_writer()
    gray = np.repeat(np.arange(256)[:, None], 3, 1)

    def write(path, pixels):
        if not kinds:
            write_bmp(path, pixels)
            return
        h, w = pixels.shape[:2]
        if pixels.ndim == 3:
            bgra = np.concatenate([pixels[..., ::-1], np.full(
                (h, w, 1), 255, np.uint8)], -1)
            path.write_bytes(bw.bmp(bw.pack_rows(bgra, 32), w, h, 32,
                                    bw.BI_BITFIELDS,
                                    masks=(0xFF0000, 0xFF00, 0xFF)))
        else:
            path.write_bytes(bw.bmp(bw.rle(pixels, 8), w, h, 8, bw.BI_RLE8,
                                    palette=gray))

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    lines = ["name,patient ID,grade (GlaS),grade (Sirinukunwattana et al. "
             "2015)"]
    for split, n in GLAS_RAW.items():
        for i in range(1, n + 1):
            img, mask = glas_image(rng)
            ids, _ = ndimage.label(mask)
            write(root / f"{split}_{i}.bmp", img)
            write(root / f"{split}_{i}_anno.bmp",
                  np.minimum(ids, 255).astype(np.uint8))
            grade = ("adenomatous", "healthy")[int(rng.random() < 0.44)]
            lines.append(f"{split}_{i},{i % 16},"
                         f"{'malignant' if grade[0] == 'a' else 'benign'},"
                         f"{grade}")
    (root / "Grade.csv").write_text("\n".join(lines) + "\n")


def run_module(args, tag, timeout=600) -> tuple:
    """(stdout, seconds) of ``python -m <args>`` from the repository root,
    as a user runs the port's scripts; a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    sec = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{tag}: python -m {args[0]} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return out.stdout, sec


def plain_score(raw, gt, threshold):
    """One (prediction in [0, 1], ground truth) pair as ``evaluate_glas``
    scores it, timed: the region flip by the native library and by scipy
    (they must agree), then each object metric with the native library and
    with its plain versions (scipy labelling, ``directed_hausdorff``).
    Returns (flip equal, {metric: (native value, plain value)}, {name:
    (native ms, plain ms)}).  Run in worker processes of
    ``scripts._common.pool_map``."""
    from wesup_tpu_torch import native
    from wesup_tpu_torch.ops.morphology import flip_small_regions
    from wesup_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    flipped = native.flip_small_regions(raw, threshold)
    t1 = time.perf_counter()
    pred = flip_small_regions(raw, threshold)
    t2 = time.perf_counter()
    times = {"flip_small_regions": ((t1 - t0) * 1e3, (t2 - t1) * 1e3)}
    values = {}
    for name in OBJECT_METRICS:
        fn = metrics.HOST_METRICS[name]
        t0 = time.perf_counter()
        got = fn(pred, gt)
        t1 = time.perf_counter()
        with mock.patch.object(metrics, "_label", native.label8_plain), \
                mock.patch.object(metrics, "hausdorff",
                                  native.hausdorff_plain):
            want = fn(pred, gt)
        t2 = time.perf_counter()
        values[name] = (got, want)
        times[name] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
    return bool(np.array_equal(flipped, pred)), values, times


def hold_plain(scored, labels, csv_rows=None) -> dict:
    """Fail unless each pair's region flips agree and its native object
    metrics (and the CSV's, where given) equal the plain versions' within
    1e-12 (detection F1, object Dice) and 1e-6 (object Hausdorff); returns
    the largest errors."""
    worst = {k: 0.0 for k in OBJECT_METRICS}
    for i, (flip_ok, values, _) in enumerate(scored):
        if not flip_ok:
            fail(f"{labels[i]}: the native region flip differs from scipy's")
        for j, k in enumerate(OBJECT_METRICS):
            got, want = values[k]
            have = [got] + ([float(csv_rows[i][j + 1])] if csv_rows else [])
            lim = 1e-6 if k == "object_hausdorff" else 1e-12
            err = max(abs(v - want) for v in have)
            if not (err <= lim or all(v == want for v in have)):
                fail(f"{labels[i]} {k}: native/CSV {have}, plain {want!r}")
            worst[k] = max(worst[k], err if np.isfinite(err) else 0.0)
    return worst


def protocol_phase(torch, card, seed) -> None:
    """Phase 13: the GlaS protocol as a user runs it on the card's
    machine, from GlaS's raw layout to the contest metrics' CSVs."""
    import tempfile

    from wesup_tpu_torch import native, test_glas
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.models.trainer import WESUPTrainer
    from wesup_tpu_torch.ops import cellpool, launch_counts, reset_launches
    from wesup_tpu_torch.scripts import measure_eval_metrics
    from wesup_tpu_torch.scripts._common import imread_gray, pool_map
    from wesup_tpu_torch.train import fit

    t_phase = time.perf_counter()
    tag = "protocol"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase13_")
    raw, data = Path(tmp.name) / "GlaS", Path(tmp.name) / "data_glas"
    secs = {}

    # ---- 13a. raw GlaS -> prepare_glas -> generate_points ----------------
    t0 = time.perf_counter()
    write_raw_glas(raw, seed)
    secs["write raw set"] = time.perf_counter() - t0
    _, secs["prepare_glas"] = run_module(
        ["wesup_tpu_torch.prepare_glas", raw, "-o", data, "--seed", seed],
        tag)
    counts = {split: len(list((data / split / "masks").iterdir()))
              for split in ("train", "val", "testA", "testB")}
    # 85 train images, val_size 0.1: ceil(8.5) = 9 val
    if counts != {"train": 76, "val": 9, "testA": 8, "testB": 8}:
        fail(f"prepare_glas split the raw set into {counts}")
    _, secs["generate_points"] = run_module(
        ["wesup_tpu_torch.scripts.generate_points", data / "train", "-p",
         "1e-4", "--seed", "0"], tag)
    (data / "train" / "points-0.0001").rename(data / "train" / "points")
    points = sorted((data / "train" / "points").iterdir())
    if len(points) != counts["train"] or not all(
            p.stat().st_size for p in points):
        fail(f"generate_points wrote {len(points)} files, some empty")
    log(f"[{tag}] raw GlaS layout ({sum(GLAS_RAW.values())} 522x775 BMPs "
        f"+ annotations, Grade.csv) -> prepare_glas {counts} -> "
        f"generate_points -p 1e-4: {len(points)} CSVs")

    # ---- 13b. train one epoch with the host metrics ----------------------
    reads, val_steps, host_s = [], [], []
    real_get, real_fetch = WESUPTrainer._get_step, WESUPTrainer._fetch_pred
    real_eval = WESUPTrainer.evaluate_host

    def get_step(self, kind, hw):
        step = real_get(self, kind, hw)
        if kind != "eval":
            return step

        def run(*args, **kwargs):
            before = launch_counts()
            with recorded(cellpool, "_pool0_fwd", 1) as k1, \
                    recorded(cellpool, "_stage_fwd", 4) as k2:
                out = step(*args, **kwargs)
                if not val_steps:
                    torch.cuda.synchronize()
                    hold_pool_kernels(torch, k1, k2, f"{tag} val step")
            after = launch_counts()
            val_steps.append({k: after[k] - before[k] for k in after})
            return out
        return run

    def evaluate_host(self, *args):
        t0 = time.perf_counter()
        out = real_eval(self, *args)
        host_s.append(time.perf_counter() - t0)
        return out

    errors = ErrorRecords("Train")
    old_root = os.environ.get("RECORD_ROOT")
    os.environ["RECORD_ROOT"] = str(Path(tmp.name) / "records")
    logging.getLogger().addHandler(errors)
    try:
        with mock.patch.object(WESUPTrainer, "_get_step", new=get_step), \
                mock.patch.object(WESUPTrainer, "_fetch_pred", new=lambda
                                  self, pred: reads.append(1)
                                  or real_fetch(self, pred)), \
                mock.patch.object(WESUPTrainer, "evaluate_host",
                                  new=evaluate_host):
            t0 = time.perf_counter()
            trainer = fit(data, epochs=1, batch_size=BATCH, seed=seed,
                          metrics=HOST_METRICS)
            secs["train.fit, 1 epoch"] = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(errors)
        if old_root is None:
            os.environ.pop("RECORD_ROOT", None)
        else:
            os.environ["RECORD_ROOT"] = old_root
    tr, va = trainer.phase_stats[(1, "train")], trainer.phase_stats[(1, "val")]
    if (tr["failed"] or va["failed"] or errors.records
            or tr["samples"] != counts["train"]
            or va["batches"] != counts["val"]):
        fail(f"the fit with metrics= ran train {tr} and val {va}; "
             f"{len(errors.records)} errors logged")
    with open(trainer.record_dir / "history.csv") as fp:
        header, row = list(csv.reader(fp))
    hist = dict(zip(header, map(float, row)))
    extra = {k: hist.get(f"val_{k}") for k in OBJECT_METRICS}
    if not all(v is not None and np.isfinite(v) for v in extra.values()):
        fail(f"history.csv lacks finite host metrics: {header} {row}")
    want = expected({"cell_pool0": 1, "cell_pool_stage": 4})
    if len(reads) != va["batches"] or len(val_steps) != va["batches"] or \
            any(n != want for n in val_steps):
        fail(f"{len(reads)} reads and {len(val_steps)} val steps for "
             f"{va['batches']} val batches; launches {val_steps[:2]}")
    log(f"[{tag}] train.fit 1 epoch, B={BATCH}, metrics="
        f"{','.join(HOST_METRICS)}: train {tr['batches']} bucketed batches "
        f"{tr['seconds']:.3f} s, val {va['batches']} images "
        f"{va['seconds']:.3f} s (host metrics {host_s[0]:.3f} s, "
        f"{host_s[0] * 1e3 / va['samples']:.1f} ms an image); reads "
        f"{len(reads)} = val batches; launches per val batch "
        + str({k: v for k, v in val_steps[0].items() if v})
        + "; history " + ", ".join(f"val_{k} {v:.6g}" for k, v in
                                  extra.items()) + f"; {card}")

    # ---- 13c. test_glas, then evaluate_glas, against the plain versions --
    ckpt = trainer.record_dir / "checkpoints" / "ckpt.0001.pth"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = test_glas.test(ckpt, scales=GLAS_SCALES, data_root=data)
    torch.cuda.synchronize()
    secs["test_glas, 5 scales"] = time.perf_counter() - t0
    glas_launches = launch_counts()
    glas_masks = {p.relative_to(results): p.read_bytes()
                  for p in sorted(results.rglob("*.png"))}
    stdout, secs["evaluate_glas"] = run_module(
        ["wesup_tpu_torch.scripts.evaluate_glas", results, "--gt-root",
         data], tag)
    means = [line for line in stdout.splitlines() if ": " in line]
    if len(means) != 10:
        fail(f"evaluate_glas printed {means}")
    labels, pairs, rows, gts = [], [], [], []
    for split in GLAS_TEST:
        preds = sorted((results / split).glob("*.png"))
        gt_paths = sorted((data / split / "masks").iterdir())
        with open(results / f"{split}.csv", newline="") as fp:
            csv_rows = list(csv.reader(fp))
        if (csv_rows[0] != ["", *OBJECT_METRICS]
                or len(preds) != len(gt_paths)
                or [r[0] for r in csv_rows[1:]] != [p.name for p in preds]):
            fail(f"{split}.csv: {csv_rows[:2]}")
        labels += [f"{split}/{p.name}" for p in preds]
        gts += [imread_gray(g) for g in gt_paths]
        pairs += [(imread_gray(p) / 255, g) for p, g in zip(preds, gts[-len(
            preds):])]
        rows += csv_rows[1:]
    # GlaS-like predictions, as a trained model's would be (one epoch
    # from random weights gives near-empty masks): each ground truth
    # shifted by (5, -4) px with 0.2% of its pixels flipped, scored by
    # evaluate_glas too
    rng = np.random.default_rng(seed)
    noisy, shifted, noisy_rows = [], Path(tmp.name) / "shifted", []
    for label, g in zip(labels, gts):
        p = np.roll(g, (5, -4), (0, 1)).astype(np.float64)
        flip = rng.random(g.shape) < 0.002
        p[flip] = 1 - p[flip]
        noisy.append((p, g))
        (shifted / label).parent.mkdir(parents=True, exist_ok=True)
        codec.write_png(shifted / label, (p * 255).astype(np.uint8))
    stdout, secs["evaluate_glas, shifted"] = run_module(
        ["wesup_tpu_torch.scripts.evaluate_glas", shifted, "--gt-root",
         data], tag)
    shifted_means = [line for line in stdout.splitlines() if ": " in line]
    for split in GLAS_TEST:
        with open(shifted / f"{split}.csv", newline="") as fp:
            noisy_rows += [[f"{split}/{r[0]}", *r[1:]]
                           for r in list(csv.reader(fp))[1:]]
    if [r[0] for r in noisy_rows] != labels:
        fail(f"evaluate_glas on the shifted masks wrote {noisy_rows[:2]}")
    t0 = time.perf_counter()
    scored = pool_map(plain_score, [(p, g, 2000) for p, g in pairs + noisy])
    secs["plain check"] = time.perf_counter() - t0
    for what, part, csv_rows, printed in (
            ("test_glas's masks", scored[:len(pairs)], rows, means),
            ("the ground truths shifted by (5, -4) px with 0.2% of pixels "
             "flipped", scored[len(pairs):], noisy_rows, shifted_means)):
        worst = hold_plain(part, labels, csv_rows)
        log(f"[{tag}] evaluate_glas over {len(part)} test images, "
            f"{what} ({'; '.join(printed[2:5])} ...): CSV values against "
            "the plain (scipy) versions, max abs err " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items())
            + " (limits 1e-12, 1e-12, 1e-6); region flip equal to scipy's")
    glands = np.mean([native.label8(g).max() for g in gts])
    for name in ("flip_small_regions",) + OBJECT_METRICS:
        ms = np.array([t[name] for _, _, t in scored[len(pairs):]])
        log(f"[{tag}] {name}: native {ms[:, 0].mean():.1f} ms, plain "
            f"{ms[:, 1].mean():.1f} ms per 522x775 image (shifted ground "
            f"truths, {glands:.1f} glands an image, mean of {len(ms)}, max {ms[:, 0].max():.1f} / "
            f"{ms[:, 1].max():.1f}; {min(len(scored), os.cpu_count() or 1)} "
            f"worker processes at once on {os.cpu_count()} host cores); "
            f"{card}")

    # ---- 13e. the raw set again in the BMP kinds slice 12 added ----------
    t0 = time.perf_counter()
    raw2, data2 = Path(tmp.name) / "GlaS-kinds", Path(tmp.name) / "data-kinds"
    write_raw_glas(raw2, seed, kinds=True)
    kinds_bytes = sum(p.stat().st_size for p in raw2.glob("*.bmp"))
    plain_bytes = sum(p.stat().st_size for p in raw.glob("*.bmp"))
    run_module(["wesup_tpu_torch.prepare_glas", raw2, "-o", data2,
                "--seed", seed], tag)
    n_masks = n_images = 0
    for p in sorted(data.rglob("*.bmp")):
        q = data2 / p.relative_to(data)
        if p.parent.name == "masks":
            n_masks += 1
            if q.read_bytes() != p.read_bytes():
                fail(f"{tag}: prepare_glas on the RLE8 annotations wrote "
                     f"{q.relative_to(data2)} unlike the uncompressed run")
        else:
            n_images += 1
            if not np.array_equal(codec.imread_rgb(q), codec.imread_rgb(p)):
                fail(f"{tag}: the bit-field image {q.relative_to(data2)} "
                     "reads unlike the 24-bit one")
    torch.cuda.synchronize()
    reset_launches()
    results2 = test_glas.test(ckpt, scales=GLAS_SCALES, data_root=data2)
    torch.cuda.synchronize()
    kinds_launches = launch_counts()
    kinds_masks = {p.relative_to(results2): p.read_bytes()
                   for p in sorted(results2.rglob("*.png"))}
    if kinds_masks != glas_masks:
        fail(f"{tag}: test_glas over the BMP kinds wrote other masks "
             f"({len(kinds_masks)} against {len(glas_masks)})")
    if (kinds_launches != glas_launches
            or not kinds_launches.get("cell_pool0")
            or kinds_launches["cell_pool_stage"]
            != 4 * kinds_launches["cell_pool0"]):
        fail(f"{tag}: test_glas over the BMP kinds launched "
             f"{kinds_launches}, over the 24-bit set {glas_launches}")
    secs["BMP kinds: write, prepare_glas, test_glas"] = (
        time.perf_counter() - t0)
    log(f"[{tag}] the raw set again with its images as 32-bit BI_BITFIELDS "
        f"and its annotations as RLE8 BMPs ({kinds_bytes} bytes against "
        f"{plain_bytes}): prepare_glas's {n_masks} masks byte-equal to the "
        f"uncompressed run's and its {n_images} images read equal; "
        f"test_glas at 5 scales over it: {len(kinds_masks)} masks equal, "
        "launches " + str({k: v for k, v in kinds_launches.items() if v})
        + f" as over the 24-bit set; {card}")

    # ---- 13d. the val phase three ways -----------------------------------
    t0 = time.perf_counter()
    host = {}
    for label, metrics, eager in measure_eval_metrics.VARIANTS:
        best, med, host[label], n_reads = measure_eval_metrics.time_val_phase(
            data, metrics, eager, repeats=1)
        log(f"[{tag}] val phase, {label}: {best:.3f} s over "
            f"{counts['val']} images (B=1, after a warm-up run), reads "
            f"{n_reads}, host metrics {host[label]}; {card}")
    secs["val phase three ways"] = time.perf_counter() - t0
    deferred, eager = (host[v[0]] for v in measure_eval_metrics.VARIANTS[1:])
    if not deferred or deferred != eager:
        fail(f"deferred and eager host metrics differ: {deferred} {eager}")
    del trainer
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] seconds per step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + f"; {card}")
    log(f"[{tag}] phase 13 took {time.perf_counter() - t_phase:.1f} s")


# The JAX package's easy-protocol result on a TPU v5e (README's table, 150
# epochs at the defaults); its figures are the reference, not the card's
JAX_EASY = {
    "testA": {"Accuracy": 0.998, "Dice": 0.994, "Detection F1": 0.95,
              "Object Dice": 0.93},
    "testB": {"Accuracy": 0.999, "Dice": 0.995, "Detection F1": 1.00,
              "Object Dice": 0.995},
}
QUALITY_METRICS = ("Accuracy", "Dice", "Detection F1", "Object Dice",
                   "Object Hausdorff")


def quality_phase(torch, card):
    """Phase 14: ``scripts.quality_protocol`` at its defaults (the easy
    task, 150 epochs, data seed 0) on the card, with its gates.  Returns a
    temporary directory that holds the trained model's last checkpoint as
    a record dir (``checkpoints/ckpt.*.pth``), for phase 16."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from wesup_tpu_torch import native
    from wesup_tpu_torch.models.trainer import WESUPTrainer
    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.scripts import profile_ops
    from wesup_tpu_torch.scripts import quality_protocol as qp
    from wesup_tpu_torch.scripts._common import imread_gray, pool_map

    t_phase = time.perf_counter()
    tag = "quality"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase14_")
    args = qp.parse_args(["--root", str(Path(tmp.name) / "easy"),
                          "--out", str(Path(tmp.name) / "easy.json")])
    trainers, busy, held = [], {}, []
    real_get = WESUPTrainer._get_step
    real_epoch = WESUPTrainer.train_one_epoch

    def get_step(self, kind, hw):
        step = real_get(self, kind, hw)
        if kind != "train" or held:
            return step

        def run(*a, **k):
            if held:
                return step(*a, **k)
            # the first train step of the run, held against plain
            out = []
            held.append(hw)
            hold_step_kernels(torch, lambda: out.append(step(*a, **k)), tag)
            return out[0]
        return run

    def train_one_epoch(self, no_val=False):
        if not trainers:
            trainers.append(self)
        if self._epoch_idx != 2:
            return real_epoch(self, no_val)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            real_epoch(self, no_val)
            torch.cuda.synchronize()
        busy["kern"], busy["busy"], busy["span"] = profile_ops.busy_share(
            [e for e in profile_ops.events_from_profiler(prof)
             if e["cat"] == profile_ops.KERNEL])

    errors = ErrorRecords("Train")
    old_root = os.environ.get("RECORD_ROOT")
    logging.getLogger().addHandler(errors)
    try:
        with mock.patch.object(WESUPTrainer, "_get_step", new=get_step), \
                mock.patch.object(WESUPTrainer, "train_one_epoch",
                                  new=train_one_epoch):
            reset_launches()
            summary, secs = qp.run(args)
            launches = launch_counts()
    finally:
        logging.getLogger().removeHandler(errors)
        if old_root is None:
            os.environ.pop("RECORD_ROOT", None)
        else:
            os.environ["RECORD_ROOT"] = old_root
    if errors.records:
        fail(f"the trainer logged {len(errors.records)} errors, the first: "
             f"{errors.records[0].getMessage()}")
    if not held:
        fail("no train step's K1-K4 were held against their plain versions")
    want_keys = {"variant", "epochs", "best_val_dice", "final_val_dice",
                 "splits", "wall_s", "record_dir", "card"}
    if set(summary) != want_keys:
        fail(f"the protocol's summary has the keys {sorted(summary)}")
    log(f"[{tag}] launches over the protocol (train, val, test_glas): "
        f"{launches}")
    on_path = {"cell_pool0", "cell_pool_stage", "cell_pool0_bwd",
               "cell_pool_stage_bwd"}
    if {k for k, v in launches.items() if v} != on_path:
        fail(f"the protocol launched {launches}; K1-K4 and no other kernel "
             "were expected")

    # ---- 14a. the gates: best val Dice, a breakthrough -------------------
    with open(Path(summary["record_dir"]) / "history.csv") as fp:
        dice = [float(r["val_dice"]) for r in csv.DictReader(fp)]
    if len(dice) != args.epochs:
        fail(f"history.csv holds {len(dice)} epochs, not {args.epochs}")
    through = next((e + 1 for e, d in enumerate(dice) if d > 0.9), None)
    log(f"[{tag}] easy protocol, {args.epochs} epochs: best val Dice "
        f"{max(dice):.4f} at epoch {dice.index(max(dice)) + 1}, final "
        f"{dice[-1]:.4f}, breakthrough (val Dice > 0.9) at epoch {through} "
        "(JAX on a TPU v5e: best 0.993 at epoch 65, final 0.908; gates: "
        f"best >= 0.95, a breakthrough within {args.epochs} epochs); {card}")
    if not max(dice) >= 0.95:
        fail(f"best val Dice {max(dice):.4f} < 0.95")
    if through is None:
        fail(f"no breakthrough (val Dice > 0.9) in {args.epochs} epochs")

    # ---- 14b. the test protocol's metrics beside the JAX package's -------
    for split in ("testA", "testB"):
        got = summary["splits"].get(split, {})
        if set(got) != set(QUALITY_METRICS) or not all(
                np.isfinite(v) for v in got.values()):
            fail(f"{split}: evaluate_glas reported {got}")
        log(f"[{tag}] {split} ({args.n_test} images): " + ", ".join(
            f"{m} {got[m]:.4f} (JAX {JAX_EASY[split][m]})"
            if m in JAX_EASY[split] else f"{m} {got[m]:.4f} (JAX: not in "
            "README)" for m in QUALITY_METRICS) + f"; {card}")

    # ---- 14c. the host metrics on the trained model's masks --------------
    results = Path(summary["record_dir"]) / "results-5scale"
    labels, pairs, rows = [], [], []
    for split in GLAS_TEST:
        preds = sorted((results / split).glob("*.png"))
        with open(results / f"{split}.csv", newline="") as fp:
            rows += list(csv.reader(fp))[1:]
        labels += [p.name for p in preds]
        pairs += [(imread_gray(p) / 255, imread_gray(
            Path(args.root) / split / "masks" / p.name), 2000) for p in preds]
    t0 = time.perf_counter()
    scored = pool_map(plain_score, pairs)
    worst = hold_plain(scored, labels, rows)
    glands = np.mean([native.label8(g).max() for _, g, _ in pairs])
    log(f"[{tag}] evaluate_glas's CSVs on the trained masks ({len(pairs)} "
        "images) against the plain (scipy) versions, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limits 1e-12, 1e-12, 1e-6); {time.perf_counter() - t0:.2f} s")
    for name in ("flip_small_regions",) + OBJECT_METRICS:
        ms = np.array([t[name] for _, _, t in scored])
        log(f"[{tag}] {name} on the trained masks: native "
            f"{ms[:, 0].mean():.1f} ms, plain {ms[:, 1].mean():.1f} ms per "
            f"{args.hw[0]}x{args.hw[1]} image ({glands:.1f} glands an "
            f"image, mean of {len(ms)}, max {ms[:, 0].max():.1f} / "
            f"{ms[:, 1].max():.1f}; {min(len(ms), os.cpu_count() or 1)} "
            f"worker processes at once on {os.cpu_count()} host cores); "
            f"{card}")

    # ---- 14d. times: per epoch, per step, device busy --------------------
    stats = trainers[0].phase_stats
    train_s = [stats[(e, "train")]["seconds"] for e in range(1, args.epochs + 1)]
    val_s = [stats[(e, "val")]["seconds"] for e in range(1, args.epochs + 1)]
    n_img = stats[(2, "train")]["samples"]
    med = statistics.median(train_s[2:])
    log(f"[{tag}] train seconds per epoch ({n_img} images at B="
        f"{trainers[0].config.batch_size}): median {med:.3f} "
        f"({n_img / med:.1f} img/s), epoch 1 {train_s[0]:.3f}, max "
        f"{max(train_s[2:]):.3f}; val {statistics.median(val_s):.3f} s "
        f"({stats[(2, 'val')]['samples']} images); {card}")
    if busy.get("span"):
        log(f"[{tag}] epoch 2 (train + val) under the profiler: "
            f"{busy['kern']} kernels, device busy "
            f"{busy['busy'] / 1e3:.1f} ms of a {busy['span'] / 1e3:.1f} ms "
            f"span, busy share {busy['busy'] / busy['span']:.3f}; {card}")
    else:
        log(f"[{tag}] no device kernels recorded: busy share not measured")
    log(f"[{tag}] seconds per protocol step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items())
        + f"; wall {summary['wall_s']} s; {card}")
    trained = tempfile.TemporaryDirectory(prefix="wesup_trained_")
    last = sorted((Path(summary["record_dir"]) / "checkpoints").glob(
        "ckpt.*.pth"))[-1]
    (Path(trained.name) / "checkpoints").mkdir()
    shutil.copy(last, Path(trained.name) / "checkpoints" / last.name)
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return trained


# Phase 15: JPEG images made from arithmetic alone (no RNG stream, so any
# numpy makes the same pixels), encoded by the plain encoder in each
# sampling mode (its bytes are cv2.imencode's with that
# IMWRITE_JPEG_SAMPLING_FACTOR), and the SHA-256 of cv2.imdecode's
# colour (RGB) and gray reads of them, computed with OpenCV 5.0.0
# (libjpeg-turbo 3.1.2), which the card's machine does not have
JPEG_HW = (97, 131)
JPEG_ORIENT_HW = (37, 53)
JPEG_SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2),
                  "440": (1, 2), "gray": None}
JPEG_CV2_SHA256 = {
    "bytes":
        "cb70fd63828fcf610d8ff69d0a70f305a5cde2c058ebbf6bf0c49cd52a011af2",
    "444":
        "6f2b1d35eaae0b0accccbacd0c6109110175a068c1e3e00fe86ac7b9f6de4b6d",
    "422":
        "73251fb8660b2adc7e39b0aac5ebb456df5580cc210c3458605532efd336495b",
    "420":
        "4caa1b96ab4d134d9d37e6e48f3946f72901329c51b7661260b43e2138cf4d57",
    "440":
        "54efa629f85fa77b5543a7ef0788ff8690a03caff8370dce0efbed9d9f8781e2",
    "gray":
        "7bcef6ca792b01d47753b06d7c840c34a83edbc4f1834279251d503e40e67c73",
    "orientations":
        "f3edf190a6ac164d7c2d6b486da626eda373751204c03af6ee99cb2e77b0d7d9",
}
# the files of beyond_cases() (tests/torch_jpeg_writer.py, integer
# arithmetic only): the SHA-256 of their bytes and of cv2.imdecode's
# colour (RGB) and gray reads of each, computed with OpenCV 5.0.0
# (libjpeg-turbo 3.1.2); a transcode's equal its baseline source's
JPEG_BEYOND_SHA256 = {
    "bytes":
        "9cb47688f7607e13056993bd7961096ee78775dbf3731d7a63c30b7e70acc0de",
    "progressive 4:2:0":
        "4caa1b96ab4d134d9d37e6e48f3946f72901329c51b7661260b43e2138cf4d57",
    "progressive 4:4:4":
        "6f2b1d35eaae0b0accccbacd0c6109110175a068c1e3e00fe86ac7b9f6de4b6d",
    "progressive gray, restarts":
        "7bcef6ca792b01d47753b06d7c840c34a83edbc4f1834279251d503e40e67c73",
    "no DHT":
        "4caa1b96ab4d134d9d37e6e48f3946f72901329c51b7661260b43e2138cf4d57",
    "arithmetic, DAC, restarts":
        "4caa1b96ab4d134d9d37e6e48f3946f72901329c51b7661260b43e2138cf4d57",
    "progressive arithmetic, DAC, restarts":
        "4caa1b96ab4d134d9d37e6e48f3946f72901329c51b7661260b43e2138cf4d57",
    "CMYK":
        "c0e95bb90f965fb7de3bf661d09c721776bb0f17df32f68b1b71331f2025a818",
    "YCCK 4:2:0":
        "07a42313c4c4f7bf5ac5f0873b4978e4f92c61f105acebd71d683eba0d34297e",
}
# the files of slice12_cases() (tests/torch_jpeg_writer.py, integer
# arithmetic only): the SHA-256 of their bytes, and of each one's four
# reads by cv2 (reads_sha256: cv2.imdecode's then cv2.imread's, colour
# (RGB) then gray, a None read as b"None"), computed with OpenCV 5.0.0
# (libjpeg-turbo 3.1.2)
JPEG_SLICE12_SHA256 = {
    "bytes":
        "50096839035391b1bed0fcbc6bfba214ddf57de6c36674a9cdb32bb39ab9f6e7",
    "smoothed 4:2:0, the simple script cut early":
        "9d6b90d1d82c660032e63eb6a2bd6167b7df62e6e51fc2a305a200b1cb586e03",
    "smoothed 4:2:0, DC only":
        "90f3807f3d3efe717947bd9aedf38f6239989721948908a52fbfba76e48fe3af",
    "smoothed 4:4:4, luma refined, chroma not":
        "92f3dcc601b3f6b02df2198a77106344939d21f738d7638fb274199fb982940a",
    "smoothed gray, DC at Al 1, restarts":
        "5a7abc3ed69325828bea963f5f08deec405028cdb2a154335b0846b3a25ff8b1",
    "smoothed 4:2:0, the last refinement left out":
        "6963c7faf80cb5e05230bfb91cf306df2d4045bd3b73cc1bbe628d5deb4e178c",
    "smoothed progressive arithmetic, cut early, restarts":
        "9d6b90d1d82c660032e63eb6a2bd6167b7df62e6e51fc2a305a200b1cb586e03",
    "lossless gray, predictor 1":
        "e47eb3bc2d04686eda4f17c12f3148a12c784e4db8c0fc5210bef2f850299adf",
    "lossless gray, predictor 4, Pt 2, restarts":
        "7a5518c1d3a79d000abeff08cb60780b5e01ab05a622eaf696b0133ccb7e8c8e",
    "lossless gray, predictor 7":
        "99ad504b813ee82fa804f6b9df41fc431595fb6246074935f8c52e8159b4694b",
    "lossless RGB, predictor 6, restarts":
        "9bf0fe46b7a7021c4e02686e7582a6a78a2e6ca6ffaeb4a493bc63f8a1c5f392",
    "lossless RGB 4:2:0, predictor 5":
        "54b0f9929f11917d5962cd07eaee4efdbed1e7036dccf04407744942267f828d",
    "baseline without EOI":
        "6f5410c0856e919579b499629af23549c3ebe7d53c0fb64800a636188bce810c",
    "baseline, a COM and no EOI":
        "1bdc0e65cbe955c7b442652ef5f35d5f1e0fdf529b725c17fe8456639f79d2e2",
    "progressive without EOI":
        "6f5410c0856e919579b499629af23549c3ebe7d53c0fb64800a636188bce810c",
}
# the kinds timed per 1000x1000 patch (written from the baseline patch,
# or its pixels for CMYK, YCCK and lossless gray)
PATCH_KINDS = ("progressive", "no_dht", "arithmetic",
               "arithmetic_progressive", "cmyk", "ycck", "smoothed",
               "lossless")
# the slides' smoothed transcodes may move a mask's foreground share by
# this much at most: the script leaves luma's coefficients one bit short
SMOOTHED_FG_BOUND = 0.05
# DigestPath2019's colonoscopy slides are JPEG, tiled at 1000: two
# synthetic slides whose sides are not multiples of the patch
DP_SLIDE_HW = (2300, 3100)
DP_PATCH = 1000


def smoke_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8: gradients under a hashed texture, integer
    arithmetic only."""
    y, x = np.mgrid[0:h, 0:w].astype(np.uint32)
    c = np.arange(3, dtype=np.uint32)
    hsh = ((x[..., None] * np.uint32(73856093))
           ^ (y[..., None] * np.uint32(19349663))
           ^ (c * np.uint32(83492791) + np.uint32(seed * 2654435761 % 2**32)))
    hsh = hsh * np.uint32(2246822519)
    tex = (hsh >> np.uint32(26)).astype(np.int64) - 32          # -32..31
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 127 // max(h + w - 2, 1)], -1).astype(np.int64)
    return np.clip(base + tex, 0, 255).astype(np.uint8)


def with_orientation(data: bytes, value: int, order: str) -> bytes:
    """``data`` with an Exif APP1 (IFD0: Orientation = ``value``, byte
    order ``order``, "II" or "MM") after its JFIF APP0."""
    import struct

    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return (data[:20] + b"\xff\xe1" + struct.pack(">H", len(body) + 2)
            + body + data[20:])


def jpeg_cases():
    """{group: [JPEG bytes, ...]}: one file per sampling mode at
    ``JPEG_HW``, and the eight orientations in both byte orders on a
    4:2:0 and a gray file at ``JPEG_ORIENT_HW``."""
    from wesup_tpu_torch.data.jpeg import encode_plain

    img = smoke_image(*JPEG_HW)
    cases = {}
    for name, sampling in JPEG_SAMPLINGS.items():
        cases[name] = [encode_plain(img[..., 0]) if sampling is None
                       else encode_plain(img, sampling)]
    small = smoke_image(*JPEG_ORIENT_HW, seed=1)
    bases = [encode_plain(small), encode_plain(small[..., 0])]
    cases["orientations"] = [with_orientation(b, v, order) for b in bases
                             for v in range(1, 9) for order in ("II", "MM")]
    return cases


def jpeg_writer():
    """``tests/torch_jpeg_writer.py``: numpy only, integer arithmetic
    where it makes coefficients, so its files are the same bytes on every
    machine."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import torch_jpeg_writer

    return torch_jpeg_writer


def bmp_writer():
    """``tests/torch_bmp_writer.py``: numpy only, like the JPEG writer."""
    jpeg_writer()                  # puts tests/ on the path
    import torch_bmp_writer

    return torch_bmp_writer


def cmyk_pixels(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) stored CMYK samples of an RGB image: C, M, Y = 255 - R,
    G, B less half their minimum, K that half (integer arithmetic)."""
    cmy = 255 - img.astype(np.int64)
    k = cmy.min(-1, keepdims=True) // 2
    return np.concatenate([cmy - k, k], -1).astype(np.uint8)


def beyond_jpeg(kind: str, data) -> bytes:
    """A JPEG beyond baseline by the test writer: ``data`` (a baseline
    file, or an RGB image for "cmyk" and "ycck") transcoded as ``kind``
    (one of JPEG_BEYOND_KINDS)."""
    w = jpeg_writer()
    if kind == "cmyk":
        return w.four_component(cmyk_pixels(data), 0)
    if kind == "lossless":                      # pixels: the gray channel
        return w.lossless(data[..., 0].astype(np.int64))
    if kind == "ycck":
        return w.four_component(cmyk_pixels(data), 2,
                                ((2, 2), (1, 1), (1, 1), (2, 2)))
    if kind == "no_dht":
        return w.without_dht(data)
    frame = w.parse(data)
    return {
        "progressive": lambda: w.progressive(frame),
        "progressive_restarts": lambda: w.progressive(frame, restart=3),
        "early_stop": lambda: w.progressive(
            frame, w.early_stop(len(frame.comps))),
        # the simple script without its last refinement: coefficients 1-9
        # of luma one bit short, and libjpeg smooths the blocks
        "smoothed": lambda: w.progressive(
            frame, w.simple_progression(len(frame.comps))[:-1]),
        "arithmetic": lambda: w.arithmetic(frame, restart=4,
                                           dac=(1, 3, 2)),
        "arithmetic_progressive": lambda: w.arithmetic(
            frame, True, restart=3, dac=(2, 5, 10)),
    }[kind]()


def smoothed_slide(data: bytes):
    """(the "smoothed" transcode of a baseline slide, its plain colour
    decode), made in a writer process beside the phases that run on the
    card."""
    from wesup_tpu_torch.data.jpeg import decode_plain

    made = beyond_jpeg("smoothed", data)
    return made, decode_plain(made)


def try_read(decode, data, gray, file):
    """``decode(data, gray, file)``, or None where it refuses the file."""
    try:
        return decode(data, gray, file)
    except ValueError:
        return None


JPEG_BEYOND_KINDS = ("progressive", "progressive_restarts", "early_stop",
                     "smoothed", "no_dht", "arithmetic",
                     "arithmetic_progressive", "cmyk", "ycck", "lossless")


def beyond_cases():
    """{case: (baseline source or None, file)} at ``JPEG_HW`` from
    ``smoke_image``: progressive 4:2:0, 4:4:4 and gray with restarts, no
    DHT, sequential and progressive arithmetic (DAC, restarts), CMYK and
    YCCK; and the early-stopping progressive file, which the port refuses
    (libjpeg smooths it)."""
    from wesup_tpu_torch.data.jpeg import encode_plain

    img = smoke_image(*JPEG_HW)
    b420, b444 = encode_plain(img), encode_plain(img, (1, 1))
    gray = encode_plain(img[..., 0])
    cases = {
        "progressive 4:2:0": (b420, beyond_jpeg("progressive", b420)),
        "progressive 4:4:4": (b444, beyond_jpeg("progressive", b444)),
        "progressive gray, restarts": (gray, beyond_jpeg(
            "progressive_restarts", gray)),
        "no DHT": (b420, beyond_jpeg("no_dht", b420)),
        "arithmetic, DAC, restarts": (b420, beyond_jpeg("arithmetic", b420)),
        "progressive arithmetic, DAC, restarts": (b420, beyond_jpeg(
            "arithmetic_progressive", b420)),
        "CMYK": (None, beyond_jpeg("cmyk", img)),
        "YCCK 4:2:0": (None, beyond_jpeg("ycck", img)),
    }
    return cases, beyond_jpeg("early_stop", b420)


def slice12_cases(early: bytes):
    """{case: file} at ``JPEG_HW`` from ``smoke_image`` (numpy and integer
    arithmetic only): progressive files that libjpeg smooths (``early``,
    beyond_cases' early-stopping file, and five more scripts, Huffman and
    arithmetic), lossless files (predictors 1, 4, 5, 6 and 7, a point
    transform, restarts, gray, RGB and RGB 4:2:0), and files without their
    EOI marker."""
    from wesup_tpu_torch.data.jpeg import encode_plain

    w = jpeg_writer()
    img = smoke_image(*JPEG_HW)
    b420 = encode_plain(img)
    f420 = w.parse(b420)
    f444 = w.parse(encode_plain(img, (1, 1)))
    fgray = w.parse(encode_plain(img[..., 0]))
    planes = [img[..., c].astype(np.int64) for c in range(3)]
    return {
        "smoothed 4:2:0, the simple script cut early": early,
        "smoothed 4:2:0, DC only": w.progressive(
            f420, [((0, 1, 2), 0, 0, 0, 0)]),
        "smoothed 4:4:4, luma refined, chroma not": w.progressive(
            f444, [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0)]),
        "smoothed gray, DC at Al 1, restarts": w.progressive(
            fgray, [((0,), 0, 0, 0, 1)], restart=3),
        "smoothed 4:2:0, the last refinement left out": w.progressive(
            f420, w.simple_progression(3)[:-1]),
        "smoothed progressive arithmetic, cut early, restarts": w.arithmetic(
            f420, True, restart=2, script=w.early_stop(3)),
        "lossless gray, predictor 1": w.lossless(planes[0]),
        "lossless gray, predictor 4, Pt 2, restarts": w.lossless(
            planes[1], 4, 2, 5),
        "lossless gray, predictor 7": w.lossless(planes[2], 7),
        "lossless RGB, predictor 6, restarts": w.lossless(planes, 6, 0, 4),
        "lossless RGB 4:2:0, predictor 5": w.lossless(
            planes, 5, sampling=((2, 2), (1, 1), (1, 1))),
        "baseline without EOI": b420[:-2],
        "baseline, a COM and no EOI": b420[:-2] + b"\xff\xfe\x00\x04hi",
        "progressive without EOI": w.progressive(f420)[:-2],
    }


def reads_sha256(read, files) -> str:
    """SHA-256 over each file's four reads, ``read(data, gray, file)``:
    of its bytes (``cv2.imdecode``'s) then as a file (``cv2.imread``'s),
    colour then gray; a read that is refused (None) hashes as b"None"."""
    import hashlib

    h = hashlib.sha256()
    for data in files:
        for file in (False, True):
            for gray in (False, True):
                out = read(data, gray, file)
                h.update(b"None" if out is None else str(out.shape).encode()
                         + np.ascontiguousarray(out).tobytes())
    return h.hexdigest()


def decodes_sha256(decode, files) -> str:
    """SHA-256 over the colour then gray decode of each file."""
    import hashlib

    h = hashlib.sha256()
    for data in files:
        for gray in (False, True):
            out = np.ascontiguousarray(decode(data, gray))
            h.update(str(out.shape).encode() + out.tobytes())
    return h.hexdigest()


def stitch(patch_dir: Path, index: int, hw) -> np.ndarray:
    """Slide ``index``'s patch masks laid side by side in numpy (the
    grid from the file names), cropped to ``hw``."""
    from wesup_tpu_torch.data import codec

    cells = {}
    for p in patch_dir.glob(f"{index}-*.png"):
        _, x, y = p.stem.split("-")
        cells[int(y), int(x)] = codec.imread_mask(p)
    ys, xs = sorted({k[0] for k in cells}), sorted({k[1] for k in cells})
    return np.block([[cells[y, x] for x in xs] for y in ys])[:hw[0], :hw[1]]


def jpeg_pipeline_phase(torch, card, seed) -> None:
    """Phase 15: the JPEG library against its plain versions and cv2's
    decodes, its times per 1000x1000 patch, the DigestPath2019 pipeline
    on two JPEG slides through both routes, and a JPEG ``POST
    /predict``."""
    import io
    import tempfile

    from wesup_tpu_torch import native
    from wesup_tpu_torch import test_dp2019_pipeline as dp
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.data import jpeg as plain
    from wesup_tpu_torch.inference import Predictor, predict_multiscale_batch
    from wesup_tpu_torch.models import initialize_trainer, jax_init, wesup
    from wesup_tpu_torch.ops import cellpool, launch_counts, pixhead, pool, \
        reset_launches
    from wesup_tpu_torch.scripts.make_dataset import make_image_hard
    from wesup_tpu_torch.serve import create_server

    t_phase = time.perf_counter()
    tag = "jpeg"

    # ---- 15a. the library against its plain versions and cv2 ------------
    t0 = time.perf_counter()
    native.jpeg_library()
    log(f"[{tag}] {native.JPEG_SOURCE.name} loaded (built with the host's "
        f"C++ compiler on first use) in {time.perf_counter() - t0:.2f} s")
    cases = jpeg_cases()
    enc = plain.encode_plain
    img = smoke_image(*JPEG_HW)
    for label, arr in (("420", img), ("gray", img[..., 0])):
        if native.jpeg_encode(arr) != enc(arr):
            fail(f"{tag}: the library's {label} encode differs from the "
                 "plain encoder's")
    got_bytes = decodes_sha256(lambda d, g: np.frombuffer(d, np.uint8),
                               [f for fs in cases.values() for f in fs])
    if got_bytes != JPEG_CV2_SHA256["bytes"]:
        fail(f"{tag}: the plain encoder's files differ from cv2.imencode's")
    for group, files in cases.items():
        for data in files:
            for gray in (False, True):
                a = native.jpeg_decode(data, gray)
                b = plain.decode_plain(data, gray)
                if a.shape != b.shape or not np.array_equal(a, b):
                    fail(f"{tag}: {group}: the library's decode (gray "
                         f"{gray}) differs from the plain version's")
        digest = decodes_sha256(native.jpeg_decode, files)
        if digest != JPEG_CV2_SHA256[group]:
            fail(f"{tag}: {group}: decodes differ from cv2.imdecode's "
                 f"({digest} != {JPEG_CV2_SHA256[group]})")
    n_files = sum(len(f) for f in cases.values())
    log(f"[{tag}] {n_files} JPEGs (4:4:4, 4:2:2, 4:2:0, 4:4:0 and gray at "
        f"{JPEG_HW[0]}x{JPEG_HW[1]}; 8 EXIF orientations x II/MM x 4:2:0/"
        f"gray at {JPEG_ORIENT_HW[0]}x{JPEG_ORIENT_HW[1]}): the library's "
        "colour and gray decodes equal the plain versions' and, by SHA-256, "
        "cv2.imdecode's; its 4:2:0 and gray encodes equal the plain "
        "encoder's, whose files are cv2.imencode's")

    # times per 1000x1000 patch, on the host
    patch = smoke_image(DP_PATCH, DP_PATCH, seed=2)
    data = native.jpeg_encode(patch)
    times = {}
    for label, fn, n in (
            ("decode, library", lambda: native.jpeg_decode(data), 10),
            ("decode, plain", lambda: plain.decode_plain(data), 1),
            ("encode, library", lambda: native.jpeg_encode(patch), 10),
            ("encode, plain", lambda: plain.encode_plain(patch), 1)):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times[label] = (time.perf_counter() - t0) * 1e3 / n
    log(f"[{tag}] a {DP_PATCH}x{DP_PATCH} 4:2:0 patch ({len(data)} bytes), "
        "ms on the card's host: " + ", ".join(
            f"{k} {v:.1f}" for k, v in times.items()) + f"; {card}")
    # the writer's files for 15e are made in spawned processes (the writer
    # is pure Python: seconds a megapixel) while 15b and 15c run
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    writers = ProcessPoolExecutor(max_workers=max(1, min(6, (os.cpu_count()
                                                           or 2) - 2)),
                               mp_context=multiprocessing.get_context(
                                   "spawn"))
    patch_jobs = {k: writers.submit(beyond_jpeg, k, patch if k in (
        "cmyk", "ycck", "lossless") else data) for k in PATCH_KINDS}

    # ---- 15b. the DigestPath2019 pipeline on two JPEG slides -------------
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase15_")
    root = Path(tmp.name) / "dp"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for stem in ("negative-00", "positive-00"):
        slide, mask = make_image_hard(rng, *DP_SLIDE_HW)
        codec.imwrite(root / "images" / f"{stem}.jpg", slide)
        codec.imwrite(root / "masks" / f"{stem}.png", mask * 255)
    slide_jobs = {(stem, kind): writers.submit(
        smoothed_slide if kind == "smoothed" else beyond_jpeg,
        *([] if kind == "smoothed" else [kind]),
        (root / "images" / f"{stem}.jpg").read_bytes())
        for stem, kind in (("negative-00", "progressive"),
                           ("positive-00", "progressive"),
                           ("positive-00", "arithmetic"),
                           ("negative-00", "smoothed"),
                           ("positive-00", "smoothed"))}
    log(f"[{tag}] two {DP_SLIDE_HW[0]}x{DP_SLIDE_HW[1]} synthetic slides "
        f"(make_image_hard, seed {seed}) written as JPEG in "
        f"{time.perf_counter() - t0:.1f} s")
    draws = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax_init.init_params(seed)
        draws.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    trainer = initialize_trainer("wesup", seed=seed)
    # a fresh head's logit margin varies little across a slide, so its
    # masks come out (nearly) one class, and a patch put in the wrong
    # place would stitch to the same mask.  So each route gets a
    # checkpoint whose classifier reads one fc3 feature: logit 0 is 0,
    # logit 1 the feature less one of its own values over the slides'
    # patches as the route sees them (so the difference is exact in
    # bf16), the feature and value that leave nearest half of the values
    # above.  The rest of the model is the fresh trainer's.
    probe = []      # the patches as the pipeline reads them back
    for stem in ("negative-00", "positive-00"):
        img = codec.imread_rgb(root / "images" / f"{stem}.jpg")
        img = np.pad(img, ((0, -img.shape[0] % DP_PATCH),
                           (0, -img.shape[1] % DP_PATCH), (0, 0)))
        probe += [codec.decode(codec.encode_jpeg(
            img[y:y + DP_PATCH, x:x + DP_PATCH]))
            for y in range(0, img.shape[0], DP_PATCH)
            for x in range(0, img.shape[1], DP_PATCH)]
    cls = trainer.model.classifier[0]
    fresh = {k: v.detach().clone() for k, v in cls.state_dict().items()}
    feats, head, tail = [], wesup._mlp_head, pixhead.head

    def spy(model, x, **kwargs):
        probs, f = head(model, x, **kwargs)
        feats.append(f.reshape(-1, f.shape[-1]))
        return probs, f

    def spy_tail(z, b2, w3, b3, wc, bc):
        # the pixel route's fc3 features, as the composition gives them
        f = torch.relu(torch.relu(z + b2) @ w3.t() + b3)
        feats.append(f.float().reshape(-1, f.shape[-1]))
        return tail(z, b2, w3, b3, wc, bc)

    ckpts, picked = {}, {}
    for mode, size in (("superpixel", {"input_size": (400, 400)}),
                       ("pixel", {"scales": (0.4,)})):
        cls.load_state_dict(fresh)
        predictor = Predictor(trainer.model, trainer.config, mode=mode)
        feats.clear()
        with mock.patch.object(wesup, "_mlp_head", spy), \
                mock.patch.object(pixhead, "head", spy_tail), \
                fused_pool1(mode == "pixel"):
            predict_multiscale_batch(predictor, probe, **size)
        fc3 = torch.cat(feats)
        best = None
        for c in range(fc3.shape[1]):
            lv, n = torch.unique(fc3[:, c], return_counts=True)
            up = (n.sum() - n.cumsum(0)).double() / n.sum()
            at = int((up - 0.5).abs().argmin())
            if best is None or abs(up[at] - 0.5) < abs(best[2] - 0.5):
                best = (c, lv, float(up[at]), at)
        j, levels, share, k = best
        picked[mode] = (j, len(levels), round(share, 4))
        with torch.no_grad():
            cls.weight.zero_()
            cls.weight[1, j] = 1.0
            cls.bias.copy_(torch.stack([torch.zeros_like(levels[k]),
                                        -levels[k]]))
        ckpts[mode] = (Path(tmp.name) / "rec" / "checkpoints"
                       / f"ckpt.{mode}.pth")
        trainer.save_checkpoint(ckpts[mode], epoch=1)
    del trainer, predictor, probe, feats, fc3
    log(f"[{tag}] the initial weights drawn from JAX's bits "
        f"(jax_init.init_params, full width) in "
        + " / ".join(f"{d:.2f}" for d in draws) + " s on the card's host; "
        f"a fresh WESUPTrainer's checkpoint for each route, its classifier "
        f"reading one fc3 feature (feature, bf16 levels over the patches, "
        f"share above the threshold: "
        + ", ".join(f"{m} {v}" for m, v in picked.items())
        + f") in {time.perf_counter() - t0:.1f} s")
    gts = {stem: codec.imread_mask(root / "masks" / f"{stem}.png")
           for stem in ("positive-00", "negative-00")}
    grid = [-(-s // DP_PATCH) for s in DP_SLIDE_HW]
    n_patches = 2 * grid[0] * grid[1]
    base_masks = {}
    for route, flags, gated, forward, ckpt in (
            ("superpixel, 400x400", [], False, "forward_superpixel",
             ckpts["superpixel"]),
            ("pixel, scale 0.4, WESUP_FUSED_POOL1=1", ["--pixel"], True,
             "forward_pixel", ckpts["pixel"])):
        torch.cuda.synchronize()
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(wesup, forward,
                               wraps=getattr(wesup, forward)) as fwd, \
                recorded(cellpool, "_pool0_fwd", 1) as k1_calls, \
                recorded(cellpool, "_stage_fwd", 4) as k2_calls, \
                recorded(pool, "_kernel", 1) as k7_calls, \
                fused_pool1(gated), contextlib.redirect_stdout(out):
            dp.main([str(root), "-c", str(ckpt)] + flags)
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        n = fwd.call_count
        want = ({"fused_relu_pool_pad": n, "hypercol_upsample": n,
                 "pixel_head": n} if gated
                else {"cell_pool0": n, "cell_pool_stage": 4 * n})
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("Accuracy:", "Dice:"))]
        results = Path(tmp.name) / "rec" / f"results-for-{ckpt.name}"
        combined = results.parent / (
            ("combined-results-pixel" if gated else "combined-results")
            + f"-for-{ckpt.name}")
        fg = {stem: round(float((codec.imread_mask(
            combined / f"{stem}.png") > 0).mean()), 4)
            for stem in ("negative-00", "positive-00")}
        log(f"[{tag} {route}] python -m wesup_tpu_torch.test_dp2019_pipeline "
            f"on 2 slides ({n_patches} patches of {DP_PATCH}): {sec:.1f} s; "
            f"foreground shares {fg}; {n} forwards, launches "
            + str({k: v for k, v in counts.items() if v})
            + "; " + " | ".join(lines) + f"; {card}")
        if n == 0 or counts != expected(want):
            fail(f"{tag} {route}: {n} forwards launched {counts}")
        if not all(0.05 <= v <= 0.95 for v in fg.values()):
            fail(f"{tag} {route}: foreground shares {fg}: a one-class mask "
                 "cannot show a patch out of place")
        # the printed scores against numpy's on the combined masks
        want_lines = []
        for stem in ("positive-00", "negative-00"):
            P = codec.imread_mask(combined / f"{stem}.png")
            G = gts[stem]
            if stem.startswith("negative"):
                P, G = 255 - P, 255 - G
            S, T = P > 0, G > 0
            want_lines += [
                ("Accuracy:", float((P == G).mean())),
                ("Dice:", float(2 * (S & T).sum()
                                / (T.sum() + S.sum() + 1e-7)))]
        if len(lines) != 4 or not all(
                ln.split()[0] == name
                and math.isclose(float(ln.split()[-1]), v, rel_tol=1e-12)
                for ln, (name, v) in zip(lines, want_lines)):
            fail(f"{tag} {route}: printed {lines}, numpy gives {want_lines}")
        if gated:
            for (pre, oc), got in k7_calls:
                if not torch.equal(got, pool.reference(pre, oc)):
                    fail(f"{tag}: K7 disagrees with its plain version on "
                         "the pipeline's input")
            if len(k7_calls) != 1:
                fail(f"{tag}: recorded {len(k7_calls)} K7 calls")
        else:
            hold_pool_kernels(torch, k1_calls, k2_calls, f"{tag} {route}")
        del k1_calls, k2_calls, k7_calls
        patches = sorted((root.parent / "dp-patches" / "images").glob("*"))
        if len(patches) != n_patches or not all(
                p.read_bytes()[:2] == b"\xff\xd8" for p in patches):
            fail(f"{tag}: {len(patches)} image patches written")
        for index, stem in enumerate(("negative-00", "positive-00")):
            got = codec.imread_mask(combined / f"{stem}.png")
            want_mask = stitch(results, index, DP_SLIDE_HW)
            if got.shape != DP_SLIDE_HW or not np.array_equal(got, want_mask):
                fail(f"{tag} {route}: the combined {stem} is not its patch "
                     "masks stitched")
            if not gated:       # 15e's transcoded slides must give these
                base_masks[stem] = got
        if not gated:
            base_lines = lines
    log(f"[{tag}] each combined mask holds both classes, equals its patch "
        "masks stitched in numpy, and scores as numpy scores it")

    # ---- 15c. a JPEG POST /predict ----------------------------------------
    request = codec.encode_jpeg(glas_image(np.random.default_rng(seed))[0])
    server = create_server(port=0, host="127.0.0.1", seed=seed)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/predict"
        post(url, request)
        torch.cuda.synchronize()
        reset_launches()
        status, reply, sec, _ = post(url, request)
        torch.cuda.synchronize()
        counts = launch_counts()
        bad = post(url, request[:len(request) // 2])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    mask = codec.decode(reply, gray=True) if status == 200 else np.zeros(0)
    log(f"[serve jpeg] POST /predict of a {GLAS_HW[0]}x{GLAS_HW[1]} JPEG "
        f"({len(request)} bytes): {status}, mask {mask.shape}, "
        f"{sec * 1e3:.1f} ms, launches "
        + str({k: v for k, v in counts.items() if v})
        + f"; the JPEG cut in half: {bad[0]} {bad[1][:80]!r}; {card}")
    if not (status == 200 and mask.shape == GLAS_HW
            and set(np.unique(mask).tolist()) <= {0, 255}):
        fail(f"POST /predict of a JPEG: {status} {reply[:200]!r}")
    if counts != expected({"cell_pool0": 1, "cell_pool_stage": 4}):
        fail(f"the JPEG request launched {counts}")
    if bad[0] != 400 or b"request body" not in bad[1]:
        fail(f"a cut JPEG was answered {bad[0]}")

    try:
        beyond_phase(torch, card, root, ckpts["superpixel"], base_masks,
                     base_lines, patch_jobs, slide_jobs, seed)
    finally:
        writers.shutdown(wait=True, cancel_futures=True)
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 15 took {time.perf_counter() - t_phase:.1f} s")


def beyond_phase(torch, card, root, ckpt, base_masks, base_lines,
                 patch_jobs, slide_jobs, seed) -> None:
    """Phase 15e: JPEG beyond baseline.  The library against its plain
    versions and, by SHA-256, cv2's decodes on the writer's files (the
    smoothed progressive, lossless and EOI-less ones too, each read as
    ``cv2.imdecode`` and ``cv2.imread`` read it); ms to decode a 1000x1000
    patch of each kind, and of an RLE8 BMP; the DigestPath2019 pipeline
    on phase 15's slides transcoded to progressive and to arithmetic,
    whose masks must be the baseline slides', to a smoothed progressive
    script, whose masks' foreground shares must stay within
    ``SMOOTHED_FG_BOUND`` of theirs, and with its ground truths as
    lossless JPEG, whose scores must be the PNG masks'; ``POST /predict``
    with a progressive and a CMYK body."""
    import io
    import shutil

    from wesup_tpu_torch import native
    from wesup_tpu_torch import test_dp2019_pipeline as dp
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.data import jpeg as plain
    from wesup_tpu_torch.inference import predict_multiscale
    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.serve import create_server

    tag = "jpeg beyond"
    t0 = time.perf_counter()
    cases, early = beyond_cases()
    files = [f for _, f in cases.values()] + [early]
    got = decodes_sha256(lambda d, g: np.frombuffer(d, np.uint8), files)
    if got != JPEG_BEYOND_SHA256["bytes"]:
        fail(f"{tag}: the writer's files differ from those the constants "
             f"were computed on ({got})")
    for name, (src, data) in cases.items():
        for gray in (False, True):
            a = native.jpeg_decode(data, gray)
            b = plain.decode_plain(data, gray)
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"{tag}: {name}: the library's decode (gray {gray}) "
                     "differs from the plain version's")
            if src is not None and not np.array_equal(
                    a, native.jpeg_decode(src, gray)):
                fail(f"{tag}: {name}: the transcode decodes unlike its "
                     "baseline source")
        digest = decodes_sha256(native.jpeg_decode, [data])
        if digest != JPEG_BEYOND_SHA256[name]:
            fail(f"{tag}: {name}: decodes differ from cv2.imdecode's "
                 f"({digest} != {JPEG_BEYOND_SHA256[name]})")
    log(f"[{tag}] {len(cases)} files at {JPEG_HW[0]}x{JPEG_HW[1]} from "
        "tests/torch_jpeg_writer.py (" + ", ".join(cases) + "): the "
        "library's colour and gray decodes equal the plain versions' and, "
        "by SHA-256, cv2.imdecode's; each transcode decodes as its "
        f"baseline source ({time.perf_counter() - t0:.1f} s)")

    # ---- the kinds of slice 12: smoothed, lossless, without EOI ----------
    t0 = time.perf_counter()
    c12 = slice12_cases(early)
    got = decodes_sha256(lambda d, g: np.frombuffer(d, np.uint8),
                         list(c12.values()))
    if got != JPEG_SLICE12_SHA256["bytes"]:
        fail(f"{tag}: the writer's slice-12 files differ from those the "
             f"constants were computed on ({got})")
    refused = []
    for name, data in c12.items():
        for file in (False, True):
            for gray in (False, True):
                a = try_read(native.jpeg_decode, data, gray, file)
                b = try_read(plain.decode_plain, data, gray, file)
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    fail(f"{tag}: {name}: the library's read (gray {gray}, "
                         f"file {file}) differs from the plain version's")
                if a is None:
                    refused.append(f"{name} ({'file' if file else 'bytes'}"
                                   f", {'gray' if gray else 'colour'})")
        digest = reads_sha256(lambda d, g, f: try_read(native.jpeg_decode,
                                                       d, g, f), [data])
        if digest != JPEG_SLICE12_SHA256[name]:
            fail(f"{tag}: {name}: reads differ from cv2's ({digest} != "
                 f"{JPEG_SLICE12_SHA256[name]})")
    try:
        codec.decode(c12["lossless gray, predictor 1"], name="lossless.jpg")
        fail(f"{tag}: the codec read a lossless gray file in colour")
    except codec.ImageReadError as ex:
        if ("lossless.jpg" not in str(ex) or "cv2 returns None" not in
                str(ex) or not isinstance(ex, FileNotFoundError)):
            fail(f"{tag}: the refusal does not name the file and cv2: {ex}")
    log(f"[{tag}] {len(c12)} files of slice 12 at {JPEG_HW[0]}x"
        f"{JPEG_HW[1]} (" + ", ".join(c12) + "): each one's four reads "
        "(bytes as cv2.imdecode, file as cv2.imread; colour, gray) by the "
        "library equal the plain version's and, by SHA-256, cv2's; "
        f"{len(refused)} reads refused where cv2 returns None: "
        + "; ".join(refused) + f" ({time.perf_counter() - t0:.1f} s)")

    # the DigestPath2019 pipeline on the transcoded slides (the
    # arithmetic run's negative slide is the baseline file), and on the
    # baseline slides with their ground truths as lossless JPEG
    writer = jpeg_writer()
    base_fg = {stem: float((m > 0).mean()) for stem, m in base_masks.items()}
    both = ("negative-00", "positive-00")
    for kind, stems, lossless_masks in (
            ("progressive", both, False), ("arithmetic", ("positive-00",),
                                           False),
            ("smoothed", both, False), ("lossless masks", (), True)):
        data_root = root.parent / f"dp-{kind.replace(' ', '-')}" / "dp"
        (data_root / "images").mkdir(parents=True)
        (data_root / "masks").mkdir()
        for stem in both:
            made = (root / "images" / f"{stem}.jpg").read_bytes()
            if stem in stems:
                made = slide_jobs[stem, kind].result()
            if kind == "smoothed":
                made, want = made
                if not np.array_equal(native.jpeg_decode(made), want):
                    fail(f"{tag}: the smoothed {stem}'s library decode "
                         "differs from the plain version's")
            (data_root / "images" / f"{stem}.jpg").write_bytes(made)
            mask = (root / "masks" / f"{stem}.png").read_bytes()
            if lossless_masks:
                gt = codec.decode(mask, gray=True)
                mask = writer.lossless(gt.astype(np.int64))
                if not np.array_equal(codec.decode(mask, gray=True), gt):
                    fail(f"{tag}: the lossless {stem} mask reads unlike "
                         "its PNG")
            (data_root / "masks" / f"{stem}.png").write_bytes(mask)
        run_ckpt = data_root.parent / "rec" / "checkpoints" / ckpt.name
        run_ckpt.parent.mkdir(parents=True)
        shutil.copy(ckpt, run_ckpt)
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            dp.main([str(data_root), "-c", str(run_ckpt)])
        sec = time.perf_counter() - t1
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("Accuracy:", "Dice:"))]
        combined = run_ckpt.parent.parent / f"combined-results-for-{ckpt.name}"
        fg = {}
        for stem in both:
            got = codec.imread_mask(combined / f"{stem}.png")
            fg[stem] = float((got > 0).mean())
            if kind == "smoothed":
                if abs(fg[stem] - base_fg[stem]) > SMOOTHED_FG_BOUND:
                    fail(f"{tag}: the smoothed {stem}'s foreground share "
                         f"{fg[stem]:.4f} is more than {SMOOTHED_FG_BOUND} "
                         f"from the baseline slide's {base_fg[stem]:.4f}")
            elif not np.array_equal(got, base_masks[stem]):
                fail(f"{tag}: the {kind} {stem}'s combined mask differs "
                     "from the baseline slide's")
        if lossless_masks and lines != base_lines:
            fail(f"{tag}: the scores on the lossless masks {lines} are not "
                 f"the PNG masks' {base_lines}")
        files = sorted((data_root / ("masks" if lossless_masks else
                                     "images")).iterdir())
        sizes = [len(f.read_bytes()) for f in files]
        if kind == "smoothed":
            what = ("foreground shares " + ", ".join(
                f"{s} {fg[s]:.4f} (baseline {base_fg[s]:.4f})" for s in both)
                + f", within {SMOOTHED_FG_BOUND}; the slides' library "
                "decodes equal the plain version's")
        elif lossless_masks:
            what = "scores " + " | ".join(lines) + ", the PNG masks'"
        else:
            what = "both combined masks bitwise the baseline slides'"
        log(f"[{tag}] test_dp2019_pipeline (superpixel, 400x400) on two "
            f"slides, " + (f"ground truths as lossless gray JPEG ({sizes} "
                           "bytes)" if lossless_masks else
                           f"{', '.join(stems)} transcoded to {kind} "
                           f"({sizes} bytes)")
            + f": {sec:.1f} s; {what}; {card}")

    # ms to decode a 1000x1000 patch of each kind, native and plain (the
    # writer's processes are idle by now); lossless gray reads in gray
    patch_files = {k: f.result() for k, f in patch_jobs.items()}
    times = []
    for kind, data in patch_files.items():
        gray = kind == "lossless"
        a = native.jpeg_decode(data, gray)
        t1 = time.perf_counter()
        for _ in range(10):
            native.jpeg_decode(data, gray)
        nat = (time.perf_counter() - t1) * 1e2
        t1 = time.perf_counter()
        b = plain.decode_plain(data, gray)
        pl = (time.perf_counter() - t1) * 1e3
        if not np.array_equal(a, b):
            fail(f"{tag}: the {kind} patch decodes differently by the "
                 "library and the plain version")
        times.append(f"{kind} {nat:.1f} / {pl:.1f} ({len(data)} B)")
    # an RLE8 BMP of a slide's mask (OpenCV's BMP decoder is the codec's
    # numpy one: no library)
    bw = bmp_writer()
    cut = codec.imread_mask(root / "masks" / "positive-00.png")[
        :DP_PATCH, :DP_PATCH] // 255
    rle = bw.bmp(bw.rle(cut, 8), DP_PATCH, DP_PATCH, 8, bw.BI_RLE8,
                 palette=np.array([[0, 0, 0], [255, 255, 255]]))
    if not np.array_equal(codec.decode(rle, gray=True), cut * 255):
        fail(f"{tag}: the RLE8 BMP mask reads unlike its PNG")
    t1 = time.perf_counter()
    for _ in range(10):
        codec.decode(rle, gray=True)
    times.append(f"RLE8 BMP mask (the codec's numpy decoder, no library) "
                 f"{(time.perf_counter() - t1) * 1e2:.1f} ({len(rle)} B)")
    log(f"[{tag}] ms to decode a {DP_PATCH}x{DP_PATCH} patch on the card's "
        "host, library / plain: " + "; ".join(times)
        + f" (baseline 25.3 / 1722.1, PERF.md section 5); {card}")

    # POST /predict with a progressive and a CMYK body
    img = glas_image(np.random.default_rng(seed + 1))[0]
    base = codec.encode_jpeg(img)
    bodies = {"progressive": beyond_jpeg("progressive", base),
              "CMYK": beyond_jpeg("cmyk", img)}
    server = create_server(port=0, host="127.0.0.1", seed=seed)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/predict"
        for name, body in bodies.items():
            torch.cuda.synchronize()
            reset_launches()
            status, reply, sec, _ = post(url, body)
            torch.cuda.synchronize()
            counts = launch_counts()
            mask = (codec.decode(reply, gray=True) if status == 200
                    else np.zeros(0))
            with server.state.lock:
                want = predict_multiscale(server.state.predictor,
                                          codec.decode(body),
                                          scales=server.state.scales)
            want = (want * 255).astype(np.uint8)
            same = mask.shape == want.shape and np.array_equal(mask, want)
            log(f"[serve jpeg] POST /predict of a {GLAS_HW[0]}x{GLAS_HW[1]} "
                f"{name} JPEG ({len(body)} bytes): {status}, "
                f"{sec * 1e3:.1f} ms, launches "
                + str({k: v for k, v in counts.items() if v})
                + f"; equal to the Predictor's on codec.decode of the "
                f"body: {same}; {card}")
            if status != 200 or not same:
                fail(f"POST /predict of a {name} JPEG: {status} "
                     f"{reply[:200]!r}")
            if counts != expected({"cell_pool0": 1, "cell_pool_stage": 4}):
                fail(f"the {name} JPEG request launched {counts}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


# the K1-K8 launches per step that phase 16 expects of each of
# profile_train_step's modes (pixel under WESUP_FUSED_POOL1=1)
PROFILE_MODES = (("train", {}, {"K1": 1, "K2": 4, "K3": 1, "K4": 4}),
                 ("predict", {}, {"K1": 1, "K2": 4}),
                 ("pixel", {"WESUP_FUSED_POOL1": "1"}, {"K7": 1}))


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept off this script's (the
    result lines must end it) and returned beside its result."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines()


def tools_phase(torch, card, seed, trained) -> None:
    """Phase 16: the profiling tools and the small tools on the card.
    ``trained`` is phase 14's record dir, whose model
    ``measure_connectivity`` runs."""
    import tempfile

    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.scripts import (generate_spl_masks,
                                         measure_connectivity, profile_epoch,
                                         profile_train_step)
    from wesup_tpu_torch.scripts.make_dataset import make_dataset

    t_phase = time.perf_counter()
    tag = "tools"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase16_")
    H, W = CANVAS

    # ---- 16a. profile_train_step: train, predict, pixel ------------------
    for mode, env, want in PROFILE_MODES:
        with environ(WESUP_PROF_MODE=mode, WESUP_PROF_STEPS="2", **env):
            out, _ = quiet(profile_train_step.main,
                           [str(BATCH), str(H), str(W), "10"])
        for line in out["lines"]:
            log(f"[{tag} profile {mode}] {line}")
        got = {k: v for k, v in out["launches"].items() if v}
        log(f"[{tag} profile {mode}] B={BATCH} {H}x{W}: steady "
            f"{out['ms']:.3f} ms/step; K1-K8 launches per step {got} "
            f"(expected {want}); {card}")
        if got != want:
            fail(f"profile_train_step {mode} launched {got}, not {want}")

    # ---- 16b. profile_epoch: 2 epochs at B=8 on 16 images ----------------
    with environ(TMPDIR=tmp.name):
        tempfile.tempdir = None
        try:
            report, _ = quiet(profile_epoch.main,
                              ["2", str(BATCH), "16", "fixed", "both"])
        finally:
            tempfile.tempdir = None
    for ep in report["epochs"]:
        log(f"[{tag} epoch] " + ", ".join(f"{k} {v}" for k, v in ep.items()))
    rng = [ep["rng_ms_per_batch"] for ep in report["epochs"]
           if ep["loop"] == "instrument"]
    log(f"[{tag} epoch] rng stage (the key chain and the augmentation "
        f"draws on the host) {rng[-1]:.4f} ms a batch of {BATCH} (epoch 1 "
        f"{rng[0]:.4f}); step-only {report['step_only']['ms_per_step']} "
        f"ms at {report['step_only']['canvas']}, "
        f"{report['step_only']['img_per_s']} img/s; wall over step "
        f"{report.get('wall_over_step')}; {card}")

    # ---- 16c. generate_spl_masks and measure_connectivity ----------------
    root = Path(tmp.name) / "spl"
    make_dataset(root, n_train=4, n_val=0, hw=GLAS_HW, seed=seed)
    data = root / "train"
    spl = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reset_launches()
        quiet(generate_spl_masks.main, [str(data), "--device", dev])
        n = sum(launch_counts().values())
        out_dir = data / "spl-masks"
        spl[dev] = {p.name: np.load(p) for p in sorted(out_dir.iterdir())}
        out_dir.rename(data / f"spl-masks-{dev}")
        log(f"[{tag} spl] generate_spl_masks on the {dev}: "
            f"{len(spl[dev])} masks in {time.perf_counter() - t0:.2f} s; "
            f"kernel launches {n}")
    eq = [float((spl["cuda"][k] == spl["cpu"][k]).mean()) for k in spl["cpu"]]
    log(f"[{tag} spl] card against CPU: {sum(e == 1.0 for e in eq)} of "
        f"{len(eq)} masks equal, the least share of equal values "
        f"{min(eq):.6f} (limit 0.999: SLIC on the card against the CPU)")
    if sorted(spl["cuda"]) != sorted(spl["cpu"]) or min(eq) < 0.999:
        fail("generate_spl_masks on the card differs from the CPU")

    conn = {}
    for dev in ("cuda", "cpu"):
        args = measure_connectivity.parse_args([
            "--n", "4", "--device", dev, "--root", str(Path(tmp.name)
                                                      / "conn"),
            "--ckpt", trained.name,
            "--out", str(Path(tmp.name) / f"conn_{dev}.json")])
        t0 = time.perf_counter()
        reset_launches()
        (report, segs, preds), _ = quiet(measure_connectivity.run, args)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        conn[dev] = (report, segs, preds)
        log(f"[{tag} connectivity] {dev}: 4 images in "
            f"{time.perf_counter() - t0:.2f} s; launches {counts}; mean "
            + json.dumps(report["mean"]))
        if dev == "cuda" and counts != {"segment_sum": 8,
                                        "adjoint_pool_stage": 32}:
            fail(f"measure_connectivity's 8 adjoint forwards launched "
                 f"{counts}, not K5 once and K6 four times each")
    (rc, sc, pc), (rp, sp, pp) = conn["cuda"], conn["cpu"]
    seg_eq = [float((a == b).mean()) for a, b in zip(sc, sp)]
    same = [i for i, e in enumerate(seg_eq) if e == 1.0]
    stats_eq = all(rc["images"][i][k] == rp["images"][i][k] for i in same
                   for k in rc["images"][i]
                   if not k.startswith(("pred", "dice")))
    # where the segs are equal: both probability maps of the A/B within
    # the superpixel forward's bf16 limit, the CPU's A/B moving some pixel
    # by more than twice that (so a forward that ignored the enforced seg
    # fails), and the mean move within 10% of the CPU's
    map_err = max((float(np.abs(a - b).max()) for i in same
                   for a, b in zip(pc[i], pp[i])), default=np.inf)
    moved = [float(np.abs(pp[i][0] - pp[i][1]).max()) for i in same]
    dc = [rc["images"][i]["pred_mean_abs_delta"] for i in same]
    dp = [rp["images"][i]["pred_mean_abs_delta"] for i in same]
    rel = [abs(a - b) / max(b, 1e-12) for a, b in zip(dc, dp)]
    log(f"[{tag} connectivity] card against CPU, phase 14's trained model: "
        f"seg equal share per image {[round(e, 6) for e in seg_eq]} (limit "
        f"0.999), island statistics equal where the segs are: {stats_eq}; "
        f"probability maps (A and B) within {map_err:.3e} (limit 3e-2, bf16 "
        f"forwards); the CPU's A/B moves a pixel by at most "
        f"{[round(m, 4) for m in moved]} (the largest must exceed 6e-2); "
        f"pred_mean_abs_delta card {dc} CPU {dp}, "
        f"relative difference at most {max(rel, default=np.inf):.4f} (limit "
        f"0.1); {card}")
    if (min(seg_eq) < 0.999 or not same or not stats_eq
            or not map_err <= 3e-2 or not max(moved) > 6e-2
            or not max(rel) <= 0.1):
        fail("measure_connectivity on the card differs from the CPU")
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 16 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 17: data and tensor parallelism over torch.distributed
# ---------------------------------------------------------------------------

# a job of ranks that has not ended by then fails the phase
PARALLEL_TIMEOUT = 300
PARALLEL_SEED = 17


def parallel_model(torch, dev):
    """Phase 17's full-width WESUP, the same weights in every process."""
    from wesup_tpu_torch.models import wesup

    return wesup.WESUP(generator=torch.Generator().manual_seed(
        PARALLEL_SEED)).to(dev)


def run_ranks(job: dict, world: int, name: str, out: Path) -> list:
    """``world`` ranks of ``job`` as child processes of this script
    (``--parallel-child``), joined at a fresh local port; fails when a
    rank exits non-zero or the job outlasts :data:`PARALLEL_TIMEOUT`
    (every rank is then killed).  Returns each rank's result."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = out / f"{name}.json"
    path.write_text(json.dumps(dict(job, world=world, name=name,
                                    out=str(out),
                                    coordinator=f"127.0.0.1:{port}")))
    logs = [out / f"{name}.rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-child",
         str(path), str(r)], stdout=open(log, "w"),
        stderr=subprocess.STDOUT, cwd=str(REPO)) for r, log in enumerate(logs)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, path) in enumerate(zip(procs, logs)):
        for line in path.read_text().splitlines():
            if line.startswith("["):   # the ranks' own check lines
                log(line)
        if p.returncode != 0:
            fail(f"rank {r} of the {name} job exited with {p.returncode}:\n"
                 + path.read_text()[-4000:])
    return [json.loads((out / f"{name}.{r}.result.json").read_text())
            for r in range(world)]


def step_grads(model) -> dict:
    """The gradients a train step left on ``model`` (the step zeroes
    them only at its next start), on the host."""
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def dp_rank(torch, rank, out: Path) -> dict:
    """A rank of the 2-rank DP job: one f32 train step of its 4 rows of
    the B=8 batch (K1-K4 held against their plain versions, launches
    counted), the same rows stepped alone, then 5 timed bf16 steps and
    the gradient all-reduce alone.  The f32 steps run with cuDNN's
    deterministic algorithms."""
    import torch.distributed as dist

    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import steps
    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.parallel import collectives, make_mesh
    from wesup_tpu_torch.parallel.mesh import Mesh
    from wesup_tpu_torch.utils import prng

    dev = torch.device("cuda")
    mesh = make_mesh(2, 1)
    # a group of this rank alone (every rank makes every group)
    own = [dist.new_group([r]) for r in range(2)][rank]
    rows = mesh.data_rows(BATCH)
    batch = {k: torch.from_numpy(v[rows]).to(dev)
             for k, v in train_batch(BATCH).items()}
    res = {}
    for dtype in ("float32", "bfloat16"):
        config = WESUPConfig(compute_dtype=dtype)
        model = parallel_model(torch, dev)
        optimizer = steps.make_optimizer(config, model)
        step = steps.make_train_step(config, CANVAS, point_mode=True,
                                     mesh=mesh)

        def run():
            return step(model, optimizer, steps.init_metric_acc(), batch,
                        prng.PRNGKey(7))

        if dtype == "float32":
            torch.backends.cudnn.deterministic = True
            reset_launches()
            hold_step_kernels(torch, run, f"parallel dp rank {rank}")
            res["launches"] = {k: v for k, v in launch_counts().items() if v}
            if launch_counts() != expected({
                    "cell_pool0": 1, "cell_pool_stage": 4,
                    "cell_pool0_bwd": 1, "cell_pool_stage_bwd": 4}):
                fail(f"rank {rank}'s DP step launched {launch_counts()}")
            # the same rows of the same global batch stepped with no peer:
            # the rank's own sum over its images, divided by its count
            alone = parallel_model(torch, dev)
            acc = steps.make_train_step(
                config, CANVAS, point_mode=True,
                mesh=Mesh(2, 1, rank, own, None, own))(
                    alone, steps.make_optimizer(config, alone),
                    steps.init_metric_acc(), batch, prng.PRNGKey(7))
            torch.save({"grads": step_grads(model),
                        "params": {k: v.cpu() for k, v in
                                   model.state_dict().items()},
                        "alone": step_grads(alone),
                        "alone_count": acc["count"].item()},
                       out / f"dp_f32.{rank}.pt")
            torch.backends.cudnn.deterministic = False
            del alone
            continue
        for _ in range(2):
            run()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        ar = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = collectives.all_reduce_flat(grads, mesh.data_group)
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        res.update(step_ms=statistics.median(ms), step_ms_all=ms,
                   allreduce_ms=statistics.median(ar), allreduce_bytes=nbytes)
    return res


def tp_rank(torch, rank, out: Path) -> dict:
    """A rank of the TP job (model 2): the f32 pixel forward at B=2 and
    the bf16 superpixel predict step at B=8 (K1/K2 held, launches
    counted, 5 steps timed) on the split head."""
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.models.steps import make_predict_step
    from wesup_tpu_torch.ops import cellpool as cp
    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.parallel import make_mesh, shard_params

    dev = torch.device("cuda")
    mesh = make_mesh(2, 2)
    model = shard_params(parallel_model(torch, dev), mesh).eval()
    shards = [list(model.fc_layers[0].weight.shape),
              list(model.fc_layers[2].weight.shape)]
    if shards != [[512, 2112], [1024, 512]]:
        fail(f"rank {rank}'s fc1 / fc2 shards are {shards}")
    imgs_u8, valid = bench_images(BATCH)
    img2 = torch.from_numpy(imgs_u8[:2]).to(dev).float() / 255.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        probs = wesup.forward_pixel(model, img2, torch.float32)
    torch.cuda.synchronize()
    pixel_s = time.perf_counter() - t0
    step = make_predict_step(WESUPConfig(), CANVAS, "superpixel")
    imgs = torch.from_numpy(imgs_u8).to(dev)
    valid_d = torch.from_numpy(valid).to(dev)
    step(model, imgs, valid_d)
    reset_launches()
    with recorded(cp, "_pool0_fwd", 1) as k1, \
            recorded(cp, "_stage_fwd", 4) as k2:
        pred = step(model, imgs, valid_d)
        torch.cuda.synchronize()
    launches = launch_counts()
    if launches != expected({"cell_pool0": 1, "cell_pool_stage": 4}):
        fail(f"rank {rank}'s TP predict step launched {launches}")
    hold_pool_kernels(torch, k1, k2, f"parallel tp rank {rank}")
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, imgs, valid_d)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        torch.save({"pixel": probs.cpu(), "superpixel": pred.cpu()},
                   out / "tp.pt")
    return {"shards": shards, "pixel_s": pixel_s,
            "launches": {k: v for k, v in launches.items() if v},
            "predict_ms": statistics.median(ms), "predict_ms_all": ms}


def nccl_fit_rank(torch, job) -> dict:
    """The 1-rank NCCL job: ``train.fit`` for one epoch with
    ``num_devices=1``, its collectives counted."""
    import torch.distributed as dist

    from wesup_tpu_torch.parallel import collectives
    from wesup_tpu_torch.train import fit

    calls = []
    reduce = collectives.all_reduce

    def counted(t, group):
        calls.append(t.numel())
        return reduce(t, group)

    os.environ["RECORD_ROOT"] = str(Path(job["out"]) / "records")
    t0 = time.perf_counter()
    with mock.patch.object(collectives, "all_reduce", counted):
        trainer = fit(job["data"], epochs=1, batch_size=2, num_devices=1)
    stats = {f"{e}/{p}": v for (e, p), v in trainer.phase_stats.items()}
    return {"backend": dist.get_backend(), "mesh": trainer.mesh.shape,
            "collectives": len(calls), "stats": stats,
            "history_rows": len((trainer.record_dir / "history.csv")
                                .read_text().splitlines()) - 1,
            "seconds": time.perf_counter() - t0}


def parallel_child(job_path: str, rank: int) -> int:
    """Entry of a phase-17 rank (``chip_smoke.py --parallel-child JOB
    RANK``): joins the job, runs its part, writes its result."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from wesup_tpu_torch.runtime import initialize_multihost

    job = json.loads(Path(job_path).read_text())
    out = Path(job["out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(job["coordinator"], job["world"], rank,
                         backend=job["backend"])
    res = {"device": torch.cuda.current_device()}
    if job["kind"] == "dp_tp":
        res["dp"] = dp_rank(torch, rank, out)
        torch.cuda.empty_cache()
        res["tp"] = tp_rank(torch, rank, out)
    else:
        res.update(nccl_fit_rank(torch, job))
    (out / f"{job['name']}.{rank}.result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tsne_kl(P, Y) -> float:
    """The KL divergence of embedding ``Y`` under joint ``P`` (host)."""
    from wesup_tpu_torch.utils import tsne

    import torch

    off = ~torch.eye(len(Y), dtype=torch.bool)
    return tsne._kl_divergence(torch.as_tensor(Y), P, off, True)[0]


def parallel_phase(torch, card, seed, trained) -> None:
    """Phase 17: DP over 2 ranks and TP (model 2) over 2 ranks on the one
    card over gloo, against this process's single-process runs; one NCCL
    rank through ``train.fit``; ``plot_tsne`` on phase 14's checkpoint on
    the card against the CPU."""
    import tempfile

    from wesup_tpu_torch import plot_tsne
    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.data.codec import write_png
    from wesup_tpu_torch.models import steps, wesup
    from wesup_tpu_torch.models.steps import make_predict_step
    from wesup_tpu_torch.ops.slic import slic
    from wesup_tpu_torch.utils import prng, tsne

    t_phase = time.perf_counter()
    tag = "parallel"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase17_")
    out = Path(tmp.name)
    dev = torch.device("cuda")

    # ---- 17a. the single-process runs the ranks are held against ---------
    config32 = WESUPConfig(compute_dtype="float32")
    full = train_batch(BATCH)
    key = prng.PRNGKey(7)
    ref = {}
    # the B=8 step with cuDNN's deterministic algorithms, and without
    # cuDNN: how far another order of the same f32 sums moves a gradient
    for name, cudnn in (("b8", True), ("b8_native", False)):
        torch.backends.cudnn.enabled = cudnn
        torch.backends.cudnn.deterministic = True
        model = parallel_model(torch, dev)
        steps.make_train_step(config32, CANVAS, point_mode=True)(
            model, steps.make_optimizer(config32, model),
            steps.init_metric_acc(),
            {k: torch.from_numpy(v).to(dev) for k, v in full.items()}, key)
        ref[name] = step_grads(model)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False
    model = parallel_model(torch, dev).eval()
    imgs_u8, valid = bench_images(BATCH)
    with torch.inference_mode():
        ref_pixel = wesup.forward_pixel(
            model, torch.from_numpy(imgs_u8[:2]).to(dev).float() / 255.0,
            torch.float32)
    ref_sp = make_predict_step(WESUPConfig(), CANVAS, "superpixel")(
        model, torch.from_numpy(imgs_u8).to(dev),
        torch.from_numpy(valid).to(dev))
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 17b. DP and TP: 2 ranks on the card over gloo -------------------
    t0 = time.perf_counter()
    ranks = run_ranks({"kind": "dp_tp", "backend": "gloo"}, 2, "dp_tp", out)
    job_s = time.perf_counter() - t0
    dp = [torch.load(out / f"dp_f32.{r}.pt", weights_only=True)
          for r in range(2)]
    same = all(torch.equal(dp[0][part][k], dp[1][part][k])
               for part in ("grads", "params") for k in dp[0][part])
    # the rows stepped alone, summed as the all-reduce sums them
    total = sum(d["alone_count"] for d in dp)
    halves = {k: (dp[0]["alone"][k] * dp[0]["alone_count"]
                  + dp[1]["alone"][k] * dp[1]["alone_count"]) / total
              for k in dp[0]["alone"]}

    def worst(got, want):
        """max over tensors of max|got - want| / max|want|, and its name"""
        return max(((got[k] - want[k]).abs().max().item()
                    / max(want[k].abs().max().item(), 1e-30), k)
                   for k in want)

    err_alone = worst(dp[0]["grads"], halves)
    err_b8 = worst(dp[0]["grads"], ref["b8"])
    err_native = worst(ref["b8_native"], ref["b8"])
    cos_min, norm_dev = 1.0, 0.0
    for k, want in ref["b8"].items():
        got = dp[0]["grads"][k]
        cos_min = min(cos_min, torch.nn.functional.cosine_similarity(
            got.flatten().double(), want.flatten().double(), dim=0).item())
        norm_dev = max(norm_dev, abs(got.norm().item() / want.norm().item()
                                     - 1.0))
    for r, res in enumerate(ranks):
        d = res["dp"]
        log(f"[{tag} dp] rank {r} (cuda:{res['device']}, gloo): launches in "
            f"its f32 step {d['launches']}; bf16 step at B=4 of the global "
            f"B=8 {d['step_ms']:.3f} ms (median of 5: "
            + ", ".join(f"{x:.3f}" for x in d["step_ms_all"])
            + f"); gradient all-reduce alone {d['allreduce_ms']:.3f} ms for "
            f"{d['allreduce_bytes']} bytes; {card}")
    log(f"[{tag} dp] the 2-rank f32 step (same weights, batch, key; TF32 "
        f"off, cuDNN deterministic): both ranks' gradients and parameters "
        f"bitwise equal {same}; its gradients against each rank's rows "
        f"stepped alone in its process and summed: every tensor within "
        f"{err_alone[0]:.3e} of its largest |grad| (limit 1e-5, worst "
        f"{err_alone[1]}); against the single-process B=8 step: "
        f"{err_b8[0]:.3e} ({err_b8[1]}), the tensors' cosine at least "
        f"{cos_min:.6f} (limit 0.99) and their norms within {norm_dev:.3e} "
        f"(limit 1e-2), beside the B=8 step without cuDNN against it: "
        f"{err_native[0]:.3e} ({err_native[1]}): these first-step "
        f"gradients move by percents under any other order of the f32 "
        f"sums; {card}")
    if not (same and err_alone[0] <= 1e-5 and cos_min >= 0.99
            and norm_dev <= 1e-2):
        fail("the DP train step disagrees with the single-process step")
    tp = torch.load(out / "tp.pt", weights_only=True)
    err_pixel = (tp["pixel"].to(dev) - ref_pixel).abs().max().item()
    err_sp = (tp["superpixel"].to(dev) - ref_sp).abs().max().item()
    for r, res in enumerate(ranks):
        t = res["tp"]
        log(f"[{tag} tp] rank {r}: fc1 shard {t['shards'][0]}, fc2 shard "
            f"{t['shards'][1]} (torch's (out, in)); f32 pixel forward at B=2 "
            f"{t['pixel_s']:.3f} s; bf16 superpixel predict step at B=8 "
            f"{t['predict_ms']:.3f} ms (median of 5), launches "
            f"{t['launches']}; {card}")
    log(f"[{tag} tp] against the single process: f32 pixel probabilities "
        f"within {err_pixel:.3e} (limit 1e-4), bf16 superpixel predict "
        f"within {err_sp:.3e} (limit 3e-2); the 2-rank job took "
        f"{job_s:.1f} s")
    if not (err_pixel <= 1e-4 and err_sp <= 3e-2):
        fail("tensor parallelism disagrees with the single process")

    # ---- 17c. one NCCL rank through train.fit ----------------------------
    rng = np.random.default_rng(seed)
    data = out / "data"
    for split, n in (("train", 4), ("val", 1)):
        for d in ("images", "masks") + (("points",) if split == "train"
                                        else ()):
            (data / split / d).mkdir(parents=True)
        for i in range(n):
            img, mask = glas_image(rng)
            write_png(data / split / "images" / f"{split}_{i}.png", img)
            write_png(data / split / "masks" / f"{split}_{i}.png", mask)
            if split == "train":
                ys, xs = np.nonzero(mask >= 0)
                pick = rng.choice(len(ys), 6, replace=False)
                (data / split / "points" / f"{split}_{i}.csv").write_text(
                    "".join(f"{xs[j]},{ys[j]},{mask[ys[j], xs[j]]}\n"
                            for j in pick))
    (nccl,) = run_ranks({"kind": "nccl_fit", "backend": "nccl",
                         "data": str(data)}, 1, "nccl", out)
    log(f"[{tag} nccl] one rank, backend {nccl['backend']}, mesh "
        f"{nccl['mesh']}: train.fit 1 epoch on 4 + 1 synthetic 522x775 "
        f"images at B=2 in {nccl['seconds']:.1f} s, phases {nccl['stats']}, "
        f"{nccl['collectives']} all-reduces; {card}")
    if (nccl["backend"] != "nccl" or nccl["history_rows"] != 1
            or not nccl["collectives"]
            or any(v["failed"] for v in nccl["stats"].values())
            or nccl["stats"]["1/train"]["samples"] != 4):
        fail("the NCCL rank's train.fit did not train its epoch")

    # ---- 17d. plot_tsne on phase 14's model: card against CPU -------------
    (ckpt,) = (Path(trained.name) / "checkpoints").glob("ckpt.*.pth")
    segs = []
    real_slic = plot_tsne.slic

    def spy(img, valid_, **kw):
        seg = real_slic(img, valid_, **kw)
        segs.append((img, valid_, kw, seg))
        return seg

    t0 = time.perf_counter()
    with mock.patch.object(plot_tsne, "slic", spy):
        card_res, _ = quiet(lambda: plot_tsne.main(
            data / "val", checkpoint=ckpt,
            output=str(out / "tsne_card.png")))
    card_s = time.perf_counter() - t0
    img, valid_, kw, seg = segs[0]
    cpu_seg = slic(img.cpu(), valid_.cpu(), **kw)
    seg_eq = (cpu_seg == seg.cpu()).float().mean().item()
    # the CPU run takes the card's superpixels: SLIC's card-vs-CPU
    # agreement is phases 8 and 16's (its share is logged here)
    t0 = time.perf_counter()
    with mock.patch.object(plot_tsne, "slic",
                           lambda *a, **k: seg.to(a[0].device)):
        cpu_res, _ = quiet(lambda: plot_tsne.main(
            data / "val", checkpoint=ckpt, output=str(out / "tsne_cpu.png"),
            device="cpu"))
    cpu_s = time.perf_counter() - t0
    feat_err = max(np.abs(card_res[k] - cpu_res[k]).max()
                   for k in ("before", "after"))
    labels_eq = np.array_equal(card_res["sp_labels"], cpu_res["sp_labels"])
    n = len(cpu_res["sp_labels"])
    X = cpu_res["after"]
    P_cpu = tsne.joint_probabilities(X, 30.0)
    P_card = tsne.joint_probabilities(torch.from_numpy(X).to(dev), 30.0)
    p_err = ((P_card.cpu() - P_cpu).abs().max() / P_cpu.max()).item()
    # the first 20 exaggerated iterations from one start, card and CPU
    Y0 = tsne.pca_init(X)
    off = ~torch.eye(n, dtype=torch.bool)
    lr = max(n / 12.0 / 4.0, 50.0)
    short_cpu = tsne._gradient_descent(Y0, P_cpu * 12.0, off, 0, 20, 0.5,
                                       lr, 250, 1e-7)[0]
    short_card = tsne._gradient_descent(
        Y0.to(dev), P_cpu.to(dev) * 12.0, off.to(dev), 0, 20, 0.5, lr, 250,
        1e-7)[0].cpu()
    short_err = ((short_card - short_cpu).abs().max()
                 / short_cpu.abs().max()).item()
    # the whole descent is chaotic: the card's final KL is held against
    # the range of CPU runs whose start is scaled by 1 + eps
    kls = [tsne_kl(P_cpu, tsne.tsne(X, init=Y0 * (1 + eps)))
           for eps in (0.0, 1e-15, 1e-14, 1e-13)]
    kl_card = tsne_kl(P_cpu, card_res["after_x2d"])
    width = max(kls) - min(kls)
    kl_ok = min(kls) - width <= kl_card <= max(kls) + width
    log(f"[{tag} tsne] plot_tsne on phase 14's checkpoint, one synthetic "
        f"522x775 val image at 0.4: {n} superpixels; card {card_s:.2f} s, "
        f"CPU {cpu_s:.2f} s (with the card's seg; SLIC card vs CPU "
        f"{seg_eq:.6f} of the pixels equal); features within "
        f"{feat_err:.3e} (limit 1e-4), labels equal {labels_eq}; P within "
        f"{p_err:.3e} of its largest (limit 1e-12); 20 iterations within "
        f"{short_err:.3e} of the extent (limit 1e-6); final KL card "
        f"{kl_card:.4f} against CPU runs {[round(k, 4) for k in kls]} "
        f"(within their range widened by its width); {card}")
    if not (feat_err <= 1e-4 and labels_eq and p_err <= 1e-12
            and short_err <= 1e-6 and kl_ok
            and np.isfinite(card_res["after_x2d"]).all()
            and card_res["after_x2d"].shape == (n, 2)):
        fail("plot_tsne on the card disagrees with the CPU")
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 17 took {time.perf_counter() - t_phase:.1f} s")


def make_gated(step, gated: bool):
    """``step`` run under ``WESUP_FUSED_POOL1=1`` when ``gated``."""
    def run(*args, **kwargs):
        with fused_pool1(gated):
            return step(*args, **kwargs)

    return run


# phase 18: the JAX record's setting (artifacts/h2h_full.json: 12 train /
# 4 val at 96x128, K=63, data seed 0, 300 epochs on the CPU, final val
# Dice 0.93435 on both sides, breakthrough at epoch 80).  100 epochs: past
# the breakthrough, and before the window (epochs 110-150) where the 0.8
# propagation threshold flips on ulp noise and the loss gap between any
# two runs grows to 1e-3-2e-2 a point (the replica against a copy of
# itself scaled by 1 + 1e-7 too: --self-chaos), which is why the JAX
# record's own loss MAE is 1.35e-3; there 2 of 7 card runs ending at
# epoch 120 read a MAE above 1e-3 (PERF.md section 6)
H2H_EPOCHS = 100
H2H_EVAL_EVERY = 10
H2H_JAX_DICE = 0.9343536526373984


def headtohead_phase(torch, card) -> None:
    """Phase 18: ``quality_headtohead`` on the card at the JAX record's
    setting; the port's training math against the reference replica's."""
    import tempfile

    from wesup_tpu_torch.ops import launch_counts, reset_launches
    from wesup_tpu_torch.scripts import quality_headtohead as h2h
    from wesup_tpu_torch.scripts.make_dataset import make_dataset

    t_phase = time.perf_counter()
    tag = "h2h"
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase18_")
    n_train, n_val = 12, 4
    make_dataset(tmp.name, n_train=n_train, n_val=n_val, hw=(96, 128),
                 seed=0)
    torch.cuda.synchronize()
    reset_launches()
    seconds = {}
    t0 = time.perf_counter()
    final, _ = h2h.run(tmp.name, H2H_EPOCHS, H2H_EVAL_EVERY,
                       log=lambda m: log(m.replace("[h2h]", "[h2h run]")),
                       seconds=seconds)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    hist = final["history"]
    steps_n = H2H_EPOCHS * n_train
    fwd_n = steps_n + len(hist["epoch"]) * n_val
    want = expected({"segment_sum": fwd_n, "adjoint_pool_stage": 4 * fwd_n,
                     "segment_sum_bwd": steps_n,
                     "adjoint_pool_stage_bwd": 4 * steps_n})
    log(f"[{tag}] quality_headtohead on the card: {H2H_EPOCHS} epochs of "
        f"{n_train} train / {n_val} val images at 96x128, K={final['K']}, "
        f"data seed 0, eval every {H2H_EVAL_EVERY}, f32 (TF32 off): "
        f"{sec:.1f} s; s per epoch: the port {seconds['ours'] / H2H_EPOCHS:.4f}"
        f", the replica {seconds['torch'] / H2H_EPOCHS:.4f}; {card}")
    log(f"[{tag}] final val Dice: the port {final['ours_final_dice']:.5f}, the "
        f"replica {final['torch_final_dice']:.5f} (delta "
        f"{final['dice_delta']:.5f}); JAX {H2H_JAX_DICE:.5f} on both sides "
        "over 300 epochs (artifacts/h2h_full.json, CPU); loss MAE "
        f"{final['loss_mae']:.3e}; propagated labels first / last: the port "
        f"{hist['ours_prop'][0]:.3f} / {hist['ours_prop'][-1]:.3f}, the "
        f"replica {hist['torch_prop'][0]:.3f} / {hist['torch_prop'][-1]:.3f}"
        "; val Dice by evaluation: " + ", ".join(
            f"{e}: {a:.3f}/{b:.3f}" for e, a, b in zip(
                hist["epoch"], hist["ours_dice"], hist["torch_dice"])))
    log(f"[{tag}] launches over the run: "
        + str({k: v for k, v in counts.items() if v})
        + f"; per train step K5 1, K6 4, K3 (segment_sum_bwd) 1, K8 4 over "
        f"{steps_n} steps, and K5 1, K6 4 per forward of "
        f"{fwd_n - steps_n} val predicts")
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    if not final["loss_mae"] < 1e-3:
        fail(f"{tag}: loss MAE {final['loss_mae']:.3e} between the sides")
    if not final["dice_delta"] <= 0.005:
        fail(f"{tag}: final val Dice {final['ours_final_dice']:.5f} against "
             f"the replica's {final['torch_final_dice']:.5f}")
    if not (final["ours_final_dice"] > 0 and final["torch_final_dice"] > 0):
        fail(f"{tag}: a side did not break through (final Dice "
             f"{final['ours_final_dice']}, {final['torch_final_dice']})")
    if not (torch.backends.cuda.matmul.allow_tf32 is False
            and torch.backends.cudnn.allow_tf32 is False):
        fail(f"{tag}: the run left TF32 settings changed")
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase 18 took {time.perf_counter() - t_phase:.1f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 19: damaged files
# ---------------------------------------------------------------------------

DAMAGE_SEED = 19
# the files of damage_cases() (tests/torch_jpeg_damage.py on
# data/jpeg.encode_plain's bytes, which are cv2.imencode's: integer
# arithmetic and numpy's seeded PCG64 only): the SHA-256 of their bytes,
# and for each kind of file the SHA-256 of its damaged files' reads by cv2
# (reads_sha256: cv2.imdecode's then cv2.imread's, colour (RGB) then
# gray, a None read as b"None"), computed with OpenCV 5.0.0
# (libjpeg-turbo 3.1.2)
JPEG_DAMAGE_SHA256 = {
    "bytes":
        "b0edf0938b715fdd72575ef1385245fa0d4e75bf91d0c1f3d1c3ad24ea3b2e0e",
    "baseline":
        "39d7a0e196f9f7260f46b1cca34359b19efcf9bb47f97cf72dd7e1bac9c6ce6a",
    "gray":
        "02d0340219707d5e9a3ef1818077218359bc0c772db522fef8b1e0728a7898aa",
    "restart2":
        "3c384e1537b9917f18125bd62d491b942f59f583351fb2808ca9b15686bb294b",
    "progressive":
        "f5b14c1b03de3a313f6f9011676dd607e99f9a99681f4e685c52ee05ec9d2843",
    "progressive_rst":
        "902e67d0fc968d6be416a55561467183b1d2dc7762e052d42bf6d2d08a4f30b8",
    "arith":
        "924804b1d7b63e04ace04ac6e83a2aa2f93fa096e053407e24a6fac1ccc78522",
    "arith_progressive":
        "f9dc14bfb5a54024633017b9330dbdee5abbe29e7a01590b15be11acb8129e5a",
    "lossless_gray":
        "cdfb899167d9fdb6fef69c499df784148d37a7dcaabd38005b59449dc993b32b",
    "lossless_rgb":
        "afb034b4d4617736c3c94b6940b923a902332803205b396cb14fda4eda7e68cc",
}


def jpeg_damage():
    """``tests/torch_jpeg_damage.py``: numpy only, like the JPEG writer."""
    jpeg_writer()                  # puts tests/ on the path
    import torch_jpeg_damage

    return torch_jpeg_damage


def damage_cases() -> dict:
    """{kind: [(name, bytes)]}: phase 19's damaged files, one 40x56
    image's nine kinds (baseline, gray, a restart interval of 2,
    progressive with and without restarts, sequential and progressive
    arithmetic, lossless gray and RGB), each damaged once by each of the
    eight edits of ``torch_jpeg_damage.DAMAGE``."""
    from wesup_tpu_torch.data.jpeg import encode_plain

    dmg = jpeg_damage()
    out = {}
    for name, data in dmg.corpus(encode_plain, DAMAGE_SEED, n_images=1,
                                 per_kind=1):
        how = next(h for h in sorted(dmg.DAMAGE, key=len, reverse=True)
                   if name.rsplit("_", 1)[0].endswith("_" + h))
        kind = name.split("_", 2)[2].rsplit("_", 1)[0][:-len(how) - 1]
        out.setdefault(kind, []).append((name, data))
    return out


def damaged_glas(root: Path, seed: int) -> dict:
    """A GlaS-shaped dataset under ``root``: 8 train images (522x775 JPEG,
    from ``seed``) with gland masks (PNG) and points, 2 val images; train
    image 0 has a byte replaced, image 1 is cut mid-scan, image 2 (written
    with a restart interval of 4) lost a restart marker, and mask 3 holds
    a tEXt chunk whose CRC is wrong.  Returns {what: path} of the damaged
    files."""
    import struct

    from wesup_tpu_torch.data import codec

    dmg, writer = jpeg_damage(), jpeg_writer()
    rng = np.random.default_rng(seed)
    edit = np.random.default_rng(seed + 1)
    damaged = {}
    for split, n in (("train", 8), ("val", 2)):
        dirs = {d: root / split / d for d in ("images", "masks", "points")}
        for d, path in dirs.items():
            if d != "points" or split == "train":
                path.mkdir(parents=True)
        for i in range(n):
            img, mask = glas_image(rng)
            name = f"{split}_{i:02d}"
            data = codec.encode_jpeg(img)
            png = codec.encode_png(mask)
            if split == "train" and i == 0:
                data = dmg.damage(data, "byte", edit)
            elif split == "train" and i == 1:
                data = dmg.damage(data, "cut", edit)
            elif split == "train" and i == 2:
                data = dmg.damage(writer.sequential(writer.parse(data),
                                                    restart=4), "no_rst",
                                  edit)
            elif split == "train" and i == 3:
                text = b"tEXt" + b"Comment\0damaged"
                png = (png[:33] + struct.pack(">I", len(text) - 4) + text
                       + b"\0\0\0\0" + png[33:])
            (dirs["images"] / f"{name}.jpg").write_bytes(data)
            (dirs["masks"] / f"{name}.png").write_bytes(png)
            if split == "train" and i < 3:
                damaged[("byte replaced", "cut mid-scan", "RST missing")[i]] = \
                    dirs["images"] / f"{name}.jpg"
            if split == "train" and i == 3:
                damaged["mask with a bad tEXt CRC"] = \
                    dirs["masks"] / f"{name}.png"
            if split == "train":
                rows = []
                for cls in (0, 1):
                    ys, xs = np.nonzero(mask == cls)
                    for j in rng.choice(len(ys), 3, replace=False):
                        rows.append(f"{xs[j]},{ys[j]},{cls}\n")
                (dirs["points"] / f"{name}.csv").write_text("".join(rows))
    return damaged


def hold_adjoint_kernels(torch, calls, tag) -> str:
    """K5, K3 (``segment_sum_bwd``), K6 and K8 as one train step called
    them, against their plain versions on the same inputs, with the limits
    of phases 9 and 10; returns the errors' summary."""
    from wesup_tpu_torch.ops import adjoint, pooling

    errs = {}
    for name, args, got in calls:
        if name == "K5":
            seg, feat, K = args[:3]
            want = pooling.segment_sum_plain(seg, feat, K)
            err = (got - want).abs().max().item()
            ok = err <= 1e-5 * max(1.0, want.abs().max().item())
        elif name == "K3":
            want = pooling.segment_sum_bwd_plain(*args[:3])
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want)
        elif name == "K6":
            seg, tapsH_T, A_wT, K = args[:4]
            want = adjoint.adjoint_pool_stage_plain(seg, tapsH_T, A_wT, K)
            diff = (got - want).abs()
            err = diff.max().item()
            lim = 1e-5 * max(1.0, want.abs().max().item())
            if tapsH_T.dtype == torch.float32:
                ok = err <= lim
            else:
                mass = adjoint.adjoint_pool_stage_plain(seg, tapsH_T.abs(),
                                                        A_wT, K)
                ok = bool((diff <= lim + 2.0 ** -8 * mass).all())
        else:
            seg, dsums, A_wT, K, dt = args[:5]
            want = adjoint.adjoint_pool_stage_bwd_plain(seg, dsums, A_wT, K,
                                                        dt)
            mass = adjoint.adjoint_pool_stage_bwd_plain(
                seg, dsums.abs(), A_wT, K, torch.float32)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            lim = 1e-5 * mass
            if dt == torch.bfloat16:
                lim = lim + 2.0 ** -8 * mass + bf16_ulp(torch, want)
            ok = bool((diff <= lim).all())
        if not ok:
            fail(f"{tag}: {name} disagrees with its plain version in the "
                 f"first train step ({tuple(got.shape)}, max_abs_err "
                 f"{err:.3e})")
        errs[name] = max(errs.get(name, 0.0), err)
    return ", ".join(f"{k} {v:.3e}" for k, v in sorted(errs.items()))


def damage_phase(torch, card, seed) -> None:
    """Phase 19: damaged JPEG and PNG files, read as cv2 reads them.
    19a: the corpus of ``damage_cases`` read four ways by the library,
    against the plain version and, by SHA-256, cv2; decode ms of a whole
    and a damaged 1000x1000 patch.  19b: ``python -m
    wesup_tpu_torch.train`` in this process, one epoch at pooling
    "adjoint" and one at "fullres", over a GlaS-shaped directory with
    three damaged image JPEGs and a mask PNG with a bad tEXt CRC.  19c: a
    superpixel server's answers to a byte-damaged JPEG and to a PNG
    without its IEND."""
    import tempfile

    from wesup_tpu_torch import cli, native
    from wesup_tpu_torch import train as train_cli
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.data import jpeg as plain
    from wesup_tpu_torch.models.trainer import WESUPTrainer
    from wesup_tpu_torch.ops import (adjoint, launch_counts, pooling,
                                     reset_launches)
    from wesup_tpu_torch.serve import create_server

    t_phase = time.perf_counter()
    tag = "damage"
    dmg = jpeg_damage()

    # ---- 19a. the corpus: library, plain version, cv2 --------------------
    t0 = time.perf_counter()
    cases = damage_cases()
    files = [d for kind in cases.values() for _, d in kind]
    got = decodes_sha256(lambda d, g: np.frombuffer(d, np.uint8), files)
    if got != JPEG_DAMAGE_SHA256["bytes"]:
        fail(f"{tag}: the damaged files differ from those the constants "
             f"were computed on ({got})")
    n_plain = decoded = refused = 0
    for kind, named in cases.items():
        for i, (name, data) in enumerate(named):
            for file in (False, True):
                for gray in (False, True):
                    a = try_read(native.jpeg_decode, data, gray, file)
                    decoded += a is not None
                    refused += a is None
                    if i % 3:
                        continue
                    b = try_read(plain.decode_plain, data, gray, file)
                    n_plain += 1
                    if (a is None) != (b is None) or (
                            a is not None and not np.array_equal(a, b)):
                        fail(f"{tag}: {name}: the library's read (gray "
                             f"{gray}, file {file}) differs from the plain "
                             "version's")
        digest = reads_sha256(lambda d, g, f: try_read(native.jpeg_decode,
                                                       d, g, f),
                              [d for _, d in named])
        if digest != JPEG_DAMAGE_SHA256[kind]:
            fail(f"{tag}: {kind}: the damaged files' reads differ from "
                 f"cv2's ({digest} != {JPEG_DAMAGE_SHA256[kind]})")
    log(f"[{tag}] {len(files)} damaged files ({len(cases)} kinds x "
        f"{len(dmg.DAMAGE)} edits: " + ", ".join(dmg.DAMAGE) + "), four "
        f"reads each by the library: {decoded} decoded, {refused} refused, "
        f"all equal by SHA-256 to cv2's; {n_plain} reads equal to the plain "
        f"version's ({time.perf_counter() - t0:.1f} s)")
    patch = dmg.image((1000, 1000), seed)
    whole = native.jpeg_encode(patch)
    broken = dmg.damage(whole, "byte", np.random.default_rng(seed))
    times = {}
    for what, data in (("whole", whole), ("damaged", broken)):
        lib = []
        for _ in range(5):
            t0 = time.perf_counter()
            a = native.jpeg_decode(data)
            lib.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        b = plain.decode_plain(data)
        times[what] = (statistics.median(lib),
                       (time.perf_counter() - t0) * 1e3)
        if not np.array_equal(a, b):
            fail(f"{tag}: the {what} 1000x1000 patch: the library's decode "
                 "differs from the plain version's")
    log(f"[{tag}] decode of a 1000x1000 patch (baseline, {len(whole)} "
        f"bytes), library / plain: whole {times['whole'][0]:.1f} / "
        f"{times['whole'][1]:.1f} ms, one byte replaced "
        f"{times['damaged'][0]:.1f} / {times['damaged'][1]:.1f} ms "
        f"(library median of 5, plain one run; {card})")

    # ---- 19b. the trainer over damaged files ------------------------------
    tmp = tempfile.TemporaryDirectory(prefix="wesup_phase19_")
    root = Path(tmp.name) / "glas"
    damaged = damaged_glas(root, seed)
    for what, path in damaged.items():
        read = codec.imread_mask if path.suffix == ".png" else \
            codec.imread_rgb
        try:
            img = read(path)
        except codec.ImageReadError as ex:
            fail(f"{tag}: the {what} file is refused: {ex}")
        data = path.read_bytes()
        if path.suffix == ".jpg" and not np.array_equal(
                img, plain.decode_plain(data, False, True)):
            fail(f"{tag}: the {what} file: the codec's read differs from "
                 "the plain version's")
    per_step = {"adjoint": {"segment_sum": 1, "adjoint_pool_stage": 4,
                            "segment_sum_bwd": 1,
                            "adjoint_pool_stage_bwd": 4},
                "fullres": {"segment_sum": 2, "segment_sum_bwd": 2}}
    for pooling_, want_step in per_step.items():
        step_counts = []
        first = {"on": False}
        calls = []
        real_get = WESUPTrainer._get_step

        def get_step(self, kind, hw):
            step = real_get(self, kind, hw)
            if kind != "train":
                return step

            def run(*args, **kwargs):
                before = launch_counts()
                first["on"] = not step_counts
                try:
                    out = step(*args, **kwargs)
                    torch.cuda.synchronize()
                finally:
                    first["on"] = False
                after = launch_counts()
                step_counts.append({k: after[k] - before[k] for k in after})
                return out
            return run

        def recording(name, fn):
            def run(*args, **kwargs):
                out = fn(*args, **kwargs)
                if first["on"]:
                    calls.append((name, args, out.detach()))
                return out
            return run

        errors = ErrorRecords("Train")
        old_root = os.environ.get("RECORD_ROOT")
        os.environ["RECORD_ROOT"] = str(Path(tmp.name) / f"rec_{pooling_}")
        logging.getLogger().addHandler(errors)
        t0 = time.perf_counter()
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(
                    WESUPTrainer, "_get_step", new=get_step))
                for name, module, attr in (
                        ("K5", pooling, "_segment_sum_fwd"),
                        ("K3", pooling, "segment_sum_bwd"),
                        ("K6", adjoint, "adjoint_pool_stage"),
                        ("K8", adjoint, "adjoint_pool_stage_bwd")):
                    stack.enter_context(mock.patch.object(
                        module, attr,
                        new=recording(name, getattr(module, attr))))
                reset_launches()
                trainer = cli.run(train_cli.fit, [
                    str(root), "epochs=1", f"pooling={pooling_}",
                    f"batch_size={BATCH}", f"seed={seed}"])
        finally:
            logging.getLogger().removeHandler(errors)
            if old_root is None:
                os.environ.pop("RECORD_ROOT", None)
            else:
                os.environ["RECORD_ROOT"] = old_root
        sec = time.perf_counter() - t0
        stats = trainer.phase_stats
        if errors.records:
            fail(f"{tag}: the {pooling_} fit logged "
                 f"{errors.records[0].getMessage()}")
        if not step_counts or any(st["failed"] or not st["batches"]
                                  for st in stats.values()):
            fail(f"{tag}: the {pooling_} fit ran {stats}, "
                 f"{len(step_counts)} train steps")
        with open(trainer.record_dir / "history.csv") as fp:
            rows = list(csv.DictReader(fp))
        losses = {k: float(v) for r in rows for k, v in r.items()
                  if "loss" in k and v not in ("", None)}
        if not losses or not all(math.isfinite(v) for v in losses.values()):
            fail(f"{tag}: the {pooling_} fit's losses {losses}")
        summed = {}
        for c in step_counts:
            for k, v in c.items():
                summed[k] = summed.get(k, 0) + v
        want = expected({k: v * len(step_counts)
                         for k, v in want_step.items()})
        if summed != want:
            fail(f"{tag}: the {pooling_} fit's {len(step_counts)} train "
                 f"steps launched {summed}, expected {want}")
        held = {n: sum(c[0] == n for c in calls)
                for n in ("K5", "K3", "K6", "K8")}
        want_held = {"K5": want_step.get("segment_sum", 0),
                     "K3": want_step.get("segment_sum_bwd", 0),
                     "K6": want_step.get("adjoint_pool_stage", 0),
                     "K8": want_step.get("adjoint_pool_stage_bwd", 0)}
        if held != want_held:
            fail(f"{tag}: the {pooling_} fit's first step called {held}")
        errs = hold_adjoint_kernels(torch, calls, tag)
        del calls
        log(f"[{tag}] python -m wesup_tpu_torch.train (in process) "
            f"pooling={pooling_}, 1 epoch over {len(damaged)} damaged files ("
            + ", ".join(damaged) + f"): {len(step_counts)} train steps, "
            + ", ".join(f"{(e, p)}: {st['batches']} batches, "
                        f"{st['failed']} failed" for (e, p), st in
                        sorted(stats.items()))
            + "; losses " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in losses.items())
            + f"; launches {summed}; the first step's kernels against their "
            f"plain versions: max_abs_err {errs}; {sec:.1f} s")
        torch.cuda.empty_cache()

    # ---- 19c. the server: a damaged JPEG, a PNG without IEND -------------
    img = glas_image(np.random.default_rng(seed + 2))[0]
    body = dmg.damage(codec.encode_jpeg(img), "byte",
                      np.random.default_rng(seed + 3))
    png = codec.encode_png(img)
    no_iend = png[:-12]
    server = create_server(port=0, host="127.0.0.1", seed=seed)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/predict"
        post(url, codec.encode_jpeg(img))
        torch.cuda.synchronize()
        reset_launches()
        status, reply, sec, _ = post(url, body)
        torch.cuda.synchronize()
        counts = launch_counts()
        bad = post(url, no_iend)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    mask = codec.decode(reply, gray=True) if status == 200 else np.zeros(0)
    log(f"[serve damage] POST /predict of a {GLAS_HW[0]}x{GLAS_HW[1]} JPEG "
        f"with one byte replaced: {status}, mask {mask.shape}, "
        f"{sec * 1e3:.1f} ms, launches "
        + str({k: v for k, v in counts.items() if v})
        + f"; a PNG without its IEND: {bad[0]} {bad[1][:90]!r}; {card}")
    if not (status == 200 and mask.shape == GLAS_HW
            and set(np.unique(mask).tolist()) <= {0, 255}):
        fail(f"POST /predict of a damaged JPEG: {status} {reply[:200]!r}")
    if counts != expected({"cell_pool0": 1, "cell_pool_stage": 4}):
        fail(f"the damaged JPEG request launched {counts}")
    if bad[0] != 400 or b"request body" not in bad[1] or \
            b"IEND" not in bad[1]:
        fail(f"a PNG without its IEND was answered {bad[0]} {bad[1]!r}")
    tmp.cleanup()
    log(f"[{tag}] phase 19 took {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=11,
                        help="seed of phases 11-13's synthetic datasets, "
                             "weights and shuffles")
    parser.add_argument("--parallel-child", nargs=2, metavar=("JOB", "RANK"),
                        help=argparse.SUPPRESS)
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
    if args.parallel_child:
        return parallel_child(args.parallel_child[0],
                              int(args.parallel_child[1]))

    from wesup_tpu_torch.config import WESUPConfig
    from wesup_tpu_torch.inference import Predictor, predict_multiscale_batch
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.models.steps import make_predict_step
    from wesup_tpu_torch import native
    from wesup_tpu_torch.ops import (cellgrid, cellpool, kernels,
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
    kernels.library()
    built = native.builds["wesup_cuda"]
    log(f"[build] {built.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
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
    breakdown(torch, "[step]", lambda: step(model, imgs_dev, valid))
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
    kernels += tile_phase(torch, args.seed)
    kernels += hypercol_phase(torch)
    kernels += pixel_head_phase(torch)
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

    # ---- 13. the GlaS protocol: prepare, points, train, test, evaluate ---
    protocol_phase(torch, card, args.seed)

    # ---- 14. the quality protocol: a model the port trains, scored -------
    trained = quality_phase(torch, card)

    # ---- 15. JPEG, and the DigestPath2019 pipeline -----------------------
    jpeg_pipeline_phase(torch, card, args.seed)

    # ---- 16. the profiling tools and the small tools ---------------------
    tools_phase(torch, card, args.seed, trained)

    # ---- 17. data and tensor parallelism, plot_tsne ----------------------
    parallel_phase(torch, card, args.seed, trained)
    trained.cleanup()

    # ---- 18. the head-to-head against the reference's training math -----
    headtohead_phase(torch, card)

    # ---- 19. damaged files: the reads, the trainer, the server -----------
    damage_phase(torch, card, args.seed)
    log("[kernels] " + ", ".join(
        f"{k['name']}: launches {k['launches']}, pass" for k in kernels))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
