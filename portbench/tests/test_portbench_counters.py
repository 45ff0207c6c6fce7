"""The counting in ``portbench/metrics`` and ``portbench/trace.py``
against figures worked by hand."""

from __future__ import annotations

import math

import pytest

from portbench import trace
from portbench.metrics import (conv_roofline, device_idle, launches_per_img,
                               mfu, pool_roofline)


def test_vgg16_conv_flops_at_224():
    # VGG16's 13 convolutions are 15.35 G multiply-adds at 224 x 224
    # (its 15.47 G less the 0.12 G of its three fully connected layers)
    assert conv_roofline.conv_flops(224, 224) == pytest.approx(
        2 * 15.35e9, rel=2e-3)
    # conv1_1 alone: 224 * 224 * 3 * 64 * 9 multiply-adds
    assert conv_roofline.conv_flops(224, 224) > 2 * 224 * 224 * 3 * 64 * 9


def test_pixel_record_flops_by_hand():
    """One 400 x 400 patch through the pixel path, worked by hand."""
    h = w = 400
    width = 1024
    conv = conv_roofline.conv_flops(h, w)
    stages = [128, 256, 768, 1536, 1536]
    proj = sum(2 * (h / 2 ** s) * (w / 2 ** s) * c * width
               for s, c in enumerate(stages))
    head = 2 * h * w * (width * width + width * 32 + 32 * 2)
    fold = 2 * width * sum(c * c // 2 for c in
                           (64, 64, 128, 128, 256, 256, 256) + (512,) * 6)
    rec = {"kind": "pixel", "rows": 1, "H": 416, "W": 416,
           "content": [(h, w)], "fc_width": width, "D": 32, "n_classes": 2}
    assert mfu.record_flops(rec) == pytest.approx(conv + proj + head + fold)
    # the head (fc2 over every pixel) is the largest term, as it should be
    assert head > conv > proj


def test_train_record_is_three_forwards():
    rec = {"kind": "train", "rows": 2, "H": 224, "W": 320,
           "content": [(200, 300)], "sp_area": 200, "fc_width": 1024,
           "D": 32, "n_classes": 2}
    fwd = dict(rec, kind="predict")
    assert mfu.record_flops(rec) == pytest.approx(3 * mfu.record_flops(fwd))


def test_pool_bytes_by_hand():
    # one 288 x 416 predict row: K = round(288 / sqrt(200)) *
    # round(416 / sqrt(200)) = 20 * 29
    rec = {"kind": "predict", "rows": 1, "H": 288, "W": 416,
           "sp_area": 200}
    K = 20 * 29
    assert pool_roofline.n_clusters(288, 416, 200) == K
    want = 288 * 416 * 4                                     # ids, once
    for s, c in enumerate((128, 256, 768, 1536, 1536)):
        want += (288 >> s) * (416 >> s) * c * 2 + K * c * 4
    assert pool_roofline.record_bytes(rec) == want
    assert pool_roofline.record_bytes(dict(rec, kind="train")) == 2 * want


def _ev(name, ts, dur, dev=False):
    return {"name": name, "ts": float(ts), "dur": float(dur), "dev": dev}


def test_trace_reduce_by_hand():
    events = [
        _ev(trace.STRETCH, 0, 100),
        _ev("step", 0, 60), _ev("cudaLaunchKernel", 1, 1),
        _ev("cudaLaunchKernel", 5, 1), _ev("cudaGraphLaunch", 7, 1),
        _ev("sync", 60, 40),
        _ev("k1", 10, 20, True), _ev("k2", 25, 15, True),   # union 10-40
        _ev("k1", 70, 10, True),                             # 70-80
        _ev("late", 150, 10, True),                          # outside
    ]
    red = trace.reduce(events)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(40e-6)
    assert red["launches"] == 3
    assert red["op_s"]["k1"] == pytest.approx(30e-6)
    # gaps 40-70 (during "step"), 80-100 ("sync"), 0-10 ("step")
    gaps = red["breakdown"]["idle_gaps"]
    assert [g for _, g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert [n for n, _ in gaps] == ["step", "sync", "step"]
    ctx = {"trace": red, "traced_units": 4}
    assert device_idle.read("device_idle.x", ctx) == pytest.approx(60.0)
    assert launches_per_img.read("launches_per_img.x", ctx) == 0.75


def test_mfu_and_rooflines_read_nothing_without_work():
    red = {"op_s": {}, "launches": 0, "busy_s": 0.0, "window_s": 1.0}
    ctx = {"trace": red, "traced_units": 0, "traced_work": [],
           "window": {"seconds": 1.0}, "window_work": []}
    for mod in (mfu, conv_roofline, pool_roofline, device_idle,
                launches_per_img):
        assert mod.read("x.y", ctx) is None


def test_conv_pattern():
    names = ["sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
             "sm90_xmma_dgrad_implicit_gemm_bf16", "cutlass_wgrad_kernel",
             "void at::native::vectorized_elementwise_kernel<convert>"]
    hits = [bool(conv_roofline.PATTERN.search(n)) for n in names]
    assert hits == [True, True, True, False]
    assert math.isclose(conv_roofline.kernel_seconds(
        dict(zip(names, [1.0, 2.0, 3.0, 4.0]))), 6.0)
