"""The port's tracer (``wesup_tpu_torch/tracing.py``) on the CPU.

- off: without a profiler the trainer's epoch, ``predict_multiscale_batch``
  and ``predict_tiled`` record no span and enter no profiler range,
  and an off span allocates nothing;
- on: under ``torch.profiler`` they record the span tree of the layers
  (parents, one trace id per batch, chunk and slide, namespaced by the
  kind of unit, the staging worker's spans in memory), each main-thread
  span's interval holds its mirror's (a profiler range of its name) in
  ``prof.events()`` and matches it within 100 us at the 95th percentile,
  and self times add up to each root's duration;
- the predictor builds each canvas's step once;
- counters: ``ops.launch_counts()`` reads the tracer's
  ``launches.<kernel>`` counters, one per kernel of the registry.
"""

import statistics
import sys
import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).parent))
from make_dataset import make_dataset  # noqa: E402

from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch import inference, ops, tracing  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer, wesup  # noqa: E402

CFG = dict(slic_iters=2, compute_dtype="float32", sp_area=100, fc_width=64)
EPOCH = 3
# the phases of a train step (wesup.step.<phase>), in order: the draws,
# then their application, are both augment
TRAIN_PHASES = ["augment", "augment", "slic", "forward", "loss",
                "backward", "optimizer"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("tracing_ds"), n_train=3,
                        n_val=0, hw=(48, 64))


@pytest.fixture(scope="module")
def trainer(dataset, tmp_path_factory):
    import os

    os.environ.setdefault("RECORD_ROOT",
                          str(tmp_path_factory.mktemp("records")))
    tr = initialize_trainer("wesup", batch_size=2, canvas_size=(48, 64),
                            checkpoint_period=0, device="cpu", **CFG)
    tr.setup_dataloaders(dataset / "train", None)
    yield tr
    tr._cancel_lookahead()


def _epoch(trainer, epoch=EPOCH):
    trainer.tracker.start_new_epoch(trainer.current_lr())
    trainer._epoch_idx = epoch
    trainer.train_one_epoch(no_val=True)
    trainer._cancel_lookahead()


@pytest.fixture(scope="module")
def predictors():
    cfg = WESUPConfig(**CFG)
    model = wesup.WESUP(fc_width=64,
                        generator=torch.Generator().manual_seed(0))
    return {mode: inference.Predictor(model, cfg, mode=mode, device="cpu")
            for mode in ("superpixel", "pixel")}


def _images(n=3, hw=(40, 50), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


def _predict(predictors):
    """Two chunks of a multi-scale batch, then two slides of two chunks."""
    inference.predict_multiscale_batch(predictors["superpixel"], _images(),
                                       scales=(0.5,), max_batch=2)
    for seed in (1, 2):
        inference.predict_tiled(predictors["pixel"],
                                _images(1, (70, 90), seed)[0], 48, chunk=2,
                                round_patches=False)


def _traced(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return prof, tracing.spans()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _main(spans):
    main = threading.get_ident()
    return [s for s in spans if s.thread == main]


def _ancestors(s):
    while s.parent is not None:
        s = s.parent
        yield s


def _assert_mirrored(prof, spans):
    """Each main-thread span has its mirror, a CPU op of its name (matched
    by name, in order), which lies inside the span's interval (the clock
    read before the mirror opens and after it closes) up to 20 us of the
    profiler's clock conversion; 95% of the spans' starts and ends are
    within 100 us of their mirrors'.  (Where the thread is descheduled, or
    another thread takes the interpreter lock, between a clock read and
    the mirror's own, that span's interval is wider by the stall.)"""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mirrors = {}
    for e in prof.events():
        mirrors.setdefault(e.name, []).append(e)
    ours = {}
    for s in _main(spans):
        ours.setdefault(s.name, []).append(s)
    gaps = []
    for name, group in ours.items():
        events = sorted(mirrors.get(name, []),
                        key=lambda e: e.time_range.start)
        assert len(events) == len(group), name
        for s, e in zip(group, events):
            before = t0 + 1e3 * e.time_range.start - s.start_ns
            after = s.end_ns - (t0 + 1e3 * e.time_range.end)
            assert before >= -2e4 and after >= -2e4, (name, before, after)
            gaps += [before, after]
    assert gaps and statistics.quantiles(gaps, n=20)[-1] <= 1e5, \
        sorted(gaps)[-5:]


def _assert_self_times_add_up(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def subtree_self(s):
        return s.self_ns + sum(subtree_self(c) for c in kids.get(s, ()))

    for s in spans:
        assert s.end_ns is not None and s.self_ns >= 0, s
        if s.parent is None:
            assert subtree_self(s) == s.duration_ns, s


def test_off_records_nothing(trainer, predictors, monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda *a, **k: entered.append(a))
    monkeypatch.setattr(tracing, "_spans", [])
    _epoch(trainer, epoch=1)
    _predict(predictors)
    assert tracing.spans() == [] and entered == []
    assert trainer.phase_stats[(1, "train")]["batches"] == 2


def test_off_span_allocates_nothing():
    def run():
        for _ in range(1000):
            with tracing.span("wesup.test.off", trace=(1, 2)):
                pass

    run()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        run()
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 512


def test_train_epoch_span_tree(trainer):
    prof, spans = _traced(lambda: _epoch(trainer))
    steps = _named(spans, "wesup.step.train")
    assert [s.trace for s in steps] == [("train", EPOCH, 0),
                                        ("train", EPOCH, 1)]
    (phase,) = _named(spans, "wesup.train.phase")
    assert phase.trace == ("train", EPOCH) and phase.parent is None
    for step in steps:
        assert step.parent is phase
        kids = [s.name.removeprefix("wesup.step.") for s in spans
                if s.parent is step]
        assert kids == TRAIN_PHASES
        below = [s for s in spans if step in _ancestors(s)]
        assert {s.trace for s in below} == {step.trace}
        names = {s.name for s in below}
        assert {"wesup.step.rng", "wesup.step.backbone", "wesup.step.k1",
                "wesup.step.k2", "wesup.step.head"} <= names
    waits = _named(spans, "wesup.stage.wait")
    # the two batches' waits, then the one that finds the chain's end
    assert [s.trace for s in waits] == [("train", EPOCH, i)
                                        for i in range(3)]
    assert all(s.parent is phase for s in waits)
    assert [s.parent for s in _named(spans, "wesup.train.drain")] == [phase]
    # the staging worker's spans are kept in memory, off the main thread
    main = threading.get_ident()
    for name in ("wesup.stage.load", "wesup.stage.put"):
        ours = [s for s in _named(spans, name)
                if s.trace[:2] == ("train", EPOCH)]
        assert ours and all(s.thread != main and s.parent is None
                            for s in ours), name
    assert {s.trace for s in _named(spans, "wesup.stage.put")
            if s.trace[:2] == ("train", EPOCH)} == {("train", EPOCH, 0),
                                                    ("train", EPOCH, 1)}
    _assert_mirrored(prof, spans)
    _assert_self_times_add_up([s for s in spans if s.thread == main])


def test_val_phase_trace_ids(trainer, monkeypatch):
    """A val phase's units are ("val", epoch, i), apart from the train
    phase's batches of the same epoch."""
    monkeypatch.setitem(trainer.dataloaders, "val",
                        trainer.dataloaders["train"])
    if "train" in trainer._resize_cache:
        monkeypatch.setitem(trainer._resize_cache, "val",
                            trainer._resize_cache["train"])
    trainer.tracker.start_new_epoch(trainer.current_lr())
    trainer._epoch_idx = EPOCH
    trainer.tracker.eval()
    prof, spans = _traced(trainer._run_val_phase)
    val = [("val", EPOCH, i) for i in range(3)]
    assert [s.trace for s in _named(spans, "wesup.step.eval")] == val[:2]
    assert [s.trace for s in _named(spans, "wesup.stage.wait")] == val
    assert [s.trace for s in _named(spans, "wesup.stage.put")] == val[:2]
    for step in _named(spans, "wesup.step.eval"):
        kids = [s.name.removeprefix("wesup.step.") for s in spans
                if s.parent is step]
        assert kids[:2] == ["augment", "slic"]
    _assert_mirrored(prof, spans)


def test_predict_span_trees(predictors):
    prof, spans = _traced(lambda: _predict(predictors))
    # the multi-scale batch: two chunks (images 0-1 and 2), one trace each
    dispatches = _named(spans, "wesup.predict.dispatch")
    group = dispatches[0].trace[1]
    assert [s.trace for s in dispatches] == [("chunk", group, 0),
                                             ("chunk", group, 2)]
    for d in dispatches:
        assert d.parent is None
        kids = [s.name for s in spans if s.parent is d]
        assert kids[0] == "wesup.predict.fill"
        assert kids[-1] == "wesup.step.predict"
        (step,) = [s for s in spans if s.parent is d
                   and s.name == "wesup.step.predict"]
        below = {s.name for s in spans if step in _ancestors(s)}
        assert {"wesup.step.resize", "wesup.step.slic", "wesup.step.k1",
                "wesup.step.paint"} <= below
        assert {s.trace for s in spans if d in _ancestors(s)} == {d.trace}
    assert [(s.trace, s.parent) for s in
            _named(spans, "wesup.predict.drain")] == [
                (("chunk", group, 0), None), (("chunk", group, 2), None)]
    assert [s.trace for s in _named(spans, "wesup.predict.fuse")] == [
        ("chunk", group, 0), ("chunk", group, 0), ("chunk", group, 2)]
    # two slides, each a trace of its own holding its upload and cuts,
    # steps, stitch and the one drain
    slides = _named(spans, "wesup.tile.slide")
    assert len(slides) == 2 and slides[0].trace != slides[1].trace
    assert {s.trace[0] for s in slides} == {"wesup.tile.slide"}
    for slide in slides:
        assert slide.parent is None
        below = [s for s in spans if slide in _ancestors(s)]
        assert {s.trace for s in below} == {slide.trace}
        kids = [s.name for s in spans if s.parent is slide]
        assert kids.count("wesup.step.predict") == 2
        assert kids.count("wesup.tile.drain") == 1
        assert kids[0] == "wesup.tile.cut"
        assert kids[-2:] == ["wesup.tile.stitch", "wesup.tile.drain"]
        # the slide's upload and each chunk's cut
        assert kids.count("wesup.tile.cut") == 3
    _assert_mirrored(prof, spans)
    _assert_self_times_add_up(spans)


def test_infer_profile_dir_writes_the_spans(trainer, dataset, tmp_path,
                                            monkeypatch):
    """``infer.py profile_dir=``: the prediction's Chrome trace holds the
    inference path's spans."""
    import json

    from wesup_tpu_torch import infer

    monkeypatch.setitem(trainer.kwargs, "profile_dir", str(tmp_path))
    masks = infer.infer(trainer, dataset / "train", scales=(0.5,))
    assert len(masks) == 3
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.infer.json").read_text())["traceEvents"]}
    assert {"wesup.predict.dispatch", "wesup.predict.fill",
            "wesup.predict.drain", "wesup.predict.fuse",
            "wesup.step.predict", "wesup.step.slic"} <= names


def test_a_new_session_replaces_the_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("wesup.test.first"):
            pass
    first = tracing.spans()
    with tracing.span("wesup.test.between"):     # profiler off
        pass
    assert tracing.spans() == first
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("wesup.test.second", trace="t"):
            with tracing.span("wesup.test.child"):
                pass
    names = [(s.name, s.trace) for s in tracing.spans()]
    assert names == [("wesup.test.second", "t"), ("wesup.test.child", "t")]


@pytest.mark.parametrize("on", [False, True])
def test_span_as_decorator(on):
    @tracing.span("wesup.test.decorated")
    def double(x):
        return 2 * x

    if not on:
        assert double(3) == 6
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert double(4) == 8
    (s,) = _named(tracing.spans(), "wesup.test.decorated")
    assert s.duration_ns > 0 and s.trace[0] == "wesup.test.decorated"
    assert [e.name for e in prof.events()].count("wesup.test.decorated") == 1


def test_predictor_builds_each_canvas_once(predictors, monkeypatch):
    pred = inference.Predictor(predictors["superpixel"].model,
                               WESUPConfig(**CFG), device="cpu")
    builds = []
    for name in ("make_predict_step", "make_scaled_predict_step"):
        make = getattr(inference.steps, name)
        monkeypatch.setattr(inference.steps, name,
                            lambda *a, make=make, **k: builds.append(a)
                            or make(*a, **k))
    imgs = _images(2, (40, 50)) + _images(1, (60, 30), seed=3)
    for _ in range(2):
        inference.predict_multiscale_batch(pred, imgs, scales=(0.5,),
                                           max_batch=2)
    # two image shapes at one scale: two scaled steps, built once each
    assert len(builds) == 2
    for hw in ((32, 32), (32, 64), (32, 32)):
        pred.predict_canvas(np.zeros((1,) + hw + (3,), np.uint8),
                            np.ones((1,) + hw, bool))
    assert len(builds) == 4 and len(pred._scaled_cache) == 4


def test_launch_counts_are_the_tracers_counters():
    names = ["cell_pool0", "cell_pool_stage", "cell_pool0_bwd",
             "cell_pool_stage_bwd", "segment_sum", "segment_sum_bwd",
             "adjoint_pool_stage", "adjoint_pool_stage_bwd",
             "fused_relu_pool_pad", "tile_cut", "tile_stitch",
             "hypercol_upsample", "pixel_head"]
    ops.reset_launches()
    assert ops.launch_counts() == dict.fromkeys(names, 0)
    assert list(ops.launch_counts()) == names
    tracing.count("launches.cell_pool_stage", 4)
    tracing.count("launches.segment_sum_bwd")
    tracing.count("launches.fused_relu_pool_pad")
    tracing.count("test.not_a_launch", 2)
    counts = ops.launch_counts()
    assert counts == dict(dict.fromkeys(names, 0), cell_pool_stage=4,
                          segment_sum_bwd=1, fused_relu_pool_pad=1)
    assert counts["cell_pool0_bwd"] == 0   # segment_sum_bwd's C function
    assert tracing.counters()["launches.cell_pool_stage"] == 4
    tracing.reset(["launches.segment_sum_bwd"])
    assert ops.launch_counts() == dict(dict.fromkeys(names, 0),
                                       cell_pool_stage=4,
                                       fused_relu_pool_pad=1)
    ops.reset_launches()
    assert not any(ops.launch_counts().values())
    assert tracing.counters()["test.not_a_launch"] == 2
    tracing.reset(["test.not_a_launch"])
    with pytest.raises(KeyError):
        ops.launch_counts()["wesup_cell_pool0_bwd"]
