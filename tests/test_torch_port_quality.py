"""The port's quality tools against the repository's scripts, on the CPU.

- ``scripts.quality_protocol.run_test_protocol`` against the JAX
  script's on one JAX checkpoint (fc_width 64, f32; the classifier's
  foreground bias balanced as in tests/test_torch_port_infer.py so that
  the masks hold both classes), one 64x80 test image per split: the
  per-split metrics within 1e-6;
- a tiny protocol run on the CPU (2 epochs, 64x80): the summary's keys are
  the JAX script's; ``best_val_dice`` and ``final_val_dice`` equal
  pandas' correctly rounded reading of the same ``history.csv`` and lie
  within one ulp of its default reading (pandas' default float parser
  is not correctly rounded; the port reads with ``float``);
  ``--reuse-record auto`` finds the record and does not train, and does
  not take a record whose ``code_digest`` names other sources; the
  scripts' default paths lie in the temporary directory;
- ``quality_ablation``'s rows and markdown table and ``quality_sweep``'s
  runs against the JAX scripts', with the trainers (ablation) and the
  protocol runs (sweep) stubbed by the same seeded histories and
  summaries; the sweep's default ``--out`` lies outside ``artifacts/``.
"""

import importlib.util
import json
import subprocess
import sys
import zlib
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(REPO))
from make_dataset import make_dataset  # noqa: E402

from wesup_tpu.models import initialize_trainer as j_init  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu_torch.scripts import quality_ablation as t_qa  # noqa: E402
from wesup_tpu_torch.scripts import quality_protocol as t_qp  # noqa: E402
from wesup_tpu_torch.scripts import quality_sweep as t_qs  # noqa: E402

SMALL = dict(compute_dtype="float32", sp_area=100, slic_iters=3, fc_width=64)
METRICS = ("Accuracy", "Dice", "Detection F1", "Object Dice",
           "Object Hausdorff")
SUMMARY = {"variant", "epochs", "best_val_dice", "final_val_dice", "splits",
           "wall_s", "record_dir"}


def _jax_script(name):
    """The repository's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pandas(path):
    """(best, final) val Dice as the JAX scripts read them, and as pandas
    reads them correctly rounded."""
    out = []
    for prec in (None, "round_trip"):
        d = pd.read_csv(path, float_precision=prec)["val_dice"]
        out.append((float(d.max()), float(d.to_numpy()[-1])))
    return out


def _within_ulp(a, b):
    return abs(a - b) <= np.spacing(max(abs(a), abs(b)))


# ---------------------------------------------------------------------------
# the test protocol on one JAX checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def protocol_tree(tmp_path_factory):
    """testA and testB of one 64x80 image each, and one JAX checkpoint
    copied into a record directory per package."""
    import shutil

    root = tmp_path_factory.mktemp("quality_protocol")
    data = make_dataset(root / "data", n_train=0, n_val=0, hw=(64, 80),
                        with_points=False, n_testA=1, n_testB=1, seed=5)
    params = j_wesup.init_params(jax.random.PRNGKey(0), fc_width=64)
    imgs = np.stack([cv2.imread(str(p))[..., ::-1]
                     for p in sorted(data.rglob("images/*.png"))])
    p = np.asarray(jax.jit(j_wesup.forward_pixel, static_argnums=2)(
        params, jnp.asarray(imgs, jnp.float32) / 255.0, jnp.float32),
        np.float64)
    shift = np.median(np.log(p[..., 1]) - np.log(p[..., 0]))
    params = jax.tree.map(np.asarray, params)
    params["cls"]["b"] = params["cls"]["b"] - np.float32(shift) * np.array(
        [0, 1], np.float32)
    jt = j_init("wesup", **SMALL)
    jt.params = jax.tree.map(jnp.asarray, params)
    recs = {}
    for side in ("jax", "port"):
        recs[side] = root / side / "rec"
        ckpt = recs[side] / "checkpoints" / "ckpt.0000.msgpack"
        if side == "jax":
            jt.save_checkpoint(ckpt, epoch=0)
        else:
            ckpt.parent.mkdir(parents=True)
            shutil.copy(recs["jax"] / "checkpoints" / ckpt.name, ckpt)
    return data, recs


def test_run_test_protocol_matches_jax(protocol_tree, monkeypatch):
    import test_glas as j_test_glas

    from wesup_tpu_torch import test_glas as t_test_glas

    data, recs = protocol_tree
    j_qp = _jax_script("quality_protocol")
    # both packages' test_glas at the checkpoint's small f32 config
    monkeypatch.setattr(j_test_glas, "test", partial(j_test_glas.test,
                                                     **SMALL))
    monkeypatch.setattr(t_test_glas, "test", partial(t_test_glas.test,
                                                     **SMALL))
    want = j_qp.run_test_protocol(recs["jax"], data)
    got = t_qp.run_test_protocol(recs["port"], data, device="cpu")
    for split in ("testA", "testB"):
        masks = list((recs["jax"] / "results-5scale" / split).iterdir())
        assert len(np.unique(cv2.imread(str(masks[0]), 0))) == 2
        assert set(got[split]) == set(want[split]) == set(METRICS)
        for m in METRICS:
            assert abs(got[split][m] - want[split][m]) <= 1e-6, (split, m)


# ---------------------------------------------------------------------------
# a tiny run, its summary and its reuse
# ---------------------------------------------------------------------------

def _jax_summary_keys(tmp_path, monkeypatch):
    """The keys of the JAX script's summary, from its ``main`` with the
    dataset, training and test protocol stubbed."""
    j_qp = _jax_script("quality_protocol")
    monkeypatch.setattr(j_qp, "build_dataset", lambda args: Path(args.root))
    monkeypatch.setattr(j_qp, "train", lambda root, args, ov: (
        tmp_path / "jrec", 0.5, 0.25))
    monkeypatch.setattr(j_qp, "run_test_protocol", lambda rec, root: {})
    out = tmp_path / "jax_summary.json"
    monkeypatch.setattr(sys, "argv", ["quality_protocol.py", "--root",
                                      str(tmp_path / "jroot"), "--out",
                                      str(out)])
    j_qp.main()
    return set(json.loads(out.read_text()))


def test_tiny_protocol_run_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "unused"))
    argv = ["--device", "cpu", "--epochs", "2", "--hw", "64", "80",
            "--n-train", "2", "--n-val", "1", "--n-test", "1", "--root",
            str(tmp_path / "qp"), "--out", str(tmp_path / "qp.json")]
    summary = t_qp.main(argv)
    assert set(summary) == _jax_summary_keys(tmp_path, monkeypatch) == SUMMARY
    assert json.loads((tmp_path / "qp.json").read_text()) == summary
    assert summary["variant"] == "easy" and summary["epochs"] == 2
    for split in ("testA", "testB"):
        assert set(summary["splits"][split]) == set(METRICS)
    record = Path(summary["record_dir"])
    assert sorted(p.name for p in (record / "checkpoints").iterdir()) == [
        "ckpt.0002.pth"]
    default, exact = _pandas(record / "history.csv")
    got = (summary["best_val_dice"], summary["final_val_dice"])
    assert got == exact and all(map(_within_ulp, got, default))

    def no_training(*args):
        raise AssertionError("--reuse-record auto trained")

    monkeypatch.setattr(t_qp, "train", no_training)
    again = t_qp.main(argv + ["--reuse-record", "auto"])
    assert again["record_dir"] == summary["record_dir"]
    assert (again["best_val_dice"], again["final_val_dice"]) == got
    assert again["splits"] == summary["splits"]
    # a record that other sources of the port trained is not reused
    (record / t_qp.CODE_DIGEST).write_text("0" * 64)
    with pytest.raises(AssertionError, match="trained"):
        t_qp.main(argv + ["--reuse-record", "auto"])


def test_defaults_lie_in_the_temporary_directory(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for hard in ([], ["--hard"]):
        args = t_qp.parse_args(hard)
        variant = "hard" if hard else "easy"
        assert Path(args.root) == tmp_path / f"torch_quality_protocol_{variant}"
        assert Path(args.out) == tmp_path / f"torch_quality_protocol_{variant}.json"
    args = t_qs.parse_args([])
    assert Path(args.root) == tmp_path / "torch_quality_protocol_hard"
    assert Path(args.out) == tmp_path / "torch_qp_hard_sweep.json"


def _history(path, overrides, epochs=14):
    """A seeded ``history.csv`` (the trainer's layout) for a config."""
    from wesup_tpu_torch.utils.history import HistoryTracker

    rng = np.random.default_rng(zlib.crc32(json.dumps(
        overrides, sort_keys=True).encode()))
    dice = np.clip(np.linspace(0.3, 1.1, epochs) + rng.normal(0, 0.1, epochs),
                   0, 1)
    tracker = HistoryTracker(path)
    for d in dice:
        tracker.start_new_epoch(5e-5)
        tracker.train()
        tracker.step({"loss": float(rng.random())})
        tracker.eval()
        tracker.step({"dice": float(d)})
        tracker.save()


def test_val_dice_reads_history_as_pandas(tmp_path):
    for seed in range(5):
        path = tmp_path / f"h{seed}.csv"
        _history(path, {"seed": seed})
        default, exact = _pandas(path)
        got = t_qp.val_dice(path)
        assert got == exact and all(map(_within_ulp, got, default))


# ---------------------------------------------------------------------------
# the ablation and the sweep against the JAX scripts
# ---------------------------------------------------------------------------

class _StubTrainer:
    """Writes the seeded history of its config and trains nothing."""

    def __init__(self, kwargs):
        import os

        self.kwargs = kwargs
        self.device = SimpleNamespace(type="cpu")
        self.record_dir = Path(os.environ["RECORD_ROOT"]) / "rec"

    def train(self, data_root, epochs):
        self.record_dir.mkdir(parents=True)
        overrides = {k: v for k, v in self.kwargs.items()
                     if k not in ("epochs", "seed", "checkpoint_period",
                                  "device")}
        _history(self.record_dir / "history.csv", overrides)


def _strip_wall(text):
    return [line.rsplit("|", 2)[0] for line in text.splitlines()
            if line.startswith("|")]


def test_ablation_rows_and_table_match_jax(tmp_path, monkeypatch, capsys):
    import wesup_tpu.models
    import wesup_tpu_torch.models

    j_qa = _jax_script("quality_ablation")
    stub = lambda model, **kw: _StubTrainer(kw)  # noqa: E731
    monkeypatch.setattr(wesup_tpu.models, "initialize_trainer", stub)
    monkeypatch.setattr(wesup_tpu_torch.models, "initialize_trainer", stub)
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "unused"))
    small = ["--hw", "32", "48", "--n-train", "1", "--n-val", "1"]
    monkeypatch.setattr(sys, "argv", ["quality_ablation.py", "--root",
                                      str(tmp_path / "j"), "--out",
                                      str(tmp_path / "j.json"), *small])
    j_qa.main()
    want_table = _strip_wall(capsys.readouterr().out)
    rows = t_qa.main(["--root", str(tmp_path / "t"), "--out",
                      str(tmp_path / "t.json"), *small])
    got_table = _strip_wall(capsys.readouterr().out)
    want = json.loads((tmp_path / "j.json").read_text())
    assert rows == json.loads((tmp_path / "t.json").read_text())
    assert [r["variant"] for r in rows] == [r["variant"] for r in want] == [
        *t_qa.POINT_VARIANTS, *t_qa.MASK_VARIANTS]
    assert any(r["breakthrough_epoch"] for r in rows)
    for r, w in zip(rows, want):
        assert r["breakthrough_epoch"] == w["breakthrough_epoch"]
        for k in ("final_dice", "best_dice", "mean_last10"):
            assert _within_ulp(r[k], w[k]), (r["variant"], k)
    assert got_table == want_table and len(got_table) == 8


def test_sweep_runs_match_jax_and_default_out(tmp_path, monkeypatch):
    j_qs = _jax_script("quality_sweep")
    assert t_qs.DEFAULT_CONFIGS == j_qs.DEFAULT_CONFIGS
    args = t_qs.parse_args([])
    artifacts = (REPO / "artifacts").resolve()
    assert artifacts not in Path(args.out).resolve().parents
    assert (args.epochs, args.configs) == (250, ";".join(t_qs.DEFAULT_CONFIGS))

    def local(path, *more):
        """The JAX script's per-config summaries, moved from /tmp into
        this test's directory."""
        path = Path(path, *more)
        if str(path).startswith("/tmp/qp_sweep_"):
            path = tmp_path / path.name
        return path

    def protocol(cmd, **kwargs):
        """A stubbed protocol run: a summary seeded by its --set values."""
        sets = [cmd[i + 1] for i, c in enumerate(cmd) if c == "--set"]
        v = np.random.default_rng(zlib.crc32(";".join(sets).encode())).random(
            12)
        summary = {"variant": "hard", "epochs": 250,
                   "best_val_dice": float(v[0]), "final_val_dice": float(v[1]),
                   "splits": {s: dict(zip(METRICS, map(float, v[i:i + 5])))
                              for s, i in (("testA", 2), ("testB", 7))},
                   "wall_s": 1.0, "record_dir": "rec"}
        local(cmd[cmd.index("--out") + 1]).write_text(json.dumps(summary))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(j_qs, "Path", local)
    monkeypatch.setattr(j_qs.subprocess, "run", protocol)
    monkeypatch.setattr(sys, "argv", ["quality_sweep.py", "--out",
                                      str(tmp_path / "j.json")])
    j_qs.main()
    (tmp_path / "t").mkdir()
    got = t_qs.main(["--out", str(tmp_path / "t" / "t.json"), "--device",
                     "cpu"])
    monkeypatch.undo()
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t" / "t.json").read_text())["runs"] == got
    assert want["epochs"] == 250 and len(got) == len(want["runs"]) == 5
    assert len(list((tmp_path / "t").glob("torch_qp_sweep_*.json"))) == 5
    for g, w in zip(got, want["runs"]):
        assert g.pop("sweep_wall_s") >= 0 and w.pop("sweep_wall_s") >= 0
        assert g == w

