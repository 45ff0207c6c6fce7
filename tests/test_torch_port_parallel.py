"""The port's data and tensor parallelism, on the CPU over gloo.

Each job is a few processes (``tests/torch_parallel_child.py``, one
thread each, ``OMP_NUM_THREADS=1``) joined by
``runtime.initialize_multihost`` at a ``tcp`` coordinator; a job that
has not ended within :data:`TIMEOUT` seconds is killed and its test
fails.  Small shapes: ``tests/make_dataset.py`` images of three sizes
(bucketed canvases), 2 SLIC iterations, sp_area 64, f32, fc_width 64.

- the mesh's size rule is JAX's (``gcd``), and a ``num_devices`` the job
  cannot hold raises;
- DP over 2 ranks: the trainer's history equals the 1-process port's at
  batch sizes 2 and 3 (3 pads with a blank; an epoch's last batch of one
  image leaves the second rank only blanks), rtol 1e-4 / atol 1e-6 as
  tests/test_trainer_dp.py, with the host metrics (detection F1, object
  Dice) that each rank scores on its own rows; a rank that raises in one
  batch makes both count it failed, and the run ends; so does a rank
  whose staging thread fails to copy a batch (the trainer's chain queues
  ``steps.FailedBatch``);
- one DP train step of a padded global batch (3 images + 1 blank) against
  JAX's train step on a 2-device mesh, same weights, batch and key: lr 1
  and no weight decay, so the update is the gradient, held within the
  f32 train-step limits of tests/test_torch_port_prng.py (1e-3 of each
  tensor's largest |grad|, the backbone's 5e-3); its loss against the
  1-process port's step on the whole batch (1e-5);
- TP over 2 ranks (model 2): the pixel Predictor and the superpixel
  predict step against the 1-process port (rtol 1e-5 / atol 1e-6, as
  tests/test_tp.py) and against JAX's ``Predictor(mesh=make_mesh(2,
  2))`` and predict step (2e-4, the suite's f32 port-vs-JAX limit,
  tests/test_torch_port_infer.py), with fc1 and fc2 split;
- the sharded Predictor (data 2): padded (3 images), tiled (9 tiles, a
  chunk of 8 and one of 1) and multi-scale inference against the solo
  Predictor within 1e-5;
- (data 2, model 2) on 4 ranks: the history equals the 1-process port's,
  with the shard shapes asserted; its last checkpoint loads into a
  1-process trainer, whose ``predict_probs`` equals the 4-rank trainer's;
  a rank that raises in one batch before the split head's forward makes
  all four count it failed, and the run ends.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
from make_dataset import make_dataset  # noqa: E402

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.inference import Predictor as JPredictor  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.inference import (  # noqa: E402
    Predictor, get_top_left_coordinates, predict_multiscale, predict_tiled)
from wesup_tpu_torch.models import initialize_trainer, steps, wesup  # noqa
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
from wesup_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401

CHILD = Path(__file__).parent / "torch_parallel_child.py"
TIMEOUT = 240
FC_WIDTH = 64
SIZES = [(40, 56), (56, 72), (48, 64)]
STEP_HW = (64, 64)
KW = dict(compute_dtype="float32", slic_iters=2, sp_area=64,
          fc_width=FC_WIDTH)
# host metrics beside the device ones: each rank scores its own rows
METRICS = ["accuracy", "dice", "detection_f1", "object_dice"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(out: Path, world: int, scenarios) -> Path:
    """Run one job of ``world`` ranks; fails the test on a non-zero exit
    or after :data:`TIMEOUT` seconds (every rank is killed)."""
    job = out / f"job{world}.json"
    job.write_text(json.dumps({
        "coordinator": f"127.0.0.1:{_free_port()}", "world": world,
        "out": str(out), "scenarios": scenarios}))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [out / f"job{world}.rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(job), str(r)],
                              stdout=open(log, "w"),
                              stderr=subprocess.STDOUT, env=env,
                              cwd=str(CHILD.parent.parent))
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the {world}-rank job ran past {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        tails = "\n".join(f"--- rank {r} (rc {rc}):\n"
                          + logs[r].read_text()[-3000:] for r, rc in bad)
        pytest.fail(f"ranks failed:\n{tails}")
    return out


def _report(out, name, rank=0):
    return json.loads((out / f"{name}.{rank}.json").read_text())


def _history(record):
    return pd.read_csv(Path(record) / "history.csv")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _jax_params():
    return j_wesup.init_params(jax.random.PRNGKey(3), fc_width=FC_WIDTH)


def _step_batch(B=4, n_real=3, P=12, seed=21):
    H, W = STEP_HW
    rng = np.random.default_rng(seed)
    batch = {
        "image": np.clip(rng.normal(180, 40, (B, H, W, 3)), 0,
                         255).astype(np.uint8),
        "valid": np.zeros((B, H, W), bool),
        "pixel_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
        "points": np.zeros((B, P, 3), np.int32),
        "point_valid": np.zeros((B, P), bool),
        "use_mask_as_points": np.zeros((B,), bool),
        "sample_valid": np.arange(B) < n_real,
    }
    batch["valid"][:n_real, :H - 2, :W - 7] = True
    batch["pixel_mask"][~batch["valid"]] = -1
    for b in range(n_real):
        for i in range(8):
            x, y = rng.integers(8, W - 14), rng.integers(6, H - 6)
            batch["points"][b, i] = (x, y, batch["pixel_mask"][b, y, x])
            batch["point_valid"][b, i] = True
    batch["image"][n_real:] = 0
    return batch


def _predict_inputs():
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 255, (2, 64, 96, 3)).astype(np.uint8)
    valid = np.zeros((2, 64, 96), bool)
    valid[:, :60, :90] = True
    return {"images": rng.random((3, 48, 64, 3)).astype(np.float32),
            "tile_image": rng.integers(0, 255, (100, 100, 3)).astype(
                np.uint8),
            "patch": 40, "canvas": canvas, "valid": valid}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_ds")
    # 7 images: an epoch's last batch holds one, so the second rank's
    # rows are only blanks
    make_dataset(root, n_train=7, n_val=2, hw=SIZES)
    return root


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """The 2-rank job: DP histories, a failing rank, one DP step, the
    sharded Predictor (data 2) and the TP predicts (model 2)."""
    out = tmp_path_factory.mktemp("two_ranks")
    params = _jax_params()
    state = from_jax_params(jax.tree.map(np.asarray, params))
    step_cfg = dict(KW, slic_iters=4, sp_area=100, lr=1.0, weight_decay=0.0)
    torch.save({"config": step_cfg, "state": state, "hw": STEP_HW,
                "batch": _step_batch(), "key": np.asarray(
                    jax.random.PRNGKey(8))}, out / "step_inputs.pt")
    torch.save(dict(_predict_inputs(), config=KW, state=state),
               out / "predict_inputs.pt")

    def hist(name, bs, **kw):
        return dict(kind="history", name=name, batch_size=bs,
                    data=str(data), fc_width=FC_WIDTH, metrics=METRICS,
                    record_root=str(out / name), **kw)

    run_job(out, 2, [
        hist("dp_bs2", 2), hist("dp_bs3", 3),
        hist("dp_fail", 2, fail_rank=1, epochs=1),
        hist("dp_stage_fail", 2, stage_fail_rank=0, epochs=1),
        dict(kind="one_step", name="dp_step",
             inputs=str(out / "step_inputs.pt")),
        dict(kind="predict", name="dp_predict", mode="superpixel",
             model_parallel=1, inputs=str(out / "predict_inputs.pt")),
        dict(kind="predict", name="tp_pixel", mode="pixel",
             model_parallel=2, inputs=str(out / "predict_inputs.pt")),
        dict(kind="predict", name="tp_superpixel", mode="superpixel",
             model_parallel=2, inputs=str(out / "predict_inputs.pt")),
    ])
    return out, params


@pytest.fixture(scope="module")
def four_ranks(data, tmp_path_factory):
    """The (data 2, model 2) training job, and one epoch of it in which
    rank 1 (model column 1 of data row 0) raises in its first batch."""
    out = tmp_path_factory.mktemp("four_ranks")
    run_job(out, 4, [
        dict(kind="history", name=name, batch_size=2, data=str(data),
             fc_width=FC_WIDTH, metrics=METRICS, model_parallel=2,
             record_root=str(out / name), **kw)
        for name, kw in (("tp_bs2", {}),
                         ("tp_fail", dict(fail_rank=1, epochs=1)))])
    return out


@pytest.fixture(scope="module")
def solo(data, tmp_path_factory):
    """The 1-process trainers' histories by batch size, and the bs 2
    trainer."""
    root = tmp_path_factory.mktemp("solo")
    runs = {}
    for bs in (2, 3):
        os.environ["RECORD_ROOT"] = str(root / f"bs{bs}")
        try:
            trainer = initialize_trainer(
                "wesup", device="cpu", epochs=2, batch_size=bs,
                metrics=METRICS, **KW)
            trainer.train(data, epochs=2)
        finally:
            del os.environ["RECORD_ROOT"]
        runs[bs] = (_history(trainer.record_dir), trainer)
    return runs


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,mp,shape", [
    (8, 2, (4, 2)), (8, 3, (8, 1)), (8, 4, (2, 4)), (6, 4, (3, 2)),
    (1, 2, (1, 1))])
def test_mesh_size_rule_is_jaxs(monkeypatch, world, mp, shape):
    monkeypatch.setattr(t_mesh, "world_size", lambda: world)
    mesh = t_mesh.make_mesh(0, mp)
    assert mesh.shape == {"data": shape[0], "model": shape[1]}
    assert not mesh.distributed
    with pytest.raises(ValueError, match="num_devices"):
        t_mesh.make_mesh(world + 1, mp)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [2, 3])
def test_dp_history_matches_one_process(two_ranks, solo, bs):
    out, _ = two_ranks
    reports = [_report(out, f"dp_bs{bs}", r) for r in range(2)]
    assert reports[0]["mesh"] == {"data": 2, "model": 1}
    # every global batch is a multiple of 2, each rank holds half of it
    assert reports[0]["effective"] % 2 == 0
    assert reports[0]["rows"] == reports[0]["effective"] // 2
    want, _ = solo[bs]
    got = _history(reports[0]["record"])
    assert list(got.columns) == list(want.columns)
    assert {"val_detection_f1", "val_object_dice"} <= set(got.columns)
    np.testing.assert_allclose(got.to_numpy(np.float64),
                               want.to_numpy(np.float64), rtol=1e-4,
                               atol=1e-6)
    # rank 1 writes nothing and reads rank 0's record directory
    assert reports[0]["record"] == reports[1]["record"]
    # the last batch of one image: rank 1 steps only blanks
    assert 0 in reports[1]["valid_rows"]
    assert reports[0]["probs"] == reports[1]["probs"]


def test_failing_rank_is_counted_failed_on_both(two_ranks):
    out, _ = two_ranks
    for r in range(2):
        rep = _report(out, "dp_fail", r)
        assert rep["failed"]["1/train"] == 1, rep["failed"]
        assert rep["failed"]["1/val"] == 0
    assert len(_history(_report(out, "dp_fail")["record"])) == 1


def test_staging_failure_is_counted_failed_on_both(two_ranks):
    """Rank 0's staging thread fails to copy its first train batch; the
    chain queues a failure marker, both ranks' steps fail on it together
    (neither waits in a collective the other skipped), and the run
    goes on."""
    out, _ = two_ranks
    for r in range(2):
        rep = _report(out, "dp_stage_fail", r)
        assert rep["failed"]["1/train"] == 1, rep["failed"]
        assert rep["failed"]["1/val"] == 0
    assert len(_history(_report(out, "dp_stage_fail")["record"])) == 1


def test_failing_rank_under_tp_is_counted_failed_on_all(four_ranks):
    # rank 1's model peer (rank 0) would otherwise wait in the split
    # head's all-reduce while rank 1 waits in the failure flag's
    for r in range(4):
        rep = _report(four_ranks, "tp_fail", r)
        assert rep["failed"]["1/train"] == 1, rep["failed"]
        assert rep["failed"]["1/val"] == 0
    assert len(_history(_report(four_ranks, "tp_fail")["record"])) == 1


def test_dp_step_matches_jax_and_one_process(two_ranks):
    out, params = two_ranks
    inputs = torch.load(out / "step_inputs.pt", weights_only=False)
    got = torch.load(out / "dp_step.pt", weights_only=False)
    batch, key = inputs["batch"], inputs["key"]

    jcfg = JConfig(**inputs["config"])
    tx = j_steps.make_optimizer(jcfg)
    mesh = j_make_mesh(2, 1)
    rep = NamedSharding(mesh, P())
    jstep = jax.jit(j_steps.make_train_step(jcfg, STEP_HW, point_mode=True,
                                            tx=tx))
    jparams, _, jacc = jstep(
        jax.device_put(params, rep), jax.device_put(tx.init(params), rep),
        jax.device_put(j_steps.init_metric_acc(), rep),
        jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       NamedSharding(mesh, P("data"))),
        jnp.asarray(key))
    assert got["count"] == float(jacc["count"]) == 3
    jmeans = [float(jacc["sums"][k]) / 3 for k in steps.TRAIN_METRIC_KEYS]
    np.testing.assert_allclose(got["means"], jmeans, rtol=1e-4, atol=1e-5)
    # lr 1, no weight decay, a fresh momentum: the update is the gradient
    before = inputs["state"]
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    for name, p in got["state"].items():
        jgrad = before[name] - want[name]
        grad = before[name] - p
        rel = 5e-3 if name.startswith("backbone.") else 1e-3
        lim = rel * jgrad.abs().max().item() + 1e-7
        err = (grad - jgrad).abs().max().item()
        assert err <= lim, (name, err, lim)

    # the multi-process job's loss is the 1-process global-batch step's
    cfg = WESUPConfig(**inputs["config"])
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(before)
    acc = steps.make_train_step(cfg, STEP_HW, point_mode=True,
                                device="cpu")(
        model, steps.make_optimizer(cfg, model),
        steps.init_metric_acc(device="cpu"), batch, key)
    loss = acc["sums"]["loss"].item() / acc["count"].item()
    np.testing.assert_allclose(got["means"][0], loss, rtol=1e-5)


# ---------------------------------------------------------------------------
# the sharded Predictor and tensor parallelism
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solo_predictions(two_ranks):
    out, params = two_ranks
    inputs = torch.load(out / "predict_inputs.pt", weights_only=False)
    cfg = WESUPConfig(**inputs["config"])
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(inputs["state"])
    res = {}
    for mode in ("superpixel", "pixel"):
        pred = Predictor(model, cfg, mode=mode, device="cpu")
        res[mode] = {"padded": pred.predict_padded(inputs["images"])}
    sp = Predictor(model, cfg, device="cpu")
    res["superpixel"].update(
        tiled=predict_tiled(sp, inputs["tile_image"],
                            patch_size=inputs["patch"]),
        multiscale=predict_multiscale(sp, inputs["tile_image"],
                                      scales=(0.5, 0.4)),
        step=steps.make_predict_step(cfg, inputs["canvas"].shape[1:3],
                                     device="cpu")(
            model, inputs["canvas"], inputs["valid"]))
    return inputs, res


def test_sharded_predictor_matches_solo(two_ranks, solo_predictions):
    out, _ = two_ranks
    inputs, want = solo_predictions
    got = torch.load(out / "dp_predict.pt", weights_only=False)
    assert got["data_shards"] == 2
    # 9 tiles: a chunk of 8 and one of 1, padded to 2
    assert len(get_top_left_coordinates(100, 100, inputs["patch"])) == 9
    for key in ("padded", "tiled", "multiscale"):
        np.testing.assert_allclose(got[key], want["superpixel"][key],
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["pixel", "superpixel"])
def test_tp_predict_matches_solo_and_jax(two_ranks, solo_predictions, mode):
    out, params = two_ranks
    inputs, want = solo_predictions
    got = torch.load(out / f"tp_{mode}.pt", weights_only=False)
    assert got["mesh"] == {"data": 1, "model": 2}
    # fc1 keeps half its output rows (2112 x 32 in JAX's layout), fc2
    # half its input columns
    assert got["fc1"] == [FC_WIDTH // 2, 2112]
    assert got["fc2"] == [FC_WIDTH, FC_WIDTH // 2]
    key = "step" if mode == "superpixel" else "padded"
    np.testing.assert_allclose(np.asarray(got[key]),
                               np.asarray(want[mode][key]), rtol=1e-5,
                               atol=1e-6)

    jcfg = JConfig(**KW)
    if mode == "pixel":
        jpred = JPredictor(params, jcfg, mode="pixel",
                           mesh=j_make_mesh(2, 2))
        assert tuple(jpred.params["fc1"]["w"].sharding.spec) == (
            None, "model")
        jwant = jpred.predict_padded(inputs["images"])
    else:
        jstep = j_steps.make_predict_step(
            jcfg, inputs["canvas"].shape[1:3], "superpixel")
        jwant = np.asarray(jstep(params, jnp.asarray(inputs["canvas"]),
                                 jnp.asarray(inputs["valid"])))
    np.testing.assert_allclose(np.asarray(got[key]), jwant, atol=2e-4)


def test_tp_training_matches_one_process(four_ranks, solo, tmp_path,
                                         monkeypatch):
    reports = [_report(four_ranks, "tp_bs2", r) for r in range(4)]
    assert reports[0]["mesh"] == {"data": 2, "model": 2}
    assert reports[0]["fc1"] == [FC_WIDTH // 2, 2112]
    assert reports[0]["fc2"] == [FC_WIDTH, FC_WIDTH // 2]
    want, trainer = solo[2]
    got = _history(reports[0]["record"])
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(np.float64),
                               want.to_numpy(np.float64), rtol=1e-4,
                               atol=1e-6)
    # the 4-rank checkpoint (full fc1 / fc2 and momentum) loads into one
    # process and predicts what the 4-rank trainer predicted
    (ckpt,) = (Path(reports[0]["record"]) / "checkpoints").glob("ckpt.*")
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path))
    one = initialize_trainer("wesup", device="cpu", **KW)
    one.load_checkpoint(ckpt)
    assert one.model.fc_layers[0].weight.shape == (FC_WIDTH, 2112)
    assert len(one.optimizer.state_dict()["state"]) > 0
    img = np.random.default_rng(5).integers(0, 255, (45, 61, 3), np.uint8)
    for rep in reports:
        np.testing.assert_allclose(one.predict_probs(img), rep["probs"],
                                   rtol=1e-5, atol=1e-6)
