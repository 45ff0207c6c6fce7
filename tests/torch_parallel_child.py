"""One rank of a ``torch.distributed`` job of the port's parallel tests.

    python tests/torch_parallel_child.py <job.json> <rank>

The job file (written by tests/test_torch_port_parallel.py) names the
coordinator (``host:port``), the world size and a list of scenarios; the
rank joins the job with ``runtime.initialize_multihost`` over gloo on the
CPU, runs each scenario in turn and writes what the test reads under the
job's ``out`` directory.  It imports no JAX.
"""

import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.inference import (Predictor, predict_multiscale,  # noqa
                                       predict_tiled)
from wesup_tpu_torch.models import initialize_trainer, steps, wesup  # noqa
from wesup_tpu_torch.parallel import collectives, make_mesh  # noqa: E402
from wesup_tpu_torch.runtime import initialize_multihost  # noqa: E402


def _trainer(sc, world):
    os.environ["RECORD_ROOT"] = sc["record_root"]
    return initialize_trainer(
        "wesup", device="cpu", epochs=sc.get("epochs", 2),
        batch_size=sc["batch_size"],
        slic_iters=2, sp_area=64, compute_dtype="float32",
        fc_width=sc.get("fc_width", 1024), metrics=sc.get("metrics"),
        num_devices=world, model_parallel=sc.get("model_parallel", 1))


def history(sc, rank, world, out):
    """Train (2 epochs by default); report the mesh, the loader's rows, the shard
    shapes, the valid rows of every batch, the failed batches, the record
    and (after training) ``predict_probs`` of a fixed image.  ``fail_rank``
    raises in that rank's first step, ``stage_fail_rank`` in the copy of
    its first train batch (the staging thread's)."""
    trainer = _trainer(sc, world)
    put, rows = trainer._put_batch, []
    stage_fail = [sc.get("stage_fail_rank") == rank]

    def spy(batch, rng_idx=None):
        rows.append(int(np.asarray(batch["sample_valid"]).sum()))
        if stage_fail[0] and rng_idx == (1, 0):   # the first train batch
            stage_fail[0] = False
            raise RuntimeError("injected staging failure")
        return put(batch, rng_idx)

    fail_at = sc.get("fail_rank") == rank
    prep = steps._preprocess_sample

    def failing(*args, **kwargs):
        if failing.armed:
            failing.armed = False
            raise RuntimeError("injected failure")
        return prep(*args, **kwargs)

    failing.armed = fail_at
    with mock.patch.object(trainer, "_put_batch", spy), \
            mock.patch.object(steps, "_preprocess_sample", failing):
        trainer.train(sc["data"], epochs=sc.get("epochs", 2))
    loader = trainer.dataloaders["train"]
    img = np.random.default_rng(5).integers(0, 255, (45, 61, 3), np.uint8)
    report = {
        "mesh": trainer.mesh.shape,
        "rows": loader.rows, "effective": loader.effective_batch_size,
        "fc1": list(trainer.model.fc_layers[0].weight.shape),
        "fc2": list(trainer.model.fc_layers[2].weight.shape),
        "valid_rows": rows,
        "failed": {f"{e}/{p}": v["failed"]
                   for (e, p), v in trainer.phase_stats.items()},
        "record": str(trainer.record_dir),
        "probs": trainer.predict_probs(img).tolist(),
    }
    (out / f"{sc['name']}.{rank}.json").write_text(json.dumps(report))


def one_step(sc, rank, world, out):
    """One train step of the global batch in ``sc['inputs']`` from its
    weights and key, this rank's rows; rank 0 writes the weights after it
    and the global metric means."""
    inputs = torch.load(sc["inputs"], weights_only=False)
    cfg = WESUPConfig(**inputs["config"])
    mesh = make_mesh()
    model = wesup.WESUP(fc_width=cfg.fc_width)
    model.load_state_dict(inputs["state"])
    batch = inputs["batch"]
    rows = mesh.data_rows(batch["sample_valid"].shape[0])
    mine = {k: v[rows] for k, v in batch.items()}
    step = steps.make_train_step(cfg, inputs["hw"], point_mode=True,
                                 device="cpu", mesh=mesh)
    acc = step(model, steps.make_optimizer(cfg, model),
               steps.init_metric_acc(device="cpu"), mine, inputs["key"])
    packed = torch.stack([acc["count"]] + [acc["sums"][k] for k in
                                           steps.TRAIN_METRIC_KEYS])
    collectives.all_reduce(packed, mesh.data_group)
    if rank == 0:
        torch.save({"state": model.state_dict(),
                    "means": (packed[1:] / packed[0]).tolist(),
                    "count": packed[0].item()}, out / f"{sc['name']}.pt")


def predict(sc, rank, world, out):
    """The sharded Predictor: padded, tiled and multi-scale inference in
    ``sc['mode']`` on a (data, model) mesh, and in superpixel mode the
    predict step on the (split) model; rank 0 writes them."""
    inputs = torch.load(sc["inputs"], weights_only=False)
    cfg = WESUPConfig(**inputs["config"])
    mesh = make_mesh(world, sc["model_parallel"])
    model = wesup.WESUP(fc_width=cfg.fc_width)
    model.load_state_dict(inputs["state"])
    pred = Predictor(model, cfg, mode=sc["mode"], device="cpu", mesh=mesh)
    res = {"mesh": mesh.shape, "data_shards": pred.data_shards,
           "fc1": list(pred.model.fc_layers[0].weight.shape),
           "fc2": list(pred.model.fc_layers[2].weight.shape),
           "padded": pred.predict_padded(inputs["images"])}
    if "tile_image" in inputs:
        res["tiled"] = predict_tiled(pred, inputs["tile_image"],
                                     patch_size=inputs["patch"])
        res["multiscale"] = predict_multiscale(pred, inputs["tile_image"],
                                               scales=(0.5, 0.4))
    if sc["mode"] == "superpixel":
        hw = inputs["canvas"].shape[1:3]
        step = steps.make_predict_step(cfg, hw, "superpixel", device="cpu")
        res["step"] = step(pred.model, inputs["canvas"], inputs["valid"])
    if rank == 0:
        torch.save(res, out / f"{sc['name']}.pt")


SCENARIOS = {"history": history, "one_step": one_step, "predict": predict}


def main(job_path, rank):
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    out = Path(job["out"])
    initialize_multihost(job["coordinator"], job["world"], rank,
                         backend="gloo")
    for sc in job["scenarios"]:
        SCENARIOS[sc["kind"]](sc, rank, job["world"], out)
        print(f"rank {rank}: {sc['name']} done", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
