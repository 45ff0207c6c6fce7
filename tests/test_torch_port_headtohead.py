"""The JAX trainer against the port's over several epochs with the
augmentation off (``tests/trainer_headtohead.py``), on the CPU.

With the augmentation draws replaced by the identity in both packages,
both trainers take the same SGD steps from one JAX checkpoint (f32) on
the same batches in the same order: every history column agrees to float
noise (1e-5 relative), the propagation counts are equal, and each
parameter has moved the same way: the port's change from the initial
weights is the JAX trainer's within 1e-2 of the largest change of that
tensor plus 8 f32 ulps of its largest weight (the f32 weights round
changes of 1e-7 to 1e-5 to a few ulps).  This holds
what the one-step parity tests cannot: the momentum and weight decay
carried across steps and epochs, the data order and multiscale draws of
later epochs, the propagation branch as the weights move, the constant
learning rate.  ``python tests/trainer_headtohead.py --epochs 120`` runs
the same comparison at 96x128 for as long as asked.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
from trainer_headtohead import run  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401


def test_trainers_agree_without_augmentation(tmp_path):
    """2 epochs of 3 images at 64x80: 6 SGD steps and 2 val phases."""
    hist = run(tmp_path, epochs=2, hw=(64, 80), n_train=3, n_val=2)
    assert len(hist["jax"]) == len(hist["port"]) == 2
    for j, t in zip(hist["jax"], hist["port"]):
        assert list(j) == list(t)
        assert j["propagated_labels"] == t["propagated_labels"]
        for k in j:
            assert abs(j[k] - t[k]) <= 1e-5 * max(1.0, abs(j[k])), k
    assert hist["jax"][0]["loss"] != hist["jax"][1]["loss"]
    w = hist["weights"]
    assert list(w["port"]) == list(w["jax"]) == list(w["init"])
    for name, init in w["init"].items():
        want, got = w["jax"][name] - init, w["port"][name] - init
        scale = np.abs(want).max()
        ulp = np.spacing(np.float32(np.abs(init).max()))
        assert scale > 0, name
        assert np.abs(got - want).max() <= 1e-2 * scale + 8 * ulp, name


def test_port_on_jax_streams_follows_jax_trainer_with_masks(tmp_path,
                                                             monkeypatch):
    """The mask-supervised path with its augmentation on (elastic p=0.5):
    the JAX trainer from its own seed against the port on that trainer's
    initial weights and augmentation draws (``tests/jax_stream_replay.py``),
    2 epochs of 3 images at 64x80.  Every history column agrees to 1e-5
    relative and the propagation counts are equal, as without the
    augmentation: the appearance, elastic and affine warps of the image,
    mask and valid canvas, and the dumped key chain, are the JAX
    trainer's."""
    from jax_stream_replay import dump, train
    from make_dataset import make_dataset
    from trainer_headtohead import _rows
    from wesup_tpu.models import initialize_trainer as j_init

    data = make_dataset(tmp_path / "data", n_train=3, n_val=2, hw=(64, 80),
                        seed=0, with_points=False)
    cfg = dict(compute_dtype="float32", elastic_p=0.5)
    monkeypatch.setenv("RECORD_ROOT", str(tmp_path / "jax"))
    trainer = j_init("wesup", seed=0, checkpoint_period=0, **cfg)
    trainer.train(str(data), epochs=2)
    want = _rows(trainer.record_dir / "history.csv")
    draws = dump(tmp_path / "draws", 2, 3, masks=True, elastic_p=0.5)
    got = train(draws, data, 2, cfg, device="cpu")["history"]
    assert len(want) == len(got) == 2
    for j, t in zip(want, got):
        assert list(j) == list(t)
        assert j["propagated_labels"] == t["propagated_labels"]
        for k in j:
            assert abs(j[k] - t[k]) <= 1e-5 * max(1.0, abs(j[k])), (k, j, t)
    assert want[0]["loss"] != want[1]["loss"]
