"""The port's ``quality_headtohead`` against the JAX script's, on the CPU.

- On ``make_dataset(n_train=6, n_val=3, hw=(64, 80), seed=0)``, the
  port's ``run()`` for 12 epochs (eval every 2) meets what
  ``tests/test_quality_headtohead.py`` asserts of the JAX script: loss MAE
  < 1e-3 between its two sides, identical propagation counts, final val
  Dice within 0.005, the loss moved and propagation was active; and its
  side's losses follow the JAX script's ``run()`` on the same data within
  1e-4 (one JAX run, shared by the module);
- ``--self-chaos`` runs and writes the JAX script's keys;
- the replica (``scripts/_reference_replica.py``) is a faithful copy:
  its forward and loss functions equal ``tests/test_model.py``'s
  ``_TorchWESUP`` and ``tests/test_loss.py``'s functions bitwise, on the
  same weights and superpixels;
- the tool imports and runs with ``jax``, ``cv2`` and ``wesup_tpu``
  blocked.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))

from make_dataset import make_dataset  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch.scripts import _reference_replica as replica  # noqa: E402
from wesup_tpu_torch.scripts import quality_headtohead as port_h2h  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
EPOCHS, EVAL_EVERY = 12, 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_h2h")
    make_dataset(root, n_train=6, n_val=3, hw=(64, 80), seed=0)
    return root


@pytest.fixture(scope="module")
def port_run(dataset):
    final, _ = port_h2h.run(str(dataset), EPOCHS, EVAL_EVERY,
                            log=lambda *a, **k: None, device="cpu")
    return final


@pytest.fixture(scope="module")
def jax_run(dataset):
    import jax

    if jax.default_backend() != "cpu":
        pytest.skip("the JAX script's head-to-head is CPU-only")
    import quality_headtohead as jax_h2h

    final, _ = jax_h2h.run(str(dataset), epochs=EPOCHS,
                           eval_every=EVAL_EVERY, log=lambda *a, **k: None)
    return final


def test_multiepoch_trajectory_matches_the_replica(port_run):
    final, hist = port_run, port_run["history"]
    assert final["loss_mae"] < 1e-3, final
    np.testing.assert_array_equal(hist["ours_prop"], hist["torch_prop"])
    assert final["dice_delta"] <= 0.005, final
    assert hist["ours_loss"][0] - hist["ours_loss"][-1] > 1e-3
    assert max(hist["ours_prop"]) > 0
    assert (final["K"], final["hw"], final["n_train"], final["n_val"]) == (
        30, [64, 80], 6, 3)


def test_port_side_follows_the_jax_script(port_run, jax_run):
    """The same keys as the JAX script's ``final``; the port's side
    (forward_superpixel + wesup_loss + SGD) within 1e-4 of JAX's
    (forward_superpixel + wesup_loss + optax) at every evaluation, and
    the replicas' losses too."""
    assert set(port_run) == set(jax_run)
    assert set(port_run["history"]) == set(jax_run["history"])
    ours, theirs = port_run["history"], jax_run["history"]
    assert ours["epoch"] == theirs["epoch"]
    for key in ("ours_loss", "torch_loss"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(ours["ours_prop"], theirs["ours_prop"])


def test_self_chaos_writes_the_jax_keys(dataset, tmp_path):
    out = tmp_path / "chaos.json"
    final = port_h2h.main(["--root", str(dataset), "--epochs", "1",
                           "--eval-every", "1", "--self-chaos",
                           "--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert set(written) == {"final_a_dice", "final_b_dice", "dice_delta",
                            "max_traj_delta", "epochs", "weights",
                            "history"}
    assert set(written["history"]) == {"epoch", "a_dice", "b_dice",
                                       "a_loss", "b_loss"}
    assert written["epochs"] == 1 and written["history"]["epoch"] == [1]
    assert final["dice_delta"] == written["dice_delta"]


def test_replica_copy_equals_the_test_replica_bitwise():
    from test_loss import _torch_propagate, _torch_semi_ce
    from test_model import _TorchWESUP

    from wesup_tpu_torch.models import jax_init

    state = jax_init.init_params(3)
    ours = replica.ReferenceWESUP()
    replica.copy_weights(state, ours)
    theirs = _TorchWESUP()
    theirs.load_state_dict(ours.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 3, 32, 40)).astype(np.float32))
    seg = rng.integers(0, 9, 32 * 40)
    oh = np.zeros((seg.size, 9), np.float32)
    oh[np.arange(seg.size), seg] = 1.0
    sp_maps = torch.from_numpy(oh.T / oh.sum(0)[:, None])
    with torch.no_grad():
        (pa, fa), (pb, fb) = ours(x, sp_maps), theirs(x, sp_maps)
    assert torch.equal(pa, pb) and torch.equal(fa, fb)
    # the weight copy reads the port's state dict in the reference's names
    sd = ours.state_dict()
    assert torch.equal(sd["backbone.28.weight"], state["backbone.28.weight"])
    assert torch.equal(sd["side.12.weight"], state["side_conv1856.weight"])
    assert torch.equal(sd["classifier.0.bias"], state["classifier.0.bias"])
    y = torch.zeros(9, 2)
    y[[0, 3], 0] = 1.0
    y[5, 1] = 1.0
    for weights in (None, (3, 1)):
        assert torch.equal(replica.semi_ce(pa, y, weights),
                           _torch_semi_ce(pa, y, weights))
    assert torch.equal(replica.semi_ce(pa, torch.zeros(9, 2)),
                       _torch_semi_ce(pa, torch.zeros(9, 2)))
    for threshold in (0.0, 0.8, 1.0):
        assert torch.equal(replica.propagate(fa, y[:4], threshold),
                           _torch_propagate(fa, y[:4], threshold))


def test_tool_runs_without_jax_opencv_and_the_jax_package(dataset, tmp_path):
    out = tmp_path / "h2h.json"
    code = f"""
import sys
for name in ("jax", "wesup_tpu", "cv2"):
    sys.modules[name] = None         # any import of these now fails
from wesup_tpu_torch.scripts import quality_headtohead
quality_headtohead.main(["--root", {str(dataset)!r}, "--epochs", "1",
                         "--eval-every", "1", "--device", "cpu",
                         "--out", {str(out)!r}])
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "wesup_tpu", "cv2")]
assert not bad, bad
print("done")
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert run.stdout.rstrip().endswith("done")
    assert json.loads(out.read_text())["epochs"] == 1
