"""The port's initial weights are the JAX trainer's, on the CPU.

``models/jax_init.py`` draws them with ``utils/prng.py``, a numpy copy
of the parts of ``jax.random`` that ``wesup_tpu.models.wesup.init_params``
uses.  Held against the
installed JAX:

- the flag it follows (``jax_threefry_partitionable``) and the raw
  ``random_bits``, ``split`` and ``fold_in`` of a few keys, bitwise: if a
  JAX upgrade changes either, these fail first;
- ``uniform``, ``normal`` and XLA's f32 ``erf_inv`` on 200 000 draws,
  bitwise;
- for seeds 0, 1 and 7 at ``fc_width=64``, ``jax_init.init_params``
  against ``from_jax_params(init_params(PRNGKey(seed)))``: the linear
  layers bitwise, the conv weights within 2 f32 ulps (they are bitwise
  here too);
- ``WESUPTrainer(seed=s, device="cpu")`` starts from those weights, and
  a trainer that loads a checkpoint first draws none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wesup_tpu.models import wesup as j_wesup
from wesup_tpu_torch.models import initialize_trainer, jax_init, wesup
from wesup_tpu_torch.models.convert import from_jax_params
from wesup_tpu_torch.utils import prng
from torch_threads import worker_threads  # noqa: E402,F401

SEEDS = [0, 1, 7]


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_jax_follows_the_flag_this_copy_follows():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_raw_bits_split_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), mine)
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 18)),
                                  prng.split(mine, 18))
    for data in (0, 3, 123456):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)),
            prng.fold_in(mine, data))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (3, 5, 7), jnp.uint32)),
        prng.random_bits(mine, (3, 5, 7)))


def test_uniform_normal_and_erf_inv_are_bitwise():
    key = jax.random.PRNGKey(3)
    mine = prng.PRNGKey(3)
    n = 200_000
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, (n,), jnp.float32, -0.3, 0.3)),
        prng.uniform(mine, (n,), -0.3, 0.3))
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(key, (n,), jnp.float32)),
        prng.normal(mine, (n,)))
    u = prng.uniform(mine, (n,), -1.0, 1.0)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.lax.erf_inv)(u)), prng.erf_inv(u))


def _jax_state(seed):
    params = j_wesup.init_params(jax.random.PRNGKey(seed), fc_width=64)
    return from_jax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("seed", SEEDS)
def test_init_params_match_jax(seed):
    want = _jax_state(seed)
    got = jax_init.init_params(seed, fc_width=64)
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name].numpy(), want[name].numpy()
        assert a.shape == b.shape, name
        if name.startswith("backbone.") and name.endswith(".weight"):
            assert _ulps(a, b).max() <= 2, name
        else:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32), err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_trainer_starts_from_jax_weights(seed):
    trainer = initialize_trainer("wesup", device="cpu", seed=seed,
                                 fc_width=64)
    want = _jax_state(seed)
    state = trainer.model.state_dict()
    for name, value in want.items():
        a = state[name].numpy()
        if name.startswith("backbone.") and name.endswith(".weight"):
            assert _ulps(a, value.numpy()).max() <= 2, name
        else:
            np.testing.assert_array_equal(a, value.numpy(), err_msg=name)


def test_trainer_loading_a_checkpoint_draws_no_weights(tmp_path, monkeypatch):
    """The inference CLIs and the DigestPath pipeline build a trainer and
    load a checkpoint into it: no initial weights are drawn, and the
    checkpoint's are what the trainer holds."""
    src = wesup.WESUP(fc_width=64, generator=torch.Generator().manual_seed(5))
    ckpt = tmp_path / "rec" / "checkpoints" / "ckpt.0001.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save({"epoch": 1, "model_state_dict": src.state_dict()}, ckpt)

    def draw(*args, **kwargs):
        raise AssertionError("initial weights drawn")

    monkeypatch.setattr(jax_init, "init_params", draw)
    trainer = initialize_trainer("wesup", device="cpu", fc_width=64)
    trainer.load_checkpoint(ckpt)
    state = trainer.model.state_dict()
    for name, value in src.state_dict().items():
        assert torch.equal(state[name], value), name
