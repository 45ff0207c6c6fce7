"""The PyTorch port's model against the JAX package, on the CPU.

Weights are the JAX ``init_params`` tree moved into the port with
``from_jax_params``; images and segmentations are made with numpy from a
seed and fed to both.  On the CPU the JAX forward takes its dense pooling
path and the port its kernels' plain versions.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent.parent))

from wesup_tpu.models import vgg as j_vgg  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu.ops.slic import make_plan as j_make_plan, slic as j_slic  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import steps, vgg, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import (from_jax_params,  # noqa: E402
                                            load_state_dict_file)
from wesup_tpu_torch.ops.slic import make_plan  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401

FC_WIDTH = 64


@pytest.fixture(scope="module")
def weights():
    params = j_wesup.init_params(jax.random.PRNGKey(0), fc_width=FC_WIDTH)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return params, model.eval()


@pytest.fixture(scope="module")
def batch():
    """bench.py-style images, ragged validity, and the JAX SLIC seg."""
    B, H, W = 2, 64, 160
    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(
        np.uint8).astype(np.float32) / 255.0
    valid = np.ones((B, H, W), bool)
    valid[:, -5:] = False
    valid[:, :, -7:] = False
    seg = np.array(jax.vmap(lambda i, v: j_slic(i, v, sp_area=200,
                                                update_stride=3))(
        jnp.asarray(img), jnp.asarray(valid)))
    return img, valid, seg


def test_state_dict_layout(weights, tmp_path):
    params, model = weights
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    ref = wesup.WESUP(fc_width=FC_WIDTH).state_dict()
    assert list(sd) == list(ref)
    assert all(sd[k].shape == ref[k].shape for k in ref)
    assert all(f"backbone.{i}.weight" in sd for i in vgg.TORCH_CONV_INDICES)
    assert "side_conv0.weight" in sd and "side_conv1856.weight" in sd
    assert sd["side_conv0.weight"].shape == (32, 64, 1, 1)
    # a reference-format checkpoint loads through the .pth loader
    path = tmp_path / "ckpt.pth"
    torch.save({"epoch": 3, "model_state_dict": model.state_dict()}, path)
    loaded = load_state_dict_file(path)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_init_is_seeded():
    a = wesup.WESUP(fc_width=8, generator=torch.Generator().manual_seed(5))
    b = wesup.WESUP(fc_width=8, generator=torch.Generator().manual_seed(5))
    c = wesup.WESUP(fc_width=8, generator=torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fc_layers.0.weight"], sc["fc_layers.0.weight"])


def test_vgg_taps_match_jax(weights):
    params, model = weights
    img = np.random.default_rng(1).random((2, 48, 64, 3)).astype(np.float32)
    want = j_vgg.backbone_features(params["backbone"], jnp.asarray(img))
    with torch.inference_mode():
        got = vgg.backbone_features(model.backbone, torch.from_numpy(img))
    assert len(got) == 13
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)


# bf16: the two frameworks round the convs, the window weights and the
# pooled sums at the same points but sum in other orders.  Measured on this
# input: sp_pred 2.9e-05, pred 0, sp_features 4.4e-04 (max abs).
TOLS = {"float32": {"sp_pred": 2e-4, "pred": 2e-4, "sp_features": 2e-3},
        "bfloat16": {"sp_pred": 3e-2, "pred": 3e-2, "sp_features": 3e-2}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_superpixel_matches_jax(weights, batch, dtype):
    params, model = weights
    img, valid, seg = batch
    H, W = img.shape[1:3]
    jplan = j_make_plan(H, W, 200)
    fwd = jax.jit(lambda p, i, s, v: j_wesup.forward_superpixel(
        p, i, s, jplan.n_clusters, v, getattr(jnp, dtype), pooling="local",
        plan=jplan))
    want = fwd(params, jnp.asarray(img), jnp.asarray(seg), jnp.asarray(valid))
    with torch.inference_mode():
        got = wesup.forward_superpixel(
            model, torch.from_numpy(img), torch.from_numpy(seg),
            jplan.n_clusters, torch.from_numpy(valid),
            getattr(torch, dtype), pooling="local", plan=make_plan(H, W, 200))
    for name, tol in TOLS[dtype].items():
        g, w = getattr(got, name), np.asarray(getattr(want, name), np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)


def test_forward_rejects_other_pooling(weights, batch):
    """The forward takes "adjoint", "local" and "fullres" and refuses any
    other pooling; the train step builds for every pooling (K5 and K6 have
    their backward kernels)."""
    _, model = weights
    img, valid, seg = batch
    plan = make_plan(*img.shape[1:3], 200)
    with pytest.raises(ValueError, match="pooling"):
        wesup.forward_superpixel(model, torch.from_numpy(img),
                                 torch.from_numpy(seg), plan.n_clusters,
                                 pooling="dense", plan=plan)
    for pooling in ("adjoint", "fullres"):
        cfg = WESUPConfig(pooling=pooling)
        step = steps.make_train_step(cfg, img.shape[1:3], point_mode=True,
                                     device="cpu")
        assert callable(step)
