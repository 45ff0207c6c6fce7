"""Weights into the port: from the JAX parameter tree, or from a .pth file.

The JAX package keeps its parameters as a pytree of arrays in its own
layouts (HWIO conv kernels, (in, out) dense weights); the port keeps the
reference's PyTorch state dict.  :func:`from_jax_params` maps one onto the
other, given the pytree as numpy arrays (``jax.tree.map(np.asarray, p)``),
so the port never imports jax.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import vgg
from .wesup import _side_conv_names


def from_jax_params(params) -> dict:
    """``wesup_tpu.models.wesup.init_params``-style tree -> WESUP state dict.

    HWIO conv kernels become OIHW, (in, out) dense weights become
    (out, in), and the side convs become (Co, Ci, 1, 1)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))

    sd = {}
    for i, ti in enumerate(vgg.TORCH_CONV_INDICES):
        p = params["backbone"][f"conv{i}"]
        sd[f"backbone.{ti}.weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[f"backbone.{ti}.bias"] = t(p["b"])
    for i, name in enumerate(_side_conv_names()):
        p = params["side"][f"side{i}"]
        sd[f"{name}.weight"] = t(np.asarray(p["w"]).T[:, :, None, None])
        sd[f"{name}.bias"] = t(p["b"])
    for prefix, key in (("fc_layers.0", "fc1"), ("fc_layers.2", "fc2"),
                        ("fc_layers.4", "fc3"), ("classifier.0", "cls")):
        sd[f"{prefix}.weight"] = t(np.asarray(params[key]["w"]).T)
        sd[f"{prefix}.bias"] = t(params[key]["b"])
    return sd


def load_state_dict_file(path) -> dict:
    """State dict of a reference checkpoint (``{"model_state_dict": ...}``,
    models/base.py's format) or of a bare state-dict ``.pth``."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if "model_state_dict" in payload:
        payload = payload["model_state_dict"]
    return dict(payload)
