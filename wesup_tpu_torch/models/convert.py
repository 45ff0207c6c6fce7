"""Weights into the port: from the JAX parameter tree or checkpoint, or
from a .pth file.

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


def _jax_param_map():
    """(path in the JAX tree, state-dict name, layout change) of every
    WESUP parameter: HWIO conv kernels become OIHW, (in, out) dense
    weights (out, in), and the side convs (Co, Ci, 1, 1)."""
    def conv(a):
        return np.asarray(a).transpose(3, 2, 0, 1)

    def side(a):
        return np.asarray(a).T[:, :, None, None]

    def dense(a):
        return np.asarray(a).T

    for i, ti in enumerate(vgg.TORCH_CONV_INDICES):
        yield ("backbone", f"conv{i}", "w"), f"backbone.{ti}.weight", conv
        yield ("backbone", f"conv{i}", "b"), f"backbone.{ti}.bias", np.asarray
    for i, name in enumerate(_side_conv_names()):
        yield ("side", f"side{i}", "w"), f"{name}.weight", side
        yield ("side", f"side{i}", "b"), f"{name}.bias", np.asarray
    for prefix, key in (("fc_layers.0", "fc1"), ("fc_layers.2", "fc2"),
                        ("fc_layers.4", "fc3"), ("classifier.0", "cls")):
        yield (key, "w"), f"{prefix}.weight", dense
        yield (key, "b"), f"{prefix}.bias", np.asarray


def _leaf(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def from_jax_params(params, partial: bool = False) -> dict:
    """``wesup_tpu.models.wesup.init_params``-style tree -> WESUP state dict.

    With ``partial``, parameters missing from the tree (an optimizer
    state that leaves the frozen backbone out) are left out of the result
    instead of raising ``KeyError``."""
    sd = {}
    for path, name, layout in _jax_param_map():
        leaf = _leaf(params, path)
        if leaf is None or np.ndim(leaf) == 0:
            if partial:
                continue
            raise KeyError(f"JAX parameter {'/'.join(path)} is missing")
        sd[name] = torch.from_numpy(
            np.array(layout(leaf), np.float32, order="C", copy=True))
    return sd


def _msgpack_ext(code, data):
    """flax.serialization's ndarray (1) and numpy scalar (3) records:
    msgpack of (shape, dtype name, C-order bytes)."""
    import msgpack

    if code not in (1, 3):
        return msgpack.ExtType(code, data)
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)
    return arr if code == 1 else arr[()]


def _momentum_trace(tree):
    """The ``trace`` subtree of an optax state: ``optax.trace`` inside the
    chain (``{"1": {"trace": ...}}``), or inside ``multi_transform``'s
    trained partition under ``freeze_backbone``."""
    if not isinstance(tree, dict):
        return None
    if "trace" in tree:
        return tree["trace"]
    for sub in tree.values():
        found = _momentum_trace(sub)
        if found is not None:
            return found
    return None


def load_jax_checkpoint(path):
    """(epoch, state dict, momentum by state-dict name) of a checkpoint of
    the JAX trainer: ``flax.serialization.msgpack_serialize`` of
    ``{"params", "opt_state", "epoch"}`` (``wesup_tpu/models/base.py``),
    decoded with msgpack alone.  The momentum is optax's trace, which
    updates as ``torch.optim.SGD``'s ``momentum_buffer`` does; it is empty
    when the checkpoint holds no optimizer state."""
    import msgpack

    payload = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_msgpack_ext,
                              raw=False)
    trace = _momentum_trace(payload.get("opt_state"))
    momentum = ({} if trace is None
                else from_jax_params(trace, partial=True))
    return (int(payload["epoch"]), from_jax_params(payload["params"]),
            momentum)


def load_state_dict_file(path) -> dict:
    """State dict of a reference checkpoint (``{"model_state_dict": ...}``,
    models/base.py's format) or of a bare state-dict ``.pth``."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if "model_state_dict" in payload:
        payload = payload["model_state_dict"]
    return dict(payload)
