"""The JAX package's initial weights, drawn on the host without JAX.

``wesup_tpu.models.trainer`` draws its model from ``jax.random.PRNGKey
(seed)``; the port's trainer draws the same model, so that ``seed=s``
names one starting point in both packages.  The draws come from the
port's numpy copy of ``jax.random`` (``utils/prng.py``), bitwise JAX's on
the CPU; ``tests/test_torch_port_init.py`` fails if the installed JAX
changes its flag or its bits.

:func:`init_params` mirrors ``wesup_tpu.models.wesup.init_params`` key for
key and returns the port's state dict.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.prng import PRNGKey, normal, split, uniform
from . import vgg
from .convert import from_jax_params

_F = np.float32


def _linear(key, fan_in, fan_out):
    k1, k2 = split(key)
    bound = 1.0 / np.sqrt(fan_in)
    return {"w": uniform(k1, (fan_in, fan_out), -bound, bound),
            "b": uniform(k2, (fan_out,), -bound, bound)}


def _conv(key, in_ch, out_ch):
    w = normal(key, (3, 3, in_ch, out_ch)) * _F(np.sqrt(2.0 / (9 * in_ch)))
    return {"w": w, "b": np.zeros(out_ch, _F)}


def init_params(seed: int, n_classes: int = 2, D: int = 32,
                fc_width: int = 1024) -> dict:
    """The port's state dict of ``wesup_tpu.models.wesup.init_params(
    jax.random.PRNGKey(seed), n_classes, D, fc_width)``.

    The layers are drawn in parallel threads (numpy lets go of the GIL in
    its loops); each layer's key is fixed before, so the result does not
    depend on the order."""
    keys = split(PRNGKey(seed), 18)
    jobs, key, in_ch = {}, keys[0], 3
    for i, out_ch in enumerate(vgg.CONV_CHANNELS):
        key, k1 = split(key)               # the backbone's chained split
        jobs["backbone", f"conv{i}"] = (_conv, k1, in_ch, out_ch)
        in_ch = out_ch
    for i, c in enumerate(vgg.CONV_CHANNELS):
        jobs["side", f"side{i}"] = (_linear, keys[1 + i], c, c // 2)
    for name, k, fan_in, fan_out in (
            ("fc1", 14, vgg.FM_CHANNELS_SUM, fc_width),
            ("fc2", 15, fc_width, fc_width), ("fc3", 16, fc_width, D),
            ("cls", 17, D, n_classes)):
        jobs[name,] = (_linear, keys[k], fan_in, fan_out)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        futures = {path: pool.submit(*job) for path, job in jobs.items()}
    params = {}
    for path, fut in futures.items():
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = fut.result()
    return from_jax_params(params)
