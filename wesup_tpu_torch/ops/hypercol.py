"""The pixel head's hypercolumn upsample, kernel ``hypercol_upsample``.

From the five projected stage maps of the pixel head, stage 0 at full
resolution (B, H, W, C) and stages 1-4 at their native (B, H_s, W_s, C),
and the fused fc1 bias (C,), :func:`upsample` returns fc1's output after
its ReLU,

    relu(fused_upsample_sum([resize_w_only(m, W) for m in maps], H)
         + bias.to(dtype))

in the maps' dtype, as one contiguous (B, H, W, C) map.  The port's own
kernel (``csrc/hypercol.cu``); it replaces no ``pallas_call`` (the JAX
package contracts dense interpolation matrices, ``wesup_tpu/ops/resize.py``).
It reads each stage map once and writes the map once, where the
composition concatenated the W-resized maps into one (B, sum H_s, W, C)
buffer and multiplied it by the dense (H, sum H_s) matrix.  It rounds
where the composition rounds; only the order of z's f32 sum differs.

For a CUDA tensor :func:`upsample` launches the kernel (or raises); only
for a CPU tensor does it take :func:`upsample_plain`, the composition
itself.  The kernel is not differentiable: :func:`upsample` raises on an
input that requires grad.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import DTYPE_CODE, check, device_const, launch
from .resize import _interp_matrix, fused_upsample_sum, resize_w_only

# output rows each block of the kernel walks (csrc/hypercol.cu, at most
# 128): longer bands recompute fewer W-resized rows at their tops (at the
# tile cell's chunk, bands of 32, 64 and 128 rows took 3.08, 3.01 and 2.99
# ms on an H100)
ROWS = 128


def upsample_plain(maps, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`upsample`: the composition it replaces."""
    H, W = maps[0].shape[1:3]
    z = fused_upsample_sum([resize_w_only(m, W) for m in maps], H)
    return F.relu(z + bias.to(z.dtype))


def interp_taps(in_size: int, out_size: int):
    """Each row's two entries of ``_interp_matrix(in_size, out_size,
    True)``: ((out_size, 2) int32 columns, (out_size, 2) float32 weights),
    the rest of the row being 0 (one column twice, with weight 0 the
    second time, where ``in_size`` is 1)."""
    A = _interp_matrix(in_size, out_size, True)
    rows = np.arange(out_size)
    lo = np.minimum((A != 0).argmax(axis=1), max(in_size - 2, 0))
    hi = np.minimum(lo + 1, in_size - 1)
    w = np.stack([A[rows, lo], np.where(hi > lo, A[rows, hi], 0)], -1)
    return np.stack([lo, hi], -1).astype(np.int32), w.astype(np.float32)


def _tables(maps, dtype, device):
    """The kernel's tap tables for stages 1-4, built once per shape on the
    device: column taps (4, W, 2) and row taps (4, H, 2), int32, with
    their weights rounded to ``dtype`` as the composition rounds its
    matrices, held in float32."""
    H, W = maps[0].shape[1:3]
    sizes = tuple(tuple(m.shape[1:3]) for m in maps[1:])

    def build():
        out = []
        for axis, full in ((1, W), (0, H)):
            taps = [interp_taps(hw[axis], full) for hw in sizes]
            idx = torch.from_numpy(np.stack([t[0] for t in taps]))
            w = torch.from_numpy(np.stack([t[1] for t in taps]))
            out += [idx.to(device), w.to(dtype).float().to(device)]
        return tuple(out)

    return device_const(("hypercol", H, W, sizes, str(dtype), str(device)),
                        build)


def upsample(maps, bias: torch.Tensor) -> torch.Tensor:
    """relu(z + bias) of the five stage maps (see the module docstring),
    a contiguous (B, H, W, C) map in the maps' dtype."""
    if len(maps) != 5:
        raise ValueError(f"hypercol_upsample: {len(maps)} stage maps, "
                         f"expected 5")
    B, H, W, C = maps[0].shape
    dt, dev = maps[0].dtype, maps[0].device
    if any(t.requires_grad for t in (*maps, bias)):
        raise RuntimeError("hypercol_upsample is not differentiable: its "
                           "inputs must not require grad")
    check("maps[0]", maps[0], (B, H, W, C), DTYPE_CODE, dev)
    for s, m in enumerate(maps[1:], 1):
        check(f"maps[{s}]", m, (B, *m.shape[1:3], C), (dt,), dev)
    check("bias", bias, (C,), (torch.float32, dt), dev)
    if dev.type == "cpu":
        return upsample_plain(maps, bias)
    if dev.type != "cuda":
        raise ValueError(f"hypercol_upsample: unsupported device {dev}")
    bias_t = bias.to(dt)
    xidx, xw, yidx, yw = _tables(maps, dt, dev)
    out = torch.empty_like(maps[0])
    launch("hypercol_upsample", dev, *(m.data_ptr() for m in maps),
           bias_t.data_ptr(), xidx.data_ptr(), xw.data_ptr(), yidx.data_ptr(),
           yw.data_ptr(), out.data_ptr(), B, H, W, C,
           *(m.shape[1] for m in maps[1:]), *(m.shape[2] for m in maps[1:]),
           DTYPE_CODE[dt], ROWS)
    return out
