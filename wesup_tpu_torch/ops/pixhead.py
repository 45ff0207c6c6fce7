"""The pixel head after fc2, kernel ``pixel_head``.

From fc2's output before its bias, ``z`` (..., C) in the compute dtype,
and fc2's bias, fc3's weight and bias and the classifier's weight and
bias in the same dtype, :func:`head` returns the (..., n) float32
probabilities

    softmax(relu(relu(z + b2) @ w3.T + b3) @ wc.T + bc)

with the composition's rounding points: each product and each bias add
rounds to the dtype, and the softmax runs in float32.  The port's own
kernel (``csrc/pixhead.cu``); it replaces no ``pallas_call`` (the JAX
package leaves ``_mlp_head``'s tail to XLA).  It reads ``z`` once, where
the composition read fc2's output three times and wrote it twice more.
Only the order of the two f32 sums (fc3's over C, the classifier's over
D) differs from the composition's.

For a CUDA tensor :func:`head` launches the kernel (or raises); only for
a CPU tensor does it take :func:`head_plain`, the composition itself.
The kernel is not differentiable: :func:`head` raises on an input that
requires grad, unless grad is off (``torch.no_grad``, inference mode), as
it is for the parameters in the pixel forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import DTYPE_CODE, check, launch

MAX_D = 32          # fc3's width, at most
MAX_CLASSES = 4
# fc3's bf16 weight sits in shared memory: 4224 bytes per 64 columns
MAX_BF16_WIDTH = 3072


def head_plain(z, b2, w3, b3, wc, bc) -> torch.Tensor:
    """Plain version of :func:`head`: the composition it replaces."""
    h = F.relu(z + b2)
    feats = F.relu(h @ w3.t() + b3)
    logits = feats @ wc.t() + bc
    return torch.softmax(logits.float(), dim=-1)


def head(z, b2, w3, b3, wc, bc) -> torch.Tensor:
    """The pixel head after fc2 (see the module docstring): (..., n)
    float32 probabilities of ``z`` (..., C)."""
    params = (b2, w3, b3, wc, bc)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (z, *params)):
        raise RuntimeError("pixel_head is not differentiable: its inputs "
                           "must not require grad where grad is enabled")
    if z.dim() < 1 or z.shape[-1] < 1:
        raise ValueError("pixel_head: z needs a feature axis")
    C, dt, dev = z.shape[-1], z.dtype, z.device
    D, n = w3.shape[0], wc.shape[0]
    if not (1 <= D <= MAX_D and 1 <= n <= MAX_CLASSES):
        raise ValueError(f"pixel_head: fc3 of width {D} (1..{MAX_D}) and "
                         f"{n} classes (1..{MAX_CLASSES})")
    check("z", z, z.shape, DTYPE_CODE, dev)
    for name, t, shape in (("b2", b2, (C,)), ("w3", w3, (D, C)),
                           ("b3", b3, (D,)), ("wc", wc, (n, D)),
                           ("bc", bc, (n,))):
        check(name, t, shape, (dt,), dev)
    if dev.type == "cpu":
        return head_plain(z, *params)
    if dev.type != "cuda":
        raise ValueError(f"pixel_head: unsupported device {dev}")
    if dt is torch.bfloat16:
        if C % 8 or C > MAX_BF16_WIDTH:
            raise ValueError(f"pixel_head: bf16 width {C} must be a multiple "
                             f"of 8 up to {MAX_BF16_WIDTH}")
        if any(t.data_ptr() % 16 for t in (z, b2, w3)):
            raise ValueError("pixel_head: z, b2 and w3 must start on a "
                             "16-byte boundary")
    out = torch.empty((*z.shape[:-1], n), dtype=torch.float32, device=dev)
    N = z.numel() // C
    if N:
        launch("pixel_head", dev, z.data_ptr(), b2.data_ptr(), w3.data_ptr(),
               b3.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(), N,
               C, D, n, DTYPE_CODE[dt])
    return out
