"""Inputs, a replay and limits for the pixel head's ``hypercol_upsample``.

:func:`replay` computes what ``csrc/hypercol.cu`` computes, with torch
ops in the kernel's order from its tap tables: in bfloat16 every product
is exact in f32 and each sum rounds once, as the kernel's FMAs do, so on
the card the kernel equals it bitwise; in float32 the kernel's FMAs round
the products inside the sums.

:func:`limit` is how far a result may lie from the plain composition
(``hypercol.upsample_plain``).  In float32, 1e-6 of the map's largest
|z| (z: the map before the bias).  In bfloat16, two bf16 ulps at the
larger of |value| and |z|, and two at the value's mass (the sum of the
|terms| of its z), because the composition is no correctly rounded
reference either:
- z rounds to bf16 from another f32 sum (9 terms in the kernel, a GEMM
  over 806 on the card), so the two z may lie an ulp apart, and rounding
  z + bias moves the value by up to one more ulp: on the card, z 3.109375
  and 3.125 with the bias -0.8828125 give 2.21875 and 2.25, both ties
  rounded to even;
- on the card the composition's tensor-core GEMMs do not round as an
  IEEE f32 sum: its W-resize of two terms differs from the exact sum by
  one bf16 ulp in about 1 of 10^7 values, which moves z by up to two
  ulps of the mass, and its z differs by up to 92 ulps where z cancels
  to near 0 (then far below an ulp of the mass).
The file imports neither jax nor ``wesup_tpu``.
"""

import torch

from wesup_tpu_torch.ops import hypercol
from wesup_tpu_torch.ops.resize import fused_upsample_sum, resize_w_only


def stage_maps(B, H, W, C, dtype, device="cpu", seed=0):
    """Five normal stage maps (stage s at (H >> s, W >> s), at least 1)
    and a normal (C,) f32 bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    maps = [torch.randn((B, max(H >> s, 1), max(W >> s, 1), C), generator=g,
                        device=device).to(dtype) for s in range(5)]
    bias = torch.randn((C,), generator=g, device=device)
    return maps, bias


def kernel_sums(maps):
    """(z before its rounding, its mass) in f32, in the kernel's order."""
    dt, dev = maps[0].dtype, maps[0].device
    xidx, xw, yidx, yw = (t.to(dev) for t in
                          hypercol._tables(maps, dt, torch.device("cpu")))
    acc = maps[0].float()
    mass = acc.abs()
    for s, m in enumerate(maps[1:]):
        m = m.float()
        wr = (m[:, :, xidx[s, :, 0].long()] * xw[s, :, 0, None]
              + m[:, :, xidx[s, :, 1].long()] * xw[s, :, 1, None])
        wr = wr.to(dt).float()
        for k in range(2):
            term = yw[s, :, k, None, None] * wr[:, yidx[s, :, k].long()]
            acc = acc + term
            mass = mass + term.abs()
    return acc, mass


def replay(maps, bias):
    """The kernel's arithmetic (see the module docstring)."""
    z = kernel_sums(maps)[0].to(maps[0].dtype)
    return torch.relu(z + bias.to(z.dtype))


def pre_bias(maps):
    """The composition's z: the W-resized maps H-upsampled and summed."""
    W = maps[0].shape[2]
    return fused_upsample_sum([resize_w_only(m, W) for m in maps],
                              maps[0].shape[1])


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(2.0 ** -126))) - 7)


def limit(want, z, mass):
    """Per-value limit of a result against the composition's ``want``,
    whose z is ``z``; ``mass`` from :func:`kernel_sums` (see the module
    docstring)."""
    if want.dtype is torch.bfloat16:
        return 2 * _ulp(torch.maximum(want.float().abs(), z.float().abs())) \
            + 2 * _ulp(mass)
    return torch.full_like(want, 1e-6 * z.abs().max().item())


def gap(got, maps, bias, want=None):
    """(number of values of ``got`` beyond :func:`limit` from the
    composition, widest gap over its limit); ``want`` is the
    composition's result, computed here if not given."""
    if want is None:
        want = hypercol.upsample_plain(maps, bias)
    over = (got.float() - want.float()).abs() / limit(
        want, pre_bias(maps), kernel_sums(maps)[1])
    return int((~(over <= 1)).sum().item()), over.max().item()
