"""Inputs, a replay and limits for the pixel head's ``pixel_head`` kernel.

:func:`replay` computes what ``csrc/pixhead.cu`` computes, with torch ops
in the kernel's orders: fc3's sum over the columns, in bfloat16 as the
tensor cores take it (16 products at a time, in the kernel's permuted
groups, each group's sum added to the f32 sum and rounded once) and in
float32 as one FMA a column in order; the classifier's sum as each of a
row's four threads takes its eight features, then (t0 + t1) + (t2 + t3);
every rounding point of the composition.  The products and group sums
are taken in float64.

:func:`bounds` encloses, value by value, every result that the
composition's arithmetic gives with its f32 sums taken in any order, the
kernel's and the card's GEMMs' among them:
- each fc3 feature's f32 sum over C terms lies within 2 C 2^-24 of the
  exact sum (taken in float64) times the sum of |terms|: (C - 1) 2^-24
  bounds any order of IEEE f32 additions, and the factor 2 leaves room
  for the tensor cores, whose additions inside an mma do not round as
  IEEE's (tests/torch_hypercol.py saw a GEMM's two-term sums off by an
  ulp);
- every later step is monotone (the roundings to the dtype, the bias
  adds in f32, the ReLUs), so the two ends of each interval go through
  the composition's own ops;
- each logit's f32 sum over D terms likewise, 2 D 2^-24 of its mass,
  over the interval of the exact sums the features' intervals allow;
- the softmax is increasing in its own logit and decreasing in the
  others, so its ends are exact (float64), less and plus 2^-20 for its
  f32 exp and division.
So a feature whose exact sum lies far from a rounding boundary has one
possible value, and the probabilities' intervals are as wide as the
boundaries that the sums come near make them.  The file imports neither
jax nor ``wesup_tpu``.
"""

import math

import torch
import torch.nn.functional as F

CHUNK = 64     # columns of the bf16 kernel's chunk


def head_inputs(N, C, D, n, dtype, device="cpu", seed=0):
    """z (N, C) and the parameters (b2, w3, b3, wc, bc) in ``dtype``,
    normal, scaled so that fc3's features and the logits are of order 1
    (the probabilities spread over (0, 1))."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    z = normal(N, C)
    params = (normal(C, scale=0.5), normal(D, C, scale=2 / math.sqrt(C)),
              normal(D, scale=0.5), normal(n, D, scale=3 / math.sqrt(D)),
              normal(n, scale=0.5))
    return z, params


def groups(C):
    """The bf16 kernel's fc3 sum as an ordered list of 16-column groups:
    chunk kc, k-step s takes columns kc*64 + (s // 2)*32 + t*8 + (s % 2)*4
    + u for threads t and u in 0..3 (those below C)."""
    out = []
    for kc in range(-(-C // CHUNK)):
        for s in range(4):
            cols = [kc * CHUNK + (s // 2) * 32 + t * 8 + (s % 2) * 4 + u
                    for t in range(4) for u in range(4)]
            cols = [c for c in cols if c < C]
            if cols:
                out.append(cols)
    return out


def _round(x, dtype):
    return x.to(dtype).float()


def replay(z, b2, w3, b3, wc, bc):
    """The kernel's arithmetic (see the module docstring), (..., n) f32."""
    dt, C = z.dtype, z.shape[-1]
    D, n = w3.shape[0], wc.shape[0]
    a = F.relu(z.reshape(-1, C) + b2).double()
    w = w3.double()
    f = torch.zeros((a.shape[0], D), dtype=torch.float32, device=z.device)
    if dt is torch.bfloat16:
        for cols in groups(C):
            f = (f.double() + a[:, cols] @ w[:, cols].t()).float()
    else:
        for k in range(C):
            f = (f.double() + a[:, k:k + 1] * w[:, k]).float()
    g = F.relu(_round(_round(f, dt) + b3.float(), dt))
    wcf = wc.double()
    parts = []
    for t in range(4):
        part = torch.zeros((a.shape[0], n), dtype=torch.float32,
                           device=z.device)
        for i in range(8):
            d = 8 * (i // 2) + 2 * t + i % 2
            if d < D:
                part = (part.double() + g[:, d:d + 1].double()
                        * wcf[:, d]).float()
        parts.append(part)
    l = (parts[0] + parts[1]) + (parts[2] + parts[3])
    l = _round(_round(l, dt) + bc.float(), dt)
    e = torch.exp(l - l.max(dim=-1, keepdim=True).values)
    total = e[:, 0]
    for c in range(1, n):
        total = total + e[:, c]
    return (e / total[:, None]).reshape(*z.shape[:-1], n)


def _down_up(x, eps, dtype):
    """The ends of [x - eps, x + eps] (float64) as the composition's f32
    sum, rounded to ``dtype``, can give them: rounding is monotone, and an
    f32 sum at least x - eps is at least x - eps rounded to f32."""
    return ((x - eps).float().to(dtype).float(),
            (x + eps).float().to(dtype).float())


def _tail(f, b3, dtype):
    """relu(T(f + b3)) of fc3's rounded features f, in f32."""
    return F.relu(_round(f + b3.float(), dtype))


def bounds(z, b2, w3, b3, wc, bc):
    """(lo, hi), each (..., n) float64: the interval of each probability
    (see the module docstring)."""
    dt, C, D = z.dtype, z.shape[-1], w3.shape[0]
    a = F.relu(z.reshape(-1, C) + b2).double()
    w = w3.double()
    f_lo, f_hi = _down_up(a @ w.t(),
                          2 * C * 2.0 ** -24 * (a.abs() @ w.abs().t()), dt)
    del a
    g_lo, g_hi = _tail(f_lo, b3, dt).double(), _tail(f_hi, b3, dt).double()
    v = wc.double()
    vp, vn = v.clamp_min(0).t(), v.clamp_max(0).t()
    eps = 2 * D * 2.0 ** -24 * (torch.maximum(g_lo.abs(), g_hi.abs())
                               @ v.abs().t())
    l_lo = _down_up(g_lo @ vp + g_hi @ vn, eps, dt)[0]
    l_hi = _down_up(g_hi @ vp + g_lo @ vn, eps, dt)[1]
    l_lo = _round(l_lo + bc.float(), dt).double()
    l_hi = _round(l_hi + bc.float(), dt).double()
    # p_c is least with its own logit low and the others high
    top = torch.maximum(l_lo, l_hi).max(dim=-1, keepdim=True).values
    e_lo, e_hi = torch.exp(l_lo - top), torch.exp(l_hi - top)
    lo = e_lo / (e_lo + e_hi.sum(dim=-1, keepdim=True) - e_hi)
    hi = e_hi / (e_hi + e_lo.sum(dim=-1, keepdim=True) - e_lo)
    shape = (*z.shape[:-1], wc.shape[0])
    return ((lo - 2.0 ** -20).reshape(shape),
            (hi + 2.0 ** -20).reshape(shape))


def gap(got, z, params, rows=1 << 18):
    """(number of probabilities of ``got`` outside :func:`bounds`, the
    widest distance outside, the widest interval), ``rows`` rows at a
    time."""
    C, n = z.shape[-1], got.shape[-1]
    z2, got2 = z.reshape(-1, C), got.reshape(-1, n).double()
    beyond, worst, width = 0, 0.0, 0.0
    for i in range(0, z2.shape[0], rows):
        lo, hi = bounds(z2[i:i + rows], *params)
        g = got2[i:i + rows]
        out = torch.maximum(lo - g, g - hi)
        beyond += int((~(out <= 0)).sum().item())
        worst = max(worst, out.max().item())
        width = max(width, (hi - lo).max().item())
    return beyond, worst, width
