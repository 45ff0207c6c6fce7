"""``pool_roofline.<train|predict>``: the superpixel pooling kernels'
share of the HBM bound in the traced stretch (%), for
``pooling="local"``: K1 (``cell_pool0_kernel``, stage 0), K2
(``cell_pool_stage_kernel``, stages 1-4) and, in training, their
backward K3 and K4 (``cell_pool0_bwd_kernel``,
``cell_pool_stage_bwd_kernel``).

Bytes each launch needs, each byte once (``chip_smoke.py``'s ``bound``
arithmetic without the derived window weights, which are the program's
own layout): K1 reads the (B, H, W) int32 ids and the stage's bf16 taps
and writes (B, K, C) f32 sums; K2 reads a stage's taps and writes its
sums; K3 reads the ids and the sums' gradient and writes the taps'
gradient; K4 reads the sums' gradient and writes the taps' gradient.
B counts every row of the batch (blank rows included: the kernels
receive them), K is the canvas's superpixel grid (``sp_area``, the SLIC
plan's arithmetic, ``reference/slic.n_clusters``).  Time: those kernels' device time.
"""

from __future__ import annotations

from ..reference.slic import n_clusters
from .peaks import HBM_BYTES_PER_S

STAGES = ((0, 128), (1, 256), (2, 768), (3, 1536), (4, 1536))
NAMES = ("cell_pool0_kernel", "cell_pool_stage_kernel",
         "cell_pool0_bwd_kernel", "cell_pool_stage_bwd_kernel")


def record_bytes(r: dict) -> float:
    B, H, W = r["rows"], r["H"], r["W"]
    K = n_clusters(H, W, r["sp_area"])
    passes = 2 if r["kind"] == "train" else 1
    total = 0.0
    for s, c in STAGES:
        taps = B * (H >> s) * (W >> s) * c * 2
        sums = B * K * c * 4
        ids = B * H * W * 4 if s == 0 else 0
        total += passes * (taps + sums + ids)
    return total


def read(name, ctx):
    t = sum(s for k, s in ctx["trace"]["op_s"].items()
            if any(n in k for n in NAMES))
    nbytes = sum(record_bytes(r) for r in ctx["traced_work"]
                 if r["kind"] in ("train", "predict"))
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / (t * HBM_BYTES_PER_S)
