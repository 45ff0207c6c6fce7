"""Cell-grid superpixel ops: offsets, counts, painting and stage windows.

Port of ``wesup_tpu.ops.cellgrid``.  SLIC (``ops/slic.py``) gives every
pixel a cluster ``cluster = pixel_cell + local_offset`` with the offset in
a 3x3 neighbourhood, so per-superpixel work can be bounded by the cell
grid.  The numpy constants (``_axis_local``, ``make_stage_pool_plan``) are
copies of the JAX package's, so both packages build the same windows.

Unlike the TPU versions, counts are a scatter-add and painting is a gather
(``sp_values[seg]``): both are fast on the GPU.  Counts are sums of 0/1
values in f32, so they are exact integers in any order of summation, and
painting copies values, so it is bitwise equal to the reference.  The
general small-C segment sum (``cell_pool``, the label vote's) keeps the
reference's cell binning.

The downsampled stages' adjoint pooling weights follow the reference
derivation (see the notes in ``wesup_tpu/ops/cellgrid.py``): the compact
(B, Hs, Ih, Ws, Jw) window weights come from the 9-channel offset masks
through banded constants, and entry (p, i, q, j) is the mass stage pixel
(p, q) sends to cluster ``(anchor_y[p] + i + rmin_y, anchor_x[q] + j +
rmin_x)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .resize import _interp_matrix
from .slic import _OFFSETS, SlicPlan, _bin_cells, _cached_grid

_const_cache: dict = {}


def _device_const(key, build):
    """Per-device copy of a numpy constant, built once.

    Built outside inference mode even when the first caller runs under
    ``torch.inference_mode`` (the predict steps): a cached inference tensor
    would raise later when a train step's autograd saves it."""
    got = _const_cache.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = build()
        _const_cache[key] = got
    return got


def local_offsets(plan: SlicPlan, seg: torch.Tensor) -> torch.Tensor:
    """(..., H, W) local-offset index ``(dy+1)*3 + (dx+1)`` in [0, 9) of each
    pixel's cluster relative to the pixel's own cell."""
    dev = seg.device
    cy = _device_const(("cy", plan.H, plan.Kh, str(dev)), lambda: torch.as_tensor(
        plan.cell_y.astype(np.int64), device=dev))
    cx = _device_const(("cx", plan.W, plan.Kw, str(dev)), lambda: torch.as_tensor(
        plan.cell_x.astype(np.int64), device=dev))
    seg = seg.long()
    sy = torch.div(seg, plan.Kw, rounding_mode="floor")
    sx = seg - sy * plan.Kw
    oy = sy - cy[:, None]
    ox = sx - cx[None, :]
    return (oy + 1) * 3 + (ox + 1)


def offset_masks(plan: SlicPlan, seg: torch.Tensor, valid, dtype):
    """(..., H, W, 9) one-hot of the local offset, validity-masked."""
    o = local_offsets(plan, seg)
    masks = (o[..., None] == torch.arange(9, device=seg.device)).to(dtype)
    if valid is not None:
        masks = masks * valid[..., None].to(dtype)
    return masks


def cell_pool(plan: SlicPlan, seg: torch.Tensor, x: torch.Tensor,
              valid=None, masks: torch.Tensor | None = None) -> torch.Tensor:
    """Exact (B, K, C) segment sums of (B, H, W, C) features, no one-hot.

    Port of ``wesup_tpu.ops.cellgrid.cell_pool``: each pixel's value goes to
    its cell under its local offset (9 * C channels), the cells are binned
    by the two 0/1 matmuls in f32, and cluster (i, j) collects cell
    (i - dy, j - dx) for offset (dy, dx).  Integer-valued inputs (point
    one-hots, counts) sum exactly in any order.  ``masks`` optionally
    supplies the (validity-masked) :func:`offset_masks`."""
    B, H, W, C = x.shape
    Kh, Kw = plan.Kh, plan.Kw
    if masks is None:
        masks = offset_masks(plan, seg, valid, x.dtype)
    contrib = (masks.to(x.dtype)[..., :, None] * x[..., None, :]).reshape(
        B, H, W, 9 * C)
    cells = _bin_cells(_cached_grid(plan, 1, x.device),
                       contrib.to(torch.float32)).reshape(B, Kh, Kw, 9, C)
    cells = F.pad(cells, (0, 0, 0, 0, 1, 1, 1, 1))
    total = None
    for o, (dy, dx) in enumerate(_OFFSETS):
        term = cells[:, 1 - dy:1 - dy + Kh, 1 - dx:1 - dx + Kw, o]
        total = term if total is None else total + term
    return total.reshape(B, Kh * Kw, C)


def cell_counts(plan: SlicPlan, seg: torch.Tensor, valid=None) -> torch.Tensor:
    """Exact (B, K) f32 valid-pixel counts per superpixel of (B, H, W) seg."""
    B = seg.shape[0]
    w = (torch.ones(seg.shape, dtype=torch.float32, device=seg.device)
         if valid is None else valid.to(torch.float32))
    out = torch.zeros((B, plan.n_clusters), dtype=torch.float32,
                      device=seg.device)
    return out.scatter_add_(1, seg.reshape(B, -1).long(), w.reshape(B, -1))


def cell_paint(plan: SlicPlan, seg: torch.Tensor,
               sp_values: torch.Tensor) -> torch.Tensor:
    """Per-superpixel values (B, K) or (B, K, C) painted back to pixels:
    ``sp_values[b, seg[b, h, w]]``, bit for bit."""
    B, H, W = seg.shape
    idx = seg.reshape(B, H * W).long()
    if sp_values.ndim == 2:
        return torch.gather(sp_values, 1, idx).reshape(B, H, W)
    C = sp_values.shape[-1]
    out = torch.gather(sp_values, 1, idx[..., None].expand(B, H * W, C))
    return out.reshape(B, H, W, C)


class StagePoolPlan(NamedTuple):
    """Static constants mapping 9-channel offset masks to one stage's M."""

    Hs: int
    Ws: int
    Ih: int          # cluster-row window width per stage row
    Jw: int          # cluster-col window width per stage col
    A_hloc: tuple    # 3 x (H, Hs*Ih) f32, one per row-offset t
    A_wloc: tuple    # 3 x (W, Ws*Jw) f32, one per col-offset u
    E_y: np.ndarray  # (Hs, Ih, Kh) 0/1 window -> cluster-row expansion
    E_x: np.ndarray  # (Ws, Jw, Kw) 0/1 window -> cluster-col expansion
    anchor_y: np.ndarray  # (Hs,) cluster-row anchor per stage row
    anchor_x: np.ndarray  # (Ws,) cluster-col anchor per stage col
    rmin_y: int      # window offset: cluster row = anchor_y + i + rmin_y
    rmin_x: int      # window offset: cluster col = anchor_x + j + rmin_x
    Kh: int
    Kw: int


def _axis_local(A: np.ndarray, cell: np.ndarray, K: int):
    """Per-offset local matrices for one axis.

    A: (N_full, N_stage) interpolation matrix (<=2 nonzeros per row).
    cell: (N_full,) int cell index per full-res position.
    """
    n_full, n_stage = A.shape
    anchor = cell[np.argmax(A, axis=0)]                   # (N_stage,)
    rows, cols = np.nonzero(A)
    rel = np.concatenate([cell[rows] + t - 1 - anchor[cols]
                          for t in range(3)])
    rmin, rmax = int(rel.min()), int(rel.max())
    I = rmax - rmin + 1
    A_loc = np.zeros((3, n_full, n_stage * I), np.float32)
    for t in range(3):
        i = cell[rows] + t - 1 - anchor[cols] - rmin
        A_loc[t, rows, cols * I + i] = A[rows, cols]
    E = np.zeros((n_stage, I, K), np.float32)
    for p in range(n_stage):
        for i in range(I):
            k = anchor[p] + i + rmin
            if 0 <= k < K:
                E[p, i, k] = 1.0
    return tuple(A_loc), E, I, anchor.astype(np.int32), rmin


_STAGE_PLAN_CACHE: dict = {}


def make_stage_pool_plan(plan: SlicPlan, Hs: int, Ws: int,
                         align_corners: bool = True) -> StagePoolPlan:
    """Stage-pool constants for ``plan`` at stage resolution (Hs, Ws)."""
    key = (plan.H, plan.W, plan.Kh, plan.Kw, Hs, Ws, align_corners)
    spp = _STAGE_PLAN_CACHE.get(key)
    if spp is None:
        A_hloc, E_y, Ih, ay, rmy = _axis_local(
            _interp_matrix(Hs, plan.H, align_corners), plan.cell_y, plan.Kh)
        A_wloc, E_x, Jw, ax, rmx = _axis_local(
            _interp_matrix(Ws, plan.W, align_corners), plan.cell_x, plan.Kw)
        spp = StagePoolPlan(Hs, Ws, Ih, Jw, A_hloc, A_wloc, E_y, E_x,
                            ay, ax, rmy, rmx, plan.Kh, plan.Kw)
        _STAGE_PLAN_CACHE[key] = spp
    return spp


def _spp_const(spp: StagePoolPlan, key, build):
    """A device constant derived from ``spp``, cached per plan object (the
    entry holds the plan, so its id stays unique while cached)."""
    return _device_const((id(spp),) + key, lambda: (spp, build()))[1]


def _spp_consts(spp: StagePoolPlan, name: str, dtype, device):
    """A stage plan's constant ``name`` as a tensor on ``device``."""
    def build():
        arr = getattr(spp, name)
        if isinstance(arr, tuple):
            return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                         for a in arr)
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return _spp_const(spp, (name, dtype, str(device)), build)


def stage_window_weights(spp: StagePoolPlan, e9: torch.Tensor) -> torch.Tensor:
    """(B, Hs, Ih, Ws, Jw) compact window weights from (B, H, W, 9) offset
    masks, in ``e9``'s dtype (the reference's order of products and sums)."""
    B = e9.shape[0]
    dt, dev = e9.dtype, e9.device
    A_wloc = _spp_consts(spp, "A_wloc", dt, dev)
    A_hloc = _spp_consts(spp, "A_hloc", dt, dev)
    Mc = None
    for t in range(3):
        Gt = None
        for u in range(3):
            g = torch.matmul(e9[..., t * 3 + u], A_wloc[u])   # (B, H, Ws*Jw)
            Gt = g if Gt is None else Gt + g
        m = torch.einsum("hy,bhz->byz", A_hloc[t], Gt)        # (B, Hs*Ih, ..)
        Mc = m if Mc is None else Mc + m
    return Mc.reshape(B, spp.Hs, spp.Ih, spp.Ws, spp.Jw).contiguous()


def expand_window_weights(spp: StagePoolPlan, Mc: torch.Tensor) -> torch.Tensor:
    """(B, Hs, Kh, Ws, Kw) dense adjoint weights from the compact windows
    through the 0/1 expansions E_y and E_x."""
    Ey = _spp_consts(spp, "E_y", Mc.dtype, Mc.device)          # (Hs, Ih, Kh)
    Ex = _spp_consts(spp, "E_x", Mc.dtype, Mc.device)          # (Ws, Jw, Kw)
    tmp = torch.einsum("bpiqj,piy->bpyqj", Mc, Ey)
    return torch.einsum("bpyqj,qjx->bpyqx", tmp, Ex)


def stage_adjoint_weights(spp: StagePoolPlan, e9: torch.Tensor) -> torch.Tensor:
    """(B, Hs, Kh, Ws, Kw) adjoint pooling weights from (B, H, W, 9) masks.

    Equals ``einsum("hp,wq,bhwk->bpqk", A_h, A_w, one_hot(seg, K))`` with k
    split as (ky, kx), up to fp reassociation."""
    return expand_window_weights(spp, stage_window_weights(spp, e9))
