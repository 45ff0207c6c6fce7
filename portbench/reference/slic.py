"""Frozen copy of ``wesup_tpu_torch/ops/slic.py``, the plain math the
reference shares with the program's preprocessing; it stays as it is
when the program changes.  The original's text follows.

SLIC superpixels on the device, batched over images.

Port of ``wesup_tpu.ops.slic``.  The algorithm is the same: one cluster per
grid cell, a fixed number of iterations, every pixel choosing among the 9
clusters of the 3x3 cells around its own, distance
``D^2 = d_lab^2 + (m/S)^2 * d_xy^2`` with per-axis steps, centres
initialised to the cell means, and the k-means iterations optionally run on
a strided pixel grid while the final assignment is always full resolution.

Two things are kept exactly because every cell-grid op downstream relies on
them: ``seg = (cell_y + dy) * Kw + (cell_x + dx)`` with ``(dy, dx)`` the
chosen offset, and ties going to the first offset in 0..8 (``argmin``
returns the first minimum, which is the strict ``d < best_d`` rule of the
reference loop).  Out-of-grid offsets carry a ``+inf`` bias.

The JAX version broadcasts centres to pixels through constant 0/1 matrices
because gathers are slow on a TPU; here the candidate centres are read by
direct indexing.  The cell binning of the centre update stays a pair of
banded matmuls: it is cheap, deterministic on the GPU (no float atomics)
and sums in the reference's order (rows within a cell, then columns, then
the 9 offsets).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .colorspace import rgb2lab

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class SlicPlan(NamedTuple):
    """Static plan for a given (H, W, sp_area): the cell grid.

    The JAX plan's fields of the same names, without its 0/1 selection and
    binning matrices (the device grids below derive those they need)."""

    H: int
    W: int
    Kh: int
    Kw: int
    step_y: float
    step_x: float
    # (H,) / (W,) int32 cell index per pixel row/col
    cell_y: np.ndarray
    cell_x: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.Kh * self.Kw


@functools.lru_cache(maxsize=None)
def make_plan(H: int, W: int, sp_area: int) -> SlicPlan:
    step = math.sqrt(sp_area)
    Kh = max(1, int(round(H / step)))
    Kw = max(1, int(round(W / step)))
    step_y = H / Kh
    step_x = W / Kw

    cell_y = np.minimum((np.arange(H) / step_y).astype(np.int32), Kh - 1)
    cell_x = np.minimum((np.arange(W) / step_x).astype(np.int32), Kw - 1)
    return SlicPlan(H, W, Kh, Kw, step_y, step_x, cell_y, cell_x)


def n_clusters(H: int, W: int, sp_area: int) -> int:
    """Static number of clusters produced by :func:`slic` for this shape."""
    return make_plan(int(H), int(W), int(sp_area)).n_clusters


class _Grid(NamedTuple):
    """Device constants of one pixel grid (full or strided)."""

    bin_r: torch.Tensor   # (Kh, h) f32 0/1 binning
    bin_c: torch.Tensor   # (Kw, w) f32 0/1 binning
    bias: torch.Tensor    # (h, w, 9) f32: 0, or +inf for out-of-grid offsets
    cand: torch.Tensor    # (h, w, 9) int64 candidate cluster per offset


def _grid(plan: SlicPlan, iy: np.ndarray, ix: np.ndarray, device) -> _Grid:
    cy, cx = plan.cell_y[iy], plan.cell_x[ix]
    bin_r = np.zeros((plan.Kh, len(iy)), np.float32)
    bin_r[cy, np.arange(len(iy))] = 1.0
    bin_c = np.zeros((plan.Kw, len(ix)), np.float32)
    bin_c[cx, np.arange(len(ix))] = 1.0
    bias = []
    for dy, dx in _OFFSETS:
        rv = (cy + dy >= 0) & (cy + dy < plan.Kh)
        cv = (cx + dx >= 0) & (cx + dx < plan.Kw)
        bias.append(np.where(np.outer(rv, cv), 0.0, np.inf))
    # candidate ids, clamped into the grid: a clamped candidate carries the
    # +inf bias, so it is never chosen, and a chosen one is
    # (cy + dy) * Kw + (cx + dx) exactly
    cand = np.stack([
        np.add.outer(np.clip(cy + dy, 0, plan.Kh - 1) * plan.Kw,
                     np.clip(cx + dx, 0, plan.Kw - 1))
        for dy, dx in _OFFSETS], -1)
    t = functools.partial(torch.as_tensor, device=device)
    return _Grid(t(bin_r), t(bin_c), t(np.stack(bias, -1).astype(np.float32)),
                 t(cand.astype(np.int64)))


_GRID_CACHE: dict = {}


def _cached_grid(plan: SlicPlan, stride: int, device) -> _Grid:
    key = (plan.H, plan.W, plan.Kh, plan.Kw, stride, str(device))
    got = _GRID_CACHE.get(key)
    if got is None:
        # normal tensors even under inference mode, so that a later train
        # step may use them under autograd
        with torch.inference_mode(False):
            got = _grid(plan, np.arange(0, plan.H, stride),
                        np.arange(0, plan.W, stride), device)
        _GRID_CACHE[key] = got
    return got


def _bin_cells(grid: _Grid, pix: torch.Tensor) -> torch.Tensor:
    """Sum (B, h, w, F) pixel values into their (B, Kh, Kw, F) cells."""
    x = torch.einsum("kh,bhwf->bkwf", grid.bin_r, pix)
    return torch.einsum("lw,bkwf->bklf", grid.bin_c, x)


def _assign(grid: _Grid, scaled_feat: torch.Tensor, centers: torch.Tensor,
            inv_step: torch.Tensor):
    """Per-pixel argmin over the 9 neighbouring cell centres, all offsets
    at once.

    Returns (best offset (B, h, w) int64, seg (B, h, w) int32)."""
    B = centers.shape[0]
    cand = centers.reshape(B, -1, 5)[:, grid.cand]            # (B, h, w, 9, 5)
    diff = scaled_feat[..., None, :] - cand * inv_step
    sq = diff * diff
    d = sq[..., 0] + sq[..., 1] + sq[..., 2] + sq[..., 3] + sq[..., 4]
    best_o = torch.argmin(d + grid.bias, dim=-1)             # first minimum
    seg = torch.gather(grid.cand.expand(B, -1, -1, -1), -1, best_o[..., None])
    return best_o, seg[..., 0].to(torch.int32)


def slic(rgb: torch.Tensor, valid: torch.Tensor | None = None, *,
         sp_area: int = 200, compactness: float = 40.0,
         n_iters: int = 10, update_stride: int = 1) -> torch.Tensor:
    """SLIC assignments for a batch of images, on ``rgb``'s device.

    Args:
        rgb: (B, H, W, 3) float image in [0, 1].
        valid: optional (B, H, W) bool mask; invalid (padding) pixels are
            excluded from centre updates but still receive an assignment.
        sp_area, compactness, n_iters, update_stride: as in
            ``wesup_tpu.ops.slic.slic``.

    Returns:
        seg: (B, H, W) int32 cluster ids in [0, Kh*Kw).
    """
    B, H, W = rgb.shape[:3]
    dev = rgb.device
    plan = make_plan(int(H), int(W), int(sp_area))
    Kh, Kw = plan.Kh, plan.Kw

    lab = rgb2lab(rgb)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    # pixel features: (B, H, W, 5) = (L, a, b, y, x)
    feat = torch.cat([lab, ys.expand(B, H, W)[..., None],
                      xs.expand(B, H, W)[..., None]], dim=-1)
    if valid is None:
        weight = torch.ones((B, H, W, 1), dtype=torch.float32, device=dev)
    else:
        weight = valid.to(torch.float32)[..., None]

    inv_step = torch.tensor(
        [1.0, 1.0, 1.0, compactness / plan.step_y, compactness / plan.step_x],
        dtype=torch.float32, device=dev)

    full = _cached_grid(plan, 1, dev)
    # init centres as per-cell means of (weighted) pixel features; cells
    # fully inside padding fall back to the unweighted mean
    cell_sums = _bin_cells(full, torch.cat([feat * weight, weight], -1))
    cnt = cell_sums[..., 5:6]
    cell_sums_uw = _bin_cells(full, torch.cat([feat, torch.ones_like(weight)],
                                              -1))
    centers = torch.where(
        cnt > 0, cell_sums[..., :5] / cnt.clamp_min(1e-6),
        cell_sums_uw[..., :5] / cell_sums_uw[..., 5:6].clamp_min(1e-6))

    s = max(1, int(update_stride))
    it = _cached_grid(plan, s, dev)
    feat_it = feat[:, ::s, ::s]
    scaled_it = feat_it * inv_step
    # per-pixel (5 features + count) contribution, validity-weighted
    fw_it = torch.cat([feat_it, torch.ones_like(feat_it[..., :1])], -1) \
        * weight[:, ::s, ::s]
    h_it, w_it = feat_it.shape[1:3]
    offsets = torch.arange(9, device=dev)

    for _ in range(n_iters):
        best_o, _ = _assign(it, scaled_it, centers, inv_step)
        onehot = (best_o[..., None] == offsets).to(torch.float32)
        contrib = (onehot[..., :, None] * fw_it[..., None, :]).reshape(
            B, h_it, w_it, 54)
        cells = _bin_cells(it, contrib).reshape(B, Kh, Kw, 9, 6)
        # cluster (i, j) collects cell (i - dy, j - dx) sums for offset
        # (dy, dx); cells outside the grid are the zero padding
        cells = F.pad(cells, (0, 0, 0, 0, 1, 1, 1, 1))
        total = None
        for o, (dy, dx) in enumerate(_OFFSETS):
            term = cells[:, 1 - dy:1 - dy + Kh, 1 - dx:1 - dx + Kw, o]
            total = term if total is None else total + term
        cnt = total[..., 5:6]
        centers = torch.where(cnt > 0, total[..., :5] / cnt.clamp_min(1e-6),
                              centers)

    # final assignment always at FULL resolution
    _, seg = _assign(full, feat * inv_step, centers, inv_step)
    return seg
