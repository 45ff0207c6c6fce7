"""Superpixel pooling kernels K1 (stage 0) and K2 (stages 1-4), and their
backward bodies K3 and K4.

Port of ``wesup_tpu/ops/cellpool_pallas.py``'s kernels and custom VJPs:

- :func:`cell_pool0` (K1): ``sums[b, k, c] = sum_{seg[b,h,w]=k}
  taps[b, h, w, c]`` of full-resolution taps; pixels with ``seg < 0`` add
  nothing (the caller masks invalid pixels that way).  Its backward, K3
  (:func:`cell_pool0_bwd`), is the transposed selection ``dtaps[b, h, w] =
  dsums[b, seg[b, h, w]]`` in taps' dtype, 0 where ``seg < 0``.
- :func:`cell_pool_stage` (K2): ``sums[b, k, c] = sum_{p,q} M[b,p,q,k]
  taps[b, p, q, c]`` of a downsampled stage, with ``M`` given by its
  compact window weights ``mc`` (B, Hs, Ih, Ws, Jw) from
  :func:`wesup_tpu_torch.ops.cellgrid.stage_window_weights`.  Its backward,
  K4 (:func:`cell_pool_stage_bwd`), is ``dtaps = M dsums`` with ``dsums``
  rounded to taps' dtype first (one torch cast before the kernel) and the
  f32 sum rounded at the end, as the JAX backward rounds.

The forwards return (B, K, C) float32.  :func:`cell_pool0` and
:func:`cell_pool_stage` are ``torch.autograd.Function``s: their backward
runs K3 / K4, the segment ids and window weights get no gradient (they
descend from integer SLIC assignments).  For CUDA tensors every wrapper
launches its hand-written kernel in ``csrc/cellpool.cu`` (or raises); only
for CPU tensors does it take the plain PyTorch version beside it, which the
tests and ``chip_smoke.py`` hold the kernel against.  ``LAUNCHES`` counts
the kernel launches, one per wrapper call that reaches the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import tracing
from .cellgrid import (StagePoolPlan, _device_const, _spp_const,
                       expand_window_weights)
from .slic import SlicPlan

# kernel launches since the last reset_launches(), by kernel name: a view
# of the tracer's counters launches.<kernel>
LAUNCHES = tracing.CounterView("launches.", (
    "cell_pool0", "cell_pool_stage", "cell_pool0_bwd", "cell_pool_stage_bwd"))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES.reset()


def _window_ranges(idx: np.ndarray, lo_val: np.ndarray, hi_val: np.ndarray):
    """For a monotone non-decreasing ``idx``, the contiguous positions whose
    value lies in [lo_val[k], hi_val[k]], per k, as int32 (lo, hi)."""
    if np.any(np.diff(idx) < 0):
        raise ValueError("window tables need a monotone index")
    lo = np.searchsorted(idx, lo_val, side="left")
    hi = np.searchsorted(idx, hi_val, side="right")
    return lo.astype(np.int32), hi.astype(np.int32)


def _pool0_tables(plan: SlicPlan, device):
    """Per cluster row / column, the pixel rows / columns whose cell lies
    within +-1 of it: (row_lo, row_hi, col_lo, col_hi) int32 on device."""
    def build():
        ky, kx = np.arange(plan.Kh), np.arange(plan.Kw)
        rows = _window_ranges(plan.cell_y, ky - 1, ky + 1)
        cols = _window_ranges(plan.cell_x, kx - 1, kx + 1)
        return tuple(torch.as_tensor(t, device=device) for t in rows + cols)

    key = ("pool0", plan.H, plan.W, plan.Kh, plan.Kw, str(device))
    return _device_const(key, build)


def _stage_tables(spp: StagePoolPlan, device):
    """Anchors and, per cluster row / column, the stage rows / columns whose
    window reaches it: (ay, ax, p_lo, p_hi, q_lo, q_hi) int32 on device."""
    def build():
        ky, kx = np.arange(spp.Kh), np.arange(spp.Kw)
        # row p reaches ky iff 0 <= ky - ay[p] - rmin_y < Ih
        prow = _window_ranges(spp.anchor_y, ky - spp.rmin_y - spp.Ih + 1,
                              ky - spp.rmin_y)
        qcol = _window_ranges(spp.anchor_x, kx - spp.rmin_x - spp.Jw + 1,
                              kx - spp.rmin_x)
        arrs = (spp.anchor_y.astype(np.int32), spp.anchor_x.astype(np.int32))
        return tuple(torch.as_tensor(t, device=device)
                     for t in arrs + prow + qcol)

    return _spp_const(spp, ("tables", str(device)), build)


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K1: stage-0 segment sums
# ---------------------------------------------------------------------------

def cell_pool0_plain(plan: SlicPlan, seg: torch.Tensor,
                     taps: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the dense one-hot contraction in f32."""
    K = plan.n_clusters
    oh = (seg[..., None] == torch.arange(K, device=seg.device,
                                         dtype=seg.dtype)).to(torch.float32)
    return torch.einsum("bhwk,bhwc->bkc", oh, taps.to(torch.float32))


def _pool0_fwd(plan: SlicPlan, seg: torch.Tensor,
               taps: torch.Tensor) -> torch.Tensor:
    if taps.device.type == "cpu":
        return cell_pool0_plain(plan, seg, taps)
    if taps.device.type != "cuda":
        raise ValueError(f"cell_pool0: unsupported device {taps.device}")
    B, H, W, C = taps.shape
    if (H, W) != (plan.H, plan.W):
        raise ValueError(f"taps are {H}x{W}, plan is {plan.H}x{plan.W}")
    _check("taps", taps, (B, H, W, C), _DTYPE_CODE, taps.device)
    _check("seg", seg, (B, H, W), (torch.int32,), taps.device)
    from ._build import library

    lib = library()
    tables = _pool0_tables(plan, taps.device)
    out = torch.empty((B, plan.n_clusters, C), dtype=torch.float32,
                      device=taps.device)
    with torch.cuda.device(taps.device):   # launch on the tensors' card
        err = lib.wesup_cell_pool0(
            seg.data_ptr(), taps.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in tables), B, H, W, C, plan.Kh, plan.Kw,
            _DTYPE_CODE[taps.dtype], _stream_ptr(taps.device))
    _raise_on_error("cell_pool0", err)
    tracing.count("launches.cell_pool0")
    return out


def cell_pool0_bwd_plain(plan: SlicPlan, seg: torch.Tensor,
                         dsums: torch.Tensor, dtype) -> torch.Tensor:
    """Plain version of K3: gather each pixel's cotangent row, in ``dtype``,
    zero where ``seg < 0``."""
    B, H, W = seg.shape
    C = dsums.shape[-1]
    idx = seg.clamp_min(0).reshape(B, H * W, 1).long().expand(B, H * W, C)
    rows = torch.gather(dsums.to(dtype), 1, idx).reshape(B, H, W, C)
    return rows.masked_fill((seg < 0)[..., None], 0)


def cell_pool0_bwd(plan: SlicPlan, seg: torch.Tensor, dsums: torch.Tensor,
                   dtype) -> torch.Tensor:
    """K3: (B, H, W, C) gradient in ``dtype`` of :func:`cell_pool0`'s taps
    from the (B, K, C) float32 cotangent ``dsums``."""
    dsums = dsums.contiguous()
    if dsums.device.type == "cpu":
        return cell_pool0_bwd_plain(plan, seg, dsums, dtype)
    if dsums.device.type != "cuda":
        raise ValueError(f"cell_pool0_bwd: unsupported device {dsums.device}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"cell_pool0_bwd: unsupported dtype {dtype}")
    B, H, W = seg.shape
    C = dsums.shape[-1]
    if (H, W) != (plan.H, plan.W):
        raise ValueError(f"seg is {H}x{W}, plan is {plan.H}x{plan.W}")
    _check("dsums", dsums, (B, plan.n_clusters, C), (torch.float32,),
           dsums.device)
    _check("seg", seg, (B, H, W), (torch.int32,), dsums.device)
    if max(B * H * W + 32, B * plan.n_clusters) >= 2**31:
        raise ValueError("cell_pool0_bwd: pixel and row indices must fit "
                         "in int32")
    from ._build import library

    lib = library()
    out = torch.empty((B, H, W, C), dtype=dtype, device=dsums.device)
    with torch.cuda.device(dsums.device):   # launch on the tensors' card
        err = lib.wesup_cell_pool0_bwd(
            seg.data_ptr(), dsums.data_ptr(), out.data_ptr(), B, H, W, C,
            plan.n_clusters, _DTYPE_CODE[dtype], _stream_ptr(dsums.device))
    _raise_on_error("cell_pool0_bwd", err)
    tracing.count("launches.cell_pool0_bwd")
    return out


class _CellPool0Fn(torch.autograd.Function):
    """K1 forward, K3 backward; ``seg`` gets no gradient."""

    @staticmethod
    def forward(ctx, plan, seg, taps):
        ctx.plan, ctx.dtype = plan, taps.dtype
        ctx.save_for_backward(seg)
        return _pool0_fwd(plan, seg, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums):
        (seg,) = ctx.saved_tensors
        return None, None, cell_pool0_bwd(ctx.plan, seg, dsums, ctx.dtype)


def cell_pool0(plan: SlicPlan, seg: torch.Tensor,
               taps: torch.Tensor) -> torch.Tensor:
    """(B, K, C) float32 segment sums of full-resolution (B, H, W, C) taps.

    ``seg`` (B, H, W) int32 must be validity-masked (invalid pixels < 0)
    and come from :func:`wesup_tpu_torch.ops.slic.slic` for ``plan``.
    Differentiable in ``taps`` (through K3)."""
    return _CellPool0Fn.apply(plan, seg, taps)


# ---------------------------------------------------------------------------
# K2: downsampled stages' adjoint-weighted sums
# ---------------------------------------------------------------------------

def cell_pool_stage_plain(spp: StagePoolPlan, mc: torch.Tensor,
                          taps: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: expand the windows to the dense (B, Hs, Kh, Ws,
    Kw) weights (``stage_adjoint_weights``) and contract them in f32."""
    B, C = taps.shape[0], taps.shape[-1]
    Md = expand_window_weights(spp, mc).to(torch.float32)
    sums = torch.einsum("bpyqx,bpqc->byxc", Md, taps.to(torch.float32))
    return sums.reshape(B, spp.Kh * spp.Kw, C)


def _stage_fwd(spp: StagePoolPlan, mc: torch.Tensor,
               taps: torch.Tensor) -> torch.Tensor:
    if taps.device.type == "cpu":
        return cell_pool_stage_plain(spp, mc, taps)
    if taps.device.type != "cuda":
        raise ValueError(f"cell_pool_stage: unsupported device {taps.device}")
    B, Hs, Ws, C = taps.shape
    if (Hs, Ws) != (spp.Hs, spp.Ws):
        raise ValueError(f"taps are {Hs}x{Ws}, stage plan is "
                         f"{spp.Hs}x{spp.Ws}")
    _check("taps", taps, (B, Hs, Ws, C), _DTYPE_CODE, taps.device)
    _check("mc", mc, (B, Hs, spp.Ih, Ws, spp.Jw), (taps.dtype,), taps.device)
    from ._build import library

    lib = library()
    tables = _stage_tables(spp, taps.device)
    out = torch.empty((B, spp.Kh * spp.Kw, C), dtype=torch.float32,
                      device=taps.device)
    with torch.cuda.device(taps.device):   # launch on the tensors' card
        err = lib.wesup_cell_pool_stage(
            mc.data_ptr(), taps.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in tables), B, Hs, Ws, C, spp.Ih, spp.Jw,
            spp.Kh, spp.Kw, spp.rmin_y, spp.rmin_x, _DTYPE_CODE[taps.dtype],
            _stream_ptr(taps.device))
    _raise_on_error("cell_pool_stage", err)
    tracing.count("launches.cell_pool_stage")
    return out


def cell_pool_stage_bwd_plain(spp: StagePoolPlan, mc: torch.Tensor,
                              dsums: torch.Tensor, dtype) -> torch.Tensor:
    """Plain version of K4: the dense weights times the cotangent rounded to
    ``dtype``, summed in f32 and rounded to ``dtype``."""
    B, C = dsums.shape[0], dsums.shape[-1]
    Md = expand_window_weights(spp, mc).to(torch.float32)
    ds = dsums.reshape(B, spp.Kh, spp.Kw, C).to(dtype).to(torch.float32)
    return torch.einsum("bpyqx,byxc->bpqc", Md, ds).to(dtype)


def cell_pool_stage_bwd(spp: StagePoolPlan, mc: torch.Tensor,
                        dsums: torch.Tensor) -> torch.Tensor:
    """K4: (B, Hs, Ws, C) gradient, in ``mc``'s dtype, of
    :func:`cell_pool_stage`'s taps from the (B, K, C) f32 cotangent.

    On the card the cotangent is rounded to ``mc``'s dtype once, here, with
    a torch cast (``dsums.to(dtype)``; none in f32), as the JAX backward
    casts its cotangent window before the Pallas body; the kernel then
    reads those rounded rows."""
    dsums = dsums.contiguous()
    if dsums.device.type == "cpu":
        return cell_pool_stage_bwd_plain(spp, mc, dsums, mc.dtype)
    if dsums.device.type != "cuda":
        raise ValueError(f"cell_pool_stage_bwd: unsupported device "
                         f"{dsums.device}")
    B, C = dsums.shape[0], dsums.shape[-1]
    _check("dsums", dsums, (B, spp.Kh * spp.Kw, C), (torch.float32,),
           dsums.device)
    _check("mc", mc, (B, spp.Hs, spp.Ih, spp.Ws, spp.Jw), _DTYPE_CODE,
           dsums.device)
    from ._build import library

    lib = library()
    ay, ax = _stage_tables(spp, dsums.device)[:2]
    ds = dsums.to(mc.dtype)
    out = torch.empty((B, spp.Hs, spp.Ws, C), dtype=mc.dtype,
                      device=dsums.device)
    with torch.cuda.device(dsums.device):   # launch on the tensors' card
        err = lib.wesup_cell_pool_stage_bwd(
            mc.data_ptr(), ds.data_ptr(), out.data_ptr(), ay.data_ptr(),
            ax.data_ptr(), B, spp.Hs, spp.Ws, C, spp.Ih, spp.Jw, spp.Kh,
            spp.Kw, spp.rmin_y, spp.rmin_x, _DTYPE_CODE[mc.dtype],
            _stream_ptr(dsums.device))
    _raise_on_error("cell_pool_stage_bwd", err)
    tracing.count("launches.cell_pool_stage_bwd")
    return out


class _CellPoolStageFn(torch.autograd.Function):
    """K2 forward, K4 backward; the window weights get no gradient."""

    @staticmethod
    def forward(ctx, spp, mc, taps):
        ctx.spp = spp
        ctx.save_for_backward(mc)
        return _stage_fwd(spp, mc, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums):
        (mc,) = ctx.saved_tensors
        return None, None, cell_pool_stage_bwd(ctx.spp, mc, dsums)


def cell_pool_stage(spp: StagePoolPlan, mc: torch.Tensor,
                    taps: torch.Tensor) -> torch.Tensor:
    """(B, K, C) float32 adjoint-pooled sums of (B, Hs, Ws, C) stage taps,
    from the stage's (B, Hs, Ih, Ws, Jw) window weights ``mc`` (same dtype
    as ``taps``), never expanding them to (B, Hs, Kh, Ws, Kw) on the card.
    Differentiable in ``taps`` (through K4)."""
    return _CellPoolStageFn.apply(spp, mc, taps)
