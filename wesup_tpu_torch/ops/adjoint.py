"""Adjoint superpixel pooling of one downsampled stage, kernel K6.

Port of ``wesup_tpu/ops/adjoint_pallas.py::adjoint_pool_stage``, with the
JAX signature and layouts: for one stage with the align-corners bilinear
upsample matrices ``A_h`` (H, Hs) and ``A_w`` (W, Ws) and assignments
``seg`` (B, H, W),

    sums[b, c, k] = sum_{u,v} (A_h^T OH A_w)[b, u, v, k] taps[b, u, v, c]
                  = sum_h tapsH_T[b, :, h, :] @ p_h,
    p_h = A_w^T onehot(seg[b, h])   (Ws, K),

where ``tapsH_T`` (B, C, H, Ws) holds the stage taps already upsampled
along H (the caller's einsum over the small native-resolution taps).
Pixels with ``seg < 0`` add nothing.  As on the TPU, ``A_w^T`` is rounded
to the taps' dtype and so is each ``p_h``, and the products accumulate in
f32.  This is the ``pooling="adjoint"`` forward's stages 1-4.

On a CUDA tensor :func:`adjoint_pool_stage` launches the hand-written
kernel in ``csrc/adjoint.cu`` (or raises); on a CPU tensor it takes
:func:`adjoint_pool_stage_plain`, which follows the TPU kernel's math and
which the tests and ``chip_smoke.py`` hold the kernel against.  The
kernel compacts each segment's nonzero ``p_h`` terms from the per-segment
pixel lists of ``ops/pooling.py`` once, then streams the tap rows they
meet; it reads ``tapsH_T`` through its strides and makes no copy.  A
channels-last (B, H, Ws, C) tensor viewed as (B, C, H, Ws), as the forward
passes it, is read 16 bytes at a time; any other layout element by element
(right, but slow).  The card's result is a
(B, C, K) view of a (B, K, C) tensor.

:func:`adjoint_pool_stage` is a ``torch.autograd.Function``; its backward
is kernel K8 (:func:`adjoint_pool_stage_bwd`, in the same source), the
exact transpose of K6 as K6 computes it:

    dtapsH_T[b, c, h, v] = T( sum_k T(p_h[v, k]) dsums[b, k, c] ),

summed in f32 with the same rounded ``p_h``, T the taps' dtype.  The JAX
package has no kernel here: it differentiates its einsums.  The seg, the
lists and the table get no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .kernels import DTYPE_CODE, check, device_const, launch
from .pooling import SegmentLists, segment_lists


def _rounded_p(seg: torch.Tensor, A_wT: torch.Tensor, K: int, dt):
    """The dense (B, H, Ws, K) ``p_h = A_w^T onehot(seg[b, h])``, summed in
    f32 from ``A_wT`` rounded to ``dt``, then rounded to ``dt`` (as f32)."""
    awt = A_wT.to(device=seg.device, dtype=dt).to(torch.float32)
    ids = torch.arange(K, dtype=seg.dtype, device=seg.device)
    oh = (seg[..., None] == ids).to(torch.float32)           # (B, H, W, K)
    return torch.einsum("vw,bhwk->bhvk", awt, oh).to(dt).to(torch.float32)


def adjoint_pool_stage_plain(seg: torch.Tensor, tapsH_T: torch.Tensor,
                             A_wT: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of K6, in the TPU kernel's order: per row h,
    ``p_h = A_w^T onehot(seg[b, h])`` summed in f32 and rounded to the
    taps' dtype, then ``tapsH_T[b, :, h, :] @ p_h`` accumulated in f32."""
    p = _rounded_p(seg, A_wT, K, tapsH_T.dtype)
    return torch.einsum("bchv,bhvk->bck", tapsH_T.to(torch.float32), p)


def adjoint_pool_stage_bwd_plain(seg: torch.Tensor, dsums: torch.Tensor,
                                 A_wT: torch.Tensor, K: int,
                                 dtype) -> torch.Tensor:
    """Plain version of K8: the dense product of the rounded p_h (as K6's
    plain version builds it) and the (B, K, C) cotangent in f32, rounded
    to ``dtype``; (B, C, H, Ws) (a view of a (B, H, Ws, C) tensor)."""
    p = _rounded_p(seg, A_wT, K, dtype)
    out = torch.einsum("bhvk,bkc->bhvc", p, dsums.to(torch.float32))
    return out.to(dtype).permute(0, 3, 1, 2)


class ColumnTable(NamedTuple):
    """A (Ws, W) linear-interpolation matrix, by pixel column w and by
    row v, on one device: ``v0[w]`` (non-decreasing in w) is column w's
    first nonzero row, ``a0[w]`` and ``a1[w]`` (f32, rounded to the dtype
    the table was built for) its weights of rows v0[w] and v0[w] + 1; row
    v's nonzeros lie in columns [lo[v], hi[v]), where v0 is v - 1 or v.
    ``cap`` is the widest such range."""

    v0: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    cap: int


def column_table(A_wT: torch.Tensor, dtype, device) -> ColumnTable:
    """The :class:`ColumnTable` of the (Ws, W) matrix rounded to ``dtype``,
    on ``device``.  Built once per matrix (keyed by its contents, so an
    A_wT on the CPU costs no device sync, but a lookup reads the whole
    matrix: a caller that pools many times keeps the table and passes it)."""
    A = A_wT.detach().cpu().to(dtype).to(torch.float32).numpy()
    key = ("adjoint_columns", A.shape, str(dtype), str(device), A.tobytes())
    return device_const(key, lambda: _build_column_table(A, device))


def _build_column_table(A: np.ndarray, device):
    Ws, W = A.shape
    nz = A != 0
    if (nz.sum(0) > 2).any():
        raise ValueError("adjoint_pool_stage needs at most two nonzeros "
                         "per column of A_wT")
    first = np.where(nz.any(0), nz.argmax(0), -1)
    # an all-zero column adds nothing; give it its left neighbour's row
    v0 = np.maximum.accumulate(np.maximum(first, 0))
    if (first >= 0).any() and (first[first >= 0] != v0[first >= 0]).any():
        raise ValueError("adjoint_pool_stage needs the nonzero rows of A_wT "
                         "to be non-decreasing along W")
    cols = np.arange(W)
    a0 = A[v0, cols]
    a1 = np.where(v0 + 1 < Ws, A[np.minimum(v0 + 1, Ws - 1), cols], 0.0)
    if (nz.sum(0) - (a0 != 0) - (a1 != 0)).any():
        raise ValueError("adjoint_pool_stage needs the nonzeros of each "
                         "column of A_wT on two adjacent rows")
    # row v meets the columns whose v0 is v - 1 (weight a1) or v (a0)
    rows = np.arange(Ws)
    lo = np.searchsorted(v0, rows - 1, side="left")
    hi = np.searchsorted(v0, rows, side="right")

    def on(t, dt):
        return torch.as_tensor(t.astype(dt), device=device)

    return ColumnTable(on(v0, np.int32), on(a0, np.float32),
                       on(a1, np.float32), on(lo, np.int32),
                       on(hi, np.int32), int((hi - lo).max(initial=0)))


def _check_stage(seg, tapsH_T, A_wT, K, lists, table):
    """The shapes K6 and K8 need; returns (lists, table), built when not
    given."""
    B, H, W = seg.shape
    _, C, H2, Ws = tapsH_T.shape
    if tapsH_T.shape[0] != B or H2 != H:
        raise ValueError(f"tapsH_T is {tuple(tapsH_T.shape)}, seg is "
                         f"{tuple(seg.shape)}")
    if tuple(A_wT.shape) != (Ws, W):
        raise ValueError(f"A_wT is {tuple(A_wT.shape)}, expected {(Ws, W)}")
    if tapsH_T.dtype not in DTYPE_CODE:
        raise TypeError(f"tapsH_T has dtype {tapsH_T.dtype}, expected one "
                        f"of {tuple(DTYPE_CODE)}")
    check("seg", seg, (B, H, W), (torch.int32,), tapsH_T.device)
    if lists is None:
        lists = segment_lists(seg, K)
    elif lists.K != K or lists.order.numel() != B * H * W:
        raise ValueError("lists were built for another seg or K")
    if table is None:
        table = column_table(A_wT, tapsH_T.dtype, tapsH_T.device)
    if (table.v0.numel() != W or table.lo.numel() != Ws
            or table.v0.device != tapsH_T.device):
        raise ValueError("table was built for another A_wT or device")
    return lists, table


def _launch_fwd(seg, tapsH_T, K, lists, table) -> torch.Tensor:
    """K6 on checked CUDA inputs: the (B, K, C) float32 sums."""
    B, W = seg.shape[0], seg.shape[2]
    C, Ws = tapsH_T.shape[1], tapsH_T.shape[3]
    out = torch.empty((B, K, C), dtype=torch.float32, device=tapsH_T.device)
    launch("adjoint_pool_stage", tapsH_T.device, lists.order.data_ptr(),
           lists.start.data_ptr(), tapsH_T.data_ptr(), *tapsH_T.stride(),
           table.v0.data_ptr(), table.a0.data_ptr(), table.a1.data_ptr(),
           out.data_ptr(), B, W, Ws, C, K, DTYPE_CODE[tapsH_T.dtype])
    return out


def adjoint_pool_stage_bwd(seg: torch.Tensor, dsums: torch.Tensor,
                           A_wT: torch.Tensor, K: int, dtype,
                           table: ColumnTable | None = None) -> torch.Tensor:
    """K8: the (B, C, H, Ws) gradient in ``dtype`` of
    :func:`adjoint_pool_stage`'s ``tapsH_T`` from the (B, K, C) float32
    cotangent ``dsums`` (any strides).  The result is a view of a
    channels-last (B, H, Ws, C) tensor, the layout the forward's
    H-upsample produced.  ``table``: the :func:`column_table` of ``A_wT``
    for ``dtype`` on the cotangent's device, when the caller has it."""
    if dsums.device.type == "cpu":
        return adjoint_pool_stage_bwd_plain(seg, dsums, A_wT, K, dtype)
    if dsums.device.type != "cuda":
        raise ValueError(f"adjoint_pool_stage_bwd: unsupported device "
                         f"{dsums.device}")
    if dtype not in DTYPE_CODE:
        raise TypeError(f"adjoint_pool_stage_bwd: unsupported dtype {dtype}")
    B, H, W = seg.shape
    Ws = A_wT.shape[0]
    C = dsums.shape[-1]
    if tuple(dsums.shape) != (B, K, C) or dsums.dtype != torch.float32:
        raise ValueError(f"dsums is {tuple(dsums.shape)} {dsums.dtype}, "
                         f"expected {(B, K, C)} float32")
    if tuple(A_wT.shape) != (Ws, W):
        raise ValueError(f"A_wT is {tuple(A_wT.shape)}, seg is "
                         f"{tuple(seg.shape)}")
    check("seg", seg, (B, H, W), (torch.int32,), dsums.device)
    if table is None:
        table = column_table(A_wT, dtype, dsums.device)
    if (table.v0.numel() != W or table.lo.numel() != Ws
            or table.v0.device != dsums.device):
        raise ValueError("table was built for another A_wT or device")
    out = torch.empty((B, H, Ws, C), dtype=dtype, device=dsums.device)
    launch("adjoint_pool_stage_bwd", dsums.device, seg.data_ptr(),
           dsums.data_ptr(), *dsums.stride(), table.v0.data_ptr(),
           table.a0.data_ptr(), table.a1.data_ptr(), table.lo.data_ptr(),
           table.hi.data_ptr(), out.data_ptr(), B, H, W, Ws, C, K, table.cap,
           DTYPE_CODE[dtype])
    return out.permute(0, 3, 1, 2)


class _AdjointPoolStageFn(torch.autograd.Function):
    """K6 forward, K8 backward.  seg, A_wT, lists and table get no
    gradient."""

    @staticmethod
    def forward(ctx, seg, tapsH_T, A_wT, K, lists, table):
        if tapsH_T.device.type == "cpu":
            out = adjoint_pool_stage_plain(seg, tapsH_T, A_wT, K)
        elif tapsH_T.device.type != "cuda":
            raise ValueError(f"adjoint_pool_stage: unsupported device "
                             f"{tapsH_T.device}")
        else:
            lists, table = _check_stage(seg, tapsH_T, A_wT, K, lists, table)
            out = _launch_fwd(seg, tapsH_T, K, lists, table).transpose(1, 2)
        ctx.A_wT, ctx.K, ctx.table = A_wT, K, table
        ctx.dtype = tapsH_T.dtype
        ctx.save_for_backward(seg)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums_T):
        (seg,) = ctx.saved_tensors
        dsums = dsums_T.transpose(1, 2)   # (B, K, C), any strides
        return (None, adjoint_pool_stage_bwd(seg, dsums, ctx.A_wT, ctx.K,
                                             ctx.dtype, ctx.table),
                None, None, None, None)


def adjoint_pool_stage(seg: torch.Tensor, tapsH_T: torch.Tensor,
                       A_wT: torch.Tensor, K: int,
                       lists: SegmentLists | None = None,
                       table: ColumnTable | None = None) -> torch.Tensor:
    """K6: (B, C, K) float32 adjoint-pooled sums for one stage.
    Differentiable in ``tapsH_T`` (through K8).

    Args:
        seg: (B, H, W) int32 assignments (< 0: the pixel adds nothing).
        tapsH_T: (B, C, H, Ws) H-upsampled stage taps, f32 or bf16, in any
            strides.
        A_wT: (Ws, W) transposed W-upsample matrix: at most two nonzeros
            per column, on adjacent rows that do not decrease along W (any
            linear interpolation matrix).
        lists: the :func:`~wesup_tpu_torch.ops.pooling.segment_lists` of
            ``seg``, when the caller has built them.
        table: the :func:`column_table` of ``A_wT`` for the taps' dtype
            and device, when the caller has built it.
    """
    return _AdjointPoolStageFn.apply(seg, tapsH_T, A_wT, K, lists, table)
