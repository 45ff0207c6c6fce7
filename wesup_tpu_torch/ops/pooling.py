"""General segment sum, kernel K5, and the per-segment pixel lists it walks.

Port of ``wesup_tpu/ops/pooling_pallas.py`` (``segment_sum_pallas``,
``segment_mean_pallas``), batched: :func:`segment_sum` takes (B, P, C)
features and (B, P) int32 ids and returns (B, K, C) float32 sums; ids
outside [0, K) add nothing.  No cell structure is assumed, so it pools any
assignment: the plan-less ``pooling="adjoint"`` forward's stage 0 and the
``pooling="fullres"`` forward's two pools run through it.

On a CUDA tensor :func:`segment_sum` launches the hand-written kernel in
``csrc/pooling.cu`` (or raises); on a CPU tensor it takes
:func:`segment_sum_plain`, the dense one-hot contraction in f32, which the
tests and ``chip_smoke.py`` hold the kernel against.  The kernel walks
per-segment pixel lists (:func:`segment_lists`), built in the wrapper with
one stable sort of the ids; the adjoint stage kernel K6
(``ops/adjoint.py``) walks the same lists, so a forward builds them once.

:func:`segment_sum` is a ``torch.autograd.Function``: its backward,
:func:`segment_sum_bwd`, is ``dfeat[b, p] = T(dsums[b, seg[b, p]])`` in the
features' dtype T, 0 where the id lies outside [0, K), and launches K3's
kernel (``csrc/cellpool.cu``, ``wesup_cell_pool0_bwd``), which computes
exactly that over a flat pixel axis.  The ids get no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from .kernels import DTYPE_CODE, check, launch


class SegmentLists(NamedTuple):
    """The pixels of each (image, segment), in pixel order.

    ``order`` (B * P,) int32 holds pixel indices within their image,
    grouped by ``b * K + k``; group ``g`` is ``order[start[g]:start[g + 1]]``.
    Pixels whose id lies outside [0, K) sit after the last group."""

    order: torch.Tensor
    start: torch.Tensor      # (B * K + 1,) int32
    K: int


def segment_lists(seg: torch.Tensor, K: int) -> SegmentLists:
    """Per-segment pixel lists of (B, ...) int ids, from one stable sort."""
    B = seg.shape[0]
    ids = seg.reshape(B, -1).to(torch.int32)
    P = ids.shape[1]
    if B * (K + 1) >= 2**31 or B * P >= 2**31:
        raise ValueError(f"segment lists need B*K and B*P below 2^31 "
                         f"(B={B}, K={K}, P={P})")
    base = torch.arange(B, dtype=torch.int32, device=seg.device)[:, None] * K
    key = torch.where((ids >= 0) & (ids < K), base + ids, B * K).reshape(-1)
    key_sorted, flat = torch.sort(key, stable=True)
    order = (flat % P).to(torch.int32)
    bounds = torch.arange(B * K + 1, dtype=torch.int32, device=seg.device)
    start = torch.searchsorted(key_sorted, bounds, out_int32=True)
    return SegmentLists(order, start, K)


def segment_sum_plain(seg: torch.Tensor, feat: torch.Tensor,
                      K: int) -> torch.Tensor:
    """Plain version of K5: the dense one-hot contraction in f32."""
    ids = torch.arange(K, dtype=seg.dtype, device=seg.device)
    oh = (seg[..., None] == ids).to(torch.float32)          # (B, P, K)
    return torch.einsum("bpk,bpc->bkc", oh, feat.to(torch.float32))


def _segment_sum_fwd(seg: torch.Tensor, feat: torch.Tensor, K: int,
                     lists: SegmentLists | None) -> torch.Tensor:
    if feat.device.type == "cpu":
        return segment_sum_plain(seg, feat, K)
    if feat.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {feat.device}")
    B, P, C = feat.shape
    check("feat", feat, (B, P, C), DTYPE_CODE, feat.device)
    check("seg", seg, (B, P), (torch.int32,), feat.device)
    if lists is None:
        lists = segment_lists(seg, K)
    elif lists.K != K or lists.order.numel() != B * P:
        raise ValueError("lists were built for another seg or K")
    out = torch.empty((B, K, C), dtype=torch.float32, device=feat.device)
    launch("segment_sum", feat.device, lists.order.data_ptr(),
           lists.start.data_ptr(), feat.data_ptr(), out.data_ptr(), B, P, C,
           K, DTYPE_CODE[feat.dtype])
    return out


def segment_sum_bwd_plain(seg: torch.Tensor, dsums: torch.Tensor,
                          dtype) -> torch.Tensor:
    """Plain version of K5's backward: gather each pixel's cotangent row, in
    ``dtype``, zero where the id lies outside [0, K)."""
    B, P = seg.shape
    K, C = dsums.shape[1:]
    ok = (seg >= 0) & (seg < K)
    idx = torch.where(ok, seg, 0).long()[..., None].expand(B, P, C)
    rows = torch.gather(dsums.to(dtype), 1, idx)
    return rows.masked_fill(~ok[..., None], 0)


def segment_sum_bwd(seg: torch.Tensor, dsums: torch.Tensor,
                    dtype) -> torch.Tensor:
    """K5's backward: the (B, P, C) gradient in ``dtype`` of
    :func:`segment_sum`'s features from the (B, K, C) float32 cotangent.

    On the card it launches K3's kernel with the flat pixel axis as one
    image row, (H, W) = (1, P), so that a pixel's image stays its flat
    index over P.  That kernel drops only ids < 0 and would read another
    image's row for an id >= K, so the ids outside [0, K) are set to -1
    first (one elementwise op)."""
    dsums = dsums.contiguous()
    if dsums.device.type == "cpu":
        return segment_sum_bwd_plain(seg, dsums, dtype)
    if dsums.device.type != "cuda":
        raise ValueError(f"segment_sum_bwd: unsupported device "
                         f"{dsums.device}")
    if dtype not in DTYPE_CODE:
        raise TypeError(f"segment_sum_bwd: unsupported dtype {dtype}")
    B, P = seg.shape
    K, C = dsums.shape[1:]
    check("dsums", dsums, (B, K, C), (torch.float32,), dsums.device)
    check("seg", seg, (B, P), (torch.int32,), dsums.device)
    if max(B * P + 32, B * K) >= 2**31:
        raise ValueError("segment_sum_bwd: pixel and row indices must fit "
                         "in int32")
    ids = torch.where((seg >= 0) & (seg < K), seg, -1)
    out = torch.empty((B, P, C), dtype=dtype, device=dsums.device)
    launch("segment_sum_bwd", dsums.device, ids.data_ptr(), dsums.data_ptr(),
           out.data_ptr(), B, 1, P, C, K, DTYPE_CODE[dtype])
    return out


class _SegmentSumFn(torch.autograd.Function):
    """K5 forward, K3's kernel backward; ids and lists get no gradient."""

    @staticmethod
    def forward(ctx, seg, feat, K, lists):
        ctx.dtype = feat.dtype
        ctx.save_for_backward(seg)
        return _segment_sum_fwd(seg, feat, K, lists)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums):
        (seg,) = ctx.saved_tensors
        return None, segment_sum_bwd(seg, dsums, ctx.dtype), None, None


def segment_sum(seg: torch.Tensor, feat: torch.Tensor, K: int,
                lists: SegmentLists | None = None) -> torch.Tensor:
    """K5: (B, K, C) float32 sums of (B, P, C) features by (B, P) int32
    ids; ids outside [0, K) add nothing.  ``lists`` may pass the
    :func:`segment_lists` of ``seg`` when the caller has built them.
    Differentiable in ``feat`` (through :func:`segment_sum_bwd`)."""
    return _SegmentSumFn.apply(seg, feat, K, lists)


def segment_mean(seg: torch.Tensor, feat: torch.Tensor, K: int,
                 counts: torch.Tensor) -> torch.Tensor:
    """Mean-pool via :func:`segment_sum` (counts (B, K) precomputed)."""
    return segment_sum(seg, feat, K) / counts[..., None].clamp_min(1.0)
