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
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cellpool import _DTYPE_CODE, _check, _raise_on_error, _stream_ptr

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"segment_sum": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def segment_sum(seg: torch.Tensor, feat: torch.Tensor, K: int,
                lists: SegmentLists | None = None) -> torch.Tensor:
    """K5: (B, K, C) float32 sums of (B, P, C) features by (B, P) int32
    ids; ids outside [0, K) add nothing.  ``lists`` may pass the
    :func:`segment_lists` of ``seg`` when the caller has built them."""
    if feat.device.type == "cpu":
        return segment_sum_plain(seg, feat, K)
    if feat.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {feat.device}")
    if feat.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("K5 has no backward kernel yet: train "
                                  "with pooling='local'")
    B, P, C = feat.shape
    _check("feat", feat, (B, P, C), _DTYPE_CODE, feat.device)
    _check("seg", seg, (B, P), (torch.int32,), feat.device)
    if lists is None:
        lists = segment_lists(seg, K)
    elif lists.K != K or lists.order.numel() != B * P:
        raise ValueError("lists were built for another seg or K")
    from ._build import library

    lib = library()
    out = torch.empty((B, K, C), dtype=torch.float32, device=feat.device)
    err = lib.wesup_segment_sum(
        lists.order.data_ptr(), lists.start.data_ptr(), feat.data_ptr(),
        out.data_ptr(), B, P, C, K, _DTYPE_CODE[feat.dtype],
        _stream_ptr(feat.device))
    _raise_on_error("segment_sum", err)
    LAUNCHES["segment_sum"] += 1
    return out


def segment_mean(seg: torch.Tensor, feat: torch.Tensor, K: int,
                 counts: torch.Tensor) -> torch.Tensor:
    """Mean-pool via :func:`segment_sum` (counts (B, K) precomputed)."""
    return segment_sum(seg, feat, K) / counts[..., None].clamp_min(1.0)
