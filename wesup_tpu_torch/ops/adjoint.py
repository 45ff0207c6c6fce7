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
(B, C, K) view of a (B, K, C) tensor.  ``LAUNCHES`` counts the kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .cellgrid import _device_const
from .cellpool import _DTYPE_CODE, _check, _raise_on_error, _stream_ptr
from .pooling import SegmentLists, segment_lists

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"adjoint_pool_stage": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def adjoint_pool_stage_plain(seg: torch.Tensor, tapsH_T: torch.Tensor,
                             A_wT: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of K6, in the TPU kernel's order: per row h,
    ``p_h = A_w^T onehot(seg[b, h])`` summed in f32 and rounded to the
    taps' dtype, then ``tapsH_T[b, :, h, :] @ p_h`` accumulated in f32."""
    dt = tapsH_T.dtype
    awt = A_wT.to(device=tapsH_T.device, dtype=dt).to(torch.float32)
    ids = torch.arange(K, dtype=seg.dtype, device=seg.device)
    oh = (seg[..., None] == ids).to(torch.float32)           # (B, H, W, K)
    p = torch.einsum("vw,bhwk->bhvk", awt, oh).to(dt).to(torch.float32)
    return torch.einsum("bchv,bhvk->bck", tapsH_T.to(torch.float32), p)


def column_table(A_wT: torch.Tensor, dtype, device):
    """Each pixel column w's two adjacent nonzeros of the (Ws, W) matrix
    rounded to ``dtype``: first row v0[w] (non-decreasing in w) and the
    weights a0[w] of row v0[w] and a1[w] of row v0[w] + 1, in f32, on
    ``device``.  Built once per matrix (keyed by its contents, so an A_wT
    on the CPU costs no device sync, but a lookup reads the whole matrix:
    a caller that pools many times keeps the table and passes it)."""
    A = A_wT.detach().cpu().to(dtype).to(torch.float32).numpy()
    key = ("adjoint_columns", A.shape, str(dtype), str(device), A.tobytes())
    return _device_const(key, lambda: _build_column_table(A, device))


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
    return (torch.as_tensor(v0.astype(np.int32), device=device),
            torch.as_tensor(a0.astype(np.float32), device=device),
            torch.as_tensor(a1.astype(np.float32), device=device))


def adjoint_pool_stage(seg: torch.Tensor, tapsH_T: torch.Tensor,
                       A_wT: torch.Tensor, K: int,
                       lists: SegmentLists | None = None,
                       table=None) -> torch.Tensor:
    """K6: (B, C, K) float32 adjoint-pooled sums for one stage.

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
    if tapsH_T.device.type == "cpu":
        return adjoint_pool_stage_plain(seg, tapsH_T, A_wT, K)
    if tapsH_T.device.type != "cuda":
        raise ValueError(f"adjoint_pool_stage: unsupported device "
                         f"{tapsH_T.device}")
    if tapsH_T.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("K6 has no backward kernel yet: train "
                                  "with pooling='local'")
    B, H, W = seg.shape
    _, C, H2, Ws = tapsH_T.shape
    if tapsH_T.shape[0] != B or H2 != H:
        raise ValueError(f"tapsH_T is {tuple(tapsH_T.shape)}, seg is "
                         f"{tuple(seg.shape)}")
    if tuple(A_wT.shape) != (Ws, W):
        raise ValueError(f"A_wT is {tuple(A_wT.shape)}, expected {(Ws, W)}")
    if tapsH_T.dtype not in _DTYPE_CODE:
        raise TypeError(f"tapsH_T has dtype {tapsH_T.dtype}, expected one "
                        f"of {tuple(_DTYPE_CODE)}")
    _check("seg", seg, (B, H, W), (torch.int32,), tapsH_T.device)
    if lists is None:
        lists = segment_lists(seg, K)
    elif lists.K != K or lists.order.numel() != B * H * W:
        raise ValueError("lists were built for another seg or K")
    if table is None:
        table = column_table(A_wT, tapsH_T.dtype, tapsH_T.device)
    v0, a0, a1 = table
    if v0.numel() != W or v0.device != tapsH_T.device:
        raise ValueError("table was built for another A_wT or device")
    from ._build import library

    lib = library()
    out = torch.empty((B, K, C), dtype=torch.float32, device=tapsH_T.device)
    err = lib.wesup_adjoint_pool_stage(
        lists.order.data_ptr(), lists.start.data_ptr(), tapsH_T.data_ptr(),
        *tapsH_T.stride(), v0.data_ptr(), a0.data_ptr(), a1.data_ptr(),
        out.data_ptr(), B, W, Ws, C, K, _DTYPE_CODE[tapsH_T.dtype],
        _stream_ptr(tapsH_T.device))
    _raise_on_error("adjoint_pool_stage", err)
    LAUNCHES["adjoint_pool_stage"] += 1
    return out.transpose(1, 2)
