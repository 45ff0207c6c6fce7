"""Tile cut and tile stitch of tiled inference, on the card.

The port's own kernels (``csrc/tile.cu``); they replace no ``pallas_call``:
the JAX package cuts and stitches on the host in numpy
(``wesup_tpu/inference.py``).  With them a slide goes to the card once as
uint8 and comes back once as its stitched float64 map.  Patches form the
grid of ``inference.get_top_left_coordinates``: ``tops`` (n_h,) and
``lefts`` (n_w,) int32, patch ``p`` at ``(tops[p // n_w], lefts[p % n_w])``,
each h x w.

- :func:`cut`: one chunk's (n_rows, H, W, 3) float32 canvas, row ``b <
  n_real`` the patch ``first + b`` divided by 255 (IEEE float32 division,
  numpy's), its pad the last column, then the last row, repeated; the
  other rows 0.  Bitwise ``Predictor.predict_padded``'s host canvas.
- :func:`stitch`: the (H0, W0) float64 running average of the (N, h, w)
  patch probabilities (float32, optionally rounded half to even, or
  uint8), ``v = (v * c + p) / (c + 1)`` per covering patch in patch
  order.  Bitwise ``inference.combine_patches_to_image``.

For a CUDA tensor each wrapper launches its kernel (or raises); only for a
CPU tensor does it take the plain version beside it, which the tests hold
the kernel against.  Both kernels are bound by HBM bytes (the source's
note).
"""

from __future__ import annotations

import torch

from .kernels import check, launch

# the stitch's probability dtypes and their codes in csrc/tile.cu
_STITCH_DTYPE = {torch.float32: 0, torch.uint8: 1}


def cut_plain(slide, tops, lefts, first, n_real, n_rows, patch_hw,
              canvas_hw):
    """Plain version of the cut (see the module docstring)."""
    h, w = patch_hw
    H, W = canvas_hw
    p = torch.arange(first, first + n_real, device=slide.device)
    n_w = lefts.shape[0]
    rows = (tops.long()[p // n_w][:, None]
            + torch.arange(H, device=slide.device).clamp_max(h - 1))
    cols = (lefts.long()[p % n_w][:, None]
            + torch.arange(W, device=slide.device).clamp_max(w - 1))
    canvas = torch.zeros((n_rows, H, W, 3), dtype=torch.float32,
                         device=slide.device)
    canvas[:n_real] = slide[rows[:, :, None], cols[:, None, :]].to(
        torch.float32) / 255.0
    return canvas


def cut(slide: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
        first: int, n_real: int, n_rows: int, patch_hw, canvas_hw):
    """(n_rows, H, W, 3) float32 canvas of the patches ``first`` ..
    ``first + n_real - 1`` of the (H0, W0, 3) uint8 ``slide``.

    ``tops`` and ``lefts`` must put every patch inside the slide, as the
    grid of ``Predictor.tile_grid`` does: on the card they are read only
    by the kernel, which does not check them."""
    h, w = map(int, patch_hw)
    H, W = map(int, canvas_hw)
    H0, W0 = slide.shape[:2]
    n_h, n_w = tops.shape[0], lefts.shape[0]
    check("slide", slide, (H0, W0, 3), (torch.uint8,), slide.device)
    check("tops", tops, (n_h,), (torch.int32,), slide.device)
    check("lefts", lefts, (n_w,), (torch.int32,), slide.device)
    if not (0 < h <= min(H, H0) and 0 < w <= min(W, W0)):
        raise ValueError(f"tile_cut: patch {h}x{w} does not fit the canvas "
                         f"{H}x{W} and the slide {H0}x{W0}")
    if not (0 <= n_real <= n_rows and n_rows >= 1 and first >= 0
            and (n_real == 0 or first + n_real <= n_h * n_w)):
        raise ValueError(f"tile_cut: rows {first}..{first + n_real} of "
                         f"{n_h * n_w} patches in {n_rows} canvas rows")
    if slide.device.type == "cpu":
        return cut_plain(slide, tops, lefts, first, n_real, n_rows, (h, w),
                         (H, W))
    if slide.device.type != "cuda":
        raise ValueError(f"tile_cut: unsupported device {slide.device}")
    out = torch.empty((n_rows, H, W, 3), dtype=torch.float32,
                      device=slide.device)
    launch("tile_cut", slide.device, slide.data_ptr(), tops.data_ptr(),
           lefts.data_ptr(), out.data_ptr(), W0, n_w, first, n_real, n_rows,
           h, w, H, W)
    return out


def stitch_plain(probs, tops, lefts, out_hw, round_patches):
    """Plain version of the stitch (see the module docstring)."""
    h, w = probs.shape[1:]
    n_w = lefts.shape[0]
    if round_patches and probs.dtype.is_floating_point:
        probs = torch.round(probs)                  # half to even
    v = torch.zeros(tuple(out_hw), dtype=torch.float64, device=probs.device)
    c = torch.zeros_like(v)
    for p in range(probs.shape[0]):
        top, left = int(tops[p // n_w]), int(lefts[p % n_w])
        sl = (slice(top, top + h), slice(left, left + w))
        v[sl] = (v[sl] * c[sl] + probs[p].double()) / (c[sl] + 1)
        c[sl] += 1
    return v


def stitch(probs: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
           out_hw, round_patches: bool = False) -> torch.Tensor:
    """(H0, W0) float64 running average of the (n_h * n_w, h, w) float32 or
    uint8 ``probs`` on the grid; ``round_patches`` rounds each float value
    half to even first."""
    H0, W0 = map(int, out_hw)
    n_h, n_w = tops.shape[0], lefts.shape[0]
    h, w = probs.shape[1:] if probs.dim() == 3 else (0, 0)
    check("probs", probs, (n_h * n_w, h, w), _STITCH_DTYPE, probs.device)
    check("tops", tops, (n_h,), (torch.int32,), probs.device)
    check("lefts", lefts, (n_w,), (torch.int32,), probs.device)
    if h == 0 or w == 0 or H0 < 1 or W0 < 1:
        raise ValueError(f"tile_stitch: empty patches ({h}x{w}) or map "
                         f"({H0}x{W0})")
    if probs.device.type == "cpu":
        return stitch_plain(probs, tops, lefts, (H0, W0), round_patches)
    if probs.device.type != "cuda":
        raise ValueError(f"tile_stitch: unsupported device {probs.device}")
    out = torch.empty((H0, W0), dtype=torch.float64, device=probs.device)
    launch("tile_stitch", probs.device, probs.data_ptr(), tops.data_ptr(),
           lefts.data_ptr(), out.data_ptr(), H0, W0, n_h, n_w, h, w,
           _STITCH_DTYPE[probs.dtype], int(bool(round_patches)))
    return out
