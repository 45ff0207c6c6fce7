"""cv2-exact resize as integer gathers, on the CPU and on the card.

Port of ``wesup_tpu.ops.train_resize``.  The trainer ships a dataset's
full-resolution decode to the device once per run (:func:`build_cache`)
and each batch travels as a cache index plus per-sample index and
coefficient vectors (:func:`resize_vectors`, host numpy, ~10 KB a sample);
:func:`apply_resize` then builds the uint8 canvas and the int mask on the
device, bit for bit what ``cv2.resize`` (INTER_LINEAR on uint8,
INTER_NEAREST on masks) followed by ``loader.place_on_canvas`` gives.
The same torch functions resize single images on the host for the
datasets (:func:`resize_img`, :func:`resize_mask`), in place of cv2.

cv2's uint8 INTER_LINEAR is fixed point (11-bit coefficients):

    scale   = 1 / (n_out / n_in)                  # double, both roundings
    f       = float32((o + 0.5) * scale - 0.5)    # f32 BEFORE floor
    i       = floor(f); frac = f - i              # clamp: i<0 -> (0, frac 0)
                                                  # i>=n-1 -> (n-1, frac 0)
    a0      = rint(f32(1 - frac) * 2048)          # independent roundings
    a1      = rint(f32(frac) * 2048)              # (not 2048 - a0)
    H pass  : t = (src[i]*a0 + src[i+1]*a1) >> 4  # int, <= 2^15
    V pass  : ((b0*t0) >> 16) + ((b1*t1) >> 16)   # per-tap shift
    out     = (sum + 2) >> 2

and INTER_NEAREST is src[floor(o * scale)] clamped.  The JAX package
runs the passes as banded f32 matmuls (gathers are slow on a TPU); here
they are row and column gathers with int32 multiply-adds, exact by
construction on any device and under any TF32 setting.  Output positions
past the content replicate its last row and column (the canvas's edge
padding); a blank (content 0) resizes to zeros with mask -1.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host side: cv2-exact index/coefficient vectors
# ---------------------------------------------------------------------------

def _linear_axis(n_out: int, n_in: int, n_canvas: int):
    """cv2 INTER_LINEAR taps for one axis, extended over the static canvas.

    Output positions o >= n_out replicate position n_out-1 (the canvas
    edge-replication).  n_out == 0 (batch-padding blank) yields all-zero
    coefficients so the resized image is exactly 0, matching
    loader._blank_item."""
    if n_out <= 0:
        z = np.zeros((n_canvas,), np.int32)
        return z, z, z, z
    o = np.minimum(np.arange(n_canvas), n_out - 1)
    scale = 1.0 / (np.float64(n_out) / np.float64(n_in))  # cv2's two steps
    f = ((o + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = f - i.astype(np.float32)
    frac[i < 0] = 0.0
    i[i < 0] = 0
    sel = i >= n_in - 1
    frac[sel] = 0.0
    i[sel] = n_in - 1
    a0 = np.rint((np.float32(1.0) - frac) * np.float32(2048)).astype(np.int32)
    a1 = np.rint(frac * np.float32(2048)).astype(np.int32)
    i1 = np.minimum(i + 1, n_in - 1)
    return i.astype(np.int32), i1.astype(np.int32), a0, a1


def _nearest_axis(n_out: int, n_in: int, n_canvas: int):
    """cv2 INTER_NEAREST source index per output position, canvas-extended."""
    if n_out <= 0:
        return np.zeros((n_canvas,), np.int32)
    o = np.minimum(np.arange(n_canvas), n_out - 1)
    scale = 1.0 / (np.float64(n_out) / np.float64(n_in))
    i = np.floor(o * scale).astype(np.int64)
    return np.clip(i, 0, n_in - 1).astype(np.int32)


def resize_vectors(full_hw, target_hw, canvas_hw) -> dict:
    """All per-sample resize metadata (host, numpy; ~10 KB per sample)."""
    h0, w0 = int(full_hw[0]), int(full_hw[1])
    th, tw = int(target_hw[0]), int(target_hw[1])
    Hc, Wc = int(canvas_hw[0]), int(canvas_hw[1])
    iy, iy1, b0, b1 = _linear_axis(th, h0, Hc)
    ix, ix1, a0, a1 = _linear_axis(tw, w0, Wc)
    return {
        "rsz_iy": iy, "rsz_iy1": iy1, "rsz_b0": b0, "rsz_b1": b1,
        "rsz_ix": ix, "rsz_ix1": ix1, "rsz_a0": a0, "rsz_a1": a1,
        "rsz_ny": _nearest_axis(th, h0, Hc),
        "rsz_nx": _nearest_axis(tw, w0, Wc),
    }


def build_cache(dataset, max_bytes: int | None = None):
    """Stack the dataset's full-resolution images/masks for the device.

    Returns ``{"imgs": (N, H0, W0, 3) uint8, "masks": (N, H0, W0) int8}``
    as HOST numpy (the trainer moves it to the device once) or ``None``
    when the device path cannot serve this dataset losslessly: no masks,
    mask values outside int8, or cache above ``max_bytes``.
    """
    n = len(dataset)
    if n == 0 or getattr(dataset, "contour", False):
        return None
    items = []
    h0 = w0 = 0
    for i in range(n):
        full = dataset.full_res_item(i)
        if full is None or full["pixel_mask"] is None:
            return None
        m = full["pixel_mask"]
        if m.min() < -128 or m.max() > 127:
            return None
        items.append(full)
        h0 = max(h0, full["image"].shape[0])
        w0 = max(w0, full["image"].shape[1])
    total = n * h0 * w0 * 4
    if max_bytes is not None and total > max_bytes:
        return None
    imgs = np.zeros((n, h0, w0, 3), np.uint8)
    masks = np.zeros((n, h0, w0), np.int8)
    for i, full in enumerate(items):
        hi, wi = full["image"].shape[:2]
        imgs[i, :hi, :wi] = full["image"]
        masks[i, :hi, :wi] = full["pixel_mask"].astype(np.int8)
    return {"imgs": imgs, "masks": masks}


# ---------------------------------------------------------------------------
# Resize by gathers (CPU or CUDA tensors)
# ---------------------------------------------------------------------------

def resize_linear(imgs, idx, iy, iy1, b0, b1, ix, ix1, a0, a1):
    """(B, Ho, Wo, C) uint8: cv2's INTER_LINEAR of ``imgs[idx[b]]`` at the
    taps (``iy``, ``iy1``, ``b0``, ``b1``) x (``ix``, ``ix1``, ``a0``,
    ``a1``) of :func:`resize_vectors`.

    ``imgs`` is (N, H0, W0, C) uint8; the vectors are (B, Ho) and (B, Wo)
    int32.  Only the source rows that the taps name are read."""
    N, H0, W0, C = imgs.shape
    flat = imgs.reshape(N * H0, W0, C)
    base = idx.long()[:, None] * H0
    a0 = a0[:, None, :, None]
    a1 = a1[:, None, :, None]

    def h_pass(rows_at):
        rows = flat[base + rows_at.long()]               # (B, Ho, W0, C)
        left = torch.take_along_dim(rows, ix.long()[:, None, :, None], 2)
        right = torch.take_along_dim(rows, ix1.long()[:, None, :, None], 2)
        return (left.int() * a0 + right.int() * a1) >> 4

    r = (((b0[:, :, None, None] * h_pass(iy)) >> 16)
         + ((b1[:, :, None, None] * h_pass(iy1)) >> 16))
    return ((r + 2) >> 2).to(torch.uint8)


def resize_nearest(masks, idx, ny, nx):
    """(B, Ho, Wo): cv2's INTER_NEAREST of ``masks[idx[b]]`` ((N, H0, W0),
    any dtype) at the source indices ``ny`` (B, Ho) and ``nx`` (B, Wo)."""
    N, H0, W0 = masks.shape
    rows = masks.reshape(N * H0, W0)[idx.long()[:, None] * H0 + ny.long()]
    return torch.take_along_dim(rows, nx.long()[:, None, :], 2)


def apply_resize(cache: dict, batch: dict):
    """(B, Hc, Wc, 3) uint8 image + (B, Hc, Wc) int32 mask from the cache
    (``imgs``, ``masks`` tensors of :func:`build_cache`) and a batch of
    :func:`resize_vectors` (with ``img_idx`` and ``content_hw``), on the
    cache's device: bit-exact to ``cv2.resize`` then
    ``loader.place_on_canvas``, with mask -1 outside the content."""
    idx = batch["img_idx"]
    img = resize_linear(cache["imgs"], idx, batch["rsz_iy"],
                        batch["rsz_iy1"], batch["rsz_b0"], batch["rsz_b1"],
                        batch["rsz_ix"], batch["rsz_ix1"], batch["rsz_a0"],
                        batch["rsz_a1"])
    mask = resize_nearest(cache["masks"], idx, batch["rsz_ny"],
                          batch["rsz_nx"]).to(torch.int32)
    Hc, Wc = mask.shape[1:]
    hw = batch["content_hw"]
    dev = mask.device
    inside = ((torch.arange(Hc, device=dev)[None, :, None]
               < hw[:, 0, None, None])
              & (torch.arange(Wc, device=dev)[None, None, :]
                 < hw[:, 1, None, None]))
    return img, torch.where(inside, mask, -1)


def _one(vectors: dict) -> dict:
    return {k: torch.from_numpy(v)[None] for k, v in vectors.items()}


def resize_img(img: np.ndarray, target_hw) -> np.ndarray:
    """Bilinear (th, tw, 3) uint8, ``cv2.resize(INTER_LINEAR)``'s bytes
    (reference utils/data.py:28-30)."""
    th, tw = int(target_hw[0]), int(target_hw[1])
    v = _one(resize_vectors(img.shape[:2], (th, tw), (th, tw)))
    # np.array copies: the decode cache's arrays are read-only
    out = resize_linear(torch.from_numpy(np.array(img))[None],
                        torch.zeros(1, dtype=torch.int32), v["rsz_iy"],
                        v["rsz_iy1"], v["rsz_b0"], v["rsz_b1"], v["rsz_ix"],
                        v["rsz_ix1"], v["rsz_a0"], v["rsz_a1"])
    return out[0].numpy()


def resize_mask(mask: np.ndarray, target_hw) -> np.ndarray:
    """Nearest (th, tw) resize in the mask's dtype, ``cv2.resize(
    INTER_NEAREST)`` (order=0, reference utils/data.py:24-25)."""
    th, tw = int(target_hw[0]), int(target_hw[1])
    v = _one(resize_vectors(mask.shape[:2], (th, tw), (th, tw)))
    out = resize_nearest(torch.from_numpy(np.array(mask))[None],
                         torch.zeros(1, dtype=torch.int32), v["rsz_ny"],
                         v["rsz_nx"])
    return out[0].numpy()
