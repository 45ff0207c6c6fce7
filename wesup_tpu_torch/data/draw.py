"""Raster drawing in numpy, equal to OpenCV's for what the synthetic gland
generator (``scripts/make_dataset.py``) draws.

The repository's generator (``tests/make_dataset.py``) draws with
``cv2.circle``, ``cv2.fillPoly``, ``cv2.polylines`` and ``cv2.resize``;
the port runs where OpenCV is not installed.  These functions rasterise
as OpenCV does (``imgproc/src/drawing.cpp``, 8-connected lines, 16-bit
fixed point), so that the generator's masks, and with them every random
draw that follows a pixel count, stay the same:

- :func:`circles` — filled ``cv2.circle`` (the midpoint circle's spans),
  clipped at the border; where stamps overlap the later one wins, as
  when they are drawn one after another;
- :func:`fill_poly_mask` — ``cv2.fillPoly`` with ``LINE_8``: the polygon's
  8-connected outline, and the even-odd spans [ceil(x_left),
  floor(x_right)] of its edges stepped in 16.16 fixed point.  An edge with
  an end outside the image takes its x from the clipped segment (its
  rows from the clipped ends where they differ), as OpenCV 5 does;
- :func:`polylines` — closed ``cv2.polylines`` with thickness >= 2: per
  segment the filled quadrilateral ``ThickLine`` builds (16.16 fixed
  point, its outline drawn by the fixed-point line) and a filled disc of
  radius round(thickness / 2) at the segment's end.  Inside the image
  this is OpenCV's raster; a segment that crosses the image border can
  differ from it on a few border pixels (``tests/test_torch_port_draw.py``
  counts them);
- :func:`resize_cubic` — ``cv2.resize(INTER_CUBIC)`` of a float32 grid:
  a = -0.75, OpenCV's source coordinates and float32 weights, replicated
  border; the sums are float32 in a fixed order, so values differ from
  OpenCV's (which may run Intel IPP's resize) only in float rounding.
"""

from __future__ import annotations

import math

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w, h, x1, y1, x2, y2):
    """``cv::clipLine`` to the rectangle [0, w-1] x [0, h-1]: (inside,
    x1, y1, x2, y2), the ends moved onto the border (truncated toward
    zero, each step from the ends already moved)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(h, w, x1, y1, x2, y2):
    """(ys, xs) of OpenCV's 8-connected line (``LineIterator``, left to
    right) from (x1, y1) to (x2, y2), clipped to the image."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    k = np.arange(max(dx, dy) + 1, dtype=np.int64)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    # Bresenham's minor steps after k major steps: the error term starts
    # at major - 2 minor and the minor coordinate moves while it is < 0
    m = -((major - 2 * minor * k) // (2 * major)) if major else k * 0
    if dy > dx:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _spans_mask(h, w, ys, xa, xb):
    """(h, w) bool of the row spans [xa, xb] (clipped, empty where xa > xb)."""
    keep = (xa < w) & (xb >= 0) & (xa <= xb)
    ys, xa, xb = ys[keep], np.maximum(xa[keep], 0), np.minimum(xb[keep], w - 1)
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (ys, xa), 1)
    np.add.at(diff, (ys, xb + 1), -1)
    return np.cumsum(diff[:, :w], axis=1) > 0


# ---------------------------------------------------------------------------
# circles
# ---------------------------------------------------------------------------

def _disc_spans(radius: int):
    """(dy, x_from, x_to) spans of OpenCV's filled midpoint circle."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def _disc_offsets(radius: int):
    """(dy, dx) arrays of the pixels of a filled circle of ``radius``."""
    pix = {(y, x) for y, a, b in _disc_spans(radius) for x in range(a, b + 1)}
    dy, dx = np.array(sorted(pix), np.int64).T
    return dy, dx


def circles(img, centers, radii, colors) -> None:
    """Filled ``cv2.circle(img, (x, y), r, color, -1)`` for each
    ``centers[i] = (x, y)``, ``radii[i]``, ``colors[i]`` in turn, painted
    in one pass: where discs overlap the later one's color stays."""
    h, w = img.shape[:2]
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    radii = np.asarray(radii, np.int64).reshape(-1)
    colors = np.asarray(colors, np.float64).reshape(len(radii), -1)
    pix, who = [], []
    for r in np.unique(radii):
        sel = np.nonzero(radii == r)[0]
        dy, dx = _disc_offsets(int(r))
        ys = centers[sel, 1][:, None] + dy[None]
        xs = centers[sel, 0][:, None] + dx[None]
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        pix.append((ys * w + xs)[ok])
        who.append(np.broadcast_to(sel[:, None], ys.shape)[ok])
    pix, who = np.concatenate(pix), np.concatenate(who)
    # the last disc to cover a pixel is the one whose color stays
    order = np.lexsort((-who, pix))
    first = np.ones(len(order), bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    top = order[first]
    img[pix[top] // w, pix[top] % w] = colors[who[top]].reshape(
        (len(top),) + img.shape[2:])


# ---------------------------------------------------------------------------
# fillPoly
# ---------------------------------------------------------------------------

def fill_poly_mask(h, w, poly) -> np.ndarray:
    """(h, w) bool of the pixels ``cv2.fillPoly(img, [poly], c)`` paints
    (``LINE_8``, shift 0); ``poly`` is (n, 2) int (x, y)."""
    poly = np.asarray(poly, np.int64).reshape(-1, 2)
    out = np.zeros((h, w), bool)
    edges = []
    for i in range(len(poly)):
        x0, y0 = int(poly[i - 1, 0]), int(poly[i - 1, 1])
        x1, y1 = int(poly[i, 0]), int(poly[i, 1])
        ys, xs = _line8(h, w, x0, y0, x1, y1)
        out[ys, xs] = True
        if y0 == y1:
            continue
        c0x, c0y, c1x, c1y = x0 << _SHIFT, y0, x1 << _SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
            if t0y != t1y:
                c0y, c1y = t0y, t1y
            c0x, c1x = t0x << _SHIFT, t1x << _SHIFT
        step = _cdiv(c1x - c0x, c1y - c0y)
        if y0 < y1:
            edges.append((y0, y1, c0x + (y0 - c0y) * step, step))
        else:
            edges.append((y1, y0, c1x + (y1 - c1y) * step, step))
    if len(edges) < 2:
        return out
    e = np.array(edges, np.int64)
    ey0, ey1, ex, estep = e.T
    x_end = ex + (ey1 - ey0) * estep
    if (ey1.max() < 0 or ey0.min() >= h
            or max(ex.max(), x_end.max()) < 0
            or min(ex.min(), x_end.min()) >= (w << _SHIFT)):
        return out
    ys = np.arange(max(int(ey0.min()), 0), min(int(ey1.max()), h),
                   dtype=np.int64)
    if len(ys) == 0:
        return out
    active = (ys[:, None] >= ey0[None]) & (ys[:, None] < ey1[None])
    xs = ex[None] + (ys[:, None] - ey0[None]) * estep[None]
    xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
    n_pairs = active.sum(1) // 2
    pair = np.arange(xs.shape[1] // 2)
    use = pair[None] < n_pairs[:, None]
    left, right = xs[:, 0::2][:, :len(pair)], xs[:, 1::2][:, :len(pair)]
    rows = np.broadcast_to(ys[:, None], use.shape)[use]
    xa = (left[use] + _ONE - 1) >> _SHIFT
    xb = right[use] >> _SHIFT
    return out | _spans_mask(h, w, rows, xa, xb)


# ---------------------------------------------------------------------------
# thick polylines
# ---------------------------------------------------------------------------

def _line_fixed(h, w, x1, y1, x2, y2):
    """(ys, xs) of OpenCV's 16.16 fixed-point line (``Line2``) between two
    fixed-point points, clipped to the image."""
    inside, x1, y1, x2, y2 = _clip_line(w << _SHIFT, h << _SHIFT, x1, y1,
                                        x2, y2)
    if not inside:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _cdiv(dy << _SHIFT, ax | 1)
        count = (x2 - x1) >> _SHIFT
        k = np.arange(count + 1, dtype=np.int64)
        xs = ((x1 + _HALF) >> _SHIFT) + k
        ys = (y1 + _HALF + k * step) >> _SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _cdiv(dx << _SHIFT, ay | 1)
        count = (y2 - y1) >> _SHIFT
        k = np.arange(count + 1, dtype=np.int64)
        ys = ((y1 + _HALF) >> _SHIFT) + k
        xs = (x1 + _HALF + k * step) >> _SHIFT
    ys = np.append(ys, (y2 + _HALF) >> _SHIFT)
    xs = np.append(xs, (x2 + _HALF) >> _SHIFT)
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return ys[ok], xs[ok]


def _fill_convex_fixed(h, w, v, pix, spans):
    """``FillConvexPoly`` of the 16.16 fixed-point polygon ``v`` (shift
    16, ``LINE_8``): appends its outline's pixels to ``pix`` and its rows'
    (y, x_from, x_to) to ``spans``."""
    n = len(v)
    p0 = v[-1]
    imin = min(range(n), key=lambda i: (v[i][1], i))
    for p in v:
        pix.append(_line_fixed(h, w, p0[0], p0[1], p[0], p[1]))
        p0 = p
    xmin = (min(p[0] for p in v) + _HALF) >> _SHIFT
    xmax = (max(p[0] for p in v) + _HALF) >> _SHIFT
    ymin = (v[imin][1] + _HALF) >> _SHIFT
    ymax = (max(p[1] for p in v) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # two edge walkers, forwards and backwards around the polygon
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    left_edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while left_edges > 0:
                    left_edges -= 1
                    ty = (v[idx][1] + _HALF) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
                else:
                    left_edges -= 1
        if left_edges < 0:
            return
        if y >= 0:
            a, b = sorted((edge[0][2], edge[1][2]))
            spans.append((y, (a + _HALF) >> _SHIFT, (b + _HALF) >> _SHIFT))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            return


def polylines_mask(h, w, poly, thickness) -> np.ndarray:
    """(h, w) bool of the pixels ``cv2.polylines(img, [poly], True, c,
    thickness)`` paints, for ``thickness`` >= 2 (``LINE_8``)."""
    if thickness < 2:
        raise ValueError("polylines_mask draws thickness >= 2")
    poly = np.asarray(poly, np.int64).reshape(-1, 2)
    half = thickness << (_SHIFT - 1)
    odd = thickness & 1
    dy_cap, dx_cap = _disc_offsets((half + _HALF) >> _SHIFT)
    pix, spans, caps = [], [], []
    p0 = (int(poly[-1, 0]) << _SHIFT, int(poly[-1, 1]) << _SHIFT)
    for x, y in poly:
        p1 = (int(x) << _SHIFT, int(y) << _SHIFT)
        dx = (p0[0] - p1[0]) / _ONE
        dy = (p1[1] - p0[1]) / _ONE
        r = dx * dx + dy * dy
        if abs(r) > np.finfo(np.float64).eps:
            r = (half + odd * _ONE * 0.5) / math.sqrt(r)
            # cvRound: round half to even
            ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
            quad = [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                    (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)]
            _fill_convex_fixed(h, w, quad, pix, spans)
        caps.append(((p1[1] + _HALF) >> _SHIFT, (p1[0] + _HALF) >> _SHIFT))
        p0 = p1
    out = np.zeros((h, w), bool)
    if spans:
        sy, sa, sb = (np.array(c, np.int64) for c in zip(*spans))
        out |= _spans_mask(h, w, sy, sa, sb)
    for ys, xs in pix:
        out[ys, xs] = True
    cy, cx = np.array(caps, np.int64).T
    ys = (cy[:, None] + dy_cap[None]).ravel()
    xs = (cx[:, None] + dx_cap[None]).ravel()
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    out[ys[ok], xs[ok]] = True
    return out


def polylines(img, poly, color, thickness) -> None:
    """Closed ``cv2.polylines(img, [poly], True, color, thickness)``."""
    img[polylines_mask(img.shape[0], img.shape[1], poly, thickness)] = color


# ---------------------------------------------------------------------------
# cubic resize
# ---------------------------------------------------------------------------

def _cubic_taps(dsize: int, ssize: int):
    """(dsize, 4) source indices and float32 weights of OpenCV's cubic
    resize along one axis (``interpolateCubic``, a = -0.75)."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = f - s
    a = np.float32(-0.75)
    one = np.float32(1)
    f1 = f + one
    c0 = ((a * f1 - np.float32(5) * a) * f1 + np.float32(8) * a) * f1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None],
                  0, ssize - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize_cubic(src, size) -> np.ndarray:
    """``cv2.resize(src, size, interpolation=cv2.INTER_CUBIC)`` of a 2-D
    float32 ``src``; ``size`` is (width, height) as in OpenCV."""
    w, h = size
    src = np.asarray(src, np.float32)
    xi, xc = _cubic_taps(w, src.shape[1])
    yi, yc = _cubic_taps(h, src.shape[0])
    rows = src[:, xi]                                   # (sh, w, 4)
    hz = rows[..., 0] * xc[:, 0]
    for k in range(1, 4):
        hz = hz + rows[..., k] * xc[:, k]
    cols = hz[yi]                                       # (h, 4, w)
    out = cols[:, 0] * yc[:, 0, None]
    for k in range(1, 4):
        out = out + cols[:, k] * yc[:, k, None]
    return out.astype(np.float32)
