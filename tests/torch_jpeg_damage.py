"""Damaged JPEG files for the port's tests and ``chip_smoke.py``: numpy
only (no cv2), so that the card's machine can make the same bytes.

:func:`kinds` makes the undamaged files of one image from a baseline
encoder's bytes (``cv2.imencode(".jpg")``, or ``data/jpeg.encode_plain``,
which writes the same bytes) and the transcodes of
``tests/torch_jpeg_writer.py``: baseline 4:2:0 and gray, a restart
interval of 2, progressive with and without restarts, sequential and
progressive arithmetic coding, lossless gray and RGB.  :func:`damage`
applies one seeded edit to a file's entropy-coded data, as a disk, a
network or a camera damages it:

- ``byte``: one byte replaced by a random one (never 0xFF, never the
  byte after an 0xFF);
- ``bits``: 1-4 bits flipped;
- ``cut``: the file cut in mid-scan; ``cut_eoi``: the same with an EOI
  marker appended;
- ``no_rst``: one restart marker removed; ``swap_rst``: two neighbouring
  restart markers swapped; ``extraneous``: 1-5 random bytes before a
  restart marker (before the marker that ends the scan where the scan has
  none);
- ``marker``: a marker inserted into the scan data: a restart marker, an
  EOI, a COM or a reserved code.

:func:`corpus` draws the damaged files of a seed.
"""

from __future__ import annotations

import numpy as np

import torch_jpeg_writer as writer

DAMAGE = ("byte", "bits", "cut", "cut_eoi", "no_rst", "swap_rst",
          "extraneous", "marker")


def image(hw, seed: int) -> np.ndarray:
    """(H, W, 3) uint8: ramps plus seeded noise, from integer arithmetic."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 127 // max(h + w - 2, 1)], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def kinds(img: np.ndarray, encode, more=None) -> dict:
    """{kind: bytes} of ``img`` (H, W, 3 RGB); ``encode(array)`` is the
    baseline encoder of an (H, W, 3) RGB or (H, W) gray array, and
    ``more`` maps further kinds to their encoders of ``img``."""
    base = encode(img)
    gray = encode(img[..., 0])
    frame = writer.parse(base)
    return {
        "baseline": base,
        "gray": gray,
        "restart2": writer.sequential(writer.parse(base), restart=2),
        "progressive": writer.progressive(frame),
        "progressive_rst": writer.progressive(writer.parse(base), restart=3),
        "arith": writer.arithmetic(writer.parse(base), restart=4),
        "arith_progressive": writer.arithmetic(writer.parse(base), True),
        "lossless_gray": writer.lossless(img[..., 1]),
        "lossless_rgb": writer.lossless([img[..., i] for i in range(3)],
                                        predictor=4, restart_rows=3),
        **{kind: make(img) for kind, make in (more or {}).items()},
    }


def spans(data: bytes):
    """[(start, end)] of each scan's entropy-coded data: from the end of its
    SOS header to the marker (not a restart marker) that ends it."""
    out, n, p = [], len(data), 2
    while p + 3 < n:
        if data[p] != 0xFF or data[p + 1] in (0x00, 0xFF):
            p += 1
            continue
        m = data[p + 1]
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            p += 2
            continue
        length = (data[p + 2] << 8) | data[p + 3]
        p += 2 + length
        if m != 0xDA:
            continue
        q = p
        while q + 1 < n and not (data[q] == 0xFF and data[q + 1] not in (
                0x00, 0xFF) and not 0xD0 <= data[q + 1] <= 0xD7):
            q += 1
        out.append((p, q))
        p = q
    return out


def _rsts(data: bytes, sp):
    return [i for a, b in sp for i in range(a, b - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def damage(data: bytes, how: str, rng: np.random.Generator) -> bytes:
    """``data`` with one edit of kind ``how`` (see the module's doc) at a
    place drawn from ``rng``; a restart edit on a file without restart
    markers replaces a byte instead."""
    sp = [(a, b) for a, b in spans(data) if b - a > 2]
    weights = np.array([b - a for a, b in sp], float)
    a, b = sp[rng.choice(len(sp), p=weights / weights.sum())]
    d = bytearray(data)
    rsts = _rsts(data, sp)
    if how in ("no_rst", "swap_rst") and len(rsts) < 2:
        how = "byte"
    if how == "byte":
        while True:
            i = int(rng.integers(a + 1, b))
            if d[i] != 0xFF and d[i - 1] != 0xFF:
                break
        d[i] = int(rng.choice([v for v in range(255) if v != d[i]]))
    elif how == "bits":
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(a, b))
            d[i] ^= 1 << int(rng.integers(0, 8))
    elif how in ("cut", "cut_eoi"):
        d = d[:int(rng.integers(a + 1, b))]
        if how == "cut_eoi":
            d += b"\xff\xd9"
    elif how == "no_rst":
        i = rsts[int(rng.integers(len(rsts)))]
        del d[i:i + 2]
    elif how == "swap_rst":
        k = int(rng.integers(len(rsts) - 1))
        i, j = rsts[k], rsts[k + 1]
        d[i + 1], d[j + 1] = d[j + 1], d[i + 1]
    elif how == "extraneous":
        i = rsts[int(rng.integers(len(rsts)))] if rsts else b
        junk = rng.integers(0, 255, int(rng.integers(1, 6)))
        d[i:i] = bytes(junk.astype(np.uint8).tolist())
    elif how == "marker":
        while True:
            i = int(rng.integers(a + 1, b))
            if d[i - 1] != 0xFF:
                break
        code = [0xD0 + int(rng.integers(8)), 0xD9, 0xFE,
                int(rng.integers(0x02, 0xC0))][int(rng.integers(4))]
        d[i:i] = bytes([0xFF, code])
    else:
        raise ValueError(f"unknown damage {how!r}")
    return bytes(d)


def corpus(encode, seed: int, n_images: int = 4, per_kind: int = 2,
           sizes=((40, 56), (37, 53)), more=None):
    """[(name, bytes)]: every kind of ``n_images`` seeded images, each
    damaged ``per_kind`` times by every edit of :data:`DAMAGE`; names are
    ``seed_image_kind_damage_index``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_images):
        img = image(sizes[k % len(sizes)], seed * 1000 + k)
        for kind, data in kinds(img, encode, more).items():
            for how in DAMAGE:
                for j in range(per_kind):
                    out.append((f"{seed}_{k}_{kind}_{how}_{j}",
                                damage(data, how, rng)))
    return out


def sweep(seeds, tail: int = 24) -> dict:
    """The library's four reads of each seed's corpus (2 images a seed,
    each kind damaged once by each edit) and of every EOI-less cut within
    ``tail`` bytes of the end of each undamaged file of 4 larger images
    (where ``cv2.imdecode``'s suspension depends on the bit reader's
    fills), against cv2's: {"reads": n, "files": n, "cuts": n,
    "mismatches": [...]}."""
    import tempfile
    from pathlib import Path

    import cv2

    from wesup_tpu_torch import native

    def enc(a, *flags):
        return cv2.imencode(".jpg", a[..., ::-1] if a.ndim == 3 else a,
                            list(flags))[1].tobytes()

    path = Path(tempfile.mkdtemp()) / "f.jpg"
    out = {"reads": 0, "files": 0, "cuts": 0, "mismatches": []}

    def check(name, data, files=(False, True)):
        path.write_bytes(data)
        for gray in (False, True):
            flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
            for file in files:
                want = (cv2.imread(str(path), flag) if file else
                        cv2.imdecode(np.frombuffer(data, np.uint8), flag))
                if want is not None and not gray:
                    want = want[..., ::-1]
                try:
                    got = native.jpeg_decode(data, gray, file)
                except ValueError:
                    got = None
                out["reads"] += 1
                if (want is None) != (got is None) or (
                        want is not None and not np.array_equal(want, got)):
                    out["mismatches"].append((name, gray, file))

    for seed in seeds:
        for name, data in corpus(enc, seed, n_images=2, per_kind=1):
            out["files"] += 1
            check(name, data)
    more = {"rst1": lambda i: enc(i, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)}
    for k, hw in enumerate([(200, 300), (64, 64), (97, 131), (400, 240)]):
        for kind, data in kinds(image(hw, k), enc, more).items():
            body = data[:-2]
            for cut in range(len(body) - tail, len(body) + 1):
                out["cuts"] += 1
                check(f"{kind}_{hw}_cut{cut}", body[:cut], files=(False,))
    return out


if __name__ == "__main__":
    # python tests/torch_jpeg_damage.py [first_seed last_seed]: the sweep
    # against cv2 (needs OpenCV)
    import json
    import sys

    lo, hi = (int(v) for v in (sys.argv[1:3] or (60, 200)))
    res = sweep(range(lo, hi))
    print(json.dumps({**res, "mismatches": res["mismatches"][:20],
                      "n_mismatches": len(res["mismatches"])}))
