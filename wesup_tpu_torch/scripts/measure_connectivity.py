"""Quantify the missing SLIC connectivity pass, on the port.

Port of ``scripts/measure_connectivity.py`` (VERDICT r4 #6).  The
reference runs skimage SLIC with ``enforce_connectivity=True``: after
k-means, connected components smaller than ``min_size_factor * (H*W/K)``
are merged into an adjacent segment.  The on-device SLIC (``ops/slic``)
has no such pass, and the superpixel-oracle probe cannot see
fragmentation: a superpixel split into disconnected islands changes the
propagation graph (feature means over non-contiguous regions) without
moving the oracle.  On hard-protocol images this script measures:

1. islands-per-superpixel statistics of the production seg (4-connected
   components per label, cropped to per-label bounding boxes);
2. an A/B of the model's outputs: ``forward_superpixel`` with that seg
   and with the same seg after a host connectivity-enforcement pass
   (non-primary islands merged into the dominant adjacent label),
   comparing painted predictions and per-image Dice against ground truth.

As in the JAX script, the forward runs ``pooling="adjoint"`` in bf16
(kernels K5 and K6 on the card): the enforced seg no longer keeps each
superpixel in its SLIC cell's window, which the "local" pooling's plan
assumes.  The images are made by the port's ``scripts/make_dataset.py``
and read by ``data/codec.py``; no OpenCV, no JAX.

Usage:
    python -m wesup_tpu_torch.scripts.measure_connectivity [--n 16]
        [--ckpt RECORD_DIR] [--device cpu] [--out F] [--root DIR]
        [--hw 522 775]

Without ``--ckpt`` it uses the JAX script's fresh init,
``init_params(PRNGKey(0))`` (``models/jax_init.py``): prediction deltas
between the two segs are still meaningful; absolute Dice is not and is
omitted.  ``--ckpt`` takes a record dir with ``checkpoints/ckpt.*.pth``
(or a JAX trainer's ``.msgpack``).  ``--out`` defaults to
``torch_connectivity.json`` and ``--root`` (the dataset) to
``connectivity_ds``, both in the temporary directory.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def island_stats(seg: np.ndarray, sp_area: int):
    """Per-label 4-connected component stats for one (H, W) int seg."""
    from scipy import ndimage

    H, W = seg.shape
    labels = np.unique(seg)
    min_size = 0.5 * sp_area  # skimage min_size_factor=0.5 * (H*W/K)
    n_frag = n_total = 0
    stray_px = 0
    big_islands = 0
    comps_per_label = []
    slices = ndimage.find_objects(seg + 1)
    s4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for lab in labels:
        sl = slices[lab]
        if sl is None:
            continue
        m = seg[sl] == lab
        cc, n = ndimage.label(m, structure=s4)
        n_total += 1
        comps_per_label.append(n)
        if n > 1:
            n_frag += 1
            sizes = np.bincount(cc.ravel())[1:]
            order = np.argsort(sizes)[::-1]
            stray_px += int(sizes[order[1:]].sum())
            big_islands += int((sizes[order[1:]] >= min_size).sum())
    return {
        "n_superpixels": n_total,
        "fragmented": n_frag,
        "fragmented_pct": round(100.0 * n_frag / max(n_total, 1), 2),
        "stray_pixels": stray_px,
        "stray_pixel_pct": round(100.0 * stray_px / seg.size, 4),
        "mean_components": round(float(np.mean(comps_per_label)), 4),
        "max_components": int(np.max(comps_per_label)),
        "islands_above_skimage_min_size": big_islands,
    }


def enforce_connectivity(seg: np.ndarray) -> np.ndarray:
    """Merge every non-primary island into the dominant adjacent label.

    Static-K analogue of skimage's _enforce_label_connectivity: fragments
    are absorbed by a neighboring segment (skimage would promote
    >=min_size fragments to NEW labels, which a static-K pipeline cannot
    represent; island_stats reports how often that case occurs)."""
    from scipy import ndimage

    out = seg.copy()
    s4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    slices = ndimage.find_objects(seg + 1)
    for lab in np.unique(seg):
        sl = slices[lab]
        if sl is None:
            continue
        m = out[sl] == lab
        cc, n = ndimage.label(m, structure=s4)
        if n <= 1:
            continue
        sizes = np.bincount(cc.ravel())[1:]
        keep = int(np.argmax(sizes)) + 1
        for c in range(1, n + 1):
            if c == keep:
                continue
            island = cc == c
            ring = ndimage.binary_dilation(island, structure=s4) & ~island
            neigh = out[sl][ring]
            neigh = neigh[neigh != lab]
            if neigh.size == 0:  # island enclosed by its own label: keep
                continue
            vals, counts = np.unique(neigh, return_counts=True)
            out[sl][island] = vals[np.argmax(counts)]
    return out


def _load_model(ckpt_dir, device):
    """(model, trained): the last checkpoint of ``ckpt_dir``, or the JAX
    script's fresh init."""
    import torch

    from ..models import convert, jax_init, wesup

    model = wesup.empty(device)
    if not ckpt_dir:
        model.load_state_dict(jax_init.init_params(0))
        return model.eval(), False
    ckpts = sorted(Path(ckpt_dir).glob("checkpoints/ckpt.*"))
    assert ckpts, f"no checkpoints under {ckpt_dir}"
    if ckpts[-1].suffix == ".pth":
        state = torch.load(ckpts[-1], map_location="cpu",
                           weights_only=True)["model_state_dict"]
    else:
        _, state, _ = convert.load_jax_checkpoint(ckpts[-1])
    model.load_state_dict(state)
    print(f"[ckpt] {ckpts[-1]}", file=sys.stderr)
    return model.eval(), True


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--ckpt", default=None,
                    help="record dir with checkpoints/ckpt.*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--sp-area", type=int, default=200)
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir())
                                         / "torch_connectivity.json"))
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir())
                                          / "connectivity_ds"))
    ap.add_argument("--hw", type=int, nargs=2, default=(522, 775),
                    help="the images' size (default GlaS's)")
    return ap.parse_args(argv)


def run(args):
    """(report, segs, preds): the report the script writes, each image's
    production seg (the card's or the CPU's), and each image's pair of
    foreground-probability maps ``(pa, pb)``, with the production seg and
    with the enforced one, cropped to the image."""
    import torch

    from ..config import WESUPConfig
    from ..data import codec
    from ..models import wesup
    from ..ops.slic import n_clusters, slic
    from ..ops.train_resize import resize_img, resize_mask
    from ..runtime import resolve_device
    from .make_dataset import make_dataset

    dev = resolve_device(args.device)
    root = Path(args.root)
    if not (root / "val" / "images").exists():
        make_dataset(root, n_train=1, n_val=args.n, hw=tuple(args.hw), seed=7,
                     hard=True)

    config = WESUPConfig(sp_area=args.sp_area)
    model, trained = _load_model(args.ckpt, dev)

    img_paths = sorted((root / "val" / "images").iterdir())[:args.n]
    mask_paths = sorted((root / "val" / "masks").iterdir())[:args.n]

    # one fixed canvas for all (same-size synthetic images)
    im0 = codec.imread_rgb(img_paths[0])
    th, tw = (int(np.ceil(args.scale * im0.shape[0])),
              int(np.ceil(args.scale * im0.shape[1])))
    Hc, Wc = ((th + 31) // 32) * 32, ((tw + 31) // 32) * 32
    K = n_clusters(Hc, Wc, args.sp_area)

    @torch.inference_mode()
    def seg_of(image_u8, valid):
        img = image_u8.to(torch.float32) / 255.0
        return slic(img, valid, sp_area=config.sp_area,
                    compactness=config.sp_compactness,
                    n_iters=config.slic_iters,
                    update_stride=config.slic_update_stride)

    @torch.inference_mode()
    def pred_with_seg(image_u8, valid, seg):
        img = image_u8.to(torch.float32) / 255.0
        out = wesup.forward_superpixel(model, img, seg, K, valid,
                                       torch.bfloat16, pooling="adjoint",
                                       plan=None)
        return out.pred

    def dice(pred, mask):
        p = pred > 0.5
        m = mask > 0
        return 2.0 * (p & m).sum() / max(p.sum() + m.sum(), 1)

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    report = {"n": args.n, "scale": args.scale, "sp_area": args.sp_area,
              "canvas": [Hc, Wc], "K": K, "trained": trained, "images": []}
    segs, preds = [], []
    t0 = time.time()
    for ip, mp in zip(img_paths, mask_paths):
        img = resize_img(codec.imread_rgb(ip), (th, tw))
        mask = resize_mask(codec.imread_mask(mp), (th, tw))
        canvas = np.zeros((Hc, Wc, 3), np.uint8)
        canvas[:th, :tw] = img
        canvas[:th, tw:] = img[:, -1:]
        canvas[th:] = canvas[th - 1:th]
        valid = np.zeros((Hc, Wc), bool)
        valid[:th, :tw] = True

        image_d, valid_d = on_dev(canvas[None]), on_dev(valid[None])
        seg = seg_of(image_d, valid_d)[0].cpu().numpy()
        segs.append(seg)
        stats = island_stats(seg[:th, :tw], args.sp_area)
        seg_enf = seg.copy()
        seg_enf[:th, :tw] = enforce_connectivity(seg[:th, :tw])

        pa, pb = (pred_with_seg(image_d, valid_d, on_dev(s[None]))[
            0, :th, :tw].float().cpu().numpy() for s in (seg, seg_enf))
        preds.append((pa, pb))
        entry = {
            **stats,
            "pred_changed_px_pct": round(
                100.0 * float(np.mean((pa > 0.5) != (pb > 0.5))), 4),
            "pred_mean_abs_delta": round(float(np.abs(pa - pb).mean()), 6),
        }
        if trained:
            entry["dice_ours"] = round(float(dice(pa, mask)), 5)
            entry["dice_enforced"] = round(float(dice(pb, mask)), 5)
        report["images"].append(entry)
        print(f"[{ip.name}] {entry}", file=sys.stderr, flush=True)

    agg = {}
    for k in report["images"][0]:
        agg[k] = round(float(np.mean([im[k] for im in report["images"]])), 5)
    report["mean"] = agg
    report["wall_s"] = round(time.time() - t0, 1)
    return report, segs, preds


def main(argv=None):
    args = parse_args(argv)
    report, _, _ = run(args)
    Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps({"mean": report["mean"], "out": args.out}))
    return report


if __name__ == "__main__":
    main()
