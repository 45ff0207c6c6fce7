"""Multi-epoch quality head-to-head: the port's training math against a
torch replica of the original reference's, on the card.

Port of ``scripts/quality_headtohead.py``, with the same flags (plus
``--device``) and output.  The reference itself cannot run here
(torchvision / skimage / albumentations are absent), so the evidence for
the north star "within 0.5% of the reference" is a controlled
head-to-head against the replica of the reference's training math
(``scripts/_reference_replica.py``, a copy of the JAX package's test
replica).

Controls, both sides see the same inputs:
  * the same initial weights: JAX's ``init_params(PRNGKey(1))``, drawn
    without JAX (``models/jax_init.init_params(1)``), the replica gets a
    copy;
  * the same superpixels: the port's stride-1 SLIC, once per image,
    shared;
  * the same point labels and majority-vote superpixel stats;
  * the reference's hyperparameters: SGD(lr=5e-5, momentum=0.9,
    wd=1e-3), loss = CE + 0.5 * propagation-CE at threshold 0.8,
    unweighted CE (the reference's real wiring, models/wesup.py:434,
    445-451, 514);
  * a fixed epoch order and no augmentation.

The port's side is what its trainer runs: ``forward_superpixel`` at its
default pooling (``"adjoint"``: kernels K5 and K6 forward, K8 and K3's
``segment_sum_bwd`` backward on the card) in f32, ``objectives.
wesup_loss`` and ``torch.optim.SGD``.  torch's SGD with weight decay and
momentum (dampening 0, its first momentum buffer the first gradient)
equals the JAX script's ``optax.chain(add_decayed_weights(wd),
trace(momentum), scale(-lr))``.  Both sides run in strict f32: TF32 is off
for matmuls and cuDNN during the run, and the previous settings come back
after it.

What is NOT controlled: floating-point op order (the port's kernels vs
the replica's dense ops).  Once fc3 features spread, the 0.8 propagation
threshold becomes a discrete branch whose flips amplify ulp noise, so the
acceptance is statistical: final val Dice within 0.5% (plus loss
agreement along the run).  ``--self-chaos`` measures that noise: the
replica against itself, one copy's weights scaled by (1 + 1e-7).

The tool runs in one process, on the card unless ``--device cpu`` asks
for the host, and never falls back.  Without ``--root`` it writes the
synthetic dataset (``scripts/make_dataset.py``, seed 0) into a temporary
directory.  ``--out`` defaults to ``torch_headtohead.json`` in the
temporary directory (``$TMPDIR``).

Usage:
    python -m wesup_tpu_torch.scripts.quality_headtohead [--epochs 60]
        [--eval-every 5] [--out FILE.json] [--self-chaos] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SP_AREA = 200
LR, MOMENTUM, WD = 5e-5, 0.9, 1e-3
THRESHOLD, PROP_WEIGHT = 0.8, 0.5
CLASS_WEIGHTS = None  # --weighted sets (3, 1), the reference's written
                      # weights (models/wesup.py:434); both sides use it


def load_split(root, split, with_points):
    """[(img f32 [0,1], mask (H,W) u8, point_onehot (H,W,2) or None)]."""
    from wesup_tpu_torch.data import codec

    items = []
    img_dir = Path(root) / split / "images"
    for img_path in sorted(img_dir.iterdir()):
        img = codec.imread_rgb(img_path)
        mask = codec.imread_mask(Path(root) / split / "masks" / img_path.name)
        pts = None
        if with_points:
            pts = np.zeros((*mask.shape, 2), np.float32)
            csv_path = Path(root) / split / "points" / f"{img_path.stem}.csv"
            for line in csv_path.read_text().splitlines():
                x, y, c = (int(v) for v in line.split(","))
                pts[y, x, c] = 1.0
        items.append((img.astype(np.float32) / 255.0, mask, pts))
    return items


def prepare_problems(items, K, device):
    """Shared per-image SLIC + superpixel label stats (both sides use
    these), as numpy arrays."""
    from wesup_tpu_torch.ops.segments import superpixel_stats
    from wesup_tpu_torch.ops.slic import slic

    out = []
    for img, mask, pts in items:
        x = torch.from_numpy(img).to(device)[None]
        seg = slic(x, sp_area=SP_AREA, update_stride=1)
        sup = None if pts is None else torch.from_numpy(pts).to(device)[None]
        stats = superpixel_stats(seg, K, sup)
        out.append({
            "img": img, "mask": mask, "seg": seg[0].cpu().numpy(),
            "labels": stats.labels[0].cpu().numpy(),
            "labeled": stats.labeled[0].cpu().numpy(),
            "real": stats.real[0].cpu().numpy(),
        })
    return out


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and cuDNN; the previous settings restored."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def make_ours(state, K, device):
    from wesup_tpu_torch.models import wesup
    from wesup_tpu_torch.models.objectives import wesup_loss

    model = wesup.empty(device)
    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM,
                          weight_decay=WD)

    def prep(prob):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
        return {"img": t(prob["img"])[None], "seg": t(prob["seg"])[None],
                "labels": t(prob["labels"])[None],
                "labeled": t(prob["labeled"])[None],
                "real": t(prob["real"])[None]}

    def train_step(p):
        opt.zero_grad(set_to_none=True)
        out = wesup.forward_superpixel(model, p["img"], p["seg"], K)
        loss = wesup_loss(out.sp_pred, out.sp_features, p["labels"],
                          p["labeled"], p["real"],
                          class_weights=CLASS_WEIGHTS,
                          propagate_threshold=THRESHOLD,
                          propagate_weight=PROP_WEIGHT)
        loss.loss.sum().backward()
        opt.step()
        return (float(loss.loss[0].detach()),
                float(loss.propagated_labels[0].detach()))

    def predict(p):
        with torch.no_grad():
            out = wesup.forward_superpixel(model, p["img"], p["seg"], K)
        return out.pred[0].cpu().numpy()

    return model, prep, train_step, predict


# ---------------------------------------------------------------------------
# the replica's side
# ---------------------------------------------------------------------------

def make_torch(state, device):
    from wesup_tpu_torch.scripts._reference_replica import (
        ReferenceWESUP, copy_weights, propagate, semi_ce)

    tmodel = ReferenceWESUP()
    copy_weights(state, tmodel)
    tmodel.to(device)
    opt = torch.optim.SGD(tmodel.parameters(), lr=LR, momentum=MOMENTUM,
                          weight_decay=WD)

    def prep(prob, K):
        oh = np.zeros((prob["seg"].size, K), np.float32)
        oh[np.arange(prob["seg"].size), prob["seg"].reshape(-1)] = 1.0
        sp_maps = torch.from_numpy(
            (oh.T / np.maximum(oh.sum(0)[:, None], 1.0)).astype(np.float32))
        labeled = prob["labeled"]
        order = np.concatenate([np.where(labeled)[0], np.where(~labeled)[0]])
        y_l = torch.from_numpy(prob["labels"][labeled])
        xt = torch.from_numpy(prob["img"]).permute(2, 0, 1)[None]
        return {"sp_maps": sp_maps.to(device),
                "order": torch.from_numpy(order).to(device),
                "y_l": y_l.to(device), "xt": xt.to(device),
                "seg": prob["seg"]}

    def train_step(tp):
        opt.zero_grad()
        sp_pred, sp_feats = tmodel(tp["xt"], tp["sp_maps"])
        pred_ord, feats_ord = sp_pred[tp["order"]], sp_feats[tp["order"]]
        n_l = len(tp["y_l"])
        ce = semi_ce(pred_ord[:n_l], tp["y_l"], CLASS_WEIGHTS)
        y_u = propagate(feats_ord.detach(), tp["y_l"], THRESHOLD)
        pce = semi_ce(pred_ord[n_l:], y_u, CLASS_WEIGHTS)
        loss = ce + PROP_WEIGHT * pce
        loss.backward()
        opt.step()
        return float(loss.detach()), float(y_u.sum())

    def predict(tp):
        with torch.no_grad():
            sp_pred, _ = tmodel(tp["xt"], tp["sp_maps"])
        return sp_pred[:, 1].cpu().numpy()[tp["seg"]]

    return tmodel, prep, train_step, predict


def dice(pred_bin, gt_bin):
    inter = float(np.logical_and(pred_bin, gt_bin).sum())
    total = float(pred_bin.sum() + gt_bin.sum())
    return 2.0 * inter / total if total else 1.0


def _problems(root, device, log, tag):
    from wesup_tpu_torch.ops.slic import n_clusters

    train_items = load_split(root, "train", with_points=True)
    val_items = load_split(root, "val", with_points=False)
    H, W = train_items[0][0].shape[:2]
    K = n_clusters(H, W, SP_AREA)
    log(f"[{tag}] {len(train_items)} train / {len(val_items)} val images, "
        f"{H}x{W}, K={K}, weights={CLASS_WEIGHTS}, device {device}")
    return (prepare_problems(train_items, K, device),
            prepare_problems(val_items, K, device), H, W, K)


def run(root, epochs, eval_every, log=print, device=None, seconds=None):
    """(the JAX script's ``final`` dict, the port's model).  ``seconds``,
    if given, gets each side's training seconds ("ours", "torch")."""
    from wesup_tpu_torch.models import jax_init
    from wesup_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    torch.manual_seed(0)
    with strict_f32():
        train_probs, val_probs, H, W, K = _problems(root, device, log, "h2h")
        state = jax_init.init_params(1)     # JAX's init_params(PRNGKey(1))
        model, oprep, our_step, our_predict = make_ours(state, K, device)
        ot = [oprep(p) for p in train_probs]
        ov = [oprep(p) for p in val_probs]
        _, tprep, torch_step, torch_predict = make_torch(state, device)
        tt = [tprep(p, K) for p in train_probs]
        tv = [tprep(p, K) for p in val_probs]

        def eval_dice():
            ours, theirs = [], []
            for p, op, tp in zip(val_probs, ov, tv):
                po = our_predict(op)
                ours.append(dice(np.round(po) > 0, p["mask"] > 0))
                pt = torch_predict(tp)
                theirs.append(dice(np.round(pt) > 0, p["mask"] > 0))
            return float(np.mean(ours)), float(np.mean(theirs))

        hist = {"epoch": [], "ours_dice": [], "torch_dice": [],
                "ours_loss": [], "torch_loss": [],
                "ours_prop": [], "torch_prop": []}
        sec = {"ours": 0.0, "torch": 0.0}
        t0 = time.time()
        for epoch in range(1, epochs + 1):
            ol, tl, op_, tpn = [], [], [], []
            for i in range(len(train_probs)):
                t1 = time.perf_counter()
                loss, n_prop = our_step(ot[i])
                t2 = time.perf_counter()
                l2, np2 = torch_step(tt[i])
                sec["ours"] += t2 - t1
                sec["torch"] += time.perf_counter() - t2
                ol.append(loss)
                tl.append(l2)
                op_.append(n_prop)
                tpn.append(np2)
            if epoch % eval_every == 0 or epoch == epochs:
                do, dt = eval_dice()
                hist["epoch"].append(epoch)
                hist["ours_dice"].append(do)
                hist["torch_dice"].append(dt)
                hist["ours_loss"].append(float(np.mean(ol)))
                hist["torch_loss"].append(float(np.mean(tl)))
                hist["ours_prop"].append(float(np.mean(op_)))
                hist["torch_prop"].append(float(np.mean(tpn)))
                log(f"[h2h] epoch {epoch:3d}  loss {np.mean(ol):.4f}/"
                    f"{np.mean(tl):.4f}  val-dice {do:.4f}/{dt:.4f}  "
                    f"prop {np.mean(op_):.1f}/{np.mean(tpn):.1f}  "
                    f"({time.time() - t0:.0f}s)")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if seconds is not None:
        seconds.update(sec)
    final = {
        "ours_final_dice": hist["ours_dice"][-1],
        "torch_final_dice": hist["torch_dice"][-1],
        "dice_delta": abs(hist["ours_dice"][-1] - hist["torch_dice"][-1]),
        "loss_mae": float(np.mean(np.abs(
            np.array(hist["ours_loss"]) - np.array(hist["torch_loss"])))),
        "epochs": epochs, "K": K, "hw": [H, W],
        "n_train": len(train_probs), "n_val": len(val_probs),
        "history": hist,
    }
    return final, model


def run_self_chaos(root, epochs, eval_every, log=print, device=None):
    """Control experiment: the SAME replica trained twice, one copy's
    init scaled by (1 + 1e-7), about one f32 ulp.  Any trajectory
    divergence here comes from the training dynamics alone (the
    propagation threshold is a discrete branch; class weights steepen the
    transition), with no difference of implementation.  This bounds how
    much port-vs-replica divergence the dynamics themselves explain."""
    from wesup_tpu_torch.models import jax_init
    from wesup_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    torch.manual_seed(0)
    with strict_f32():
        train_probs, val_probs, _, _, K = _problems(root, device, log,
                                                    "chaos")
        state = jax_init.init_params(1)     # JAX's init_params(PRNGKey(1))
        state_b = {k: v * (1.0 + 1e-7) for k, v in state.items()}
        _, prep, stepA, predictA = make_torch(state, device)
        _, _, stepB, predictB = make_torch(state_b, device)
        tt = [prep(p, K) for p in train_probs]
        tv = [prep(p, K) for p in val_probs]

        hist = {"epoch": [], "a_dice": [], "b_dice": [],
                "a_loss": [], "b_loss": []}
        t0 = time.time()
        for epoch in range(1, epochs + 1):
            la, lb = [], []
            for tp in tt:
                la.append(stepA(tp)[0])
                lb.append(stepB(tp)[0])
            if epoch % eval_every == 0 or epoch == epochs:
                da = float(np.mean([
                    dice(np.round(predictA(tp)) > 0, p["mask"] > 0)
                    for p, tp in zip(val_probs, tv)]))
                db = float(np.mean([
                    dice(np.round(predictB(tp)) > 0, p["mask"] > 0)
                    for p, tp in zip(val_probs, tv)]))
                hist["epoch"].append(epoch)
                hist["a_dice"].append(da)
                hist["b_dice"].append(db)
                hist["a_loss"].append(float(np.mean(la)))
                hist["b_loss"].append(float(np.mean(lb)))
                log(f"[chaos] epoch {epoch:3d}  loss {np.mean(la):.4f}/"
                    f"{np.mean(lb):.4f}  val-dice {da:.4f}/{db:.4f}  "
                    f"({time.time() - t0:.0f}s)")
    return {
        "final_a_dice": hist["a_dice"][-1],
        "final_b_dice": hist["b_dice"][-1],
        "dice_delta": abs(hist["a_dice"][-1] - hist["b_dice"][-1]),
        "max_traj_delta": float(max(abs(a - b) for a, b in
                                    zip(hist["a_dice"], hist["b_dice"]))),
        "epochs": epochs, "weights": CLASS_WEIGHTS, "history": hist,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="dataset root (default: synth into a temp dir)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=12)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--out", default=None,
                    help="default: torch_headtohead.json in $TMPDIR")
    ap.add_argument("--weighted", action="store_true",
                    help="use the reference's written (3,1) class weights "
                         "on BOTH sides (earlier Dice breakthrough)")
    ap.add_argument("--self-chaos", action="store_true",
                    help="control: the replica vs itself with a 1-ulp "
                         "init perturbation (no cross-framework diff)")
    ap.add_argument("--lr", type=float, default=None,
                    help="override SGD lr on BOTH sides")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs on the host")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = str(Path(tempfile.gettempdir()) / "torch_headtohead.json")
    return args


def main(argv=None):
    global CLASS_WEIGHTS, LR
    args = parse_args(argv)
    if args.weighted:
        CLASS_WEIGHTS = (3, 1)
    if args.lr is not None:
        LR = args.lr

    root = args.root
    if root is None:
        from wesup_tpu_torch.scripts.make_dataset import make_dataset

        root = tempfile.mkdtemp(prefix="torch_h2h_")
        make_dataset(root, n_train=args.n_train, n_val=args.n_val,
                     hw=tuple(args.hw), seed=0)

    if args.self_chaos:
        final = run_self_chaos(root, args.epochs, args.eval_every,
                               device=args.device)
        Path(args.out).write_text(json.dumps(final, indent=2))
        print(f"[chaos] final dice A={final['final_a_dice']:.4f} "
              f"B={final['final_b_dice']:.4f} "
              f"delta={final['dice_delta']:.4f} "
              f"max-traj-delta={final['max_traj_delta']:.4f} -> {args.out}")
        return final

    final, _ = run(root, args.epochs, args.eval_every, device=args.device)
    Path(args.out).write_text(json.dumps(final, indent=2))
    print(f"[h2h] final dice ours={final['ours_final_dice']:.4f} "
          f"torch={final['torch_final_dice']:.4f} "
          f"delta={final['dice_delta']:.4f} -> {args.out}")
    return final


if __name__ == "__main__":
    main()
