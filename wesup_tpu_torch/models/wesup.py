"""WESUP: VGG16 hypercolumn -> superpixel MLP classifier, in PyTorch.

Port of ``wesup_tpu.models.wesup`` (superpixel forward with
``pooling="local"``).  The parameters live in :class:`WESUP`, an
``nn.Module`` whose state-dict keys are the reference's (``backbone.{i}``,
``side_conv{cum}``, ``fc_layers.{0,2,4}``, ``classifier.0``), so a
reference ``.pth`` loads with ``load_state_dict``.

The forward is the JAX package's exact refactor of the reference: side
conv and the fc1 block of each tap fold into one projection per resolution
stage, pooling commutes with it, so every stage is pooled at its NATIVE
resolution and projected after pooling.  Stage 0 (full resolution) pools
with kernel K1 through the segment ids (invalid pixels masked as seg=-1);
stages 1-4 pool with kernel K2 through the adjoint window weights built
from the validity-weighted offset masks (``ops/cellpool.py``).

bf16 casts follow the reference: taps are in the compute dtype, pooled
sums are f32 and are cast to the compute dtype before the projection (the
product then accumulates in f32), projections are built in f32 and cast,
the head runs in its input's dtype (f32 here, as the pooled features are
f32) with the softmax in f32, and ``pred`` is painted in the compute dtype
and returned as f32.
"""

from __future__ import annotations

from typing import List, NamedTuple

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cellgrid, cellpool
from . import vgg

D_DEFAULT = 32


def _side_conv_names() -> List[str]:
    """Reference names of the 13 side convs: cumulative half-channel offset."""
    names, cum = [], 0
    for c in vgg.CONV_CHANNELS:
        names.append(f"side_conv{cum}")
        cum += c // 2
    return names


class WESUP(nn.Module):
    """The WESUP parameters under the reference's module names.

    Weights are drawn from ``generator`` (He-normal backbone, zero conv
    biases, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for side convs and
    linear layers, as ``wesup_tpu.models.wesup.init_params``)."""

    def __init__(self, n_classes: int = 2, D: int = D_DEFAULT,
                 fc_width: int = 1024, generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = vgg.make_backbone()
        for name, c in zip(_side_conv_names(), vgg.CONV_CHANNELS):
            setattr(self, name, nn.Conv2d(c, c // 2, 1))
        self.fc_layers = nn.Sequential(
            nn.Linear(vgg.FM_CHANNELS_SUM, fc_width), nn.ReLU(),
            nn.Linear(fc_width, fc_width), nn.ReLU(),
            nn.Linear(fc_width, D), nn.ReLU())
        self.classifier = nn.Sequential(nn.Linear(D, n_classes),
                                        nn.Softmax(dim=1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def side_convs(self) -> List[nn.Conv2d]:
        return [getattr(self, name) for name in _side_conv_names()]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        vgg.init_backbone_(self.backbone, generator)
        linears = self.side_convs() + [self.fc_layers[0], self.fc_layers[2],
                                       self.fc_layers[4], self.classifier[0]]
        for layer in linears:
            fan_in = layer.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)


# ---------------------------------------------------------------------------
# Forward pieces (the JAX package's names)
# ---------------------------------------------------------------------------

def _fc1_blocks(model: WESUP) -> List[torch.Tensor]:
    """fc1's weight as 13 per-conv (C_i // 2, fc_width) blocks, in the JAX
    (in, out) layout."""
    w1 = model.fc_layers[0].weight.t()                     # (2112, width)
    blocks, off = [], 0
    for c in vgg.CONV_CHANNELS:
        blocks.append(w1[off:off + c // 2])
        off += c // 2
    return blocks


def _side_weight(conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 side conv as an (in, out) matrix."""
    return conv.weight[:, :, 0, 0].t()


def _stage_taps_and_proj(model: WESUP, taps, w1_blocks, s: int,
                         compute_dtype):
    """Concatenated (B, Hs, Ws, sum C_i) taps of resolution stage ``s`` and
    the fused (side conv x fc1-block) projection for them, built in f32 and
    cast to the compute dtype."""
    idxs = [i for i, st in enumerate(vgg.CONV_STAGE) if st == s]
    stage_taps = torch.cat([taps[i] for i in idxs], dim=-1)
    sides = model.side_convs()
    proj = torch.cat([_side_weight(sides[i]).float() @ w1_blocks[i].float()
                      for i in idxs], dim=0).to(compute_dtype)
    return stage_taps, proj


def _fused_bias(model: WESUP, w1_blocks) -> torch.Tensor:
    """fc1 bias + every side-conv bias pushed through its fc1 block."""
    bias = model.fc_layers[0].bias.float()
    for conv, block in zip(model.side_convs(), w1_blocks):
        bias = bias + conv.bias.float() @ block.float()
    return bias


def _mlp_head(model: WESUP, x: torch.Tensor):
    """ReLU -> fc2 -> ReLU -> fc3 -> ReLU -> classifier softmax, in x's dtype
    with the softmax in f32.  Returns (probs, f32 fc3 features)."""
    dt = x.dtype
    fc2, fc3, cls = model.fc_layers[2], model.fc_layers[4], model.classifier[0]
    h = F.relu(x)
    h = F.relu(h @ fc2.weight.t().to(dt) + fc2.bias.to(dt))
    feats = F.relu(h @ fc3.weight.t().to(dt) + fc3.bias.to(dt))
    logits = feats @ cls.weight.t().to(dt) + cls.bias.to(dt)
    probs = torch.softmax(logits.float(), dim=-1)
    return probs, feats.float()


class SuperpixelForward(NamedTuple):
    sp_pred: torch.Tensor      # (B, K, C) softmax probabilities
    sp_features: torch.Tensor  # (B, K, D) propagation features
    pred: torch.Tensor         # (B, H, W) foreground-probability map


def forward_superpixel(model: WESUP, img: torch.Tensor, seg: torch.Tensor,
                       K: int, valid: torch.Tensor | None = None,
                       compute_dtype=torch.float32, pooling: str = "local",
                       plan=None, mark=None) -> SuperpixelForward:
    """Superpixel-wise forward (reference WESUP.forward).

    Args:
        img: (B, H, W, 3) float in [0, 1]
        seg: (B, H, W) int32 SLIC assignments for ``plan``
        valid: (B, H, W) bool canvas validity
        pooling: only ``"local"`` (the default of ``WESUPConfig``) is ported.
        plan: the ``SlicPlan`` ``seg`` came from (required).
        mark: optional ``mark(phase_name)`` callback, called after each
            phase (backbone, masks, windows, k1, k2, proj, head, paint) so a
            caller can time them; it does not change the result.
    """
    if pooling != "local":
        raise NotImplementedError(
            f"pooling={pooling!r} is not ported; only 'local' is")
    if plan is None:
        raise ValueError("pooling='local' requires a SlicPlan")
    if plan.n_clusters != K:
        raise ValueError(f"plan has {plan.n_clusters} clusters, K={K}")
    mark = mark or (lambda name: None)
    B, H, W = img.shape[:3]

    taps = vgg.backbone_features(model.backbone, img, compute_dtype)
    w1_blocks = _fc1_blocks(model)
    bias = _fused_bias(model, w1_blocks)
    mark("backbone")

    counts = cellgrid.cell_counts(plan, seg, valid)             # (B, K) f32
    e9 = cellgrid.offset_masks(plan, seg, valid, compute_dtype)
    # contiguous for K1, whatever layout seg and valid arrive in
    seg_m = seg if valid is None else torch.where(valid, seg, -1)
    seg_m = seg_m.contiguous()
    mark("masks")

    pooled = None
    for s in range(5):
        stage_taps, proj = _stage_taps_and_proj(model, taps, w1_blocks, s,
                                                compute_dtype)
        Hs, Ws = stage_taps.shape[1:3]
        if (Hs, Ws) == (H, W):
            sums = cellpool.cell_pool0(plan, seg_m, stage_taps)
            mark("k1")
        else:
            spp = cellgrid.make_stage_pool_plan(plan, Hs, Ws, True)
            mc = cellgrid.stage_window_weights(spp, e9)
            mark("windows")
            sums = cellpool.cell_pool_stage(spp, mc, stage_taps)
            mark("k2")
        # bf16-rounded sums times the bf16 projection, accumulated in f32
        contrib = sums.to(compute_dtype).float() @ proj.float()
        pooled = contrib if pooled is None else pooled + contrib
        mark("proj")

    pooled = pooled / counts[..., None].clamp_min(1.0)          # (B, K, width)
    sp_pred, sp_feats = _mlp_head(model, pooled + bias)
    mark("head")

    vals = sp_pred[..., 1].to(compute_dtype)
    fg = cellgrid.cell_paint(plan, seg, vals).float()
    mark("paint")
    return SuperpixelForward(sp_pred, sp_feats, fg)
