"""WESUP: VGG16 hypercolumn -> superpixel MLP classifier, in PyTorch.

Port of ``wesup_tpu.models.wesup`` (the superpixel and pixel forwards).  The
parameters live in :class:`WESUP`, an ``nn.Module`` whose state-dict keys
are the reference's (``backbone.{i}``, ``side_conv{cum}``,
``fc_layers.{0,2,4}``, ``classifier.0``), so a reference ``.pth`` loads
with ``load_state_dict``.

The forward is the JAX package's exact refactor of the reference: side
conv and the fc1 block of each tap fold into one projection per resolution
stage, pooling commutes with it, so every stage is pooled at its NATIVE
resolution and projected after pooling.  Three poolings, as in JAX:

- ``"adjoint"`` (the default; with or without a ``SlicPlan``): stage 0 is
  a segment sum, kernel K5 (``ops/pooling.py``), over the seg with invalid
  pixels masked as -1; each downsampled stage is upsampled along H by a
  plain matmul and pooled through the W-adjoint of the one-hot, kernel K6
  (``ops/adjoint.py``).  Counts and painting use the plan's exact cell-grid
  forms when a plan is given, else the one-hot forms.
- ``"local"`` (``WESUPConfig``'s default; needs the plan): stage 0 pools
  with kernel K1 and stages 1-4 with kernel K2 through the adjoint window
  weights built from the validity-weighted offset masks
  (``ops/cellpool.py``).
- ``"fullres"`` (the round-1 ablation): stages 1-4 are projected at native
  resolution, W-resized and H-upsampled into one full-resolution map,
  which K5 pools beside stage 0's taps.

The pixel head (:func:`forward_pixel`, the reference's
WESUPPixelInference) classifies every pixel: each stage's taps are
projected at native resolution and W-resized, and ONE contraction against
the stacked H-interpolation matrices upsamples and sums all five stages
(stage 0's block is the identity) into the (B, H, W, 1024) pre-ReLU fc1
map, which the head reads in the compute dtype.  It runs no pooling
kernel; the backbone's K7 under ``WESUP_FUSED_POOL1`` is its only one.

Every path is differentiable in the weights: the kernels are autograd
Functions whose backward bodies are kernels too (K3, K4; K5's on K3's
kernel; K6's is K8), and the rest is plain torch.

bf16 casts follow the reference: taps are in the compute dtype, pooled
sums are f32 and are cast to the compute dtype before the projection (the
product then accumulates in f32), projections are built in f32 and cast,
the head runs in its input's dtype (f32 on the superpixel paths, as the
pooled features are f32; the compute dtype on the pixel path) with the
softmax in f32, and ``pred`` is painted in the compute dtype
and returned as f32.  One-hot counts are exact f32 sums rounded to the
compute dtype, as the JAX one-hot sum rounds them.
"""

from __future__ import annotations

from typing import List, NamedTuple

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import adjoint, cellgrid, cellpool
from ..ops import pooling as seg_pool
from ..ops.resize import _interp_matrix, fused_upsample_sum, resize_w_only
from ..ops.segments import paint
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


def _masked_seg(seg: torch.Tensor, valid) -> torch.Tensor:
    """seg with invalid pixels set to -1, contiguous for the kernels
    whatever layout seg and valid arrive in."""
    return (seg if valid is None else torch.where(valid, seg, -1)).contiguous()


def _onehot_counts(seg_m: torch.Tensor, K: int, compute_dtype) -> torch.Tensor:
    """(B, K) counts of the ids in [0, K), as JAX's compute-dtype one-hot
    sum gives them: exact in f32, then rounded to the compute dtype."""
    B = seg_m.shape[0]
    ids = seg_m.reshape(B, -1).long()
    ok = ((ids >= 0) & (ids < K)).to(torch.float32)
    counts = torch.zeros((B, K), dtype=torch.float32, device=seg_m.device)
    counts.scatter_add_(1, ids.clamp(0, K - 1), ok)
    return counts.to(compute_dtype).to(torch.float32)


def _onehot_paint(seg: torch.Tensor, vals: torch.Tensor, K: int):
    """``onehot(seg) @ vals``: ``vals[b, seg]``, 0 where seg is outside
    [0, K) (exactly the one-hot product: one nonzero term per pixel)."""
    ok = (seg >= 0) & (seg < K)
    return torch.where(ok, paint(seg.clamp(0, K - 1), vals),
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def _upsample_h(taps: torch.Tensor, H: int) -> torch.Tensor:
    """(B, Hs, Ws, C) -> (B, H, Ws, C) align-corners upsample along H, one
    matmul in taps' dtype; the result is contiguous (channels last)."""
    B, Hs, Ws, C = taps.shape
    A_h = cellgrid._device_const(
        ("interp", Hs, H, str(taps.dtype), str(taps.device)),
        lambda: torch.as_tensor(_interp_matrix(Hs, H, True), dtype=taps.dtype,
                                device=taps.device))
    return torch.matmul(A_h, taps.reshape(B, Hs, Ws * C)).reshape(B, H, Ws, C)


def forward_superpixel(model: WESUP, img: torch.Tensor, seg: torch.Tensor,
                       K: int, valid: torch.Tensor | None = None,
                       compute_dtype=torch.float32, pooling: str = "adjoint",
                       plan=None, mark=None) -> SuperpixelForward:
    """Superpixel-wise forward (reference WESUP.forward).

    Args:
        img: (B, H, W, 3) float in [0, 1]
        seg: (B, H, W) int32 superpixel ids in [0, K)
        valid: (B, H, W) bool canvas validity
        pooling: ``"adjoint"`` (default, as in JAX), ``"local"`` (needs
            ``plan``) or ``"fullres"`` (ignores ``plan``); see the module
            docstring.
        plan: optional ``SlicPlan`` that ``seg`` came from.
        mark: optional ``mark(phase_name)`` callback, called after each
            phase (backbone, k7 under ``WESUP_FUSED_POOL1``, masks,
            windows, k1, k2, tapsH, k5, k6, zmap, proj, head, paint) so a
            caller can time them; it does not change the result.
    """
    if pooling == "fullres":
        return forward_superpixel_fullres(model, img, seg, K, valid,
                                          compute_dtype, mark=mark)
    if pooling not in ("adjoint", "local"):
        raise ValueError(f"unknown pooling {pooling!r}")
    if plan is not None and plan.n_clusters != K:
        raise ValueError(f"plan has {plan.n_clusters} clusters, K={K}")
    local = pooling == "local"
    if local and plan is None:
        raise ValueError("pooling='local' requires a SlicPlan")
    mark = mark or (lambda name: None)
    B, H, W = img.shape[:3]

    taps = vgg.backbone_features(model.backbone, img, compute_dtype, mark)
    w1_blocks = _fc1_blocks(model)
    bias = _fused_bias(model, w1_blocks)
    mark("backbone")

    seg_m = _masked_seg(seg, valid)
    if plan is not None:
        counts = cellgrid.cell_counts(plan, seg, valid)         # (B, K) f32
    else:
        counts = _onehot_counts(seg_m, K, compute_dtype)
    if local:
        e9 = cellgrid.offset_masks(plan, seg, valid, compute_dtype)
    else:
        lists = seg_pool.segment_lists(seg_m, K)    # shared by K5 and K6
    mark("masks")

    pooled = None
    for s in range(5):
        stage_taps, proj = _stage_taps_and_proj(model, taps, w1_blocks, s,
                                                compute_dtype)
        Hs, Ws, C = stage_taps.shape[1:]
        if (Hs, Ws) == (H, W) and local:
            sums = cellpool.cell_pool0(plan, seg_m, stage_taps)
            mark("k1")
        elif (Hs, Ws) == (H, W):
            sums = seg_pool.segment_sum(
                seg_m.reshape(B, H * W), stage_taps.reshape(B, H * W, C), K,
                lists)
            mark("k5")
        elif local:
            spp = cellgrid.make_stage_pool_plan(plan, Hs, Ws, True)
            mc = cellgrid.stage_window_weights(spp, e9)
            mark("windows")
            sums = cellpool.cell_pool_stage(spp, mc, stage_taps)
            mark("k2")
        else:
            # JAX contracts M = A_w^T (A_h^T OH) with the taps; here the
            # taps are upsampled along H (channels last, viewed as
            # (B, C, H, Ws)) and K6 applies the W-adjoint of the one-hot
            tapsH = _upsample_h(stage_taps, H)
            mark("tapsH")
            A_wT = torch.from_numpy(_interp_matrix(Ws, W, True)).t()
            table = cellgrid._device_const(
                ("adjoint_table", Ws, W, str(compute_dtype),
                 str(tapsH.device)),
                lambda: adjoint.column_table(A_wT, compute_dtype,
                                             tapsH.device))
            sums = adjoint.adjoint_pool_stage(
                seg_m, tapsH.permute(0, 3, 1, 2), A_wT, K, lists,
                table).transpose(1, 2)
            mark("k6")
        # bf16-rounded sums times the bf16 projection, accumulated in f32
        contrib = sums.to(compute_dtype).float() @ proj.float()
        pooled = contrib if pooled is None else pooled + contrib
        mark("proj")

    pooled = pooled / counts[..., None].clamp_min(1.0)          # (B, K, width)
    sp_pred, sp_feats = _mlp_head(model, pooled + bias)
    mark("head")

    vals = sp_pred[..., 1].to(compute_dtype)
    if plan is not None:
        fg = cellgrid.cell_paint(plan, seg, vals).float()
    else:
        # the unmasked one-hot, as in JAX: invalid pixels are painted too
        fg = _onehot_paint(seg, vals, K).float()
    mark("paint")
    return SuperpixelForward(sp_pred, sp_feats, fg)


def forward_superpixel_fullres(model: WESUP, img: torch.Tensor,
                               seg: torch.Tensor, K: int,
                               valid: torch.Tensor | None = None,
                               compute_dtype=torch.float32,
                               mark=None) -> SuperpixelForward:
    """The round-1 formulation (ablation baseline): stages 1-4 projected at
    native resolution, W-resized, then H-upsampled and summed in ONE
    contraction into the full-resolution (B, H, W, 1024) map, which K5
    pools; stage 0 pools its 128-channel taps with K5 and projects the sums
    (rounded to the compute dtype, as in JAX).  Counts are the one-hot
    form; the plan, if any, is not used."""
    mark = mark or (lambda name: None)
    B, H, W = img.shape[:3]
    taps = vgg.backbone_features(model.backbone, img, compute_dtype, mark)
    w1_blocks = _fc1_blocks(model)
    bias = _fused_bias(model, w1_blocks)
    mark("backbone")

    stage_maps = []
    for s in range(1, 5):
        stage_taps, proj = _stage_taps_and_proj(model, taps, w1_blocks, s,
                                                compute_dtype)
        stage_maps.append(resize_w_only(stage_taps @ proj, W))
    z_rest = fused_upsample_sum(stage_maps, H)                  # (B, H, W, D)
    del stage_maps
    mark("zmap")

    taps0, proj0 = _stage_taps_and_proj(model, taps, w1_blocks, 0,
                                        compute_dtype)
    seg_m = _masked_seg(seg, valid)
    counts = _onehot_counts(seg_m, K, compute_dtype)
    lists = seg_pool.segment_lists(seg_m, K)
    mark("masks")
    seg_p = seg_m.reshape(B, H * W)
    sum0 = seg_pool.segment_sum(seg_p, taps0.reshape(B, H * W, -1), K, lists)
    sum_rest = seg_pool.segment_sum(seg_p, z_rest.reshape(B, H * W, -1), K,
                                    lists)
    mark("k5")
    total = (sum0.to(compute_dtype) @ proj0).float() + sum_rest
    pooled = total / counts[..., None].clamp_min(1.0)           # (B, K, D)
    mark("proj")
    sp_pred, sp_feats = _mlp_head(model, pooled + bias)
    mark("head")
    fg = _onehot_paint(seg, sp_pred[..., 1].to(compute_dtype), K).float()
    mark("paint")
    return SuperpixelForward(sp_pred, sp_feats, fg)


def hypercolumn_projection_parts(model: WESUP, img: torch.Tensor,
                                 compute_dtype=torch.float32, mark=None):
    """The shared pre-ReLU fc1 map WITHOUT its bias, and the bias:
    ((B, H, W, width) in the compute dtype, (width,) f32).

    Each stage's concatenated taps are projected with one matmul at native
    resolution and W-resized; then ONE contraction against the stacked
    H-interpolation matrices upsamples and sums all five stages, stage 0
    (whose block is the identity) included, so bf16 rounds where it does in
    JAX.  ``mark``, if given, is called with ``"backbone"``, ``"proj"``
    (the stage projections and W-resizes) and ``"upsample"`` after each
    phase."""
    mark = mark or (lambda name: None)
    H, W = img.shape[1:3]
    taps = vgg.backbone_features(model.backbone, img, compute_dtype, mark)
    w1_blocks = _fc1_blocks(model)
    bias = _fused_bias(model, w1_blocks)
    mark("backbone")
    stage_maps = []
    for s in range(5):
        stage_taps, proj = _stage_taps_and_proj(model, taps, w1_blocks, s,
                                                compute_dtype)
        stage_maps.append(resize_w_only(stage_taps @ proj, W))
    del taps, stage_taps
    mark("proj")
    z = fused_upsample_sum(stage_maps, H)
    mark("upsample")
    return z, bias


def hypercolumn_projection(model: WESUP, img: torch.Tensor,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """The biased pre-ReLU fc1 map (B, H, W, width) in f32."""
    z, bias = hypercolumn_projection_parts(model, img, compute_dtype)
    return z.float() + bias


def forward_pixel(model: WESUP, img: torch.Tensor,
                  compute_dtype=torch.float32, mark=None) -> torch.Tensor:
    """Pixel-wise forward (reference WESUPPixelInference.forward): every
    pixel's hypercolumn through the head.  Returns the (B, H, W, C) f32
    softmax probabilities.

    The bias is cast to the map's dtype and added there, so in bf16 the
    whole head runs in bf16 and only the softmax in f32, as in JAX.
    ``mark`` is passed to :func:`hypercolumn_projection_parts` and called
    with ``"head"`` at the end."""
    z, bias = hypercolumn_projection_parts(model, img, compute_dtype, mark)
    z = z + bias.to(z.dtype)
    probs, _ = _mlp_head(model, z)
    if mark is not None:
        mark("head")
    return probs
