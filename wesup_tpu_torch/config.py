"""Configuration system of the PyTorch port (a copy of ``wesup_tpu.config``).

The port keeps its own copy so that it never imports the JAX package, whose
``__init__`` pulls in jax.  Field names and defaults are identical, so a
config dict moves between the two packages unchanged.

Mirrors the reference's class-attribute config chain (models/base.py:16-36 and
models/wesup.py:142-179 in mrcfps/WESUP): defaults come from the config class,
are flattened with ``to_dict()`` and merged with caller kwargs, which are
merged again with CLI kwargs at train time.  Field names and default values
are kept identical so a reference user can carry their flags over unchanged.

TPU-specific additions live in extra fields (``canvas_size``, ``slic_iters``,
``compute_dtype``...) that have no reference counterpart; they default to
values that reproduce reference behavior.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class BaseConfig:
    """Base model configuration (reference: models/base.py:16-36)."""

    # batch size for training
    batch_size: int = 1

    # number of epochs for training
    epochs: int = 10

    # numerical stability term
    epsilon: float = 1e-7

    # Save a checkpoint every N epochs (for N > 0 the final epoch is always
    # saved).  1 = the reference's per-epoch cadence (models/base.py:219-222);
    # 0 disables checkpoints entirely (ablation/benchmark runs —
    # this single-core host writes the ~150 MB msgpack at ~8 MB/s, which
    # starves the training loop even through the async record worker).
    checkpoint_period: int = 1

    def to_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        return "\n".join(
            f"{f.name:<32s}{getattr(self, f.name)}"
            for f in dataclasses.fields(self)
        )


@dataclass
class WESUPConfig(BaseConfig):
    """Configuration for the WESUP model (reference: models/wesup.py:142-179)."""

    # Rescale factor to subsample input images.
    rescale_factor: float = 0.5

    # multi-scale range for training
    multiscale_range: Tuple[float, float] = (0.3, 0.4)

    # Number of target classes.
    n_classes: int = 2

    # Class weights for cross-entropy loss function.
    # Reference parity note: the reference DEFINES this field (models/
    # wesup.py:155) but never applies it — its trainer binds
    # ``partial(_cross_entropy)`` with no weights (models/wesup.py:434), so
    # (3, 1) is dead config there.  The field is kept for config-surface
    # parity and only takes effect when ``apply_class_weights=True``.
    class_weights: Tuple[float, ...] = (3, 1)

    # Opt-in: actually apply ``class_weights`` to both CE terms.  False by
    # default so training dynamics match the reference's real wiring.
    apply_class_weights: bool = False

    # Superpixel parameters.
    sp_area: int = 200
    sp_compactness: float = 40

    # whether to enable label propagation
    enable_propagation: bool = True

    # Similarity threshold for label propagation
    # (reference passes 0.8 at models/wesup.py:514 despite the 0.95 function
    # default at models/wesup.py:99).
    propagate_threshold: float = 0.8

    # Weight for label-propagated samples when computing loss function
    propagate_weight: float = 0.5

    # Optimization parameters.
    lr: float = 5e-5
    momentum: float = 0.9
    weight_decay: float = 0.001

    # Whether to freeze backbone.
    freeze_backbone: bool = False

    # Training configurations.
    batch_size: int = 1
    epochs: int = 300

    # ------------------------------------------------------------------
    # TPU-native additions (no reference counterpart)
    # ------------------------------------------------------------------

    # Output dimension of superpixel features (reference hardcodes D=32 at
    # models/wesup.py:185).
    sp_feature_dim: int = 32

    # Width of the two hidden fc layers (reference hardcodes 1024 at
    # models/wesup.py:213-232).  Knob for the capacity sweep (VERDICT r4
    # #4): the forward derives every matmul shape from the param tree, so
    # widening/narrowing here only changes initialization.
    fc_width: int = 1024

    # Where the per-epoch train/val resize runs.  "auto"/"on": ship the
    # full-resolution decode to the device ONCE per run and resize
    # bit-exactly inside the jitted step (ops/train_resize.py — cv2's
    # fixed-point algorithm on the MXU; histories stay byte-identical);
    # "auto" falls back to the host path when the dataset can't be cached
    # losslessly (no masks / values beyond int8 / above the size cap).
    # "off": always resize on host with cv2 (the round-4 behavior).
    device_resize: str = "auto"

    # Fixed number of SLIC iterations on device (skimage default max_iter=10).
    slic_iters: int = 10

    # SLIC center-update subsampling stride: the iterative assign/update
    # runs on an (H/s, W/s) strided pixel grid (final assignment is always
    # full resolution).  3 measured within noise of the exact stride-1
    # k-means on the oracle probe (hard images: 0.98101 vs 0.98153), the
    # 120-epoch ablation (best Dice -0.0002) and the 250-epoch hard
    # protocol (test Dice/Object Dice equal-or-better on both splits; see
    # PERF_NOTES 34 + artifacts/), cutting SLIC device time ~9x vs stride
    # 1; set 1 for the exact full-grid k-means.
    slic_update_stride: int = 3

    # Static canvas (H, W) that images are padded onto.  ``None`` = derive
    # from the dataset (max image size x max scale, rounded up to x32).
    canvas_size: Optional[Tuple[int, int]] = None

    # Compute dtype for the backbone ("bfloat16" or "float32").  Params are
    # always float32.
    compute_dtype: str = "bfloat16"

    # Superpixel pooling formulation: "local" (default) pools every stage at
    # native resolution with the adjoint-resized assignment weights derived
    # from SLIC's 9-channel offset masks through banded window constants
    # (ops/cellgrid.py; kernels K1, K2), exact up to fp reassociation;
    # "adjoint" is the general form that needs no plan (kernels K5, K6; it
    # is what plan-less ``forward_superpixel`` callers get); "fullres" is the
    # round-1 upsample-then-pool path (ablation baseline; kernel K5).  The
    # port's train step takes only "local" so far.
    pooling: str = "local"

    # Probability of the coarse-field elastic deformation in the
    # mask-supervised (SegmentationDataset) augmentation stack; the
    # point-supervised path never applies elastic (reference
    # utils/data.py point transforms have no ElasticTransform).  Exposed
    # for the augmentation-divergence ablation (PERF_NOTES).
    elastic_p: float = 0.5

    # Affine-warp formulation for train-time augmentation: "cascade"
    # (default) is the shift-cascade factoring (PERF_NOTES item 14, ~3x
    # train step; sub-pixel values differ from direct bilinear by one lerp
    # composition); "exact" is the one-pass map_coordinates warp (gathers,
    # ~2x slower) kept to quantify that divergence (PERF_NOTES
    # "augmentation A/B").
    warp_method: str = "cascade"

    # Number of data-parallel shards (<=0 means "all visible devices").
    num_devices: int = 0

    # Random seed.
    seed: int = 0


def merge_config(config: WESUPConfig, **kwargs) -> WESUPConfig:
    """Apply the reference's kwargs-override merge chain to a dataclass.

    Unknown keys are kept in ``config.extra_kwargs``-style dict semantics by
    simply being ignored for the frozen fields; callers that need raw kwargs
    (e.g. ``checkpoint``, ``metrics``) keep their own dict, as the reference
    trainer does with ``self.kwargs``.
    """

    known = {f.name for f in dataclasses.fields(config)}
    updates = {k: v for k, v in kwargs.items() if k in known and v is not None}
    # fire-style CLIs pass tuples as lists; normalize
    for key in ("multiscale_range", "class_weights", "canvas_size"):
        if key in updates and updates[key] is not None:
            updates[key] = tuple(updates[key])
    return dataclasses.replace(config, **updates)
