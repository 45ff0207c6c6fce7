"""Data layer of the port: image decode, host-side datasets, canvas
batching."""

from .datasets import (AreaConstraintDataset, CompoundDataset,  # noqa: F401
                       Digest2019PointDataset, PointSupervisionDataset,
                       SegmentationDataset, WESUPV2Dataset)
from .loader import CanvasBatcher, CanvasSpec  # noqa: F401
