"""Data layer of the port: image decode, host-side datasets, canvas
batching.

The datasets and the loader (which import torch) load on first access,
so ``from wesup_tpu_torch.data import codec`` stays light for the offline
scripts and their worker processes."""

_EXPORTS = {
    "AreaConstraintDataset": "datasets", "CompoundDataset": "datasets",
    "Digest2019PointDataset": "datasets",
    "PointSupervisionDataset": "datasets", "SegmentationDataset": "datasets",
    "WESUPV2Dataset": "datasets", "CanvasBatcher": "loader",
    "CanvasSpec": "loader",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
