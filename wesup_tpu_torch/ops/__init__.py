"""Tensor ops of the port: colour space, SLIC, resizes, cell-grid pooling,
label vote, CLAHE and augmentation."""
