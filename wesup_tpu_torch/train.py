"""Training entry point of the port (CLI parity with the repository's
train.py).

Usage:
    python -m wesup_tpu_torch.train /path/to/dataset [model=wesup]
        [epochs=300] [batch_size=1] [lr=5e-5] [checkpoint=<ckpt>]
        [checkpoint_period=1] [proportion=1] [smoke=True] [device=cpu]
        [metrics=accuracy,dice,object_dice] [<any WESUPConfig field>=...]

``device=`` takes the place of the JAX CLI's ``platform=``: by default the
run trains on the card (and stops when there is none); ``device=cpu``
trains on the host.  ``checkpoint=`` resumes from a ``.pth`` of this
trainer or the reference, or from a JAX trainer's ``.msgpack``.
``smoke=True`` deletes the record directory at the end.

``metrics=`` selects evaluation metrics by name (reference train.py:26-27
passes the functions [accuracy, dice], which stay the effective default
and run on the device inside the eval step).  Other names
(``detection_f1``, ``object_dice``, ``hausdorff``, ``object_hausdorff``)
are evaluated on the host on the validation predictions and land in
history.csv as ``val_<name>``; an unknown name raises ``ValueError``.

The dataset directory must contain ``train/`` (and optionally ``val/``) with
``images/``, ``masks/`` and optionally ``points/`` subdirectories; images
are PNG, BMP or JPEG (``data/codec.py``).
"""

import logging
from shutil import rmtree

from wesup_tpu_torch import cli
from wesup_tpu_torch.models import initialize_trainer


def fit(dataset_path, model="wesup", **kwargs):
    """Train ``model`` on ``dataset_path``; returns the trainer."""
    logger = logging.getLogger("Train")
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())

    trainer = initialize_trainer(model, logger=logger, **kwargs)

    try:
        trainer.train(dataset_path, **kwargs)
    finally:
        if kwargs.get("smoke") and trainer.record_dir is not None:
            rmtree(trainer.record_dir, ignore_errors=True)
    return trainer


if __name__ == "__main__":
    cli.run(fit)
