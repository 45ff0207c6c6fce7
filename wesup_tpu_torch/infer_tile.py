"""Tiled superpixel-wise inference CLI of the port (parity with the
repository's infer_tile.py).

Usage:
    python -m wesup_tpu_torch.infer_tile <data_dir> [checkpoint=<ckpt>]
        [patch_size=464] [output_dir=...] [chunk=8] [device=cpu]
        [<any WESUPConfig field>=...]

Each image of ``<data_dir>/images`` is cut into np.linspace-spaced
overlapping patches, each patch's prediction is rounded, and the patches
are stitched by a running average.  The mask is written under the image's
own name, so a ``.bmp`` image (GlaS) gives a BMP mask, as ``cv2.imwrite``
does.  ``checkpoint=`` and ``device=`` as in ``infer.py``.

Kept from the reference: the stitched average is saved with a uint8
TRUNCATION (infer_tile.py:141), so a pixel whose overlapping patches
disagree is 0; and the default ``model_type`` is ``wesup``, since the
reference's ``mild`` is not in its own factory.
"""

from pathlib import Path

from wesup_tpu_torch import cli
from wesup_tpu_torch.data import codec
from wesup_tpu_torch.inference import Predictor, predict_tiled
from wesup_tpu_torch.models import initialize_trainer


def infer(trainer, data_dir, patch_size, output_dir=None, chunk=8):
    """Tiled prediction of every image of ``data_dir``; returns the
    stitched float maps."""
    data_dir = Path(data_dir).expanduser()
    img_paths = sorted((data_dir / "images").iterdir())
    predictor = Predictor(trainer.model, trainer.config, mode="superpixel",
                          device=trainer.device)

    print(f"Predicting {len(img_paths)} images from {data_dir} ...")
    predictions = [predict_tiled(predictor, codec.imread_rgb(img_path),
                                 patch_size, chunk=chunk, round_patches=True)
                   for img_path in img_paths]

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        print(f"\nSaving prediction to {output_dir} ...")
        for pred, img_path in zip(predictions, img_paths):
            codec.imwrite(output_dir / img_path.name,
                          pred.astype("uint8") * 255)
    return predictions


def main(data_dir, model_type="wesup", patch_size=464, checkpoint=None,
         output_dir=None, chunk=8, **kwargs):
    if output_dir is None and checkpoint is not None:
        output_dir = Path(checkpoint).expanduser().parent.parent / "results"
        output_dir.mkdir(parents=True, exist_ok=True)

    trainer = initialize_trainer(model_type, **kwargs)
    if checkpoint is not None:
        trainer.load_checkpoint(checkpoint)
    return infer(trainer, data_dir, patch_size, output_dir, chunk=chunk)


if __name__ == "__main__":
    cli.run(main)
