"""Tiled pixel-wise inference CLI of the port (parity with the
repository's pixel_infer_tile.py): the CRAG large-image path (README's
patch size is 400).

Usage:
    python -m wesup_tpu_torch.pixel_infer_tile <data_root>
        [checkpoint=<ckpt>] [patch_size=300] [output=...] [chunk=8]
        [device=cpu] [<any WESUPConfig field>=...]

The patches' raw probabilities are stitched by a running average, which
is ROUNDED before saving (pixel_infer_tile.py:58-60), unlike the
truncating superpixel tile path.  The mask keeps the image's name.
Without ``output=``, masks go to
``<record dir>/results-pixel-tile-<patch_size>/<data_root name>`` when a
checkpoint is given, else to ``predictions/``.  ``checkpoint=`` and
``device=`` as in ``infer.py``.
"""

from pathlib import Path

from wesup_tpu_torch import cli
from wesup_tpu_torch.data import codec
from wesup_tpu_torch.inference import Predictor, predict_tiled
from wesup_tpu_torch.models import initialize_trainer


def main(data_root, checkpoint=None, patch_size=300, output=None, chunk=8,
         **kwargs):
    data_root = Path(data_root).expanduser()
    if output is not None:
        output_dir = Path(output).expanduser()
    elif checkpoint is not None:
        output_dir = (Path(checkpoint).expanduser().parent.parent /
                      f"results-pixel-tile-{patch_size}" / data_root.name)
    else:
        output_dir = Path("predictions")
    output_dir.mkdir(parents=True, exist_ok=True)

    trainer = initialize_trainer("wesup", **kwargs)
    if checkpoint is not None:
        trainer.load_checkpoint(checkpoint)
    predictor = Predictor(trainer.model, trainer.config, mode="pixel",
                          device=trainer.device)

    print("Making inference ...")
    for img_path in sorted((data_root / "images").iterdir()):
        pred = predict_tiled(predictor, codec.imread_rgb(img_path),
                             patch_size, chunk=chunk, round_patches=False)
        codec.imwrite(output_dir / img_path.name,
                      pred.round().astype("uint8") * 255)
    return output_dir


if __name__ == "__main__":
    cli.run(main)
