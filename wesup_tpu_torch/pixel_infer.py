"""Pixel-wise inference CLI of the port (parity with the repository's
pixel_infer.py).

Usage:
    python -m wesup_tpu_torch.pixel_infer <data_root> [checkpoint=<ckpt>]
        [scales=0.5] [output=...] [device=cpu] [<any WESUPConfig field>=...]

Every image of ``<data_root>/images`` (PNG, BMP or JPEG as ``cv2.imread``
reads them, ``data/codec.py``) goes through the pixel head at each scale; the
probabilities are averaged and rounded.  The mask keeps the image's
name with ``.jpg`` renamed ``.png`` (so a ``.bmp`` image gives a
BMP mask).  Without ``output=``, masks go to
``<record dir>/results-pixel-<scales>/<data_root name>`` when a
checkpoint is given, else to ``predictions/``.  ``checkpoint=`` and
``device=`` as in ``infer.py``.
"""

from pathlib import Path

from wesup_tpu_torch import cli
from wesup_tpu_torch.data import codec
from wesup_tpu_torch.inference import Predictor, predict_multiscale
from wesup_tpu_torch.models import initialize_trainer


def main(data_root, checkpoint=None, output=None, scales=(0.5,), **kwargs):
    if not isinstance(scales, (tuple, list)):
        scales = (scales,)
    data_root = Path(data_root).expanduser()
    if output is not None:
        output_dir = Path(output).expanduser()
    elif checkpoint is not None:
        scale_tag = ",".join(str(s) for s in scales)
        output_dir = (Path(checkpoint).expanduser().parent.parent /
                      f"results-pixel-{scale_tag}" / data_root.name)
    else:
        output_dir = Path("predictions")
    output_dir.mkdir(parents=True, exist_ok=True)

    trainer = initialize_trainer("wesup", **kwargs)
    if checkpoint is not None:
        trainer.load_checkpoint(checkpoint)
    predictor = Predictor(trainer.model, trainer.config, mode="pixel",
                          device=trainer.device)

    for img_path in sorted((data_root / "images").iterdir()):
        pred = predict_multiscale(predictor, codec.imread_rgb(img_path),
                                  scales=scales)
        codec.imwrite(output_dir / img_path.name.replace(".jpg", ".png"),
                      pred.astype("uint8") * 255)
    return output_dir


if __name__ == "__main__":
    cli.run(main)
