"""Superpixel-wise inference CLI of the port (parity with the repository's
infer.py, itself the reference's infer.py).

Usage:
    python -m wesup_tpu_torch.infer <data_dir> [checkpoint=<ckpt>]
        [scales=0.6,0.55,0.5,0.45,0.4] [input_size=H,W] [output_dir=...]
        [device=cpu] [<any WESUPConfig field>=...]

``data_dir`` holds ``images/`` (PNG or uncompressed BMP, ``data/codec.py``).
``checkpoint=`` is a ``.pth`` of the port or the reference, or a JAX
trainer's ``.msgpack``; without ``output_dir=`` the masks go to
``<record dir>/results``.  Each image gives ``{stem}.png``, a {0, 255}
mask.  ``device=`` as in ``train.py``: the card by default, ``cpu`` for
the host.
"""

from pathlib import Path

from wesup_tpu_torch import cli
from wesup_tpu_torch.data import codec
from wesup_tpu_torch.data.datasets import SegmentationDataset
from wesup_tpu_torch.inference import Predictor, predict_multiscale_batch
from wesup_tpu_torch.models import initialize_trainer


def save_predictions(predictions, dataset, output_dir="predictions"):
    """Save binary predictions as {0, 255} PNGs (reference infer.py:99-116)."""
    print(f"\nSaving prediction to {output_dir} ...")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for pred, img_path in zip(predictions, dataset.img_paths):
        codec.imwrite(output_dir / f"{img_path.stem}.png",
                      pred.astype("uint8") * 255)


def infer(trainer, data_dir, output_dir=None, input_size=None, scales=(0.5,),
          **_):
    """Predict every image of ``data_dir`` with the trainer's model; writes
    the masks when ``output_dir`` is given.  Returns the (H, W) 0/1 masks."""
    dataset = SegmentationDataset(data_dir, train=False)
    predictor = Predictor(trainer.model, trainer.config, mode="superpixel",
                          device=trainer.device)

    size_info = (f"input size {input_size}" if input_size
                 else f"scales {scales}")
    print(f"\nPredicting {len(dataset)} images with {size_info} ...")

    imgs = [codec.imread_rgb(dataset.img_paths[dataset.picked[i]])
            for i in range(len(dataset))]
    predictions = predict_multiscale_batch(predictor, imgs, scales=scales,
                                           input_size=input_size)

    if output_dir is not None:
        save_predictions(predictions, dataset, output_dir)
    return predictions


def main(data_dir, model_type="wesup", checkpoint=None, output_dir=None,
         input_size=None, scales=(0.5,), **kwargs):
    if not isinstance(scales, (tuple, list)):
        scales = (scales,)
    if output_dir is None and checkpoint is not None:
        output_dir = Path(checkpoint).parent.parent / "results"
        output_dir.mkdir(parents=True, exist_ok=True)

    trainer = initialize_trainer(model_type, **kwargs)
    if checkpoint is not None:
        trainer.load_checkpoint(checkpoint)

    return infer(trainer, data_dir, output_dir, input_size=input_size,
                 scales=scales)


if __name__ == "__main__":
    cli.run(main)
