"""Save binary masks as viewable x255 images.

Port of ``scripts/visualize_masks.py``: each mask of ``mask_root`` is
written, times 255, under the same name to ``--output`` (default
``<mask_root>/../viz``), through ``data/codec.py`` (no OpenCV).

Usage:
    python -m wesup_tpu_torch.scripts.visualize_masks <mask_root> [-o DIR]
"""

import argparse
from pathlib import Path

from wesup_tpu_torch.scripts._common import imread_gray, imsave, list_images


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mask_root", help="Path to mask directory")
    parser.add_argument("-o", "--output")
    args = parser.parse_args(argv)

    mask_root = Path(args.mask_root)
    output_dir = (Path(args.output) if args.output
                  else mask_root.parent / "viz")
    output_dir.mkdir(exist_ok=True)

    for mask_path in list_images(mask_root):
        imsave(output_dir / mask_path.name, imread_gray(mask_path) * 255)


if __name__ == "__main__":
    main()
