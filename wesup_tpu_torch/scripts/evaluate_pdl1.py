"""Offline PD-L1 evaluation (port of ``scripts/evaluate_pdl1.py``): the
CRAG evaluator with a 5000 px threshold and a different (author-specific
in the reference, here overridable) GT root (reference
evaluate_pdl1.py:73).

Usage:
    python -m wesup_tpu_torch.scripts.evaluate_pdl1 <pred_root>
        [--gt-root ~/data/PDL1/test/masks] [--threshold 5000]
"""

from wesup_tpu_torch.scripts import evaluate_crag


def main(argv=None):
    evaluate_crag.main(argv, default_gt_root="~/data/PDL1/test/masks")


if __name__ == "__main__":
    main()
