"""Average point count per annotation CSV.

Port of ``scripts/count_points.py`` (same CLI, same stdout: one float).

Usage:
    python -m wesup_tpu_torch.scripts.count_points <points_path>
"""

import sys
from pathlib import Path


def mean_points(points_dir: str) -> float:
    counts = [max(sum(1 for _ in f.open()) - 1, 0)
              for f in sorted(Path(points_dir).glob("*.csv"))]
    return sum(counts) / len(counts) if counts else float("nan")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("usage: count_points.py <points_path>", file=sys.stderr)
        raise SystemExit(0 if argv and argv[0] in ("-h", "--help") else 2)
    print(mean_points(argv[0]))


if __name__ == "__main__":
    main()
