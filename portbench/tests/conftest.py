"""The benchmark's CPU tests: the checkout's root on the path, torch on a
few threads, and the ``cuda`` marker's tests skipped (inside a fixture)
where no card is present.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _threads_and_card(request):
    import torch

    torch.set_num_threads(4)
    if request.node.get_closest_marker("cuda") and \
            not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
