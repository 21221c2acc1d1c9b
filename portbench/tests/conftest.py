"""The benchmark's own tests: on the CPU at tiny sizes, and, marked
``gpu``, on the card (``python -m pytest portbench/tests -m gpu`` there).
Whether a card is there is decided inside the ``card`` fixture."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda", 0)
