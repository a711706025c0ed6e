"""The benchmark's own tests: the manifest against the contract, the
work counts, the plain references against the port, the harness's
imports, the trace reduction, and whole runs on the CPU with faults
planted in the program.  Run from the root of the repository:

    python -m pytest -q bench/tests

A test that needs the card carries the ``gpu`` marker and skips here.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda", 0)
