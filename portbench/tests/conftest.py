"""Puts the checkout's root and ``src`` on the path, and gives the card
tests a fixture that decides inside a test whether a card is there."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# A solver small enough for a host run of a cell (the defaults take
# minutes there); everything else as the configuration states.
TINY = {"hmooc": {"n_c_init": 16, "n_clusters": 3, "n_p_pool": 32,
                  "n_c_enrich": 8, "max_bank": 8}}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
