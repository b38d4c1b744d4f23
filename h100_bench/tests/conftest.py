"""The benchmark's tests: ``python -m pytest h100_bench/tests`` from the repository's root.

Tests that need a CUDA card carry the ``gpu`` marker and decide inside the test whether a
card is there (:func:`cuda_device`); on a machine without one they skip.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny sizes the CPU runs of both cells take
RUN_SMALL = {"traffic": {"size": [64, 64], "pool": 4, "batch": 2, "warm_batches": 1},
             "checks": {"batches": 1, "among": [0, 2], "ref_block": 2}}
TRAIN_SMALL = {"traffic": {"size": [96, 96], "pool": 8, "batch": 2, "crop": [64, 64], "warm_steps": 3,
                           "readback": 2}}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
