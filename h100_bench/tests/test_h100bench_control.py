"""On the card, at each cell's own size: the program passes every limit of its cell, and the
control (the reference a precision step below the configuration's, in the program's place)
fails at least one; so does the training cell's fault that leaves half of each batch out.

    python -m pytest h100_bench/tests -m gpu
"""

import json
from pathlib import Path

import pytest

from h100_bench import calibrate

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_where_the_program_passes(workload, cuda_device):
    limits = json.loads((ROOT / "h100_bench" / "workloads" / f"{workload}.json").read_text())["limits"]
    out = calibrate.readings(workload, 2 ** 31 + 101, 3.0, True)
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
    if "half_batch" in out:
        assert any(out["half_batch"][k] > v for k, v in limits.items()), out
