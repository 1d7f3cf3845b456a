"""Shared helpers of the benchmark's own tests (CPU; the card-only ones
carry the ``cuda`` marker and skip inside the test where there is none).

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips inside the test when "
        "none is present")


def shrink(res: dict, grid=(10, 10, 10)) -> dict:
    """A resolved cell at a size a CPU test holds: the grid cut to
    ``grid``; k=10 configurations keep 4 pairs (a whole cluster: 1 + 3),
    k=100 ones 10 (1 + 3 + 3 + 3)."""
    res = dict(res, config=copy.deepcopy(res["config"]),
               workload=copy.deepcopy(res["workload"]))
    cfg = res["config"]
    cfg["grid"] = list(grid)
    if cfg["k"] <= 10:
        cfg["k"] = 4
        cfg["f32_stage"]["minRestartSize"] = 8
    else:
        cfg["k"] = 10
        cfg["f32_stage"]["ncv"] = 32
    return res


@pytest.fixture(scope="session")
def spec():
    import run
    return run.load_json(ROOT, "BENCHMARK.json")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is present")
    return torch.device("cuda", 0)
