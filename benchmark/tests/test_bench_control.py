"""The control at a size a test run holds: the plain reference polish in
float32, put in the program's place, fails the comparison on every seed;
the same reference in float64 passes it (so the limits separate the two
precisions, not the reference from the program)."""

import pytest
import torch

import control
import run
from conftest import shrink


@pytest.mark.parametrize("cell", ["lap3d7_128_k10.northstar",
                                  "lap3d7_128_k10.polish",
                                  "lap3d7_128_k100.polish"])
def test_control_fails_and_reference_passes(spec, cell):
    res = shrink(run.resolve(spec, cell))
    seeds = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]
    low = control.control(res, seeds, torch.float32, 100,
                          torch.device("cpu"), log=None)
    assert all(not r["passes"] for r in low), low
    # every number of the control is past its limit, by far
    for r in low:
        for name, v in r["numbers"].items():
            assert v > 10 * r["limits"][name], (name, v)
    high = control.control(res, seeds[:1], torch.float64, 200,
                           torch.device("cpu"), log=None)
    assert high[0]["passes"], high
