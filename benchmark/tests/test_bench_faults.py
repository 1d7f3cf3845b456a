"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program for the length of one run of a cell
at a small grid on the CPU (the run skips the look for a card), once for
each kind of call: a polish step that returns its state unchanged; half
of the block left out of the polish; an answer altered where the entry
produces it (a value, a vector). The exchange between chips is not among
them: every cell runs on one card.
"""

import importlib

import numpy as np
import pytest

import run
from conftest import shrink

CELLS = ("lap3d7_128_k10.northstar", "lap3d7_128_k10.polish",
         "lap3d7_128_k100.polish")


def plant(monkeypatch, fault):
    refine = importlib.import_module("primme_tpu_torch.refine")
    ptt = importlib.import_module("primme_tpu_torch")
    step, entry = refine.refine_step, ptt.refine_eigsh

    def unchanged(Aop, K, X, P, sgn):
        _, _, lam, res = step(Aop, K, X, P, sgn)
        return X, P, lam, res

    def half(Aop, K, X, P, sgn):
        X2, P2, lam, res = step(Aop, K, X, P, sgn)
        h = X.shape[1] // 2
        X2 = X2.clone()
        X2[:, h:] = X[:, h:]
        return X2, P2, lam, res

    def value(*a, **k):
        ev, V, st = entry(*a, **k)
        ev = ev.copy()
        ev[-1] += 1e-8
        return ev, V, st

    def vector(*a, **k):
        ev, V, st = entry(*a, **k)
        V = V.copy()
        V[len(V) // 3, 0] += 1e-6
        return ev, V, st

    if fault in ("unchanged", "half"):
        monkeypatch.setattr(refine, "refine_step",
                            {"unchanged": unchanged, "half": half}[fault])
    elif fault in ("value", "vector"):
        monkeypatch.setattr(ptt, "refine_eigsh",
                            {"value": value, "vector": vector}[fault])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "value",
                                   "vector"])
def test_fault_makes_the_run_not_correct(monkeypatch, spec, cell, fault):
    res = shrink(run.resolve(spec, cell))
    plant(monkeypatch, fault)
    out = run.run_cell(res, 2 ** 31 + 99, 0.5, False, "cpu")
    nums = {k: v["value"] for k, v in out["checks"].items()}
    if fault is None:
        assert out["correct"] and out["failed"] == 0, nums
    else:
        assert not out["correct"] and out["failed"] >= 1, (fault, nums)
        assert any(not np.isfinite(v) or v > out["checks"][k]["limit"]
                   for k, v in nums.items())
