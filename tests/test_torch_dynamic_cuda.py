"""The eleventh slice on the card against the same calls on the CPU:
``eigsh(method="DYNAMIC")`` on ``bench.py``'s headline configuration at
24^3 (the 7-point ``Stencil3DOperator`` with the shift-aware
``JacobiPrecond``, k=10 smallest, f32, tol 1e-5, block 2, basis 24,
restart 14), a segmented JDQMR_ETol solve bit-identical to the unsegmented
one, the event stream's counts, and the measured profile. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dynamic_cuda.py

Tolerances: the card and the CPU take different rounding paths and the
DYNAMIC trace depends on the clock, so each DYNAMIC solve is held to the
closed form on its own (values within 1e-4, bench.py's bar) and the
card's matvecs to within 2x of the CPU's; the stencil kernel launches at
least once every two matvecs, the Jacobi kernel once every two matvecs
outside the probe (whose filter applies no preconditioner), and no other
kernel. A segmented solve
on the card returns exactly the unsegmented one's values, residuals and
counts. Every test here needs a card and skips without one."""

import numpy as np
import pytest
import torch

import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu_torch.core.inner import jdqmr_inner_solve
from primme_tpu_torch.core.solver import solve_eigs
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST
from primme_tpu_torch.ops import windowed_ell as WE

GRID = 24
HEADLINE = dict(k=10, which="SA", tol=1e-5, ncv=24, maxBlockSize=2,
                minRestartSize=14, locking=False, jacobi=True,
                return_stats=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _v0(n):
    return np.random.default_rng(0).normal(size=(n, 2)).astype(np.float32)


def _dynamic(device):
    A = ptt.Stencil3DOperator(GRID, GRID, GRID, dtype=torch.float32,
                              device=device)
    return ptt.eigsh(A, method="DYNAMIC", v0=_v0(GRID ** 3), device=device,
                     **HEADLINE)


@pytest.mark.cuda
def test_dynamic_headline_on_the_card(card):
    lam, _ = CS.stencil_eigenvalues(GRID, 10)
    CS.reset_counts(ST, JK, WE, DK)
    w, X, st = _dynamic(card)
    launches = {**ST.KERNEL_LAUNCHES, **JK.KERNEL_LAUNCHES,
                **WE.KERNEL_LAUNCHES, **DK.KERNEL_LAUNCHES}
    wc, _, sc = _dynamic("cpu")
    for vals in (w, wc):
        assert np.abs(np.sort(vals) - lam).max() <= 1e-4
    mv = st["num_matvecs"]
    assert mv <= 2 * sc["num_matvecs"] and sc["num_matvecs"] <= 2 * mv
    assert launches["stencil3d_f32"] >= mv / 2
    assert launches["jacobi_shifted_f32"] >= (mv - st["num_probe_matvecs"]) / 2
    others = {e: c for e, c in launches.items()
              if e not in ("stencil3d_f32", "jacobi_shifted_f32")}
    assert not any(others.values()), others
    assert st["probe_verified"] == 1 and st["probe_exhausted"] == 0


def _headline_solve(device, **kw):
    n = GRID ** 3
    A = ptt.Stencil3DOperator(GRID, GRID, GRID, dtype=torch.float32,
                              device=device)
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                         max_block_size=2, min_restart_size=14,
                         max_matvecs=16000, locking=0)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    v0 = torch.from_numpy(_v0(n)).to(device)
    return solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                      inner_solve=jdqmr_inner_solve, **kw)


@pytest.mark.cuda
def test_segmented_headline_bit_identical_on_the_card(card):
    r1 = _headline_solve(card)
    r2 = _headline_solve(card, segment_outer=10)
    np.testing.assert_array_equal(r1.evals.cpu().numpy(),
                                  r2.evals.cpu().numpy())
    np.testing.assert_array_equal(r1.resnorms.cpu().numpy(),
                                  r2.resnorms.cpu().numpy())
    assert r1.stats.num_matvecs == r2.stats.num_matvecs
    assert r1.stats.num_inner_iterations == r2.stats.num_inner_iterations


@pytest.mark.cuda
def test_event_stream_on_the_card(card):
    events = []

    def mon(event, num_inner, inner_trace=None, **kw):
        events.append((int(event), int(num_inner), inner_trace))

    r = _headline_solve(card, monitor=mon, inner_trace_cap=128)
    assert len(events) >= r.stats.num_outer_iterations
    assert sum(ni for _, ni, _ in events) == r.stats.num_inner_iterations
    for _, ni, tr in events:
        assert isinstance(tr, np.ndarray) and tr.shape == (128, 2, 3)
    # the monitor does not change the solve
    r0 = _headline_solve(card)
    np.testing.assert_array_equal(r.evals.cpu().numpy(),
                                  r0.evals.cpu().numpy())


@pytest.mark.cuda
def test_measured_profile_on_the_card(card):
    from primme_tpu_torch.profiling import measure_breakdown

    out = measure_breakdown(lambda: _headline_solve(card), device=card)
    assert out["time_source"] == "measured"
    for key in ("time_matvec", "time_precond", "time_ortho", "time_dense"):
        assert out[key] > 0, key
    parts = sum(out[k] for k in ("time_matvec", "time_precond",
                                 "time_ortho", "time_dense", "time_other"))
    assert abs(parts - out["device_busy"]) <= 0.1 * out["device_busy"]
    kern = out["device_kernels"]
    sten = sum(v for k, v in kern.items() if "stencil3d_kernel" in k)
    jac = sum(v for k, v in kern.items() if "jacobi_kernel" in k)
    assert sten > 0 and out["time_matvec"] >= 0.99 * sten
    assert jac > 0 and out["time_precond"] >= 0.99 * jac
