"""``eigs`` on normal (non-Hermitian) operators on the card against the same
calls on the CPU: the periodic convection-diffusion operator of
``chip_smoke.py`` phases 28-30 at small grids through an ``ELLOperator``
(f64 on the complex128 basis' real view: ``windowed_ell_spmm_f64``; the
complex Ginzburg-Landau operator in complex64: ``windowed_ell_spmm_c64``)
and a ``BandedOperator`` (GD_plusK, f32 on the complex64 basis' real view:
``dia_f32``), a dense complex normal matrix, and the units
``solve_H_normal`` and ``normal_inner_solve`` on card tensors. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_normal_cuda.py

Tolerances: solves on the card and on the CPU take different rounding paths,
so each is held to the closed form (or the dense spectrum) on its own, the
values within 1.5 tol ||A|| and the true residuals at most 1.5 tol ||A||,
and the card's matvecs to within 2x of the CPU's; the entry point of the
path launched at least once a matvec and no other kernel. The projected
solve on card tensors equals its CPU run exactly (it solves on the host);
the inner solution agrees with its CPU run to 1e-10 of its largest entry,
with equal counts. Every test here needs a card and skips without one."""

import numpy as np
import pytest
import torch

import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu_torch.core import inner as TI
from primme_tpu_torch.core import linalg as TL
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import windowed_ell as WE
from primme_tpu_torch.params import Target

MODS = (DK, WE)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _normal_matrix(n=120, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(n, n))
                     + 1j * rng.normal(size=(n, n)))[0]
    d = rng.normal(size=n) + 1j * rng.normal(size=n)
    return (Q * d[None, :]) @ Q.conj().T, d


# (grid, coef, the matrix's type, tol, method, format, the entry point)
SOLVES = {
    "ell_f64": (12, 1.0, "float64", 1e-8, "JDQMR", "ell",
                "windowed_ell_spmm_f64"),
    "ell_c64": (12, CS.GL_COEF, "complex64", 1e-5, "JDQMR", "ell",
                "windowed_ell_spmm_c64"),
    "dia_f32": (10, 1.0, "float32", 1e-5, "GD_plusK", "banded", "dia_f32"),
}


def _op(A, fmt):
    return (ptt.BandedOperator.from_scipy(A) if fmt == "banded"
            else ptt.ELLOperator.from_scipy(A))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOLVES))
def test_convection_diffusion_on_card(card, name):
    N, coef, dt, tol, method, fmt, entry = SOLVES[name]
    A, lam, anorm = CS.convection_diffusion(N, coef, dtype=dt)
    bar = 1.5 * tol * anorm
    kw = dict(tol=tol, method=method, seed=0, return_stats=True,
              **CS.NORMAL_KWARGS)
    CS.reset_counts(*MODS)
    wg, Vg, sg = ptt.eigs(_op(A, fmt), device=card, **kw)
    torch.cuda.synchronize()
    launches = CS.read_counts(MODS)
    wc, Vc, sc = ptt.eigs(_op(A, fmt), device="cpu", **kw)
    for w, V in ((wg, Vg), (wc, Vc)):
        assert CS.match_values(w, lam[:7]) <= bar
        V = V.astype(np.complex128)
        R = A.astype(np.complex128) @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() <= bar
    assert sg["num_matvecs"] <= 2 * sc["num_matvecs"]
    assert launches[entry] >= sg["num_matvecs"]
    assert all(v == 0 for k, v in launches.items() if k != entry), launches


@pytest.mark.cuda
def test_dense_normal_on_card(card):
    A, d = _normal_matrix()
    kw = dict(k=5, which="LM", tol=1e-10, maxMatvecs=8000,
              return_stats=True)
    exp = d[np.argsort(-np.abs(d))][:5]
    wg, Vg, sg = ptt.eigs(A, device=card, **kw)
    wc, Vc, sc = ptt.eigs(A, device="cpu", **kw)
    for w, V in ((wg, Vg), (wc, Vc)):
        assert CS.match_values(w, exp) < 1e-8 * np.abs(d).max()
        R = A @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-7 * np.abs(d).max()
    assert sg["num_matvecs"] <= 2 * sc["num_matvecs"]


@pytest.mark.cuda
def test_solve_H_normal_on_card(card):
    A, _ = _normal_matrix(16, 3)
    shifts = torch.tensor([0.3], dtype=torch.float64)
    H = torch.from_numpy(A)
    for b in (5, 16):
        sc = TL.solve_H_normal(H, b, Target.largest_abs, shifts, 0)
        sg = TL.solve_H_normal(H.to(card), b, Target.largest_abs,
                               shifts.to(card), 0)
        assert sg.hvals.device.type == sg.hvecs.device.type == "cuda"
        assert torch.equal(sg.active.cpu(), sc.active)
        assert torch.equal(sg.hvals.cpu(), sc.hvals)
        assert torch.equal(sg.hvecs.cpu(), sc.hvecs)


@pytest.mark.cuda
def test_normal_inner_solve_on_card(card):
    import types

    n, blk = 200, 2
    A, _ = _normal_matrix(n, 4)
    rng = np.random.default_rng(5)
    X = np.linalg.qr(rng.normal(size=(n, blk))
                     + 1j * rng.normal(size=(n, blk)))[0]
    lam = np.einsum("nb,nb->b", X.conj(), A @ X)
    R = A @ X - X * lam
    p = ptt.set_method(ptt.Method.JDQMR, ptt.PrimmeParams(
        n=n, num_evals=4, hermitian=False, max_block_size=blk))
    from primme_tpu_torch.core import solver as TS
    cfg = TS.make_config(p)
    outs = []
    for dev in ("cpu", card):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        s = types.SimpleNamespace(
            evecs=torch.zeros((n, cfg.lockmax), dtype=torch.complex128,
                              device=dev), Bevecs=None, num_locked=0)
        outs.append(TI.normal_inner_solve(
            cfg, ptt.DenseOperator(A).to(dev), None, None, s, t(X), t(X),
            t(R), t(lam), t(np.linalg.norm(R, axis=0)),
            t(np.array([True, True])), 1e-9))
    (solc, *cnt_c), (solg, *cnt_g) = outs
    assert cnt_c == cnt_g and cnt_c[0] > 0
    assert float((solg.cpu() - solc).abs().max()) \
        <= 1e-10 * float(solc.abs().max())
