"""The half-precision basis (bf16 and f16 storage, f32 compute) of the
port against the JAX package on the same numpy inputs, on the CPU:
``tests/test_eigsh.py::test_half_precision_basis`` through both packages,
with the same floor and the port's matvecs within 2x of the JAX package's;
the pieces the reference spreads across its solver (the compute type of
Grams and combinations, the explicit-Gram Rayleigh-Ritz, the projection
refusal, the tolerance floor, the compute-type random block).

Tolerances: the reference test's own (``16 eps(half) ||A||`` for residuals
and for the distance of each value to the spectrum); unit parity to f32's
eps where both packages compute in f32 from the same half inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import primme_tpu
from primme_tpu.core import linalg as JL
import primme_tpu_torch as ptt
from primme_tpu_torch.core import linalg as TL
from primme_tpu_torch.core import solver as TS
from tests.test_torch_problems import tridiag_fixture

MV_SLACK = 2
HALVES = ["bfloat16", "float16"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("half", HALVES)
def test_half_precision_basis_matches_reference(half):
    A, ref = tridiag_fixture()
    anorm = np.abs(ref).max()
    eps = float(jnp.finfo(jnp.dtype(half)).eps)
    tol, floor = 4 * eps, 16 * eps
    kw = dict(k=3, which="SA", tol=tol, return_stats=True,
              raise_for_unconverged=False)
    wt, Vt, st = ptt.eigsh(A.astype(np.float32), dtype=getattr(torch, half),
                           device="cpu", **kw)
    wj, Vj, sj = primme_tpu.eigsh(A.astype(np.float32),
                                  dtype=jnp.dtype(half), **kw)
    for vals, vecs in ((wt, Vt), (np.asarray(wj), np.asarray(Vj))):
        assert vals.dtype == np.float32 and vecs.dtype == np.float32
        R = A @ vecs - vecs * vals[None, :]
        assert np.linalg.norm(R, axis=0).max() < floor * anorm
        assert np.abs(ref[None, :] - vals[:, None]).min(axis=1).max() \
            < floor * anorm
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]


@pytest.mark.parametrize("half", HALVES)
def test_half_solve_stores_the_basis_in_half(half, monkeypatch):
    """The solver state holds V, W and the locked vectors in the half type
    and H, the coefficient blocks and the values in f32; the tolerance
    floors at 4 eps(half) and the projected problem takes the explicit
    Gram (``orth_explicit_I``)."""
    A, _ = tridiag_fixture()
    hd = getattr(torch, half)
    seen = {}
    build = TS._build_state

    def record(cfg, *a, **k):
        s = build(cfg, *a, **k)
        seen.update(V=s.V.dtype, W=s.W.dtype, evecs=s.evecs.dtype,
                    H=s.H.dtype, prev=s.prev_hvecs.dtype,
                    locked=s.locked_vals.dtype, cfg=cfg)
        return s

    monkeypatch.setattr(TS, "_build_state", record)
    ptt.eigsh(A.astype(np.float32), k=3, which="SA", tol=0.05, dtype=hd,
              device="cpu", raise_for_unconverged=False)
    assert seen["V"] == seen["W"] == seen["evecs"] == hd
    assert seen["H"] == seen["prev"] == seen["locked"] == torch.float32
    cfg = seen["cfg"]
    assert cfg.orth_explicit_I
    assert cfg.eps_floor == 4 * float(torch.finfo(hd).eps)


@pytest.mark.parametrize("half", HALVES)
def test_half_gram_and_bcomb_compute_in_f32(half):
    """A half block's Gram and combination run in f32 (the reference's
    ``compute_dtype``), the Gram summed in double as every single-precision
    Gram of the port: they equal the reference's f32 products to f32's
    rounding."""
    rng = np.random.default_rng(2)
    V = rng.normal(size=(500, 6)).astype(np.float32)
    Y = rng.normal(size=(500, 3)).astype(np.float32)
    C = rng.normal(size=(6, 2)).astype(np.float32)
    Vh = torch.as_tensor(V).to(getattr(torch, half))
    Vjh = jnp.asarray(Vh.float().numpy()).astype(jnp.dtype(half))
    G = TL.gram(Vh, torch.as_tensor(Y))
    Gj = np.asarray(JL.gram(Vjh, jnp.asarray(Y)))
    assert G.dtype == torch.float32 and Gj.dtype == np.float32
    assert np.abs(G.numpy() - Gj).max() <= 1e-5 * np.abs(Gj).max()
    B = TL.bcomb(Vh, torch.as_tensor(C))
    Bj = np.asarray(JL.bcomb(Vjh, jnp.asarray(C)))
    assert B.dtype == torch.float32
    assert np.abs(B.numpy() - Bj).max() <= 1e-5 * np.abs(Bj).max()
    assert TL.compute_dtype(getattr(torch, half)) == torch.float32


def test_rr_with_explicit_gram_matches_reference():
    """Rayleigh-Ritz against the basis' explicit Gram (the pencil ``H y =
    theta G y``, whitened by G's Cholesky factor) against the reference's
    ``solve_H_rr(G=)`` on the active block."""
    from primme_tpu.params import Target

    rng = np.random.default_rng(4)
    m, b = 10, 7
    M = rng.normal(size=(m, m))
    H = (M + M.T) / 2
    E = 1e-3 * rng.normal(size=(m, m))
    G = np.eye(m) + (E + E.T) / 2
    mask = np.arange(m) < b
    H = np.where(mask[:, None] & mask[None, :], H, 0).astype(np.float32)
    G = np.where(mask[:, None] & mask[None, :], G, 0).astype(np.float32)
    sh = np.zeros(1, np.float32)
    sj = JL.solve_H_rr(jnp.asarray(H), jnp.asarray(b), Target.smallest,
                       jnp.asarray(sh), jnp.asarray(0), G=jnp.asarray(G))
    st = TL.solve_H_rr(torch.as_tensor(H), b, ptt.Target.smallest,
                       torch.as_tensor(sh), 0, G=torch.as_tensor(G))
    wj = np.asarray(sj.hvals)[:b]
    wt = st.hvals.numpy()[:b]
    assert np.abs(wt - wj).max() <= 1e-5 * np.abs(wj).max()
    # the vectors are G-orthonormal: Y^T G Y = I
    Y = st.hvecs.numpy()[:b, :b].astype(np.float64)
    Gb = G[:b, :b].astype(np.float64)
    assert np.abs(Y.T @ Gb @ Y - np.eye(b)).max() <= 1e-5


@pytest.mark.parametrize("projection", ["refined", "harmonic"])
def test_half_basis_supports_rr_only(projection):
    """The reference's error for a half basis with another projection."""
    A, _ = tridiag_fixture()
    kw = dict(k=2, which="SA", tol=0.05, projection=projection)
    with pytest.raises(ValueError, match="supports RR only"):
        ptt.eigsh(A.astype(np.float32), dtype=torch.bfloat16, device="cpu",
                  **kw)
    with pytest.raises(ValueError, match="supports RR only"):
        primme_tpu.eigsh(A.astype(np.float32), dtype=jnp.bfloat16, **kw)


def test_half_dtype_names():
    """``dtype`` as a torch type, a name or the JAX package's type."""
    from primme_tpu_torch.api import _working_dtype

    assert _working_dtype("bfloat16") == torch.bfloat16
    assert _working_dtype(jnp.bfloat16) == torch.bfloat16
    assert _working_dtype(np.float16) == torch.float16
    with pytest.raises(NotImplementedError):
        _working_dtype("int8")
