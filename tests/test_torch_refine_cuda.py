"""The f64 refinement route on the card: ``ChebyshevPrecond`` over the
f64 stencil kernel and ``refine_eigsh`` in native FP64, each against the
same call on the CPU (the stencil's plain version there); and the refined
extraction's batch (``smallest_right_svecs``) on the card against the
CPU, and the polish's results crossing to the host in chunks of rows (bit
for bit the old single copy's ordered columns), on both sides of 32 pairs (f32: the Gram's f64 ``eigh``, cuSOLVER's
batched Jacobi ``eigh`` below, its looped ``syevd`` above; f64: the SVD;
LAPACK on the CPU). This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_refine_cuda.py

Tolerances: the stencil kernel is bit for bit with its plain version, but
cuBLAS and LAPACK sum the recurrence's and the polish's products in other
orders: the Chebyshev apply agrees to 1e-12 relative; the polish to 1e-12
on eigenvalues (the converged values), its residuals both under the
requested 1e-11 ||A||, and its iteration counts within 2 (the convergence
test reads a residual near the threshold); the batch's vectors (through
their projectors) and values agree to 1e-9 relative in f64 (cuSOLVER's
SVD against LAPACK's, the smallest gap 6e-5 of the norm) and to 1e-6 in
f32 (the results' own rounding).
Every test here needs a card and skips without one."""

import numpy as np
import pytest
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import stencil3d as ST


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 10])
def test_chebyshev_on_the_card_matches_cpu(card, k):
    A = {d: ptt.Stencil3DOperator(17, 20, 23, dtype=torch.float64, device=d)
         for d in ("cpu", card)}
    X = torch.randn((17 * 20 * 23, k), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(k))
    out = {}
    for d, op in A.items():
        K = ptt.ChebyshevPrecond(op, (0.6, 12.1), degree=8, sigma=0.2)
        ST.LAUNCHES = 0
        out[d] = K.matmat(X.to(d)).cpu()
        if d == card:
            assert ST.LAUNCHES == 7      # degree - 1 products
    assert torch.allclose(out[card], out["cpu"], rtol=0,
                          atol=1e-12 * float(out["cpu"].abs().max()))


@pytest.mark.cuda
def test_refine_on_the_card_matches_cpu(card):
    nx, k = 16, 6
    A32 = ptt.Stencil3DOperator(nx, nx, nx, device="cpu")
    _, X32 = ptt.eigsh(A32, k=k, which="SA", tol=1e-5, device="cpu",
                       raise_for_unconverged=False)
    res = {}
    for d in ("cpu", card):
        A64 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float64,
                                    device=d)
        K = ptt.ChebyshevPrecond.from_operator(A64, degree=8)
        res[d] = ptt.refine_eigsh(A64, X32, tol=1e-11, OPinv=K,
                                  return_stats=True, device=d)
    (ev_c, _, st_c), (ev_g, X_g, st_g) = res["cpu"], res[card]
    assert np.abs(ev_g - ev_c).max() <= 1e-12
    for st in (st_c, st_g):
        assert st["resnorms"].max() <= 1e-11 * st["anorm_estimate"]
    assert abs(st_g["num_refine_iters"] - st_c["num_refine_iters"]) <= 2
    Xt = torch.as_tensor(X_g, device=card)
    R = ST.matmat_reference(Xt, nx, nx, nx) - Xt * torch.as_tensor(
        ev_g, device=card)
    assert float(torch.linalg.vector_norm(R, dim=0).max()) <= 1e-11 * 12


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [24000, None])
@pytest.mark.parametrize("which", ["SA", "LA"])
@pytest.mark.parametrize("k", [1, 4])
def test_refine_results_cross_in_chunks(card, monkeypatch, k, which,
                                        chunk_bytes):
    """The polish's vectors reach the host a chunk of rows at a time
    (3000 or 750 rows of 4096 under the small chunk, one chunk under the
    module's), bit for bit the old ``X.cpu().numpy()[:, order]`` of the
    last step, in a fresh array that a later call leaves alone."""
    from primme_tpu_torch import refine
    if chunk_bytes is not None:
        monkeypatch.setattr(refine, "_CHUNK_BYTES", chunk_bytes)
    last = []
    step = refine.refine_step
    monkeypatch.setattr(refine, "refine_step",
                        lambda *a: last.append(step(*a)) or last[-1])
    nx = 16
    n = nx ** 3
    rows = refine._CHUNK_BYTES // (8 * k)
    assert chunk_bytes is None or n % rows
    A64 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float64,
                                device=card)
    X0 = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    ev, X, st = ptt.refine_eigsh(A64, X0, tol=1e-11, which=which,
                                 maxiter=30, return_stats=True, device=card)
    X_l, _, lam, res = (t.cpu().numpy() for t in last[-1])
    order = np.argsort((1.0 if which == "SA" else -1.0) * lam)
    assert ev.tobytes() == lam[order].tobytes()
    assert X.dtype == np.float64 and X.shape == (n, k)
    assert X.tobytes() == X_l[:, order].tobytes()
    assert st["resnorms"].tobytes() == res[order].tobytes()
    assert X.flags.c_contiguous and X.flags.writeable and X.flags.owndata
    assert st["to_host_chunks"] == -(-n // rows)
    kept = X.copy()
    ptt.refine_eigsh(A64, X0[::-1].copy(), tol=1e-11, which=which,
                     maxiter=30, device=card)
    assert X.tobytes() == kept.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [24, 36])
def test_refined_batch_on_the_card_matches_cpu(card, b, dtype):
    from primme_tpu_torch.core.linalg import smallest_right_svecs

    rng = np.random.default_rng(b)
    H = rng.standard_normal((b, b))
    H = 0.5 * (H + H.T)
    G = np.triu(rng.standard_normal((b, b))) * 0.1
    taus = np.linalg.eigvalsh(H)
    C = np.concatenate([H[None] - taus[:, None, None] * np.eye(b)[None],
                        np.broadcast_to(G, (b, b, b))], axis=1)
    C = torch.as_tensor(C, dtype=dtype)
    (Yc, sc), (Yg, sg) = (smallest_right_svecs(C.to(d))
                          for d in ("cpu", card))
    Yc, Yg = Yc.double(), Yg.cpu().double()
    assert Yg.dtype == Yc.dtype and Yg.shape == (b, b)
    Pc = Yc.T[:, :, None] * Yc.T[:, None, :]
    Pg = Yg.T[:, :, None] * Yg.T[:, None, :]
    tol = 1e-9 if dtype == torch.float64 else 1e-6
    assert float((Pg - Pc).abs().max()) <= tol
    assert torch.allclose(sg.cpu().double(), sc.double(), rtol=tol,
                          atol=tol * float(sc.max()))
