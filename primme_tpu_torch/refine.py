"""Mixed-precision eigenpair refinement: f32 solve + f64 polish.

PyTorch port of ``primme_tpu/refine.py``. Run the solver in f32, then
refine the returned block in float64 with a locally optimal block
preconditioned CG (LOBPCG) on the Rayleigh quotient over span[X, K R, P]:
linear convergence at the preconditioned-gap rate from an X that is
already f32-accurate, so the f64 phase is a short tail, not a solve.

The reference sends this tail to the host because TPU matmuls have no f64
datapath. Hopper has native FP64, so here the polish runs on the card:
the operator's own f64 kernel does every product (the f64 stencil of the
north star), and the small ``eigh``/``cholesky``/triangular solves go to
``torch.linalg``. Each LOBPCG step reads two scalars back to the host
(the convergence test), and its ``eigh`` waits for the card.

While a profiler records, the polish runs under ``pt_refine``, each step
under ``pt_refine_step`` (its products under ``pt_matvec``, its
orthonormalization under ``pt_ortho``), the norm estimate under
``pt_anorm`` and the results' copies under ``pt_to_host``; each wait for
the card is a counted ``pt_read``
(:func:`~primme_tpu_torch.core.linalg.host_read`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.linalg import (host_read, host_reads, rand_block, scope, scoped,
                          scoped_mv)
from .operators import (CastOperator, aslinearoperator, apply_precond,
                        default_device)

F64 = torch.float64


def _orth(S):
    """Two-pass CholeskyQR; collapsed columns (e.g. the zero P block of
    the first iteration) stay exactly zero. Returns ``(S, live)``."""
    m = S.shape[1]
    nrm2 = torch.sum(S * S, dim=0)
    S = S * torch.where(nrm2 > 1e-20,
                        1.0 / torch.sqrt(torch.clamp(nrm2, min=1e-300)),
                        0.0)[None, :]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    for _ in range(2):
        G = S.T @ S
        dead = torch.diagonal(G) < 1e-8
        G = 0.5 * (G + G.T) + torch.diag(torch.where(dead, 1.0, 1e-14))
        L, info = torch.linalg.cholesky_ex(G)
        # a failed factorization yields NaNs, as jnp.linalg.cholesky does
        L = torch.where(info == 0, L, torch.nan)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        S = (S @ Li.T) * (~dead).to(S.dtype)[None, :]
    live = torch.sum(S * S, dim=0) > 0.25
    return S * live.to(S.dtype)[None, :], live


@scoped("pt_refine_step")
def refine_step(Aop, K, X, P, sgn: float):
    """One LOBPCG step over span[X, K R, P] (the reference's ``step``):
    returns ``(X, P, lam, res)`` with ``res`` the true residual norms of
    the new pairs."""
    k = X.shape[1]
    AX = scoped_mv(Aop, X)
    H = X.T @ AX
    lam = torch.diagonal(H)
    R = AX - X @ H          # full block residual (X not yet RR-aligned)
    W = apply_precond(K, R, lam) if K is not None else R
    # normalize the residual directions: their magnitude is the (tiny)
    # residual scale, far below _orth's dead-column floor
    wn = torch.linalg.vector_norm(W, dim=0)
    W = torch.where(wn > 1e-300, W / torch.clamp(wn, min=1e-300)[None, :],
                    0.0)
    # the scope opens here, not on _orth: a wrapper's arguments would keep
    # the concatenated block alive through _orth and raise the peak memory
    with scope("pt_ortho"):
        S, live = _orth(torch.cat([X, W, P], dim=1))
    AS = scoped_mv(Aop, S)
    Hs = S.T @ AS
    Hs = 0.5 * (Hs + Hs.T)
    # dead columns get a decoupled sentinel ramp just above the live
    # spectrum (in the sign-flipped ordering space)
    scale = 2.0 * torch.max(torch.abs(Hs)) + 1.0
    ramp = (1.0 + torch.arange(Hs.shape[0], dtype=Hs.dtype,
                               device=Hs.device)) * scale
    Hs = sgn * Hs + torch.diag(torch.where(live, 0.0, ramp))
    w, Y = host_read(torch.linalg.eigh, Hs)
    Y = Y[:, :k]
    X2 = S @ Y
    lam2 = sgn * w[:k]
    # LOBPCG implicit P: the part of the new X outside the old X block
    Yp = Y.clone()
    Yp[:k, :] = 0.0
    P2 = S @ Yp
    pn = torch.linalg.vector_norm(P2, dim=0)
    P2 = torch.where(pn > 1e-14, P2 / torch.clamp(pn, min=1e-300)[None, :],
                     0.0)
    R2 = scoped_mv(Aop, X2) - X2 * lam2[None, :]
    res = torch.linalg.vector_norm(R2, dim=0)
    return X2, P2, lam2, res


def _f64(op, device):
    op = aslinearoperator(op).to(device)
    return op if op.dtype == F64 else CastOperator(op, F64)


@scoped("pt_anorm")
def _anorm_power(Aop, n: int, device, iters: int = 12) -> float:
    """||A|| by ``iters`` f64 power iterations from a seeded normal start
    (the refinement's convergence test needs the top of the spectrum,
    which the refined block does not contain)."""
    v = rand_block(torch.Generator().manual_seed(0), n, 1, F64, device)
    nrm = torch.zeros((), dtype=F64, device=device)
    for _ in range(iters):
        w = scoped_mv(Aop, v)
        nrm = torch.linalg.vector_norm(w)
        v = w / nrm
    return host_read(float, nrm)


@scoped("pt_refine")
def refine_eigsh(A: Any, X0: Any, *, tol: float, OPinv: Any = None,
                 which: str = "SA", maxiter: int = 300, aNorm: float = 0.0,
                 device: Any = None, return_stats: bool = False,
                 progress: int = 0):
    """Refine approximate eigenpairs of Hermitian ``A`` to ``tol * ||A||``
    in float64 (the reference's ``refine_eigsh``).

    ``X0``: ``[n, k]`` approximate eigenvectors in any precision (numpy or
    a tensor), e.g. an f32 ``eigsh``'s. ``OPinv``: a preconditioner (a
    port operator such as :class:`~primme_tpu_torch.ChebyshevPrecond`).
    Returns numpy ``(evals, evecs)`` (+ ``stats``: ``num_refine_iters``,
    ``resnorms``, ``anorm_estimate``, ``num_host_reads``: the call's
    waits for the card, :func:`~.core.linalg.host_read`) with every true
    f64 residual norm ``<= tol * ||A||``, or the best reached at
    ``maxiter``. ``device``:
    None (or ``"auto"``) is the card, and raises without one; ``"cpu"``
    runs on the CPU."""
    reads0 = host_reads()
    device = default_device(None if device == "auto" else device,
                            "refine_eigsh")
    Aop = _f64(A, device)
    K = _f64(OPinv, device) if OPinv is not None else None
    if not isinstance(X0, torch.Tensor):
        X0 = torch.as_tensor(np.asarray(X0, np.float64))
    X = (X0.to(device=device, dtype=F64) if X0.device.type == device.type
         else host_read(X0.to, device=device, dtype=F64))
    n = X.shape[0]
    sgn = 1.0 if which.upper() in ("SA", "SM") else -1.0

    P = torch.zeros_like(X)
    with scope("pt_ortho"):
        X, _ = _orth(X)
    anorm = float(aNorm)
    if anorm <= 0:
        anorm = _anorm_power(Aop, n, device)
    lam = res = None
    it = 0
    for it in range(1, maxiter + 1):
        X, P, lam, res = refine_step(Aop, K, X, P, sgn)
        lmax, mres = host_read(torch.Tensor.tolist,
                               torch.stack((torch.max(torch.abs(lam)),
                                            torch.max(res))))
        anorm = max(anorm, lmax)
        if progress and it % progress == 0:
            print(f"  refine it={it} max_res/||A||={mres / anorm:.2e}",
                  flush=True)
        if mres <= tol * anorm:
            break
    with scope("pt_to_host"):
        lam_h = host_read(lam.cpu).numpy()
        order = np.argsort(sgn * lam_h)
        out = (lam_h[order], host_read(X.cpu).numpy()[:, order])
        if return_stats:
            res_h = host_read(res.cpu).numpy()[order]
    if return_stats:
        out = out + ({"num_refine_iters": it, "resnorms": res_h,
                      "anorm_estimate": anorm,
                      "num_host_reads": host_reads() - reads0},)
    return out
