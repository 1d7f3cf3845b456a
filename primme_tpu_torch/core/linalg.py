"""Dense numerics substrate: masked kernels under static shapes.

PyTorch port of ``primme_tpu/core/linalg.py`` (its Hermitian subset:
the B inner product of generalized problems, Rayleigh-Ritz, refined and
harmonic extraction). The reference's central design move is kept so that
arrays compare one to one:
PRIMME's dynamic basis size is a count over fixed-shape ``[n, mmax]``
arrays whose inactive columns are exactly zero. Here the count is a host
integer, so a prefix projection may slice to it directly instead of
bucketing widths (the result is the same: the columns past the count are
zero).

Small dense factorizations (``eigh``, ``cholesky``, triangular solves) go
to ``torch.linalg``. Products run in full f32/f64: the port disables TF32
at import (``primme_tpu_torch/__init__.py``), the counterpart of the
reference's ``Precision.HIGHEST``; a Gram of single-precision blocks
accumulates in double precision (:func:`gram`).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..params import Target
from . import comm as cm
from .comm import col_dots, col_norms


def scope(name: str):
    """A ``torch.profiler`` scope: one of the reference's phase scopes
    (``pt_matvec``, ``pt_precond``, ``pt_ortho``, ``pt_dense``), to which
    :func:`primme_tpu_torch.profiling.measure_breakdown` attributes the
    device time of the kernels launched inside it, or a layer's span
    (``pt_eigsh``, ``pt_outer``, ``pt_inner``, ``pt_refine``, ...; README
    lists them). Opened only while a profiler records: a solve that
    nobody traces pays no scope."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


class _Reads(threading.local):
    n = 0


_READS = _Reads()


def host_reads() -> int:
    """The reads this thread has made through :func:`host_read`, a running
    count: a call's reads are the difference across it."""
    return _READS.n


def host_read(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call at which the host waits for the
    card: a read back (``.cpu()``, ``.tolist()``, ``int``, ``float`` or
    ``bool`` of a device tensor), a blocking copy to the card, or a
    ``torch.linalg`` call that checks its result on the host (``eigh``,
    ``cholesky``, ``lu_factor``, ``svd``). Counted (:func:`host_reads`)
    and, while a profiler records, under the ``pt_read`` scope, so that
    the card's idle time at the wait is put down to the read. Pass the
    tensor computed already: a kernel that makes it belongs outside the
    read."""
    _READS.n += 1
    if torch.autograd._profiler_enabled():
        with record_function("pt_read"):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


def scoped_mv(Op, X):
    """``Op.matmat(X)`` under the ``pt_matvec`` scope (the reference's
    ``timeMatvec`` attribution)."""
    with scope("pt_matvec"):
        return Op.matmat(X)


def scoped(name: str):
    """A decorator: the function runs under the ``name`` scope (``pt_dense``
    on the projected solves is the reference's ``timeDense``
    attribution). The wrapper holds the arguments until the function
    returns, so a function that frees a large argument early (by
    rebinding its name) is scoped by its caller instead."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with scope(name):
                return fn(*a, **k)
        return wrapped
    return wrap


def real_dtype(dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def machine_eps(dtype) -> float:
    return float(torch.finfo(real_dtype(dtype)).eps)


_LOW_PREC = (torch.bfloat16, torch.float16)


def compute_dtype(dtype) -> torch.dtype:
    """Accumulation dtype for a storage dtype: f32 for half precision
    (bf16 or f16, the reference's half-precision basis: stored in half,
    every product and small dense solve in f32)."""
    return torch.float32 if dtype in _LOW_PREC else dtype


def _compute_of(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The compute dtype of an operation on ``a`` and ``b``: their promoted
    type, f32 where that is a half type (a half basis against an f32
    block)."""
    return compute_dtype(torch.promote_types(a.dtype, b.dtype))


def col_mask(width: int, active: int, device=None) -> torch.Tensor:
    """[width] bool mask: index < active."""
    return torch.arange(width, device=device) < active


def mask_cols(X: torch.Tensor, active: int) -> torch.Tensor:
    """Zero out columns with index >= active."""
    return torch.where(col_mask(X.shape[1], active, X.device)[None, :], X, 0)


_WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def gram(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X^H Y at full precision, returned in the compute type of X's and Y's
    (their promoted type; f32 for a half-precision block, as the
    reference's ``compute_dtype``). Single-precision blocks (f32,
    complex64, and so a half basis) are summed in double precision: the card's
    GEMM sums the basis' n-long columns in f32 less accurately than the
    host's, and the block Krylov start and its orthogonalization amplify
    that. Summed in f32 on an NVIDIA H100 80GB HBM3 (700 W), the
    complex64 basis of ``chip_smoke.py`` phase 26 (n = 262,144, ||A|| ~
    110) came out orthonormal only to 2.1e-5, against 1.7e-6 on the CPU,
    and its Ritz values 1.3e-4 off; summed in double, to 1.3e-7
    (``ROADMAP.md`` Queue C).

    A complex ``Y`` of one column on the card is multiplied the other way
    round, ``(Y^H X)^H``: cuBLAS's conjugate-transposed matrix-vector
    product that ``X^H y`` becomes took 17.8 ms for a complex128 ``X`` of
    262,144 x 24 on the same card, ``y^H X`` 0.049 ms
    (``tools/torch_gram_bench.py``).

    ``X`` and ``Y`` are row-sharded blocks: under a sharded solve the
    local product is summed over the ranks, before the cast back from
    double. :func:`small_gram` is the same product of small replicated
    matrices."""
    return _gram(X, Y, True)


def small_gram(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X^H Y`` of two small replicated matrices (the projected problem's
    coefficient blocks) at :func:`gram`'s precision, with no sum over
    ranks."""
    return _gram(X, Y, False)


def _gram(X, Y, rows: bool):
    dtype = _compute_of(X, Y)
    wide = _WIDE.get(dtype)
    X, Y = X.to(wide or dtype), Y.to(wide or dtype)
    if X.is_cuda and X.is_complex() and Y.shape[1] == 1:
        G = (Y.mH @ X).mH.resolve_conj()
    else:
        G = X.mH @ Y
    if rows:
        G = cm.global_sum(G)
    return G if wide is None else G.to(dtype)


def bcomb(V: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Basis combination V @ C at full precision, in the compute type of
    the two (a half basis combines in f32; rounding back to storage is the
    caller's store, as in the reference)."""
    cd = _compute_of(V, C)
    return V.to(cd) @ C.to(cd)


def prefix_project(P, C, X, count: int):
    """``X - P_w (C_w^H X)`` over the first ``count`` columns (columns
    ``>= count`` of ``P`` and ``C`` are exactly zero)."""
    if count <= 0:
        return X
    return X - bcomb(P[:, :count], gram(C[:, :count], X))


def prefix_project2(Q, BQ, X, BX, count: int, same: bool):
    """Project ``X`` (and ``BX``, sharing the overlap ``BQ_w^H X``) out of
    the first ``count`` columns of ``(Q, BQ)``: the B-ortho counterpart of
    :func:`prefix_project`. ``same`` means ``BX`` aliases ``X`` (no mass
    matrix). Returns ``(X, BX)``."""
    if count <= 0:
        return X, BX
    oq = gram(BQ[:, :count], X)
    X2 = X - bcomb(Q[:, :count], oq)
    BX2 = X2 if same else BX - bcomb(BQ[:, :count], oq)
    return X2, BX2


def rand_block(gen: torch.Generator, n: int, bs: int, dtype, device):
    """Standard normal ``[n, bs]`` block drawn from the CPU generator
    ``gen`` and moved to ``device``, so the CPU and GPU streams agree. A
    complex block draws its real part, then its imaginary part, each
    standard normal (the reference's ``_rand_block``). ``n`` is the global
    row count: under a sharded solve every rank draws the global block and
    keeps its own rows, so the stream is the unsharded solve's."""
    rdt = real_dtype(dtype)
    X = torch.randn((n, bs), generator=gen, dtype=rdt)
    if dtype.is_complex:
        X = torch.complex(X, torch.randn((n, bs), generator=gen, dtype=rdt))
    return host_read(cm.rows_of(X).to, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Block orthonormalization
# ---------------------------------------------------------------------------

class OrthoResult(NamedTuple):
    X: torch.Tensor       # orthonormalized block [n, bs]
    BX: torch.Tensor      # B X (alias of X when there is no mass matrix)
    n_random: int         # columns replaced by random vectors


def _chol_qr(X, BX, active_bs: int, thresh2):
    """One CholeskyQR pass on the active columns of X with deficiency
    detection (reference ``_chol_qr``, kept with its explicit small
    inverse so the numerics match). Returns (X, BX, bad_mask)."""
    bs = X.shape[1]
    G = gram(X, BX)
    cd = G.dtype            # a half block's small matrices are f32
    d = torch.diagonal(G).real
    amask = col_mask(bs, active_bs, X.device)
    bad = ((d <= thresh2) | ~torch.isfinite(d)) & amask
    inact = bad | ~amask
    unit = torch.where(inact, 1.0, 0.0).to(cd)
    keep = (~inact).to(cd)
    Gs = G * keep[:, None] * keep[None, :] + torch.diag(unit)
    L, info = torch.linalg.cholesky_ex(Gs)
    # a failed factorization yields NaNs, as jnp.linalg.cholesky does
    L = torch.where(info == 0, L, torch.nan)
    eye = torch.eye(bs, dtype=cd, device=X.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    C = Linv.mH
    Xn = bcomb(X, C)
    BXn = Xn if BX is X else bcomb(BX, C)
    good = (amask & ~bad).to(cd)
    return Xn * good[None, :], BXn * good[None, :], bad


def block_ortho(X, V, Q, active_bs: int, gen: torch.Generator,
                n_iters: int = 2, locked_count: Optional[int] = None,
                Bop=None, BV=None, BQ=None) -> OrthoResult:
    """:func:`_block_ortho` under the ``pt_ortho`` scope (the reference's
    ``timeOrtho`` attribution)."""
    with scope("pt_ortho"):
        return _block_ortho(X, V, Q, active_bs, gen, n_iters=n_iters,
                            locked_count=locked_count, Bop=Bop, BV=BV,
                            BQ=BQ)


def _block_ortho(X, V, Q, active_bs: int, gen: torch.Generator,
                 n_iters: int = 2, locked_count: Optional[int] = None,
                 Bop=None, BV=None, BQ=None) -> OrthoResult:
    """B-orthonormalize ``X[:, :active_bs]`` against the basis ``V``
    (inactive columns exactly zero; ``BV`` its B image), the locked
    vectors ``Q`` (or None; ``BQ`` their B images) and internally:
    ``n_iters`` passes of block classical Gram-Schmidt + CholeskyQR;
    columns found dependent in the first pass are replaced by random
    vectors from ``gen`` (reference ``block_ortho``). Without ``Bop`` the
    B images are the vectors themselves. Random numbers are drawn only
    when a column is replaced."""
    n = cm.global_rows(X.shape[0])
    rdt = real_dtype(X.dtype)
    meps = max(machine_eps(X.dtype), machine_eps(V.dtype))
    same = Bop is None
    if same:
        BV, BQ = V, Q

    def project_out(X, BX):
        X, BX = prefix_project2(V, BV, X, BX, V.shape[1], same)
        if Q is not None:
            count = Q.shape[1] if locked_count is None else locked_count
            X, BX = prefix_project2(Q, BQ, X, BX, count, same)
        return X, BX

    BX = X if same else Bop.matmat(X)
    nrm0_2 = torch.clamp(col_dots(X, BX).real, min=torch.finfo(rdt).tiny)
    thresh2 = (meps ** 2 * 64.0) * nrm0_2

    total_bad = 0
    for it in range(n_iters):
        X, BX = project_out(X, BX)
        X, BX, bad = _chol_qr(X, BX, active_bs, thresh2)
        if it == 0:
            nbad = host_read(int, bad.sum())
            total_bad += nbad
            if nbad:
                rnd = rand_block(gen, n, X.shape[1], X.dtype, X.device)
                rnd = rnd / float(n) ** 0.5
                X = torch.where(bad[None, :], rnd, X)
                BX = X if same else torch.where(bad[None, :],
                                                Bop.matmat(rnd), BX)
            thresh2 = torch.full_like(thresh2, meps ** 2 * 64.0)
    return OrthoResult(X=X, BX=BX, n_random=total_bad)


# ---------------------------------------------------------------------------
# Projected (small dense) eigenproblem with masking + target sort
# ---------------------------------------------------------------------------

def target_sort_keys(w, target: Target, shifts, shift_idx: int):
    """Sort keys so that ``argsort(keys)`` orders Ritz values by target
    preference; ``shifts[min(shift_idx, len-1)]`` is the shift of the pair
    currently sought. Complex values (a normal operator's) order by their
    real part for SR/LR, by ``|w - sigma|`` for SM/LM and by the real part
    relative to ``sigma`` for CGT/CLT; sort the keys stably, since a real
    matrix's conjugate pairs tie."""
    if w.is_complex():
        return _complex_sort_keys(w, target, shifts, shift_idx)
    if target == Target.smallest:
        return w
    if target == Target.largest:
        return -w
    s = shifts[min(int(shift_idx), shifts.shape[0] - 1)]
    d = w - s
    big = torch.finfo(w.dtype).max / 8
    if target == Target.closest_abs:
        return torch.abs(d)
    if target == Target.largest_abs:
        return -torch.abs(d)
    if target == Target.closest_geq:
        return torch.where(d >= 0, d, big - d)
    if target == Target.closest_leq:
        return torch.where(d <= 0, -d, big + d)
    raise ValueError(target)


def _complex_sort_keys(w, target: Target, shifts, shift_idx: int):
    """The reference's complex branch of ``target_sort_keys``: real keys
    for complex Ritz values."""
    if target == Target.smallest:
        return w.real
    if target == Target.largest:
        return -w.real
    s = shifts[min(int(shift_idx), shifts.shape[0] - 1)]
    d = torch.abs(w - s.to(w.dtype))
    if target == Target.closest_abs:
        return d
    if target == Target.largest_abs:
        return -d
    # geq/leq: the real part relative to the shift (modulus has no order)
    dr = w.real - s.real.to(w.real.dtype)
    big = torch.finfo(dr.dtype).max / 8
    if target == Target.closest_geq:
        return torch.where(dr >= 0, dr, big - dr)
    if target == Target.closest_leq:
        return torch.where(dr <= 0, -dr, big + dr)
    raise ValueError(f"{target} unsupported for normal operators")


class ProjectedSolution(NamedTuple):
    hvals: torch.Tensor   # [mmax] Ritz values, target-sorted; pads -> finfo.max
    hvecs: torch.Tensor   # [mmax, mmax] coefficient vectors (columns), sorted
    active: torch.Tensor  # [mmax] bool, col j is a real (in-basis) pair


def _embed(w, Z, mmax: int, rdt) -> ProjectedSolution:
    """A solution of the active ``b x b`` block (values ``w``, vectors
    ``Z``, already in target order) as the reference's fixed-shape one:
    pads after the ``b`` pairs, valued ``finfo.max``, zero columns."""
    b = w.shape[0]
    dev = Z.device
    hvals = torch.full((mmax,), torch.finfo(rdt).max, dtype=rdt, device=dev)
    hvals[:b] = w
    hvecs = torch.zeros((mmax, mmax), dtype=Z.dtype, device=dev)
    hvecs[:b, :b] = Z
    return ProjectedSolution(hvals=hvals, hvecs=hvecs,
                             active=col_mask(mmax, b, dev))


def projected_eigh(M):
    """``eigh`` of a small projected matrix, computed in double precision
    for a single-precision one and returned in its precision. cuSOLVER's
    f32 ``syevd`` loses the digits an interior Ritz value needs (JDQR +
    Jacobi at sigma=50 on ``tests/test_eigsh.py``'s fixture, n = 1024,
    took 2425 matvecs with it on an NVIDIA H100 80GB HBM3 at 700 W against
    476 with LAPACK's f32 on the host; ``tools/torch_small_dense.py``). The
    matrix is at most mmax x mmax."""
    wide = _WIDE.get(M.dtype)
    if wide is None:
        return host_read(torch.linalg.eigh, M)
    w, Z = host_read(torch.linalg.eigh, M.to(wide))
    return w.to(real_dtype(M.dtype)), Z.to(M.dtype)


@scoped("pt_dense")
def solve_H_rr(H, b: int, target: Target, shifts, shift_idx: int,
               G=None) -> ProjectedSolution:
    """Rayleigh-Ritz on the active ``b x b`` block of ``H`` (reference
    ``solve_H_rr``). The reference decouples the inactive diagonal with a
    sentinel ramp so that one fixed-shape ``eigh`` serves every ``b``; the
    basis size is a host integer here, so the block is solved alone. The
    result is the same, and it keeps the small eigenvalues accurate where
    the ramp (up to ~mmax times ||H||) costs cuSOLVER's f32 ``eigh`` digits
    that interior targets need (:func:`projected_eigh`).

    ``G`` is the explicit Gram ``V^H B V`` of the basis (the reference's
    ``orth=explicit_I``): a half-precision basis is orthonormal only to
    its storage eps, so the projected problem is the pencil ``H y = theta
    G y``, whitened through the Cholesky factor ``L`` of ``G`` (a small
    perturbation of I) and the vectors brought back as ``L^-H z``; in
    double precision for a single-precision ``H``, as the ``eigh``."""
    mmax = H.shape[0]
    rdt = real_dtype(H.dtype)
    if G is not None:
        wide = _WIDE.get(H.dtype, H.dtype)
        Gb = G[:b, :b].to(wide)
        L = host_read(torch.linalg.cholesky, 0.5 * (Gb + Gb.mH))
        Hm = torch.linalg.solve_triangular(L, H[:b, :b].to(wide), upper=False)
        Hm = torch.linalg.solve_triangular(L, Hm.mH, upper=False).mH
        w, Z = host_read(torch.linalg.eigh, 0.5 * (Hm + Hm.mH))
        Z = torch.linalg.solve_triangular(L.mH, Z, upper=True)
        w, Z = w.to(rdt), Z.to(H.dtype)
        keys = target_sort_keys(w, target, shifts.to(w.dtype), shift_idx)
        order = torch.argsort(keys, stable=True)
        return _embed(w[order], Z[:, order], mmax, rdt)
    w, Z = projected_eigh(H[:b, :b])
    keys = target_sort_keys(w, target, shifts.to(w.dtype), shift_idx)
    order = torch.argsort(keys, stable=True)
    return _embed(w[order], Z[:, order], mmax, rdt)


def complex_dtype(dtype) -> torch.dtype:
    """The complex type of ``dtype``'s precision (a complex type itself)."""
    return {torch.float32: torch.complex64,
            torch.float64: torch.complex128}.get(dtype, dtype)


@scoped("pt_dense")
def solve_H_normal(H, b: int, target: Target, shifts, shift_idx: int
                   ) -> ProjectedSolution:
    """Projected solve for a normal operator (reference
    ``solve_H_normal``): ``H = V^H A V`` is not Hermitian and its Ritz
    values are complex. As in the reference, the inactive diagonal of the
    masked ``mmax x mmax`` matrix is ramped past the active spectrum and
    one ``eig`` serves every ``b``; a column with more than half its mass
    on inactive rows is a pad. The pairs are sorted by target, and QR of
    the sorted vectors orthonormalizes them (the Schur-vector
    equivalent). ``eig`` runs on a host copy in complex128, as the
    reference runs numpy's on the host, and :func:`projected_eigh` solves
    in double for the same reason; the rest follows it there and the
    result goes back to ``H``'s device in ``H``'s complex type. Returns
    complex ``hvals`` (pads ``finfo.max``)."""
    mmax = H.shape[0]
    dev = H.device
    rdt = real_dtype(H.dtype)
    cdt = complex_dtype(rdt)
    amask = col_mask(mmax, b)
    Hm = torch.where(amask[:, None] & amask[None, :],
                     host_read(H.detach().to, "cpu", torch.complex128), 0)
    scale = 2.0 * torch.max(torch.abs(Hm)) + 1.0
    ramp = (1.0 + torch.arange(mmax, dtype=torch.float64)) * scale
    Hm = Hm + torch.diag(torch.where(amask, 0.0, ramp).to(torch.complex128))
    w, Z = torch.linalg.eig(Hm)
    mass = torch.abs(Z) ** 2
    support_inactive = torch.sum(mass * (~amask).to(torch.float64)[:, None],
                                 dim=0)
    nrm2 = torch.clamp(torch.sum(mass, dim=0),
                       min=torch.finfo(torch.float64).tiny)
    is_pad = (support_inactive / nrm2) > 0.5
    keys = target_sort_keys(w, target, host_read(shifts.detach().to, "cpu",
                                                 torch.float64), shift_idx)
    keys = torch.where(is_pad, torch.finfo(torch.float64).max, keys)
    order = torch.argsort(keys, stable=True)
    w, Z, is_pad = w[order], Z[:, order], is_pad[order]
    keep = (~is_pad).to(Z.dtype)[None, :]
    Z = torch.linalg.qr(Z * keep).Q * keep
    w = torch.where(is_pad, torch.finfo(rdt).max, w)
    return ProjectedSolution(hvals=host_read(w.to, device=dev, dtype=cdt),
                             hvecs=host_read(Z.to, device=dev, dtype=cdt),
                             active=host_read((~is_pad).to, dev))


# ---------------------------------------------------------------------------
# Fused candidate residuals (Num_update_VWXR analogue)
# ---------------------------------------------------------------------------

class Candidates(NamedTuple):
    X: torch.Tensor         # Ritz vectors        [n, c]
    WX: torch.Tensor        # A X                 [n, c]
    BX: torch.Tensor        # B X (alias of X with no mass matrix)
    R: torch.Tensor         # residuals W h - B X diag(lambda)
    resnorms: torch.Tensor  # [c] 2-norms of R columns
    xnorms: torch.Tensor    # [c] 2-norms of X columns (~0: collapsed pair)


def compute_residuals(V, W, BV, hvecs_c, hvals_c) -> Candidates:
    """Candidate Ritz vectors and residuals from the coefficient block
    ``hvecs_c`` ``[mmax, c]`` and values ``hvals_c`` ``[c]`` (padded
    entries must have zero coefficient columns)."""
    with scope("pt_dense"):
        X = bcomb(V, hvecs_c)
        WX = bcomb(W, hvecs_c)
        BX = X if BV is None else bcomb(BV, hvecs_c)
        lam = torch.where(torch.isfinite(hvals_c), hvals_c, 0).to(X.dtype)
        R = WX - BX * lam[None, :]
        resnorms = col_norms(R)
        xnorms = col_norms(X)
    return Candidates(X=X, WX=WX, BX=BX, R=R, resnorms=resnorms.real,
                      xnorms=xnorms.real)


# ---------------------------------------------------------------------------
# Harmonic and refined extraction (solve_H_Harm / solve_H_Ref,
# src/eigs/solve_projection.c:430,541)
# ---------------------------------------------------------------------------
#
# As in the reference, extraction works from the R factor of a QR of a
# tall panel recomputed each outer iteration, so the conditioning is that
# of R (kappa), not of a Gram (kappa^2).


def _mask2(m: int, b: int, device):
    """[m, m] bool mask of the active ``b x b`` block."""
    amask = col_mask(m, b, device)
    return amask[:, None] & amask[None, :]


def _r_factor(S, mmax: int):
    """R of the QR of the tall ``S`` (``[n, mmax]``), padded with zero rows
    when n < mmax. A row-sharded ``S`` (a sharded solve): the R of the
    QR of every rank's R stacked in rank order (TSQR), its rows signed so
    that its diagonal is not negative. It differs from the unsharded R by
    such signs only, which the extractions do not see (they read ``R^H
    R`` and the singular vectors of ``R``-stacked blocks)."""
    R = torch.linalg.qr(S, mode="r").R
    if R.shape[0] < mmax:
        R = torch.cat([R, R.new_zeros((mmax - R.shape[0], mmax))], dim=0)
    comm = cm.active()
    if comm is None:
        return R
    # one sum over the ranks stacks them: each rank's R in its own rows
    # of a zero [P mmax, mmax] block (adding zeros is exact)
    stack = R.new_zeros((comm.size * mmax, mmax))
    stack[comm.rank * mmax:(comm.rank + 1) * mmax] = R
    R = torch.linalg.qr(cm.global_sum(stack), mode="r").R
    sgn = torch.where(torch.diagonal(R).real < 0, -1.0, 1.0).to(R.dtype)
    return sgn[:, None] * R


def shifted_qr_R(W, BV, b: int, tau):
    """R factor of the QR of (A - tau B)V = W - tau BV over the active
    columns (reference ``shifted_qr_R``); inactive rows and columns of the
    result are exactly zero."""
    mmax = W.shape[1]
    R = _r_factor(W - torch.as_tensor(tau).to(W.dtype) * BV, mmax)
    am2 = _mask2(mmax, b, W.device)
    return torch.where(am2, R, 0)


def complement_qr_R(V, W, H, b: int):
    """R factor (m x m) of the QR of D = W - V H, the part of W = AV
    orthogonal to the orthonormal basis V (reference ``complement_qr_R``):
    ``||(A - tau) V h||^2 = ||(H - tau I) h||^2 + ||G h||^2``. Standard
    problems only."""
    mmax = W.shape[1]
    am2 = _mask2(mmax, b, W.device)
    D = W - bcomb(V, torch.where(am2, H, 0))
    return torch.where(am2, _r_factor(D, mmax), 0)


def smallest_right_svecs(C):
    """Smallest right singular vector and value of each of the stacked
    ``[b, 2b, b]`` matrices ``C``, on ``C``'s device. A single-precision
    ``C``: the lowest eigenvector of the Gram ``C^H C`` from one batched
    ``eigh`` in double precision (as in :func:`projected_eigh`), its
    value ``||C y||`` recomputed from the vector; the Gram squares the
    conditioning, but in f64 that still resolves a singular value down to
    ~1e-8 ``||C||``, below what an f32 ``C`` holds. A double-precision
    ``C``: one batched SVD, as the reference takes it, since a solve in
    f64 may need its pairs' singular values resolved far below 1e-8
    ``||C||`` (svds' augmented stage on a near-null cluster). Returns
    ``(Y, smin)``: vectors as the columns of ``Y`` ``[b, pairs]`` in
    ``C``'s type, values ``[pairs]`` in its real type."""
    wide = _WIDE.get(C.dtype)
    if wide is None:
        _, sv, Vh = host_read(torch.linalg.svd, C, full_matrices=False)
        return Vh[:, -1, :].conj().T, sv[:, -1]
    Cw = C.to(wide)
    _, Z = host_read(torch.linalg.eigh, Cw.mH @ Cw)
    y = Z[:, :, 0]                                       # [pairs, b]
    smin = torch.linalg.vector_norm(Cw @ y[:, :, None], dim=(1, 2))
    return y.T.to(C.dtype), smin.to(real_dtype(C.dtype))


@scoped("pt_dense")
def solve_H_refined(H, G, b: int, target: Target, shifts, shift_idx: int,
                    anorm=None, conv_eps=None) -> ProjectedSolution:
    """Refined extraction (reference ``solve_H_refined``) on the active
    block: for each pair the unit coefficient vector minimizing ``||(A -
    tau_i) V h||`` with tau_i its own Rayleigh-Ritz value, the smallest
    right singular vector of ``[H - tau_i I; G]`` (one batched
    :func:`smallest_right_svecs` over the pairs); pairs keep the
    Rayleigh-Ritz order, near-duplicates are orthonormalized in that
    order and each cluster (``prepare_vecs``'s gap
    test, off without ``anorm``/``conv_eps``) is re-diagonalized by one
    block-diagonal ``eigh``."""
    mmax = H.shape[0]
    dev = H.device
    rdt = real_dtype(H.dtype)
    meps = machine_eps(H.dtype)
    base = solve_H_rr(H, b, target, shifts, shift_idx)
    if b == 0:
        return base
    Hb, Gb = H[:b, :b], G[:b, :b]
    taus = base.hvals[:b]
    eye = torch.eye(b, dtype=H.dtype, device=dev)
    top = Hb[None] - taus.to(H.dtype)[:, None, None] * eye[None]
    C = torch.cat([top, Gb[None].expand(b, -1, -1)], dim=1)    # [b, 2b, b]
    y, smin = smallest_right_svecs(C)
    hv = torch.linalg.qr(y).Q
    rq = torch.sum(hv.conj() * (Hb @ hv), dim=0).real

    brk = torch.ones((b,), dtype=torch.bool, device=dev)
    if anorm is not None and conv_eps is not None and b > 1:
        an = max(float(anorm), float(torch.finfo(rdt).tiny))
        ce = max(float(conv_eps), 6.28 * meps)
        smax = torch.max(torch.abs(taus)) + torch.max(torch.abs(Gb))
        dlam = torch.abs(rq[1:] - rq[:-1])
        min_diff = math.sqrt(2.0) * smax * meps * dlam / (an * ce)
        brk[1:] = torch.abs(smin[1:] - smin[:-1]) >= min_diff
    cid = torch.cumsum(brk.to(torch.int64), 0) - 1

    S = small_gram(hv, Hb @ hv)
    S = 0.5 * (S + S.mH)
    w, Z = projected_eigh(torch.where(cid[:, None] == cid[None, :], S, 0))
    # the matrix is block diagonal: each eigenvector lies in one cluster
    col_cid = torch.sum(torch.abs(Z) ** 2 * cid.to(rdt)[:, None], dim=0)
    tk = target_sort_keys(w, target, shifts.to(rdt), shift_idx)
    # lexicographic (cluster, target key): two stable sorts
    o1 = torch.argsort(tk, stable=True)
    order = o1[torch.argsort(torch.round(col_cid)[o1], stable=True)]
    return _embed(w[order], bcomb(hv, Z)[:, order], mmax, rdt)


@scoped("pt_dense")
def solve_H_harmonic(H, R, b: int, target: Target, shifts,
                     shift_idx: int) -> ProjectedSolution:
    """Harmonic Rayleigh-Ritz (reference ``solve_H_harmonic``) on the
    active block: the pencil ``(H - tau I) h = mu R^H R h``, whose right
    side factors as ``R^H R`` so its Cholesky factor is ``R^H`` (a
    near-singular diagonal clamped at 32 macheps of the largest, the
    reference's unit pad diagonal counted where there are pads); harmonic
    values ``tau + 1/mu`` sorted by target, coefficient vectors
    orthonormalized in that order, returned values the Rayleigh
    quotients."""
    mmax = H.shape[0]
    dev = H.device
    rdt = real_dtype(H.dtype)
    tiny = torch.finfo(rdt).tiny
    tau = shifts[min(int(shift_idx), shifts.shape[0] - 1)].to(rdt)
    Rb, Hb = R[:b, :b], H[:b, :b]
    d = torch.diagonal(Rb)
    mag = torch.abs(d)
    dmax = torch.max(mag) if b else torch.zeros((), dtype=rdt, device=dev)
    if b < mmax:
        dmax = torch.clamp(dmax, min=1.0)
    floor = 32.0 * machine_eps(H.dtype) * torch.clamp(dmax, min=tiny)
    phase = torch.where(mag > tiny, d / torch.clamp(mag, min=tiny),
                        torch.ones((), dtype=H.dtype, device=dev))
    dnew = torch.where(mag < floor, phase * floor.to(H.dtype), d)
    L = (Rb + torch.diag(dnew - d)).mH           # lower; L L^H = R^H R
    Hm = Hb - tau.to(H.dtype) * torch.eye(b, dtype=H.dtype, device=dev)
    S1 = torch.linalg.solve_triangular(L, Hm, upper=False)
    S = torch.linalg.solve_triangular(L, S1.mH, upper=False)
    mu, Z = projected_eigh(0.5 * (S + S.mH))
    hv = torch.linalg.solve_triangular(L.mH, Z, upper=True)
    safe_mu = torch.where(torch.abs(mu) < tiny, tiny, mu)
    keys = target_sort_keys(tau + 1.0 / safe_mu, target, shifts.to(rdt),
                            shift_idx)
    hv = torch.linalg.qr(hv[:, torch.argsort(keys, stable=True)]).Q
    rq = torch.sum(hv.conj() * (Hb @ hv), dim=0).real
    return _embed(rq, hv, mmax, rdt)


def orthonormalize_coeffs(C, valid, dtype_eps: float):
    """Orthonormalize small coefficient columns (rank-revealing, eigh
    based); invalid or dependent columns come out zero (reference
    ``orthonormalize_coeffs``, restart after refined/harmonic
    extraction). Returns ``(Q, ok)``."""
    C = C * valid.to(C.dtype)[None, :]
    G = small_gram(C, C)
    w, U = host_read(torch.linalg.eigh, G)
    wmax = torch.clamp(torch.max(w), min=1.0)
    ok = w > 64.0 * dtype_eps * wmax
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, w, 1.0)), 0.0)
    return bcomb(C, U * inv[None, :].to(C.dtype)), ok
