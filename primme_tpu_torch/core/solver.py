"""Core eigensolver iteration: block (Jacobi-)Davidson.

PyTorch port of ``primme_tpu/core/solver.py`` for Hermitian problems,
standard or generalized (a mass matrix B: the basis is B-orthonormal and
the state carries ``BV``/``Bevecs``), with orthogonality constraints
(columns ``[0, noc)`` of ``evecs``), Rayleigh-Ritz, refined or harmonic
extraction, GD/GD+k or JDQMR corrections, hard or soft locking, and the
spectrum-verification probe; and for normal (non-Hermitian) operators
(``hermitian=False``, the reference's KIND(N) axis): a complex basis,
complex Ritz values from :func:`~.linalg.solve_H_normal`, and ``H``'s row
panel computed rather than mirrored.

The reference's fixed-shape masked state is kept so that arrays compare
one to one: the basis is ``[n, mmax]`` with a basis size ``b`` whose
inactive columns are exactly zero. Its ``lax.while_loop``/``cond``/
``fori_loop`` become host Python loops and branches: integer state
(``b``, counts) and the scalars that steer branches live on the host, the
arrays on the device, and each branch reads back what it needs, through
:func:`~.linalg.host_read` (counted; a ``pt_read`` span under a profiler,
beside the ``pt_init``, ``pt_outer``, ``pt_window``, ``pt_probe`` and
``pt_restart`` spans of the loop's layers). Where the
reference rebuilt an ``[n, mmax]`` array to change a few columns, the port
writes those columns in place. Random numbers come from one CPU
``torch.Generator``, the caller's or one seeded from ``rng_seed``, and
are moved to the device.

``PTPU_PROBE_ITERS`` (read at import, default 32) caps the probe
subsolve's iterations; ``PTPU_PROBE_DEBUG`` prints a line a probe round
(any value) and one a probe iteration (``2``), as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..params import PrimmeParams, Target, ConvTest, Projection, InitBasisMode
from . import comm as cm
from .comm import all_finite, col_dots, col_norms, dot, global_max, norm
from .linalg import (Candidates, ProjectedSolution, bcomb, col_mask,
                     compute_dtype, gram, small_gram,
                     real_dtype, machine_eps, solve_H_rr, block_ortho,
                     compute_residuals, target_sort_keys, prefix_project,
                     rand_block, shifted_qr_R, complement_qr_R,
                     solve_H_refined, solve_H_harmonic, solve_H_normal,
                     orthonormalize_coeffs, scope, scoped, scoped_mv,
                     host_read)

_BIG = 1 << 20  # stable-sort priority offset

_replace = dataclasses.replace


@dataclass
class Stats:
    """Per-solve counters (``primme_stats``); host numbers."""

    num_outer_iterations: int = 0
    num_restarts: int = 0
    num_matvecs: int = 0
    num_preconds: int = 0
    num_inner_iterations: int = 0
    num_locked: int = 0
    num_random: int = 0            # random-vector ortho recoveries
    num_resets: int = 0            # basis resets (monotone; bounds cycles)
    anorm_estimate: float = 0.0
    max_conv_tol: float = 0.0      # adaptive accuracy floor
    estimate_resid_error: float = 0.0
    est_min_eval: float = 0.0
    est_max_eval: float = 0.0
    num_practical: int = 0         # weak-criterion accepts
    num_probe_rounds: int = 0
    probe_exhausted: int = 0       # 1: probe budget ran out unverified
    num_probe_matvecs: int = 0     # included in num_matvecs
    probe_unsupported: int = 0
    # 1 when the returned set survived probing (the solver state's
    # ``verified`` at extraction; the reference keeps it off its Stats)
    probe_verified: int = 0
    # the reference's analytic counts of the reductions a row-sharded
    # solve would make (globalSumReal), of the scalars they reduce, of the
    # fused residual kernel's flops and of the inner products of
    # orthogonalization, counted at the same points
    num_global_sum: int = 0
    volume_global_sum: float = 0.0
    flops_dense: float = 0.0
    num_ortho_inner_prods: float = 0.0

    @staticmethod
    def zeros(rdt):
        big = float(torch.finfo(rdt).max)
        return Stats(est_min_eval=big, est_max_eval=-big)


class ProbeResult(NamedTuple):
    found: bool
    X: torch.Tensor
    num_matvecs: int
    num_preconds: int
    valid: bool
    bnd_hi: float
    bnd_lo: float
    bnds_set: bool


@dataclass
class SolverState:
    V: torch.Tensor              # [n, mmax] basis, inactive columns zero
    W: torch.Tensor              # [n, mmax] A V
    BV: Optional[torch.Tensor]   # [n, mmax] B V (None: no mass matrix)
    H: torch.Tensor              # [mmax, mmax] V^H A V
    b: int                       # basis size
    prev_hvecs: torch.Tensor     # [mmax, kmax] +k retention candidates
    # columns [0, noc) are the orthogonality constraints, then the locked
    # pairs; Bevecs their B images (None: no mass matrix)
    evecs: torch.Tensor          # [n, lockmax]
    Bevecs: Optional[torch.Tensor]
    locked_vals: torch.Tensor    # [lockmax - noc]
    locked_res: torch.Tensor
    num_locked: int
    best_res: float              # best leading-candidate residual seen
    stall_restarts: int
    restarts_since_reset: int
    prev_ritz: torch.Tensor      # [lockmax + cwin] previous sorted Ritz values
    num_prev_ritz: int
    probe_ref: float             # ne-th best target key last verified
    probe_clean: int             # consecutive clean probe rounds
    probe_bnd_hi: float          # cached spectral bounds for the filter
    probe_bnd_lo: float
    probe_bnds_set: bool
    verified: bool
    give_up: bool
    gen: torch.Generator
    done: bool
    stats: Stats = field(default_factory=Stats)
    # the last expansion's inner-iteration event buffer [cap, blk, 3]
    # (value, eigenresidual estimate, alive); None unless
    # ``cfg.inner_trace_cap > 0``
    inner_trace: Optional[torch.Tensor] = None


class EigsResult(NamedTuple):
    evals: torch.Tensor       # [num_evals]
    evecs: torch.Tensor       # [n, num_evals]
    resnorms: torch.Tensor    # [num_evals]
    stats: Stats


class SolveConfig(NamedTuple):
    """Solver configuration distilled from
    :class:`~primme_tpu_torch.params.PrimmeParams` by :func:`make_config`."""

    n: int
    ne: int                 # num_evals
    mmax: int               # max_basis_size
    mrs: int                # min_restart_size
    blk: int                # max_block_size
    kmax: int               # max_prev_retain
    cwin: int               # candidate window width
    noc: int                # num ortho constraints
    lockmax: int
    locking: bool
    target: Target
    eps: float
    a_norm: float           # 0 -> estimate
    olsen: bool             # RightX projector: Olsen correction
    robust_shifts: bool
    max_outer: int
    max_matvecs: int
    max_inner: int          # inner (JD/QMR) solve; 0 = GD
    conv_test: ConvTest
    rel_tol_base: float
    skewX: bool
    leftQ: bool
    leftX: bool
    skewQ: bool
    rightQ: bool
    projection: Projection
    hermitian: bool
    init_random: bool
    init_user: bool = False
    b_norm: float = 0.0
    inv_b_norm: float = 0.0
    probe_extra: int = 0
    max_probe_rounds: int = 0
    probe_unsupported: int = 0
    # per-inner-iteration monitor events (primme_event_inner_iteration):
    # the QMR loop records (value, eres, alive) a step into a buffer of
    # this many rows, replayed to the monitor once per outer iteration;
    # 0 records nothing
    inner_trace_cap: int = 0
    # a half-precision basis (set by setup_solver from the storage dtype):
    # the projected problem is the pencil H y = theta (V^H B V) y, since a
    # bf16/f16 basis is orthonormal only to its storage eps (the
    # reference's orth=explicit_I), and the convergence tolerance floors at
    # 4 eps of the storage type
    orth_explicit_I: bool = False
    eps_floor: float = 0.0


def make_config(p: PrimmeParams) -> SolveConfig:
    """Distill resolved params (reference ``make_config``)."""
    mmax, blk, ne = p.max_basis_size, p.max_block_size, p.num_evals
    noc = p.num_ortho_const
    rounds = (p.num_evals + 6) if p.verify_spectrum < 0 else p.verify_spectrum
    probe_targets = (Target.smallest, Target.largest, Target.largest_abs)
    probe_ok = p.hermitian and p.target in probe_targets
    probe_extra = (min(blk, max(0, p.n - noc - ne))
                   if (rounds > 0 and probe_ok) else 0)
    cwin = min(mmax, ne + blk)
    return SolveConfig(
        n=p.n, ne=ne, mmax=mmax, mrs=p.min_restart_size, blk=blk,
        kmax=min(p.max_prev_retain, cwin), cwin=cwin, noc=noc,
        probe_extra=probe_extra, max_probe_rounds=rounds,
        probe_unsupported=int(rounds > 0 and not probe_ok),
        lockmax=noc + ne + cwin, locking=bool(p.locking), target=p.target,
        eps=p.eps, a_norm=p.a_norm, olsen=p.projectors.RightX,
        robust_shifts=p.robust_shifts,
        max_outer=min(p.max_outer_iterations, (1 << 31) - 1),
        max_matvecs=min(p.max_matvecs, (1 << 31) - 1),
        max_inner=p.max_inner_iterations, conv_test=p.conv_test,
        rel_tol_base=p.rel_tol_base, skewX=p.projectors.SkewX,
        leftQ=p.projectors.LeftQ, leftX=p.projectors.LeftX,
        skewQ=p.projectors.SkewQ, rightQ=p.projectors.RightQ,
        projection=p.projection, hermitian=p.hermitian,
        init_random=(p.init_basis_mode == InitBasisMode.random),
        init_user=(p.init_basis_mode == InitBasisMode.user),
        b_norm=p.b_norm, inv_b_norm=p.inv_b_norm)


def _host(*xs):
    """Read several device scalars back in one transfer."""
    return _host_with(xs, ())[0]


def _host_with(xs, vecs):
    """Read the device scalars ``xs`` and the 1-D tensors ``vecs`` back in
    one transfer (a complex vector as its interleaved parts). Returns the
    scalars as floats and each vector as a numpy array of its own type."""
    parts = [torch.stack([torch.as_tensor(x).to(torch.float64).reshape(())
                          for x in xs])]
    for v in vecs:
        parts.append((torch.view_as_real(v) if v.is_complex() else v)
                     .reshape(-1).to(torch.float64))
    h = host_read(torch.Tensor.cpu, torch.cat(parts)).numpy()
    out, off = [], len(xs)
    for v in vecs:
        m = v.numel() * (2 if v.is_complex() else 1)
        a = h[off:off + m]
        off += m
        ndt = str(v.dtype).replace("torch.", "")
        out.append((a[0::2] + 1j * a[1::2]).astype(ndt) if v.is_complex()
                   else a.astype(ndt))
    return h[:len(xs)].tolist(), out


def _ortho_counts(cfg: SolveConfig, has_locked: bool):
    """Reductions and scalars of one ``block_ortho`` call (the reference's
    ``_ortho_counts``): two CGS passes over the basis (and the locked
    vectors) plus the CholeskyQR Gram, the reference norms and the
    survivor norms."""
    blk = cfg.blk
    ngs = 2 * (1 + (1 if has_locked else 0) + 1) + 2
    vol = (2 * (cfg.mmax * blk + (cfg.lockmax * blk if has_locked else 0)
                + blk * blk) + 2 * blk)
    return ngs, float(vol)


def _locked(cfg: SolveConfig, s: SolverState):
    """``(Q, BQ)``: the constraint and locked columns and their B images,
    or ``(None, None)`` when the solve has neither."""
    if not (cfg.noc > 0 or cfg.locking):
        return None, None
    return s.evecs, (s.Bevecs if s.Bevecs is not None else s.evecs)


def _ortho(cfg: SolveConfig, B, s: SolverState, X, nact: int,
           **kw):
    """``block_ortho`` of X against the basis and the locked columns of
    ``s`` in the B inner product."""
    Q, BQ = _locked(cfg, s)
    return block_ortho(X, s.V, Q, nact, s.gen,
                       locked_count=cfg.noc + s.num_locked, Bop=B,
                       BV=s.BV, BQ=BQ, **kw)


# ---------------------------------------------------------------------------
# Basis initialization (init_basis, src/eigs/init.c:125)
# ---------------------------------------------------------------------------

def init_basis(A, B, cfg: SolveConfig, gen, evecs, Bevecs, v0, dtype,
               device):
    """Block-Krylov initial basis: ``V[:, :b0]`` spans {X0, A X0, ...},
    B-orthonormal and orthogonal to the constraint columns of ``evecs``;
    each A-application doubles as the W panel of its block. Returns
    ``(V, W, BV, H, b0, n_random)``."""
    n, mmax, blk = cfg.n, cfg.mmax, cfg.blk
    nl = cm.local_rows(n)
    if cfg.init_user:
        nguess = v0.shape[1] if v0 is not None else 0
        b0 = min(max(nguess, blk), mmax)
    else:
        b0 = max(min(cfg.mrs, mmax), min(blk, mmax))
    nb = -(-b0 // blk)
    mal = max(mmax, nb * blk)
    cdt = compute_dtype(dtype)     # block math runs here; stores round
    V = torch.zeros((nl, mal), dtype=dtype, device=device)
    W = torch.zeros((nl, mal), dtype=dtype, device=device)
    BV = None if B is None else torch.zeros((nl, mal), dtype=dtype,
                                            device=device)
    Q = evecs if cfg.noc > 0 else None
    BQ = Bevecs if (Q is not None and B is not None) else Q

    ngb = 0
    v0pad = None
    if v0 is not None:
        k0g = min(v0.shape[1], b0)
        ngb = -(-k0g // blk)
        v0pad = torch.zeros((nl, ngb * blk), dtype=cdt, device=device)
        v0pad[:, :k0g] = v0[:, :k0g].to(cdt)
        X = v0pad[:, :blk]
    else:
        X = rand_block(gen, n, blk, cdt, device)

    nrand = 0
    for i in range(nb):
        bi = i * blk
        if cfg.init_random or cfg.init_user:
            X = rand_block(gen, n, blk, cdt, device)
        if v0pad is not None and i < ngb:
            X = v0pad[:, bi:bi + blk]
        nact = min(blk, b0 - bi)
        res = block_ortho(X, V, Q, nact, gen, locked_count=cfg.noc, Bop=B,
                          BV=BV, BQ=BQ)
        V[:, bi:bi + blk] = res.X
        if B is not None:
            BV[:, bi:bi + blk] = res.BX
        Y = scoped_mv(A, res.X)
        W[:, bi:bi + blk] = Y
        X = Y.to(cdt)
        nrand += res.n_random
    V, W = V[:, :mmax].contiguous(), W[:, :mmax].contiguous()
    if B is not None:
        BV = BV[:, :mmax].contiguous()
    H = gram(V, W)
    if cfg.hermitian:
        H = 0.5 * (H + H.mH)
    return V, W, BV, H, b0, nrand


# ---------------------------------------------------------------------------
# Candidate preparation (prepare_candidates, main_iter.c:1470)
# ---------------------------------------------------------------------------

class Window(NamedTuple):
    sol: ProjectedSolution
    cands: Candidates      # width cwin, sorted order
    conv: torch.Tensor     # [cwin] bool: converged target pair
    is_target: torch.Tensor
    n_needed: int          # remaining sought pairs
    nconv: int             # converged targets in window
    tol: float
    passes: torch.Tensor   # [cwin] live pair passing the residual test
    live: torch.Tensor     # [cwin] active AND unit-norm Ritz vector


def _tolerance(cfg: SolveConfig, anorm: float, rdt) -> float:
    """||r|| < max(eps, 2 macheps) * problemNorm; ``cfg.eps_floor`` is a
    half-precision basis' resolution, below which residuals cannot go."""
    meps = machine_eps(rdt)
    eps = cfg.eps if cfg.eps > 0 else 1e4 * meps
    eps = max(eps, cfg.eps_floor)
    return max(eps, 2 * meps) * anorm


@scoped("pt_window")
def prepare_window(cfg: SolveConfig, s: SolverState, shifts, convtest=None):
    """Projected solve + residuals + convergence flags for the current
    candidate window (reference ``prepare_window``). Returns
    ``(Window, Stats)``. ``convtest`` is the user's convergence test
    (``convTestFun``): ``fn(evals [c], resnorms [c], tol, anorm_est) ->
    bool [c]`` on the window's tensors (inactive values zeroed) and the
    host floats ``tol`` and ``anorm_est``; it replaces ``resnorms <=
    tol``."""
    c = cfg.cwin
    dev = s.V.device
    rdt = real_dtype(s.H.dtype)
    fmax = float(torch.finfo(rdt).max)
    sidx = min(s.num_locked, shifts.shape[0] - 1)
    has_B = s.BV is not None
    if not cfg.hermitian:
        sol = solve_H_normal(s.H, s.b, cfg.target, shifts, sidx)
    elif cfg.projection == Projection.refined and not has_B:
        # the cluster gap test's inputs (prepare_vecs,
        # solve_projection.c:878-890)
        meps = machine_eps(s.V.dtype)
        sres = s.best_res / 10.0 if s.best_res < fmax / 4 else 0.0
        conv_eps = max(s.stats.max_conv_tol, sres, 6.28 * meps)
        an0 = max(s.stats.anorm_estimate, cfg.a_norm, 0.0)
        G = complement_qr_R(s.V, s.W, s.H, s.b)
        sol = solve_H_refined(s.H, G, s.b, cfg.target, shifts, sidx,
                              anorm=an0, conv_eps=conv_eps)
    elif cfg.projection in (Projection.refined, Projection.harmonic):
        # harmonic; refined with a mass matrix is served by harmonic, as
        # the reference does
        R = shifted_qr_R(s.W, s.BV if has_B else s.V, s.b, shifts[sidx])
        sol = solve_H_harmonic(s.H, R, s.b, cfg.target, shifts, sidx)
    else:
        G = (gram(s.V, s.BV if has_B else s.V) if cfg.orth_explicit_I
             else None)
        sol = solve_H_rr(s.H, s.b, cfg.target, shifts, sidx, G=G)
    hv_c = sol.hvecs[:, :c]
    hl_c = sol.hvals[:c]
    cands = compute_residuals(s.V, s.W, s.BV, hv_c, hl_c)
    active = sol.active[:c] & (cands.xnorms > 0.5)
    finite = torch.where(active, torch.where(torch.isfinite(hl_c), hl_c, 0), 0)
    rv = finite.real
    amax, emin, emax = _host(torch.max(torch.abs(finite)),
                             torch.min(torch.where(active, rv, fmax)),
                             torch.max(torch.where(active, rv, -fmax)))
    anorm_est = max(s.stats.anorm_estimate, amax)
    # problemNorm (auxiliary_eigs.c:567): with a mass matrix and both user
    # estimates, aNorm * invBNorm; otherwise the largest |Ritz value| seen
    user_pnorm = (cfg.a_norm * cfg.inv_b_norm
                  if has_B and cfg.inv_b_norm > 0 else cfg.a_norm)
    anorm = user_pnorm if cfg.a_norm > 0 else anorm_est
    tol = max(_tolerance(cfg, anorm, rdt), s.stats.max_conv_tol)
    n_needed = cfg.ne - s.num_locked
    if cfg.locking:
        n_intr = 0
        if s.num_locked >= cfg.ne:
            # verification-phase intruders: window pairs sorting strictly
            # inside the locked set must still be targeted and converged
            lkeys = target_sort_keys(s.locked_vals, cfg.target, shifts, sidx)
            lmask = torch.arange(lkeys.shape[0], device=dev) < s.num_locked
            worst_locked = torch.max(torch.where(lmask, lkeys, -fmax))
            wkeys = target_sort_keys(hl_c, cfg.target, shifts, sidx)
            n_intr = host_read(int, (active & (wkeys < worst_locked - tol))
                               .sum())
        n_needed = min(max(n_needed + n_intr, 0), c)
    if convtest is not None:
        passes = torch.as_tensor(
            convtest(torch.where(active, hl_c, 0), cands.resnorms, tol,
                     anorm_est), dtype=torch.bool, device=dev)
    else:
        passes = cands.resnorms <= tol
    is_target = (torch.arange(c, device=dev) < n_needed) & active
    conv = passes & is_target
    if cfg.hermitian and cfg.target in (Target.closest_geq,
                                        Target.closest_leq):
        sh = shifts[sidx]
        lv = torch.where(active, hl_c, 0)
        if cfg.target == Target.closest_geq:
            conv = conv & (lv + cands.resnorms >= sh)
        else:
            conv = conv & (lv - cands.resnorms <= sh)
    weak_only = torch.zeros_like(conv)
    if cfg.locking or cfg.noc > 0:
        # practically converged (check_practical_convergence)
        Rp = prefix_project(s.Bevecs if has_B else s.evecs, s.evecs,
                            cands.R, cfg.noc + s.num_locked)
        projres = col_norms(Rp).real
        attainable = math.sqrt(1.0 + cfg.noc + s.num_locked) * tol
        practical = (projres <= tol) & (cands.resnorms <= attainable)
        weak_only = practical & is_target & ~conv
        conv = conv | (practical & is_target)
    nconv, nweak = (int(x) for x in _host(conv.sum(), weak_only.sum()))
    # the residual kernel's flops (real types) and this window's reductions
    has_locked = cfg.locking or cfg.noc > 0
    st = s.stats
    stats = _replace(
        st, anorm_estimate=anorm_est,
        num_global_sum=(st.num_global_sum + 2 + (1 if has_locked else 0)
                        + (1 if cfg.orth_explicit_I else 0)),
        volume_global_sum=(st.volume_global_sum + 2.0 * c
                           + (float(cfg.lockmax * c) if has_locked else 0.0)
                           + (float(cfg.mmax * cfg.mmax)
                              if cfg.orth_explicit_I else 0.0)),
        flops_dense=(st.flops_dense
                     + 2.0 * cfg.n * cfg.mmax * c * (3 if has_B else 2)
                     + 3.0 * cfg.n * c),
        est_min_eval=min(st.est_min_eval, emin),
        est_max_eval=max(st.est_max_eval, emax),
        num_practical=st.num_practical + nweak)
    return Window(sol, cands, conv, is_target, n_needed, nconv, tol,
                  passes & active | conv, active), stats


def _kth_best_key(cfg: SolveConfig, s: SolverState, win: Window,
                  shifts) -> float:
    """Target key of the ne-th best pair among the locked pairs and the
    residual-passing window pairs (``finfo.max`` when fewer exist)."""
    rdt = real_dtype(s.H.dtype)
    big = float(torch.finfo(rdt).max)
    sidx = min(s.num_locked, shifts.shape[0] - 1)
    lv = s.locked_vals
    lk = target_sort_keys(lv, cfg.target, shifts, sidx)
    lk = torch.where(torch.arange(lv.shape[0], device=lv.device)
                     < s.num_locked, lk, big)
    wk = target_sort_keys(win.sol.hvals[:cfg.cwin], cfg.target, shifts, sidx)
    wk = torch.where(win.passes, wk, big)
    allk = torch.sort(torch.cat([lk, wk])).values
    return host_read(float, allk[cfg.ne - 1])


# Probe subsolve budget: iterations of the out-of-band deflated Davidson.
_PROBE_ITERS = int(os.environ.get("PTPU_PROBE_ITERS", "32"))
# Power iterations for the filter-band spectral bounds.
_POW_ITERS = 12


def _filtered_rand_block(cfg: SolveConfig, A, gen, dtype, device,
                         suppress_lo: float, suppress_hi: float,
                         degree: int):
    """Chebyshev-filtered random block for a verification-probe round
    (reference ``_filtered_rand_block``): the last ``blk`` iterates of one
    Chebyshev recurrence that suppresses ``[suppress_lo, suppress_hi]``.
    Costs ``degree`` matvecs (counted by the caller)."""
    n, blk = cfg.n, cfg.blk
    rdt = real_dtype(dtype)
    x = rand_block(gen, n, 1, dtype, device)
    ctr = (suppress_hi + suppress_lo) / 2
    hw = max((suppress_hi - suppress_lo) / 2,
             float(torch.finfo(rdt).tiny) * 1e8)
    # the reference evaluates the band in the working precision
    ctr, hw = (float(torch.tensor(v, dtype=rdt)) for v in (ctr, hw))

    def t_apply(Y):
        return (scoped_mv(A, Y) - ctr * Y) / hw

    def scale_of(y):
        return 1.0 / torch.clamp(global_max(torch.max(torch.abs(y))),
                                 min=1e-30)

    y0, y1 = x, t_apply(x)
    tail = min(blk - 1, degree - 1)
    steps_main = max(degree - 1 - tail, 0)
    # overflow-guard rescale every 8th step only
    for i in range(steps_main):
        y0, y1 = y1, 2.0 * t_apply(y1) - y0
        if (i & 7) == 7:
            sc = scale_of(y1)
            y0, y1 = y0 * sc, y1 * sc

    sc = scale_of(y1)
    y0, y1 = y0 * sc, y1 * sc
    if blk == 1:
        return y1
    buf = torch.cat([torch.zeros((cm.local_rows(n), blk - 1), dtype=dtype,
                                 device=device), y1], dim=1)
    for _ in range(tail):
        y2 = 2.0 * t_apply(y1) - y0
        sc = scale_of(y2)
        buf = torch.cat([buf[:, 1:] * sc, y2 * sc], dim=1)
        y0, y1 = y1 * sc, y2 * sc
    return buf


def _power_extreme(A, gen, n, dtype, device, shift=None) -> float:
    """~lambda_max(A) (or of shift*I - A) by ``_POW_ITERS`` power
    iterations; returns the last norm growth."""
    tiny = float(torch.finfo(real_dtype(dtype)).tiny)
    v = rand_block(gen, n, 1, dtype, device)
    v = v / torch.clamp(norm(v), min=tiny)
    nw = torch.zeros((), dtype=real_dtype(dtype), device=device)
    for _ in range(_POW_ITERS):
        w = scoped_mv(A, v)
        if shift is not None:
            w = shift * v - w
        nw = norm(w).real
        v = w / torch.clamp(nw, min=tiny)
    return host_read(float, nw)


def _deg(need: float, cut: float, width: float) -> int:
    """Filter degree: the band amplification beats the sqrt(n)-strong
    suppressed bulk, d >= ln(4 sqrt(n)) / acosh(1 + 2 cut / width)."""
    ac = math.acosh(1.0 + 2.0 * cut / width)
    if not ac > 1e-6:            # also catches NaN
        ac = 1e-6
    return min(max(int(need / ac) + 1, 8), 512)


@scoped("pt_probe")
def _probe_subsolve(cfg: SolveConfig, A, B, K, s: SolverState, win: Window,
                    shifts, bar: float, margin: float) -> ProbeResult:
    """Out-of-band spectrum-verification probe (reference
    ``_probe_subsolve``): a small Davidson iteration on the complement of
    the converged set, started from a Chebyshev-filtered random block (a
    plain random one with a mass matrix); *found* when its best Ritz
    value, certified on the deflated candidate, sorts strictly inside the
    returned set."""
    from ..operators import apply_precond

    n, blk = cfg.n, cfg.blk
    pw = max(min(max(3 * blk, 32), 48), 2 * blk)
    cdt = win.cands.X.dtype
    dev = win.cands.X.device
    rdt = real_dtype(cdt)
    tiny = float(torch.finfo(rdt).tiny)
    gen = s.gen
    sidx = min(s.num_locked, shifts.shape[0] - 1)
    has_B = B is not None
    Q, BQ = _locked(cfg, s)
    lcount = cfg.noc + s.num_locked
    need = math.log(4.0 * math.sqrt(n))

    valid0 = True
    bnd_hi, bnd_lo = s.probe_bnd_hi, s.probe_bnd_lo
    bnds_set = s.probe_bnds_set
    fast_start = False
    if has_B:
        Z0, mv0 = rand_block(gen, n, blk, cdt, dev), 0
    elif cfg.target == Target.largest_abs:
        sctr = host_read(float, shifts[sidx]) if shifts.shape[0] else 0.0
        cut = max(8.0 * margin, 1e-3 * max(-2.0 * bar, 0.0))
        s_lo = sctr + bar + cut
        s_hi = sctr + (-bar) - cut
        deg = _deg(need, cut, max(s_hi - s_lo, 1e-30))
        okf = s_hi > s_lo
        Z0 = (_filtered_rand_block(cfg, A, gen, cdt, dev, s_lo, s_hi, deg)
              if okf else rand_block(gen, n, blk, cdt, dev))
        mv0 = deg if okf else 0
        valid0 = host_read(bool, all_finite(Z0))
        fast_start = okf and deg < 512
    else:
        emin, emax = s.stats.est_min_eval, s.stats.est_max_eval
        mvb = 0
        if not bnds_set:
            # round-invariant bounds, measured on the first round only
            pmax = _power_extreme(A, gen, n, cdt, dev)
            bnd_hi = max(emax, 1.15 * pmax)
            if cfg.target == Target.smallest:
                bnd_lo, mvb = -math.inf, _POW_ITERS
            else:
                pneg = _power_extreme(A, gen, n, cdt, dev, shift=bnd_hi)
                bnd_lo, mvb = bnd_hi - 1.15 * pneg, 2 * _POW_ITERS
        emax_eff = max(emax, bnd_hi)
        emin_eff = (emin if cfg.target == Target.smallest
                    else min(emin, bnd_lo))
        span = max(emax_eff - emin_eff, tiny * 1e8)
        cut = max(8.0 * margin, 1e-3 * span)
        if cfg.target == Target.smallest:
            s_lo, s_hi = bar + cut, emax_eff
        else:
            s_lo, s_hi = emin_eff, (-bar) - cut
        deg = _deg(need, cut, max(s_hi - s_lo, 1e-30))
        okf = (emax_eff > emin_eff) and (s_hi > s_lo)
        Z0 = (_filtered_rand_block(cfg, A, gen, cdt, dev, s_lo, s_hi, deg)
              if okf else rand_block(gen, n, blk, cdt, dev))
        mv0 = deg + mvb if okf else mvb
        # filter sanity: the start must not be pinned at the far end
        nz2 = col_dots(Z0, Z0).real
        AZ0 = scoped_mv(A, Z0)
        rq = col_dots(Z0, AZ0).real / torch.clamp(nz2, min=tiny)
        mv0 += blk
        qtr = 0.25 * (s_hi - s_lo)
        rq_min, rq_max, fin = _host(torch.min(rq), torch.max(rq),
                                    all_finite(Z0))
        if cfg.target == Target.smallest:
            valid0 = rq_min < s_hi - qtr
        else:
            valid0 = rq_max > s_lo + qtr
        valid0 = (valid0 or not okf) and bool(fin)
        bnds_set = valid0
        fast_start = okf and deg < 512

    nl = cm.local_rows(n)
    P = torch.zeros((nl, pw), dtype=cdt, device=dev)
    WP = torch.zeros((nl, pw), dtype=cdt, device=dev)
    BP = torch.zeros((nl, pw), dtype=cdt, device=dev) if has_B else None
    Hp = torch.zeros((pw, pw), dtype=cdt, device=dev)
    V = s.V
    BVd = s.BV if has_B else V
    floor = tiny * 1e10
    ar = torch.arange(blk, device=dev)

    def deflate(Z):
        return Z - bcomb(V, gram(BVd, Z))

    def colnorm(Y):
        return torch.sqrt(torch.clamp(col_dots(Y, Y).real, min=0.0))

    def renorm(Y):
        yn = colnorm(Y)
        return torch.where((yn > floor)[None, :],
                           Y / torch.clamp(yn, min=floor)[None, :], 0.0)

    w = t = 0
    found = False
    Xb = torch.zeros((nl, blk), dtype=cdt, device=dev)
    Z = Z0
    mv, npc = mv0, 0
    prev_key = float(torch.finfo(rdt).max)
    stall = 0
    while t < _PROBE_ITERS and not found:
        if w + blk > pw:
            # thick-restart truncation on the carried projected matrix
            solc = solve_H_rr(Hp, w, cfg.target, shifts, sidx)
            kk = pw - blk
            C = solc.hvecs[:, :kk] * solc.active[:kk].to(cdt)[None, :]
            Pn = torch.zeros_like(P)
            Pn[:, :kk] = bcomb(P, C)
            WPn = torch.zeros_like(WP)
            WPn[:, :kk] = bcomb(WP, C)
            if has_B:
                BPn = torch.zeros_like(BP)
                BPn[:, :kk] = bcomb(BP, C)
                BP = BPn
            Hn = torch.zeros_like(Hp)
            Hn[:kk, :kk] = C.mH @ (Hp @ C)
            P, WP, Hp, w = Pn, WPn, Hn, min(w, kk)
        nz_pre = colnorm(Z)
        Zd = deflate(Z)
        nd_pre = colnorm(Zd)
        defl_shrunk = torch.any(nd_pre < 1e-2 * torch.clamp(nz_pre, min=tiny))
        Zd = renorm(Zd)
        # one in-block CGS pass: nearly parallel deflated columns collapse
        cols = []
        for j in range(blk):
            zj = Zd[:, j:j + 1]
            for zi in cols:
                zj = zj - zi * dot(zi, zj)
            zjn = torch.sqrt(torch.clamp(dot(zj, zj).real, min=0.0))
            cols.append(torch.where(zjn > 1e-4,
                                    zj / torch.clamp(zjn, min=floor), 0.0))
        Zd = torch.cat(cols, dim=1)
        ores = block_ortho(Zd, P, Q, blk, gen, locked_count=lcount,
                           n_iters=1, Bop=B, BV=BP, BQ=BQ)
        # count only columns certified to live in the complement of
        # span(V) and the locked set, compacted to the front
        if ores.n_random > 0 or host_read(bool, defl_shrunk):
            cert = ores.X - bcomb(V, gram(BVd, ores.X))
            if Q is not None:
                cert = prefix_project(BQ, Q, cert, lcount)
            cn2p = col_dots(cert, cert).real
        else:
            cn2p = col_dots(ores.X, ores.X).real
        okp = cn2p >= 0.25                      # NaN -> dropped
        srtp = torch.argsort(ar + _BIG * (~okp).to(ar.dtype), stable=True)
        srvp = host_read(int, okp.sum())
        keepp = (ar < srvp)[None, :]
        Xs = torch.where(keepp, ores.X[:, srtp], 0)
        P[:, w:w + blk] = Xs
        if has_B:
            BP[:, w:w + blk] = torch.where(keepp, ores.BX[:, srtp], 0)
        Y = scoped_mv(A, Xs)
        WP[:, w:w + blk] = Y
        mv += srvp
        G = gram(P, Y)                          # P already holds Xs
        Hp[:, w:w + blk] = G
        Hp[w:w + blk, :] = G.mH
        w += srvp
        sol = solve_H_rr(Hp, w, cfg.target, shifts, sidx)
        hb = sol.hvals[:blk]
        keys = target_sort_keys(hb, cfg.target, shifts, sidx)
        Cb = sol.hvecs[:, :blk]
        Xb = bcomb(P, Cb)
        xb0_t = norm(Xb[:, 0]).real
        act0, xb0, key0 = _host(sol.active[0], xb0_t, keys[0])
        pre_found = bool(act0) and xb0 > 0.5 and key0 < bar - margin
        found2 = False
        if pre_found:
            # certify on the deflated candidate: two CGS passes against
            # span(V) (+ locked) so its Rayleigh quotient bounds the
            # complement's extreme
            xd = Xb[:, :1]
            for _ in range(2):
                xd = xd - bcomb(V, gram(BVd, xd))
                if Q is not None:
                    xd = prefix_project(BQ, Q, xd, lcount)
            xdn = torch.sqrt(torch.clamp(dot(xd, xd).real, min=0.0))
            xdu = torch.where(xdn > floor, xd / torch.clamp(xdn, min=floor),
                              0.0)
            Axd = scoped_mv(A, xdu)
            den = dot(xdu, scoped_mv(B, xdu) if has_B else xdu).real
            rqd = dot(xdu, Axd).real / torch.clamp(den, min=tiny)
            ckey = target_sort_keys(rqd[None], cfg.target, shifts, sidx)[0]
            xdn_h, ckey_h = _host(xdn, ckey)
            found2 = xdn_h > 0.5 * xb0 and ckey_h < bar - margin
            mv += 1
        lamb = torch.where(torch.isfinite(hb), hb, 0).to(cdt)
        Rb = bcomb(WP, Cb) - (bcomb(BP, Cb) if has_B else Xb) \
            * lamb[None, :]
        if K is not None:
            Z = apply_precond(K, Rb, lamb.real)
            npc += blk
        else:
            Z = Rb
        # slow-creep early exit (cost rule, gated on a filtered start)
        gap = key0 - bar
        improved = (prev_key - key0) > 0.10 * max(gap, margin)
        stall = 0 if improved else stall + 1
        clean_conv = gap > margin and stall >= 3 and t >= 8 and fast_start
        if os.environ.get("PTPU_PROBE_DEBUG") == "2":
            print(f"  it {t}: key0={key0} bar={bar} stall={stall} "
                  f"srvp={srvp}", flush=True)
        t = _PROBE_ITERS if (srvp == 0 or clean_conv) else t + 1
        found = found or found2
        prev_key = min(prev_key, key0)
    return ProbeResult(found=found, X=Xb, num_matvecs=mv, num_preconds=npc,
                       valid=valid0, bnd_hi=bnd_hi, bnd_lo=bnd_lo,
                       bnds_set=bnds_set)


def _append_probe_block(cfg: SolveConfig, A, B, s: SolverState,
                        Xb) -> SolverState:
    """Inject a found probe block as new basis columns at ``s.b`` (caller
    guarantees ``s.b + blk <= mmax``)."""
    blk = cfg.blk
    ores = _ortho(cfg, B, s, Xb, blk)
    (Xs, BXs), nc = _survivors(ores)
    keep = (torch.arange(blk, device=Xb.device) < nc)[None, :]
    Xs = torch.where(keep, Xs, 0)
    b = s.b
    s.V[:, b:b + blk] = Xs
    if B is not None:
        s.BV[:, b:b + blk] = torch.where(keep, BXs, 0)
    Y = scoped_mv(A, Xs)
    s.W[:, b:b + blk] = Y
    _write_panels(cfg, s, Xs, Y, b)
    stats = _replace(s.stats, num_matvecs=s.stats.num_matvecs + nc)
    return _replace(s, b=b + nc, stats=stats)


def _write_panels(cfg: SolveConfig, s: SolverState, X, Y, b: int):
    """Write the new columns ``V^H Y`` of ``H`` at ``b`` (``X``, ``Y = A
    X``, already in ``V`` and ``W``) and its new rows: their mirror for a
    Hermitian ``H``, ``X^H W`` for a normal operator's."""
    blk = X.shape[1]
    hc = gram(s.V, Y)
    s.H[:, b:b + blk] = hc
    s.H[b:b + blk, :] = hc.mH if cfg.hermitian else gram(X, s.W)


def _unconverged_order(win: Window):
    """Stable order: unconverged live pairs first, converged next,
    padding last."""
    c = win.conv.shape[0]
    idx = torch.arange(c, device=win.conv.device)
    key = idx + _BIG * win.conv.to(idx.dtype) \
        + 4 * _BIG * (~win.live).to(idx.dtype)
    return torch.argsort(key, stable=True)


# ---------------------------------------------------------------------------
# Correction equation (solve_correction, src/eigs/correction.c:134)
# ---------------------------------------------------------------------------

def gd_correction(cfg: SolveConfig, K, R, X, sigma, valid):
    """Generalized-Davidson expansion vectors: (Olsen-)preconditioned
    residuals."""
    from ..operators import apply_precond

    vm = valid[None, :].to(R.dtype)
    if K is None:
        return R * vm
    KR = apply_precond(K, R, sigma)
    if not cfg.olsen:
        return KR * vm
    KX = apply_precond(K, X, sigma)
    num = col_dots(X, KR)
    den = col_dots(X, KX)
    den = torch.where(torch.abs(den) < torch.finfo(real_dtype(R.dtype)).tiny,
                      1.0, den)
    return (KR - KX * (num / den)[None, :]) * vm


def _robust_shifts(cfg: SolveConfig, s: SolverState, win: Window,
                   cand_idx, lam, res, valid, shifts):
    """Correction-equation shifts (reference ``_robust_shifts``). Returns
    ``(sigma, prev_ritz', num_prev_ritz')``."""
    lam0 = torch.where(valid, torch.where(torch.isfinite(lam), lam, 0), 0)
    if not cfg.hermitian:
        # a normal operator's shifts are its complex Ritz values
        return lam0, s.prev_ritz, s.num_prev_ritz
    c = cfg.cwin
    rdt = s.prev_ritz.dtype
    big = float(torch.finfo(rdt).max) / 8
    tiny = float(torch.finfo(rdt).tiny)
    hl = win.sol.hvals[:c].to(rdt)
    act = win.live
    hv = torch.where(act, torch.where(torch.isfinite(hl), hl, 0), big)
    n_act = host_read(int, act.sum())

    prev2 = s.prev_ritz.clone()
    prev2[s.num_locked:s.num_locked + c] = hv
    nprev2 = s.num_locked + n_act

    if cfg.target in (Target.smallest, Target.largest):
        if not cfg.robust_shifts:
            return lam0, prev2, nprev2
        j = cand_idx
        si = s.num_locked + j
        lastlock = s.locked_vals[max(s.num_locked - 1, 0)].to(rdt)
        has_lower = (j > 0) | (s.num_locked > 0)
        lower_val = torch.where(j > 0, hv[torch.clamp(j - 1, min=0)],
                                lastlock)
        up_ok = (j + 1 < c) & act[torch.clamp(j + 1, max=c - 1)]
        upper_val = hv[torch.clamp(j + 1, max=c - 1)]
        resr = res.to(rdt)
        lam_r = lam0.to(rdt)
        lower_gap = torch.where(has_lower, torch.abs(lam_r - lower_val), big)
        upper_gap = torch.where(up_ok, torch.abs(upper_val - lam_r), big)
        gap = torch.minimum(lower_gap, upper_gap)
        prev = s.prev_ritz[torch.clamp(si, 0, s.prev_ritz.shape[0] - 1)]
        delta = torch.where(si < s.num_prev_ritz, torch.abs(prev - lam_r),
                            big)
        eps_sep = torch.minimum(delta, torch.minimum(
            resr * resr / torch.clamp(gap, min=tiny), lower_gap))
        eps_clu = torch.minimum(resr, lower_gap)
        epsilon = torch.where(gap > resr, eps_sep, eps_clu)
        if s.stats.num_outer_iterations <= 1:
            epsilon = resr
        if cfg.target == Target.smallest:
            sig = lam_r - epsilon
            sig = torch.where(has_lower, torch.maximum(sig, lower_val), sig)
        else:
            sig = lam_r + epsilon
            sig = torch.where(has_lower, torch.minimum(sig, lower_val), sig)
        return torch.where(valid, sig, 0).to(lam0.dtype), prev2, nprev2

    # interior targets (correction.c:203-239)
    ts = shifts[min(s.num_locked, shifts.shape[0] - 1)].to(lam0.dtype)
    d = ts - lam0
    near = torch.abs(d) < res.to(lam0.dtype)
    if cfg.projection == Projection.refined:
        far = lam0      # a refined Ritz value is trusted at once
    else:
        far = lam0 + res.to(lam0.dtype) * torch.sign(d)
    return torch.where(valid, torch.where(near, ts, far), 0), prev2, nprev2


# ---------------------------------------------------------------------------
# Restart (restart_Sprimme, src/eigs/restart.c:200)
# ---------------------------------------------------------------------------

def _ortho_span_coeff(P, C, tol):
    """Orthonormalize small coefficient block ``P`` against orthonormal
    ``C`` and internally (eigh-based, rank-revealing)."""
    P = P - bcomb(C, small_gram(C, P))
    P = P - bcomb(C, small_gram(C, P))
    G = small_gram(P, P)
    w, U = host_read(torch.linalg.eigh, G)
    wmax = torch.clamp(torch.max(w), min=1.0)
    valid = w > tol * wmax
    inv = torch.where(valid, 1.0 / torch.sqrt(torch.where(valid, w, 1.0)),
                      0.0)
    return bcomb(P, U * inv[None, :].to(P.dtype)), valid


@scoped("pt_restart")
def do_restart(cfg: SolveConfig, A, B, s: SolverState,
               win: Window) -> SolverState:
    """Thick restart with +k retention and (optional) hard locking."""
    mmax, mrs, kmax, c = cfg.mmax, cfg.mrs, cfg.kmax, cfg.cwin
    dev = s.V.device
    has_B = B is not None
    idx = torch.arange(mmax, device=dev)
    active = win.sol.active
    rdt = s.locked_res.dtype

    if cfg.locking:
        cap = min(max(cfg.ne - s.num_locked, 0), c)
        lock = win.conv & (torch.cumsum(win.conv.to(idx.dtype), 0) <= cap)
        lockorder = torch.argsort(idx[:c] + _BIG * (~lock).to(idx.dtype),
                                  stable=True)
        nl = host_read(int, lock.sum())
        lvalid = idx[:c] < nl
        Xl = win.cands.X[:, lockorder] * lvalid.to(s.V.dtype)[None, :]
        laml = torch.where(lvalid, win.sol.hvals[:c][lockorder], 0)
        resl = torch.where(lvalid, win.cands.resnorms[lockorder], 0)
        off = cfg.noc + s.num_locked
        evecs = s.evecs
        evecs[:, off:off + c] = torch.where(lvalid[None, :], Xl,
                                            evecs[:, off:off + c])
        if has_B:
            BXl = win.cands.BX[:, lockorder] * lvalid.to(s.V.dtype)[None, :]
            s.Bevecs[:, off:off + c] = torch.where(
                lvalid[None, :], BXl, s.Bevecs[:, off:off + c])
        nlk = s.num_locked
        locked_vals = s.locked_vals
        locked_vals[nlk:nlk + c] = torch.where(
            lvalid, laml.to(locked_vals.dtype), locked_vals[nlk:nlk + c])
        locked_res = s.locked_res
        locked_res[nlk:nlk + c] = torch.where(
            lvalid, resl.to(rdt), locked_res[nlk:nlk + c])
        num_locked = nlk + nl
        locked_now = torch.zeros((mmax,), dtype=torch.bool, device=dev)
        locked_now[:c] = lock
    else:
        nl = 0
        evecs, locked_vals, locked_res = s.evecs, s.locked_vals, s.locked_res
        num_locked = s.num_locked
        locked_now = torch.zeros((mmax,), dtype=torch.bool, device=dev)

    # keep the converged pairs + the best unconverged ones
    conv_full = torch.zeros((mmax,), dtype=torch.bool, device=dev)
    conv_full[:c] = win.conv
    conv_keep = conv_full & ~locked_now & active
    keepW = min(max(mrs, cfg.cwin), mmax - max(kmax, 0))
    keep_key = idx + _BIG * (~conv_keep).to(idx.dtype) \
        + 2 * _BIG * locked_now.to(idx.dtype) \
        + 4 * _BIG * (~active).to(idx.dtype)
    keep_order = torch.argsort(keep_key, stable=True)[:keepW]
    nkeep = min(max(mrs, host_read(int, conv_keep.sum())), keepW)
    keep_ok = (active[keep_order] & ~locked_now[keep_order]
               & (idx[:keepW] < nkeep))
    Ckeep = win.sol.hvecs[:, keep_order] * keep_ok.to(s.H.dtype)[None, :]
    if cfg.projection != Projection.RR:
        # refined/harmonic coefficient vectors are not mutually orthogonal
        # (restart_refined/harmonic, src/eigs/restart.c:1837,2255)
        Ckeep, keep_ok = orthonormalize_coeffs(Ckeep, keep_ok,
                                               machine_eps(s.H.dtype))

    if kmax > 0:
        meps = machine_eps(s.H.dtype)
        if cfg.locking:
            Clock = win.sol.hvecs * locked_now.to(s.H.dtype)[None, :]
            Cavoid = torch.cat([Ckeep, Clock], dim=1)
        else:
            Cavoid = Ckeep
        Pq, pvalid = _ortho_span_coeff(s.prev_hvecs.to(s.H.dtype), Cavoid,
                                       64.0 * meps)
        C = torch.cat([Ckeep, Pq], dim=1)
        colvalid = torch.cat([keep_ok, pvalid], dim=0)
    else:
        C = Ckeep
        colvalid = keep_ok

    ncol = colvalid.shape[0]
    order3 = torch.argsort(idx[:ncol] + _BIG * (~colvalid).to(idx.dtype),
                           stable=True)
    C = C[:, order3]
    b_new = host_read(int, colvalid.sum())
    Cfull = torch.zeros((mmax, mmax), dtype=s.H.dtype, device=dev)
    Cfull[:, :ncol] = C

    # the restart half of the reference's timeDense accounting
    with scope("pt_dense"):
        V = bcomb(s.V, Cfull).to(s.V.dtype)
        W = bcomb(s.W, Cfull).to(s.W.dtype)
        BV = bcomb(s.BV, Cfull).to(s.BV.dtype) if has_B else None
        H = small_gram(Cfull, s.H @ Cfull)
    if cfg.hermitian:
        H = 0.5 * (H + H.mH)

    # accumulated-roundoff accounting (restart.c:425-440)
    meps_r = machine_eps(s.V.dtype)
    nres = s.stats.num_restarts + 1
    anorm_r = max(s.stats.anorm_estimate, 1e-30)
    drift = math.sqrt(nres) * meps_r * anorm_r
    if cfg.b_norm > 0:
        drift = drift / math.sqrt(cfg.b_norm)
    mct = max(s.stats.max_conv_tol, drift)
    if cfg.locking and num_locked > 0:
        mct = max(mct, host_read(float, torch.max(locked_res[:num_locked])))
    stats = _replace(s.stats, num_restarts=nres,
                     num_locked=s.stats.num_locked + nl, max_conv_tol=mct,
                     estimate_resid_error=drift,
                     num_resets=0 if nl > 0 else s.stats.num_resets)
    s = _replace(s, V=V, W=W, BV=BV, H=H, b=b_new,
                 prev_hvecs=torch.zeros_like(s.prev_hvecs),
                 evecs=evecs, locked_vals=locked_vals,
                 locked_res=locked_res, num_locked=num_locked,
                 best_res=(float(torch.finfo(rdt).max) if nl > 0
                           else s.best_res),
                 restarts_since_reset=s.restarts_since_reset + 1,
                 stall_restarts=0 if nl > 0 else s.stall_restarts,
                 stats=stats)
    # locking consumed the whole basis: refill with a random block
    return _refill_random(cfg, A, B, s) if s.b < 1 else s


def _refill_random(cfg: SolveConfig, A, B, s: SolverState) -> SolverState:
    X = rand_block(s.gen, cfg.n, cfg.blk, compute_dtype(s.V.dtype),
                   s.V.device)
    res = _ortho(cfg, B, s, X, cfg.blk)
    blk = cfg.blk
    s.V[:, :blk] = res.X
    if B is not None:
        s.BV[:, :blk] = res.BX
    Y = scoped_mv(A, res.X)
    s.W[:, :blk] = Y
    Hn = torch.zeros_like(s.H)
    Hn[:, :blk] = gram(s.V, Y)
    if cfg.hermitian:
        Hn = 0.5 * (Hn + Hn.mH)
    stats = _replace(s.stats, num_matvecs=s.stats.num_matvecs + blk)
    return _replace(s, H=Hn, b=blk, stats=stats)


# ---------------------------------------------------------------------------
# Expansion (one outer iteration of main_iter.c:517)
# ---------------------------------------------------------------------------

def _survivors(o):
    """Compact the columns of ``block_ortho``'s result that kept a norm
    (>= 0.5) to the front; NaN columns count as collapsed. Returns
    ``((X, BX), n_survivors)``."""
    X = o.X
    blk = X.shape[1]
    ar = torch.arange(blk, device=X.device)
    ok = col_dots(X, X).real >= 0.25
    srt = torch.argsort(ar + _BIG * (~ok).to(ar.dtype), stable=True)
    Xc = X[:, srt]
    return (Xc, Xc if o.BX is X else o.BX[:, srt]), host_read(int, ok.sum())


def do_expand(cfg: SolveConfig, A, B, K, s: SolverState, win: Window,
              shifts, inner_solve=None,
              force_random: bool = False) -> SolverState:
    """One expansion step; ``force_random`` replaces the corrections with
    a fresh random block (starved basis)."""
    blk, c, kmax = cfg.blk, cfg.cwin, cfg.kmax
    dev = s.V.device
    order = _unconverged_order(win)
    n_unconv = host_read(int, (~win.conv & win.live & win.is_target).sum())
    nc = blk if force_random else min(blk, n_unconv)
    cand_idx = order[:blk]
    ar = torch.arange(blk, device=dev)
    valid = ar < nc
    vmask = valid.to(win.cands.X.dtype)[None, :]
    R = win.cands.R[:, cand_idx] * vmask
    X = win.cands.X[:, cand_idx] * vmask
    BX = win.cands.BX[:, cand_idx] * vmask if B is not None else X
    lam = win.sol.hvals[:c][cand_idx]
    res = win.cands.resnorms[cand_idx]
    sigma, prev_ritz2, num_prev2 = _robust_shifts(
        cfg, s, win, cand_idx, lam, res, valid, shifts)

    if kmax > 0:
        pidx = order[:kmax]
        nlive = host_read(int, win.live.sum())
        pvalid = torch.arange(kmax, device=dev) < min(kmax, nlive)
        prev = win.sol.hvecs[:, :c][:, pidx] * pvalid.to(s.H.dtype)[None, :]
    else:
        prev = s.prev_hvecs

    n_inner = n_mv_inner = n_prec = 0
    itrace = (torch.zeros_like(s.inner_trace)
              if s.inner_trace is not None else None)
    if force_random:
        D = rand_block(s.gen, cfg.n, blk, R.dtype, dev)
    elif cfg.max_inner != 0 and inner_solve is not None:
        D, n_inner, n_mv_inner, n_prec, itrace = inner_solve(
            cfg, A, B, K, s, X, BX, R, sigma, res, valid, win.tol,
            evals=lam)
    else:
        D = gd_correction(cfg, K, R, X, sigma, valid)
        if K is not None:
            n_prec = nc
    ores = _ortho(cfg, B, s, D, nc)
    (Xo, BXo), srv = _survivors(ores)
    n_random = ores.n_random
    if srv == 0 and nc > 0:
        # every direction collapsed: retry with a fresh random block
        rnd = rand_block(s.gen, cfg.n, blk, s.V.dtype, dev)
        o2 = _ortho(cfg, B, s, rnd, nc)
        (Xo, BXo), srv = _survivors(o2)
        n_random = o2.n_random
    nc = min(nc, srv)
    keep = (ar < nc)[None, :]
    Xo = torch.where(keep, Xo, 0)

    b = s.b
    s.V[:, b:b + blk] = Xo
    if B is not None:
        s.BV[:, b:b + blk] = torch.where(keep, BXo, 0)
    Y = scoped_mv(A, Xo)
    s.W[:, b:b + blk] = Y
    _write_panels(cfg, s, Xo, Y, b)
    st = s.stats
    # one block_ortho, the H panels' Grams (a normal operator's row panel
    # is a second one) and ~5 width-blk dot products an inner iteration
    ngs_bo, vol_bo = _ortho_counts(cfg, cfg.noc > 0 or cfg.locking)
    npanel = 1 if cfg.hermitian else 2
    stats = _replace(
        st, num_outer_iterations=st.num_outer_iterations + 1,
        num_matvecs=st.num_matvecs + nc + n_mv_inner,
        num_preconds=st.num_preconds + n_prec,
        num_inner_iterations=st.num_inner_iterations + n_inner,
        num_random=st.num_random + n_random,
        num_global_sum=st.num_global_sum + ngs_bo + npanel + 5 * n_inner,
        volume_global_sum=(st.volume_global_sum + vol_bo
                           + float(npanel * cfg.mmax * blk)
                           + 5.0 * blk * n_inner),
        num_ortho_inner_prods=st.num_ortho_inner_prods + vol_bo)
    return _replace(s, b=b + nc, prev_hvecs=prev, stats=stats,
                    prev_ritz=prev_ritz2, num_prev_ritz=num_prev2,
                    inner_trace=itrace)


# ---------------------------------------------------------------------------
# Reset (main_iter.c:853-896)
# ---------------------------------------------------------------------------

@scoped("pt_restart")
def do_reset(cfg: SolveConfig, A, B, s: SolverState) -> SolverState:
    """Rebuild W = A V from a re-orthonormalized basis (rank-revealing
    symmetric whitening in the B inner product after two passes against
    the locked vectors)."""
    V = s.V * col_mask(cfg.mmax, s.b, s.V.device).to(s.V.dtype)[None, :]
    if cfg.locking or cfg.noc > 0:
        Bq = s.Bevecs if B is not None else s.evecs
        for _ in range(2):
            V = prefix_project(s.evecs, Bq, V, cfg.noc + s.num_locked)
    Bv = scoped_mv(B, V) if B is not None else V
    G = gram(V, Bv)
    G = 0.5 * (G + G.mH)
    meps = machine_eps(s.V.dtype)
    lam, U = host_read(torch.linalg.eigh, G)
    lam = torch.flip(lam, (0,)).real          # descending: good first
    U = torch.flip(U, (1,))
    lmax = torch.clamp(lam[0], min=meps)
    good = (lam > 64.0 * meps * lmax) & torch.isfinite(lam)
    scale = torch.where(good, torch.rsqrt(torch.clamp(lam, min=meps)), 0.0)
    C = U * scale.to(G.dtype)[None, :]
    V = bcomb(V, C).to(s.V.dtype)
    BV = bcomb(Bv, C).to(s.V.dtype) if B is not None else None
    W = scoped_mv(A, V).to(s.W.dtype)
    H = gram(V, W)
    if cfg.hermitian:
        H = 0.5 * (H + H.mH)
    nkeep = host_read(int, good.sum())
    has_locked = cfg.locking or cfg.noc > 0
    st = s.stats
    stats = _replace(
        st, num_matvecs=st.num_matvecs + nkeep,
        num_resets=st.num_resets + 1, estimate_resid_error=0.0,
        num_global_sum=st.num_global_sum + 2 + (2 if has_locked else 0),
        volume_global_sum=(st.volume_global_sum + 2.0 * cfg.mmax * cfg.mmax
                           + (2.0 * cfg.lockmax * cfg.mmax
                              if has_locked else 0.0)),
        num_ortho_inner_prods=(st.num_ortho_inner_prods
                               + float(cfg.mmax * cfg.mmax)))
    return _replace(s, V=V, W=W, BV=BV, H=H, b=nkeep,
                    prev_hvecs=torch.zeros_like(s.prev_hvecs),
                    best_res=float(torch.finfo(real_dtype(s.H.dtype)).max),
                    restarts_since_reset=0, stall_restarts=0, stats=stats)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _operator_device(op) -> Optional[torch.device]:
    """The device an operator's arrays live on; None for an operator that
    does not say (one that is not a port operator)."""
    try:
        d = op.device
    except (AttributeError, TypeError):
        return None
    return None if d is None else torch.device(d)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return ((a.index if a.index is not None else cur)
            == (b.index if b.index is not None else cur))


def _check_operator_devices(device: torch.device, **ops) -> None:
    """Raise where an operator of ``ops`` lives on another device than
    ``device``: nothing is moved or copied quietly."""
    for name, op in ops.items():
        d = None if op is None else _operator_device(op)
        if d is not None and not _same_device(d, device):
            raise ValueError(
                f"the solve runs on {device} and {name} lives on {d}: move "
                f"it there with {name}.to(device), or pass "
                f"device=\"{d.type}\" to solve where it lives (the solve "
                "runs on the card unless device=\"cpu\" is asked)")


@scoped("pt_init")
def setup_solver(A, p: PrimmeParams, *, B=None, K=None, v0=None,
                 ortho_const=None, dtype=None, device=None,
                 inner_trace_cap: int = 0,
                 generator: Optional[torch.Generator] = None):
    """Build config, target shifts and initial state. ``B`` is the mass
    matrix (an operator) or None; ``ortho_const`` an ``[n, noc]`` tensor
    of constraint vectors (``p.num_ortho_const`` columns);
    ``inner_trace_cap`` the rows of the inner-iteration event buffer (0:
    none). ``device`` None means the card (raising when there is none);
    ``A``, ``B`` and the preconditioner ``K`` must live there.
    ``generator`` (a CPU ``torch.Generator``) draws every random block in
    place of one seeded from ``p.rng_seed``."""
    from ..operators import default_device

    device = default_device(device, "solve_eigs")
    _check_operator_devices(device, A=A, B=B, K=K)
    cfg = make_config(p)
    if inner_trace_cap:
        cfg = cfg._replace(inner_trace_cap=int(inner_trace_cap))
    dtype = dtype or A.dtype            # the basis' storage dtype
    if not cfg.hermitian and not dtype.is_complex:
        # a normal operator's Ritz vectors are complex: a real basis
        # stores them in the matching complex type, as the reference does
        dtype = torch.promote_types(dtype, torch.complex64)
    if dtype not in (torch.float32, torch.float64, torch.complex64,
                     torch.complex128, torch.bfloat16, torch.float16):
        raise NotImplementedError(f"working dtype {dtype} is not ported "
                                  "(f32, f64, complex64, complex128 and the "
                                  "bf16/f16 basis only)")
    cdt = compute_dtype(dtype)
    if cdt != dtype:
        # a half-precision basis: the generalized projected solve against
        # the explicit V^H B V and a tolerance floor at the storage
        # resolution; the reference serves it with Rayleigh-Ritz only
        if cfg.projection != Projection.RR:
            raise ValueError(
                f"projection={cfg.projection} requires f32+ working "
                "precision; half-precision basis supports RR only")
        cfg = cfg._replace(orth_explicit_I=True,
                           eps_floor=4.0 * machine_eps(dtype))
    rdt = real_dtype(cdt)
    ts = p.target_shifts if p.target_shifts else (0.0,)
    shifts = host_read(torch.tensor, ts, dtype=rdt, device=device)
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(int(p.rng_seed)))
    s0 = _build_state(cfg, A, B, v0, ortho_const, gen, dtype, device)
    return cfg, shifts, s0


def _build_state(cfg: SolveConfig, A, B, v0, ortho_const, gen, dtype,
                 device) -> SolverState:
    n, mmax = cfg.n, cfg.mmax
    cdt = compute_dtype(dtype)
    rdt = real_dtype(cdt)
    fmax = float(torch.finfo(rdt).max)
    evecs0 = torch.zeros((cm.local_rows(n), cfg.lockmax), dtype=dtype,
                         device=device)
    if ortho_const is not None:
        if ortho_const.shape[1] != cfg.noc:
            raise ValueError(f"{ortho_const.shape[1]} constraint columns, "
                             f"num_ortho_const={cfg.noc}")
        evecs0[:, :cfg.noc] = ortho_const.to(device=device, dtype=dtype)
    Bevecs0 = None
    if B is not None:
        Bevecs0 = torch.zeros_like(evecs0)
        if cfg.noc > 0:
            Bevecs0[:, :cfg.noc] = scoped_mv(B, evecs0[:, :cfg.noc])
    if v0 is not None:
        v0 = v0.to(device=device, dtype=cdt)
    V, W, BV, H, b0, nrand0 = init_basis(A, B, cfg, gen, evecs0, Bevecs0,
                                         v0, dtype, device)
    # the initial basis: one block_ortho a block of the reference's b0,
    # and H's Gram
    nb0 = -(-max(min(cfg.mrs, mmax), min(cfg.blk, mmax)) // cfg.blk)
    ngs_bo, vol_bo = _ortho_counts(cfg, cfg.noc > 0)
    stats = _replace(Stats.zeros(rdt), num_matvecs=b0, num_random=nrand0,
                     probe_unsupported=cfg.probe_unsupported,
                     num_global_sum=nb0 * ngs_bo + 1,
                     volume_global_sum=nb0 * vol_bo + mmax * mmax,
                     num_ortho_inner_prods=nb0 * vol_bo)

    def zr(m, dt=rdt):
        return torch.zeros((m,), dtype=dt, device=device)

    # a normal operator's locked values are complex
    vdt = rdt if cfg.hermitian else cdt
    return SolverState(
        V=V, W=W, BV=BV, H=H, b=b0,
        prev_hvecs=torch.zeros((mmax, max(cfg.kmax, 1)), dtype=cdt,
                               device=device),
        evecs=evecs0, Bevecs=Bevecs0,
        locked_vals=zr(cfg.lockmax - cfg.noc, vdt),
        locked_res=zr(cfg.lockmax - cfg.noc), num_locked=0,
        best_res=fmax, stall_restarts=0, restarts_since_reset=0,
        prev_ritz=zr(cfg.lockmax + cfg.cwin), num_prev_ritz=0,
        probe_ref=fmax, probe_clean=0, probe_bnd_hi=0.0, probe_bnd_lo=0.0,
        probe_bnds_set=False, verified=cfg.probe_extra == 0,
        give_up=False, gen=gen, done=False, stats=stats,
        inner_trace=(torch.zeros((cfg.inner_trace_cap, cfg.blk, 3),
                                 dtype=rdt, device=device)
                     if cfg.inner_trace_cap > 0 else None))


def run_segment(cfg: SolveConfig, A, B, K, inner_solve, shifts,
                s: SolverState, convtest=None, seg_end: Optional[int] = None,
                monitor=None, debug: bool = False) -> SolverState:
    """The main iteration (reference ``run_segment``'s while loop, on the
    host) until done, give-up, the iteration/matvec limits, or
    ``num_outer_iterations >= seg_end``. Everything the loop carries lives
    in ``s``, so a segment resumes where the last one stopped (the
    dynamic method switch times segments on the host).
    ``convtest`` (see :func:`prepare_window`) decides every window's
    convergence, and with it what the probe takes as passing; the final
    extraction orders by the residual test, as the reference's does.

    ``monitor`` is called once per outer iteration with the reference's
    event stream (``monitorFun``; the ``primme_event`` taxonomy): 0 outer
    iteration, 1 inner iterations (aggregated per expansion), 2 restart,
    3 reset, 4 converged, 5 locked, the most significant kind winning;
    keyword arguments ``event``, ``num_outer``, ``num_matvecs``,
    ``num_locked``, ``num_converged``, ``basis_size``, ``num_inner``,
    ``hvals`` and ``resnorms`` (numpy arrays of the first ``min(cwin,
    ne)`` window pairs) and, with ``cfg.inner_trace_cap > 0``,
    ``inner_trace`` (the ``[cap, blk, 3]`` buffer as a numpy array).
    The window's values and residuals come back in the loop's one read of
    its scalars; the inner buffer, when recorded, in one more read.

    ``debug`` prints the reference's diagnostic line once per outer
    iteration (:func:`_debug_line`), one more read; off, it costs
    nothing."""
    mmax, ne, c = cfg.mmax, cfg.ne, cfg.cwin
    fmax = float(torch.finfo(real_dtype(s.H.dtype)).max)
    end = cfg.max_outer if seg_end is None else min(seg_end, cfg.max_outer)
    kshow = min(c, ne)
    while (not s.done and not s.give_up
           and s.stats.num_outer_iterations < end
           and s.stats.num_matvecs < cfg.max_matvecs):
        with scope("pt_outer"):
            win, stats = prepare_window(cfg, s, shifts, convtest)
            s = _replace(s, stats=stats)
            locked = s.num_locked
            n_base = min(max(ne - locked, 0), c)
            pos = torch.arange(c, device=s.V.device)
            unconv_t = ~win.conv & win.live & win.is_target
            scalars = ((win.conv & (pos < n_base)).sum(), unconv_t.sum(),
                       torch.min(torch.where(unconv_t, win.cands.resnorms,
                                             fmax)))
            shown = (() if monitor is None else
                     (win.sol.hvals[:kshow], win.cands.resnorms[:kshow]))
            (nconv_base, n_unconv, cur_res), shown = _host_with(scalars, shown)
            n_unconv = int(n_unconv)
            done_cand = (locked + nconv_base) >= ne and n_unconv == 0

            # --- spectrum verification -------------------------------------
            b_pre = s.b
            if cfg.probe_extra > 0:
                margin = win.tol
                newkth = _kth_best_key(cfg, s, win, shifts)
                reopen = s.verified and newkth < s.probe_ref - margin
                verified = s.verified and not reopen
                clean = 0 if reopen else s.probe_clean
                want = done_cand and not verified
                cap_hit = (want and s.stats.num_probe_rounds
                           >= cfg.max_probe_rounds)
                verified = verified or cap_hit
                do_probe = (want and not cap_hit and s.b + cfg.blk <= mmax
                            and s.stats.num_matvecs < cfg.max_matvecs)
                s = _replace(s, verified=verified, probe_clean=clean)
                if cap_hit:
                    s.stats = _replace(s.stats, probe_exhausted=1)
                if do_probe:
                    pr = _probe_subsolve(cfg, A, B, K, s, win, shifts, newkth,
                                         margin)
                    st = s.stats
                    clean2 = 0 if pr.found else (
                        s.probe_clean + 1 if pr.valid else s.probe_clean)
                    now_verified = (not pr.found) and pr.valid and clean2 >= 2
                    st = _replace(
                        st, num_matvecs=st.num_matvecs + pr.num_matvecs,
                        num_probe_matvecs=(st.num_probe_matvecs
                                           + pr.num_matvecs),
                        num_preconds=st.num_preconds + pr.num_preconds,
                        num_probe_rounds=st.num_probe_rounds + 1,
                        probe_exhausted=(0 if now_verified
                                         else st.probe_exhausted))
                    if os.environ.get("PTPU_PROBE_DEBUG"):
                        print(f"probe round {st.num_probe_rounds}: "
                              f"found={pr.found} valid={pr.valid} "
                              f"clean={clean2} "
                              f"mv={pr.num_matvecs} bar={newkth}", flush=True)
                    s = _replace(s, stats=st, probe_clean=clean2,
                                 probe_ref=newkth, probe_bnd_hi=pr.bnd_hi,
                                 probe_bnd_lo=pr.bnd_lo,
                                 probe_bnds_set=pr.bnds_set,
                                 verified=now_verified)
                    if pr.found:
                        s = _append_probe_block(cfg, A, B, s, pr.X)
            probe_injected = s.b > b_pre
            done = done_cand and s.verified

            # --- stagnation detection --------------------------------------
            improved = cur_res < 0.999 * s.best_res
            best_res = min(s.best_res, cur_res)
            stall = 0 if improved else s.stall_restarts
            full = s.b + cfg.blk > mmax
            need_reset = full and stall >= 12
            give_up = s.stats.num_resets >= 30 or stall >= 500

            lockable = ((win.nconv > 0 and locked < ne) if cfg.locking
                        else False)
            inject = n_unconv == 0 and not done and not full and not lockable
            need_restart = full or (n_unconv == 0 and not inject)

            if debug:
                _debug_line(cfg, s, win, n_unconv)
            s = _replace(s, best_res=best_res, stall_restarts=stall)
            s2 = s
            if not (done or probe_injected):
                if need_restart:
                    s2 = do_restart(cfg, A, B, s2, win)
                    s2 = _replace(s2, stall_restarts=s2.stall_restarts + 1)
                    if need_reset:
                        s2 = do_reset(cfg, A, B, s2)
                else:
                    s2 = do_expand(cfg, A, B, K, s2, win, shifts,
                                   inner_solve=inner_solve,
                                   force_random=inject)
                    if s2.stats.num_matvecs <= s.stats.num_matvecs:
                        s2 = _replace(s2, stall_restarts=s2.stall_restarts + 1)
            if monitor is not None:
                inner_delta = (s2.stats.num_inner_iterations
                               - s.stats.num_inner_iterations)
                if need_reset:
                    ev = 3
                elif s2.num_locked > s.num_locked:
                    ev = 5
                elif need_restart and not done:
                    ev = 2
                elif win.nconv > 0:
                    ev = 4
                else:
                    ev = 1 if inner_delta > 0 else 0
                kw = {}
                if s2.inner_trace is not None:
                    kw["inner_trace"] = host_read(s2.inner_trace.cpu).numpy()
                monitor(event=ev, num_outer=s.stats.num_outer_iterations,
                        num_matvecs=s2.stats.num_matvecs,
                        num_locked=s2.num_locked, num_converged=win.nconv,
                        basis_size=s2.b, num_inner=inner_delta, hvals=shown[0],
                        resnorms=shown[1], **kw)
            s = _replace(s2, done=done, give_up=give_up)
    return s


def _debug_line(cfg: SolveConfig, s: SolverState, win: Window,
                n_unconv: int) -> None:
    """The reference's ``debug`` line: the basis size, locked and
    converged counts, the leading residual and Ritz value, the smallest
    active column norm of ``V``, ``max|evecs^H V|``, the smallest norm of
    the constraint and locked columns and of the converged candidates;
    computed on the device and read in one transfer."""
    dev = s.V.device
    big = host_read(torch.tensor, 1e9, dtype=real_dtype(s.H.dtype),
                    device=dev)
    cn = col_norms(s.V)
    mincn = torch.min(torch.where(torch.arange(cfg.mmax, device=dev) < s.b,
                                  cn, big))
    vtq = torch.max(torch.abs(gram(s.evecs, s.V)))
    qn = col_norms(s.evecs)
    minqn = torch.min(torch.where(
        torch.arange(cfg.lockmax, device=dev) < cfg.noc + s.num_locked,
        qn, big))
    xn = col_norms(win.cands.X)
    minxn = torch.min(torch.where(win.conv, xn, big))
    (r0, mc, vq, mq, mx), (h0,) = _host_with(
        (win.cands.resnorms[0], mincn, vtq, minqn, minxn),
        (win.sol.hvals[:1],))
    print(f"it={s.stats.num_outer_iterations} b={s.b} lock={s.num_locked} "
          f"nconv={win.nconv} nunc={n_unconv} res0={r0:.2e} "
          f"hv0={h0[0]:.3e} mincol={mc:.2e} VtQ={vq:.2e} minQ={mq:.2e} "
          f"minconvX={mx:.2e}", flush=True)


def extract_result(cfg: SolveConfig, s: SolverState, shifts) -> EigsResult:
    """Final extraction: pool the locked pairs and the window pairs, order
    converged-first by target preference, return the best ``ne``. Slots
    with no pair return NaN eigenvalue / +inf residual. A normal
    operator's values are complex."""
    win, stats = prepare_window(cfg, s, shifts)
    ne, c = cfg.ne, cfg.cwin
    Lw = cfg.lockmax - cfg.noc
    rdt = real_dtype(s.H.dtype)
    big = float(torch.finfo(rdt).max)
    dev = s.V.device
    sidx = min(s.num_locked, shifts.shape[0] - 1)

    lvalid = torch.arange(Lw, device=dev) < s.num_locked
    lvals = torch.where(lvalid, s.locked_vals, 0)
    lres = torch.where(lvalid, s.locked_res, big)
    lkeys = target_sort_keys(lvals, cfg.target, shifts, sidx)

    act = win.live
    hl = win.sol.hvals[:c]
    wvals = torch.where(act & (torch.abs(hl) < big), hl, 0)
    wres = torch.where(act, win.cands.resnorms, big)
    wkeys = target_sort_keys(wvals, cfg.target, shifts, sidx)

    passing = torch.cat([lvalid, win.passes])
    valid = torch.cat([lvalid, act])
    keys = torch.clamp(torch.cat([lkeys, wkeys]), -big / 16, big / 16)
    # tensor operands: two Python scalars would make an f32 result, and
    # an f64 big / 8 overflows f32
    keys = keys + torch.where(passing, 0.0,
                              host_read(keys.new_tensor, big / 8)) \
        + torch.where(valid, 0.0, host_read(keys.new_tensor, big / 4))
    order = torch.argsort(keys, stable=True)[:ne]

    from_locked = order < Lw
    lcol = torch.clamp(order, 0, Lw - 1)
    wcol = torch.clamp(order - Lw, 0, c - 1)
    out_vals = torch.where(from_locked, lvals[lcol], wvals[wcol])
    out_res = torch.where(from_locked, lres[lcol], wres[wcol])
    out_vecs = torch.where(from_locked[None, :], s.evecs[:, cfg.noc + lcol],
                           win.cands.X[:, wcol])
    missing = torch.where(from_locked, ~lvalid[lcol], ~act[wcol])
    out_vals = torch.where(missing, torch.nan, out_vals)
    out_res = torch.where(missing, torch.inf, out_res)
    return EigsResult(evals=out_vals, evecs=out_vecs, resnorms=out_res,
                      stats=_replace(stats, probe_verified=int(s.verified)))


def solve_eigs(A, p: PrimmeParams, *, B=None, K=None, v0=None,
               ortho_const=None, generator: Optional[torch.Generator] = None,
               inner_solve=None, dtype=None, debug: bool = False,
               device=None, convtest=None, monitor=None,
               segment_outer: Optional[int] = None,
               inner_trace_cap: int = 0, comm=None) -> EigsResult:
    """Run the eigensolver on a port :class:`LinearOperator` with resolved
    params (``set_method``/``resolve_defaults``). ``B`` is the mass matrix
    of a generalized problem (``A x = lambda B x``, B Hermitian positive
    definite), ``ortho_const`` an ``[n, p.num_ortho_const]`` tensor the
    returned vectors are B-orthogonal to. ``device`` None runs on the card
    and raises when there is none; ``device="cpu"`` runs on the CPU. ``A``,
    ``B`` and ``K`` must live on that device (an operator built on the CPU
    moves with ``.to(device)``): one that lives elsewhere raises. ``v0`` is
    an ``[n, k]`` tensor of initial guesses; ``convtest`` a user
    convergence test (:func:`prepare_window`); ``monitor`` the event
    stream's callback and ``inner_trace_cap`` the rows of its
    inner-iteration buffer (:func:`run_segment`).

    ``generator``: a CPU ``torch.Generator`` that draws every random block
    (the initial basis, ``block_ortho``'s replacements, the probe), the
    counterpart of the reference's ``key``; one seeded ``s`` gives the
    results of ``rng_seed=s`` bit for bit. The solve advances it. ``debug`` prints the reference's diagnostic line once per outer
    iteration (:func:`run_segment`).

    ``segment_outer``: when set, the loop returns to this function every
    that-many outer iterations and resumes from the same state, with the
    reference's host-side copy of the loop's stop condition; the result
    is bit-identical to the unsegmented solve's.

    ``comm``: a :class:`~.comm.RowComm` runs the row-sharded solve (the
    reference's ``nLocal`` partition): ``A``, ``B`` and ``K`` take and
    return this rank's rows, ``v0`` and ``ortho_const`` hold them, every
    reduction over rows is summed over the ranks, and the returned
    vectors are this rank's rows. The stats count the sums made."""
    with cm.installed(comm):
        n0 = comm.num_global_sum if comm is not None else 0
        v0_ = comm.volume_global_sum if comm is not None else 0
        cfg, shifts, s0 = setup_solver(
            A, p, B=B, K=K, v0=v0, ortho_const=ortho_const, dtype=dtype,
            device=device, inner_trace_cap=inner_trace_cap,
            generator=generator)
        if segment_outer is None:
            s = run_segment(cfg, A, B, K, inner_solve, shifts, s0, convtest,
                            monitor=monitor, debug=debug)
        else:
            s, seg_end = s0, 0
            while True:
                seg_end += int(segment_outer)
                s = run_segment(cfg, A, B, K, inner_solve, shifts, s,
                                convtest, seg_end=seg_end, monitor=monitor,
                                debug=debug)
                if (s.done or s.give_up
                        or s.stats.num_outer_iterations >= cfg.max_outer
                        or s.stats.num_matvecs >= cfg.max_matvecs):
                    break
        res = extract_result(cfg, s, shifts)
    return counted_sums(res, comm, n0, v0_)


def counted_sums(res: EigsResult, comm, n0: int, v0: float) -> EigsResult:
    """``res`` with the sums over ranks that ``comm`` made since it had
    made ``n0`` of ``v0`` scalars in place of the analytic counts (the
    unsharded result as it is)."""
    if comm is None:
        return res
    return res._replace(stats=_replace(
        res.stats, num_global_sum=comm.num_global_sum - n0,
        volume_global_sum=float(comm.volume_global_sum - v0)))
