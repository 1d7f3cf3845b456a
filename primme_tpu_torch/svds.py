"""Singular value solver: two-stage hybrid SVDS.

PyTorch port of ``primme_tpu/svds.py``: ``k`` singular triplets of a
rectangular operator ``A`` from the eigensolver run on one of three
operators built on ``A``'s products:

* ``AtA``  — A^H A (n x n), used when m >= n,
* ``AAt``  — A A^H (m x m), used when m < n,
* ``augmented`` — [[0, A^H], [A, 0]] ((m+n) x (m+n)).

The **hybrid** method runs stage 1 on the normal equations and stage 2 on
the augmented operator, seeded with the stage-1 triplets as initial
guesses and with the converged ones as orthogonality constraints; each
stage decides convergence with its own test on the triplet scale, through
``solve_eigs``'s ``convtest``. A sparse ``A`` becomes an
:class:`~primme_tpu_torch.operators.ELLOperator` (its ``A`` and ``A^T``
layouts on ``csrc/windowed_ell.cu``'s sliced-ELL kernel) or, up to 8192
rows and columns, a dense operator (``torch.matmul``), as the reference
decides. The solve runs on the card unless the caller passes
``device="cpu"``.

Each stage's solver events reach ``monitor(stage, ...)`` and, with
``return_history``, ``stats["hist"]``, on the triplet scale;
``segment_outer`` goes to both stages. ``mesh`` (a 1-D ``DeviceMesh``)
runs both stages row-sharded over the same ranks
(:mod:`~primme_tpu_torch.distributed`). Not served yet: a half-precision
(bf16, f16) matrix, refused by name. Complex input
(complex64 and complex128) runs on ``A^H``: the adjoint layouts hold
conjugated values, and ``Vh`` is ``V^H``.
"""

from __future__ import annotations

import dataclasses as _dc
import os
from typing import Any, Optional

import numpy as np
import torch

from . import params as prm
from .api import PrimmeError, _unported
from .core.comm import allgather_rows
from .core.linalg import real_dtype
from .core.solver import solve_eigs
from .operators import (FunctionOperator, LinearOperator, aslinearoperator,
                        default_device)
from .params import Method, PrimmeParams, Projection, Target, set_method


def _normal_op(A: LinearOperator, use_ata: bool) -> FunctionOperator:
    """A^H A (use_ata) or A A^H as a square operator on A's device."""
    m, n = A.shape
    if use_ata:
        return FunctionOperator(lambda X: A.rmatmat(A.matmat(X)),
                                (n, n), A.dtype, device=A.device)
    return FunctionOperator(lambda X: A.matmat(A.rmatmat(X)),
                            (m, m), A.dtype, device=A.device)


def _aug_op(A: LinearOperator, pad_to: int = 1) -> FunctionOperator:
    """Augmented [[0, A^H], [A, 0]] acting on stacked [v; u] (v: n rows,
    u: m rows), on A's device. ``pad_to`` > 1 (the ranks of a mesh): each
    half is zero-padded to a multiple of it, as the reference pads them
    for its shard-aligned split; the pad slots are null directions of the
    operator, which the closest_geq floor shift sorts out of SM solves."""
    m, n = A.shape
    n_p = -(-n // pad_to) * pad_to
    m_p = -(-m // pad_to) * pad_to

    def f(X):
        top, bot = A.rmatmat(X[n_p:][:m]), A.matmat(X[:n_p][:n])
        if n_p > n:
            top = torch.cat([top, top.new_zeros((n_p - n, top.shape[1]))])
        if m_p > m:
            bot = torch.cat([bot, bot.new_zeros((m_p - m, bot.shape[1]))])
        return torch.cat([top, bot], dim=0)

    return FunctionOperator(f, (m_p + n_p, m_p + n_p), A.dtype,
                            device=A.device)


def _aug_stack(Vv, U, n_p: int, m_p: int):
    """Stack [v; u]/sqrt(2) into the (padded) augmented coordinates."""
    n, m = Vv.shape[0], U.shape[0]
    Vp = torch.cat([Vv, Vv.new_zeros((n_p - n, Vv.shape[1]))]) \
        if n_p > n else Vv
    Up = torch.cat([U, U.new_zeros((m_p - m, U.shape[1]))]) \
        if m_p > m else U
    return torch.cat([Vp, Up], dim=0) / float(np.sqrt(2.0))


def _sharded(op, comm, K, v0, oc):
    """A stage's operator, preconditioner, start block and constraints on
    this rank's rows (all of them as they are without ``comm``)."""
    if comm is None:
        return op, K, v0, oc
    from . import distributed as D
    return (D.GatheredOperator(op, comm, op.shape),
            None if K is None else D.shard_operator(K, comm),
            None if v0 is None else comm.rows(v0),
            None if oc is None else comm.rows(oc))


def _true_resnorms(A, U, V, svals):
    """resNorm = sqrt(||A v - s u||^2 + ||A^H u - s v||^2)."""
    sv = svals[None, :].to(U.dtype)
    R1 = A.matmat(V) - U * sv
    R2 = A.rmatmat(U) - V * sv
    return torch.sqrt(torch.sum(torch.abs(R1) ** 2, dim=0)
                      + torch.sum(torch.abs(R2) ** 2, dim=0))


def _colnormalize(X, floor):
    n = torch.linalg.vector_norm(X, dim=0)
    return X / torch.clamp(n, min=floor)[None, :].to(X.dtype)


def _method(meth):
    if isinstance(meth, str):
        return Method[meth.replace("PRIMME_", "")]
    return meth


def svds(A: Any, k: int = 6, ncv: Optional[int] = None, tol: float = 0.0,
         which: str = "LM", v0: Any = None, u0: Any = None,
         maxiter: Optional[int] = None, return_singular_vectors: bool = True,
         method: str = "hybrid", methodStage1: Optional[Any] = None,
         methodStage2: Optional[Any] = None, sigma: Optional[float] = None,
         precAHA: Any = None, precAAH: Any = None, precAug: Any = None,
         maxBlockSize: int = 0, return_stats: bool = False,
         raise_for_unconverged: bool = True, seed: int = 0,
         aNorm: float = 0.0, mesh: Any = None,
         segment_outer: Optional[int] = None,
         stage1_params: Optional[dict] = None,
         stage2_params: Optional[dict] = None,
         orthou0: Any = None, orthov0: Any = None,
         convtest: Any = None, monitor: Any = None,
         return_history: bool = False, device: Any = None):
    """Compute k singular triplets of the rectangular operator ``A`` (the
    reference's ``svds``, scipy's calling convention). ``which`` in {'LM',
    'SM'} or a number (closest_abs); ``method`` in {'hybrid',
    'normalequations', 'augmented'}. ``orthou0``/``orthov0``: seek
    triplets orthogonal to these left/right vectors (swapped arguments
    tolerated; a missing side is completed through ``A`` and a QR).
    ``convtest(svals, resnorms, tol, anorm)`` replaces each stage's
    default test, on tensors of singular values and triplet-scale
    residual norms and host floats ``tol`` and ``anorm``. ``device`` is
    where the solve runs: the card when it is None, which raises if there
    is none; ``"cpu"`` runs on the CPU. Returns numpy arrays, like the
    reference: ``(U, s, Vh)`` (or ``s``) and, with ``return_stats``, the
    stages' counters under ``stage1_*``/``stage2_*`` and ``resnorms``.
    ``monitor(stage, event, num_outer, num_matvecs, num_locked,
    num_converged, basis_size, num_inner, svals, resnorms)`` receives each
    stage's event stream (stage 1 or 2) with values and residuals on the
    triplet scale; ``return_history`` collects the same records into
    ``stats["hist"]``; ``segment_outer`` goes to both stages'
    ``solve_eigs``. ``mesh`` (a 1-D ``DeviceMesh``) runs both stages
    row-sharded over its ranks, each half of the augmented block padded to
    a multiple of their number; every rank calls with the same arguments
    and returns the same arrays."""
    comm0 = None
    if mesh is not None:
        from . import distributed as D
        device = D.mesh_device(mesh, device)
        Aop = aslinearoperator(A).to(device)
        # both stages run under the same ranks: one group, each stage's
        # communicator over its own row count
        comm0 = D.mesh_comm(mesh, 1, device)
    else:
        device = default_device(device, "svds")
        Aop = aslinearoperator(A).to(device)
    nsh = 1 if comm0 is None else comm0.size
    m, n = Aop.shape
    kmax = min(m, n)
    if not (0 < k <= kmax):
        raise ValueError(f"k={k} out of range for {m}x{n}")
    use_ata = n <= m
    dt = Aop.dtype
    if dt in (torch.bfloat16, torch.float16):
        raise _unported(f"svds of a {dt} matrix (eigsh serves the "
                        "half-precision basis)")
    rdt = real_dtype(dt)
    tiny = float(torch.finfo(rdt).tiny)
    meps = float(torch.finfo(rdt).eps)

    def tensor(X):
        return torch.as_tensor(np.ascontiguousarray(X)).to(device=device,
                                                           dtype=dt)

    shifts: tuple = ()
    if isinstance(which, (int, float)) and not isinstance(which, bool):
        sigma = float(which)
        which = "CA"
    which = str(which).upper()
    if which == "SM" and sigma is not None or which == "CA":
        which = "CA"
        shifts = (float(sigma if sigma is not None else 0.0),)

    eps = float(tol)
    stats_all: dict = {}

    # per-stage monitor and history (the reference's monitor_stage1/2
    # split): each stage's event stream, tagged with its stage, values
    # and residuals converted to the triplet scale of its operator
    hist: dict = {kk: [] for kk in (
        "stage", "event", "num_outer", "num_matvecs", "num_locked",
        "num_converged", "basis_size", "num_inner", "svals", "resnorms")}

    def _mk_mon(stage, to_svals, to_resn):
        if monitor is None and not return_history:
            return None

        def mon(event, num_outer, num_matvecs, num_locked, num_converged,
                basis_size, num_inner, hvals, resnorms, inner_trace=None):
            sv = to_svals(np.asarray(hvals))
            rn = to_resn(np.asarray(resnorms), sv)
            if monitor is not None:
                monitor(stage, event, num_outer, num_matvecs, num_locked,
                        num_converged, basis_size, num_inner, sv, rn)
            if return_history:
                hist["stage"].append(stage)
                hist["event"].append(int(event))
                hist["num_outer"].append(int(num_outer))
                hist["num_matvecs"].append(int(num_matvecs))
                hist["num_locked"].append(int(num_locked))
                hist["num_converged"].append(int(num_converged))
                hist["basis_size"].append(int(basis_size))
                hist["num_inner"].append(int(num_inner))
                hist["svals"].append(sv)
                hist["resnorms"].append(rn)

        return mon

    def merge_stats(st, prefix):
        for kk, vv in _dc.asdict(st).items():
            stats_all[f"{prefix}_{kk}"] = vv

    # --- external orthogonal constraints ---------------------------------
    ou = ov = None
    if orthou0 is not None or orthov0 is not None:
        ou = np.asarray(orthou0) if orthou0 is not None else None
        ov = np.asarray(orthov0) if orthov0 is not None else None
        if ou is not None and ou.ndim == 1:
            ou = ou[:, None]
        if ov is not None and ov.ndim == 1:
            ov = ov[:, None]
        if ((ou is not None and ou.shape[0] != m)
                or (ov is not None and ov.shape[0] != n)):
            ou, ov = ov, ou
        if ((ou is not None and ou.shape[0] != m)
                or (ov is not None and ov.shape[0] != n)):
            raise ValueError(
                "orthou0/orthov0 do not have the expected number of rows")
        if (ou is not None and ov is not None
                and ou.shape[1] != ov.shape[1]):
            raise ValueError(
                "orthou0 and orthov0 must have the same number of columns")
        if ov is None:
            ov, _ = np.linalg.qr(Aop.rmatmat(tensor(ou)).cpu().numpy())
        if ou is None:
            ou, _ = np.linalg.qr(Aop.matmat(tensor(ov)).cpu().numpy())
    noc_uv = 0 if ou is None else int(ou.shape[1])

    # --- stage 1: the normal equations -----------------------------------
    stage1_op = method in ("hybrid", "normalequations", "default")
    if method not in ("hybrid", "normalequations", "augmented", "default"):
        raise ValueError(f"unknown svds method {method!r}")

    U = Vv = svals = resn = None
    mv_stage1 = 0
    if stage1_op:
        Nop = _normal_op(Aop, use_ata)
        nn = Nop.shape[0]
        if which == "LM":
            tgt, tsh = Target.largest, ()
        elif which == "SM":
            tgt, tsh = Target.smallest, ()
        else:
            tgt, tsh = Target.closest_abs, tuple(s * s for s in shifts)
        p1 = PrimmeParams(n=nn, num_evals=k, target=tgt, target_shifts=tsh,
                          eps=eps, max_basis_size=(ncv or 0),
                          max_block_size=maxBlockSize,
                          num_ortho_const=noc_uv,
                          a_norm=aNorm * aNorm if aNorm > 0 else 0.0,
                          rng_seed=seed)
        if maxiter:
            # stage 1 gets half the budget, stage 2 the remainder
            p1 = p1.with_(max_matvecs=maxiter // 2)
        if which == "SM":
            # the reference's measured depth rule (BASELINE.md "svds-SM
            # stage-1 depth"): a deep basis (96) is needed for nn <= 256
            # and unsound above it; PTPU_SVDS_SM_DEPTH overrides
            if not ncv:
                depth = int(os.environ.get("PTPU_SVDS_SM_DEPTH", "0")) \
                    or (96 if nn <= 256 else 64)
                p1 = p1.with_(max_basis_size=min(nn, depth))
            if not maxBlockSize:
                p1 = p1.with_(max_block_size=max(1, min(4, k)))
        meth1 = _method(methodStage1 or Method.DEFAULT_MIN_MATVECS)
        K1 = precAHA if use_ata else precAAH
        K1 = aslinearoperator(K1).to(device) if K1 is not None else None
        p1 = set_method(meth1, p1, has_precond=K1 is not None)
        for kk, vv in (stage1_params or {}).items():
            p1 = prm.set_member(p1, kk, vv)

        g0 = None
        if use_ata and v0 is not None:
            g0 = tensor(np.atleast_2d(np.asarray(v0).T).T)
        elif not use_ata and u0 is not None:
            g0 = tensor(np.atleast_2d(np.asarray(u0).T).T)

        inner1 = None
        if p1.max_inner_iterations != 0:
            from .core.inner import jdqmr_inner_solve as inner1

        eps1 = max(eps if eps > 0 else 1e4 * meps, 3.16 * meps)
        an2_hint = aNorm * aNorm  # ||AtA|| = ||A||^2 when given

        def conv_stage1(evals, resnorms, tol, anorm_est):
            """The normal equations' test (``convTestFunATA``): the
            eigen-residual of A^H A approximates sigma x the triplet
            residual, so accept when resnorm / sigma < eps ||A||, or at the
            machine floor resnorm < 3.16 eps_mach ||A||^2."""
            aop = max(anorm_est, an2_hint)   # ~ ||A||^2
            floor = resnorms < 3.16 * meps * max(aop, 1e-300)
            sval = torch.sqrt(torch.clamp(torch.abs(evals), min=0.0))
            srn = resnorms / torch.clamp(sval, min=tiny)
            return floor | (srn < eps1 * float(np.sqrt(max(aop, 0.0))))

        if convtest is not None:
            # the user's test replaces the default, on the triplet scale:
            # sigma ~ sqrt(theta), triplet residual ~ eigen-residual / sigma
            def conv_stage1(evals, resnorms, tol, anorm_est):  # noqa: F811
                aop = max(anorm_est, an2_hint)
                sval = torch.sqrt(torch.clamp(torch.abs(evals), min=0.0))
                srn = resnorms / torch.clamp(sval, min=tiny)
                return convtest(sval, srn, tol,
                                float(np.sqrt(max(aop, 0.0))))

        oc1 = None
        if noc_uv:
            oc1 = tensor(ov if use_ata else ou)
        mon1 = _mk_mon(
            1, lambda hv: np.sqrt(np.maximum(np.real(hv), 0.0)),
            lambda rn, sv: rn / np.maximum(sv, np.finfo(np.float64).tiny))
        comm1 = None if comm0 is None else comm0.with_rows(nn)
        Nop1, K1, g0, oc1 = _sharded(Nop, comm1, K1, g0, oc1)
        r1 = solve_eigs(Nop1, p1, K=K1, v0=g0, ortho_const=oc1,
                        inner_solve=inner1, convtest=conv_stage1,
                        monitor=mon1, segment_outer=segment_outer,
                        device=device, comm=comm1)
        r1 = r1._replace(evecs=allgather_rows(r1.evecs, comm1))
        merge_stats(r1.stats, "stage1")
        mv_stage1 = int(r1.stats.num_matvecs)

        svals = torch.sqrt(torch.clamp(r1.evals, min=0.0))
        safe = torch.clamp(svals, min=tiny)[None, :].to(dt)
        if use_ata:
            Vv = r1.evecs
            U = Aop.matmat(Vv) / safe
        else:
            U = r1.evecs
            Vv = Aop.rmatmat(U) / safe
        # normalize the derived side (guards sigma ~ 0 columns)
        U = _colnormalize(U, tiny)
        Vv = _colnormalize(Vv, tiny)
        resn = _true_resnorms(Aop, U, Vv, svals)
        anorm_est = float(np.sqrt(max(r1.stats.anorm_estimate, 0.0)))
    else:
        anorm_est = aNorm

    # --- stage 2: the augmented refinement --------------------------------
    stage2 = method in ("hybrid", "default", "augmented")
    if stage2:
        anorm2 = anorm_est if anorm_est > 0 else 0.0
        if anorm2 <= 0.0 and which == "SM":
            # pure-augmented SM with neither a stage-1 estimate nor a user
            # aNorm: the floor shift and the test need ||A||, or the
            # augmented operator's |m - n| null vectors pass for the
            # smallest singular values; 8 power steps on A^H A bound it
            gen = torch.Generator().manual_seed(int(seed) + 12345)
            x = torch.randn((n, 1), generator=gen,
                            dtype=torch.float32).to(device)
            lam = 0.0
            for _ in range(8):
                y = Aop.rmatmat(Aop.matmat(x.to(dt)))
                nrm = float(torch.linalg.vector_norm(y))
                lam = nrm / max(float(torch.linalg.vector_norm(x)), 1e-300)
                # the reference's astype(float32): a complex y's real part
                x = (y / max(nrm, 1e-300)).real.to(torch.float32)
            anorm2 = float(np.sqrt(max(lam, 0.0)))
        # the final raise_for_unconverged bar reads anorm_est
        anorm_est = max(anorm_est, anorm2)
        eps_eff = eps if eps > 0 else 1e4 * meps

        if svals is not None:
            svh = svals.cpu().numpy()
            resh = resn.cpu().numpy()
            conv = resh <= max(eps_eff, 3.16 * meps) * max(anorm2, 1e-300)
            # constraints: converged triplets; guesses: the rest
            conv_idx = np.where(conv)[0]
            rest_idx = np.where(~conv)[0]
        else:
            svh = resh = None
            conv_idx = np.array([], dtype=int)
            rest_idx = np.arange(k)

        ne2 = int(len(rest_idx))
        if ne2 > 0:
            Aug = _aug_op(Aop, pad_to=nsh)
            n_p = -(-n // nsh) * nsh
            m_p = -(-m // nsh) * nsh
            oc = g2 = None
            if svh is not None:
                stack = _aug_stack(Vv, U, n_p, m_p)
                if len(conv_idx):
                    oc = stack[:, torch.as_tensor(conv_idx, device=device)]
                g2 = stack[:, torch.as_tensor(rest_idx, device=device)]
            if noc_uv:
                # external constraints lead, then the stage-1-converged
                # triplets (the reference's svecs layout)
                base_oc = _aug_stack(tensor(ov), tensor(ou), n_p, m_p)
                oc = base_oc if oc is None else torch.cat([base_oc, oc], 1)

            if which == "LM":
                tgt2, tsh2 = Target.largest, ()
            elif which == "SM":
                min_val = max(anorm2 * meps, 1e-300)
                if svh is not None:
                    lows = np.sqrt(np.abs(np.maximum(
                        svh[rest_idx] - resh[rest_idx], 0.0)
                        * svh[rest_idx]))
                    # a stage-1 value at the normal equations' machine
                    # floor carries no information: its lower bound drops
                    # to the floor
                    at_floor = (svh[rest_idx] ** 2
                                <= 10.0 * meps * max(anorm2, 1e-300) ** 2)
                    lows = np.where(at_floor, 0.0, lows)
                    # ONE shift, the smallest sound lower bound (not the
                    # reference C library's per-pair ladder)
                    tsh2 = (float(max(np.min(lows), min_val)),)
                else:
                    tsh2 = (min_val,)
                tgt2 = Target.closest_geq
            else:
                tgt2, tsh2 = Target.closest_abs, shifts

            p2 = PrimmeParams(
                n=m_p + n_p, num_evals=ne2, target=tgt2, target_shifts=tsh2,
                eps=eps, max_block_size=maxBlockSize,
                num_ortho_const=(0 if oc is None else int(oc.shape[1])),
                a_norm=anorm2, rng_seed=seed + 1)
            if maxiter:
                # stage 2 gets what the budget has left after stage 1
                p2 = p2.with_(max_matvecs=max(maxiter - mv_stage1, 1))
            if ncv:
                p2 = p2.with_(max_basis_size=ncv)
            if which != "LM":
                # refined extraction for non-largest targets
                p2 = p2.with_(projection=Projection.refined)
            meth2 = _method(methodStage2 or (Method.DEFAULT_MIN_MATVECS
                                             if which == "LM"
                                             else Method.JDQMR))
            K2 = (aslinearoperator(precAug).to(device)
                  if precAug is not None else None)
            p2 = set_method(meth2, p2, has_precond=K2 is not None)
            for kk, vv in (stage2_params or {}).items():
                p2 = prm.set_member(p2, kk, vv)

            inner2 = None
            if p2.max_inner_iterations != 0:
                from .core.inner import jdqmr_inner_solve as inner2

            sq2f = float(np.sqrt(2.0))
            eps2 = max(eps_eff, 3.16 * meps)

            def conv_stage2(evals, resnorms, tol, anorm_est):
                """The augmented operator's test (``convTestFunAug``): the
                triplet residual is sqrt(2) x the eigen-residual; no
                machine-floor shortcut (null vectors of the augmented
                operator are never accepted as sigma ~ 0)."""
                anormA = max(anorm_est, anorm2)
                return resnorms * sq2f < eps2 * max(anormA, 1e-300)

            if convtest is not None:
                # the user's test on the triplet scale: sigma ~ |theta|,
                # triplet residual ~ sqrt(2) x eigen-residual
                def conv_stage2(evals, resnorms, tol, anorm_est):  # noqa: F811
                    return convtest(torch.abs(evals), resnorms * sq2f, tol,
                                    max(anorm_est, anorm2))

            mon2 = _mk_mon(2, lambda hv: np.abs(np.real(hv)),
                           lambda rn, sv: rn * sq2f)
            comm2 = None if comm0 is None else comm0.with_rows(m_p + n_p)
            Aug, K2, g2, oc = _sharded(Aug, comm2, K2, g2, oc)
            r2 = solve_eigs(Aug, p2, K=K2, v0=g2, ortho_const=oc,
                            inner_solve=inner2, convtest=conv_stage2,
                            monitor=mon2, segment_outer=segment_outer,
                            device=device, comm=comm2)
            merge_stats(r2.stats, "stage2")

            sv2 = torch.abs(r2.evals)
            ev2 = allgather_rows(r2.evecs, comm2)
            V2 = _colnormalize(ev2[:n_p][:n], 1e-30)
            U2 = _colnormalize(ev2[n_p:][:m], 1e-30)
            res2 = _true_resnorms(Aop, U2, V2, sv2)
            if tgt2 == Target.closest_geq:
                # a null vector of the augmented operator (|m - n| of them)
                # that locked above the floor is not a singular triplet:
                # report its slot as missing, NaN value and inf residual;
                # machine-zero scale only, so that a genuine near-null
                # value or an unconverged finite one keeps its slot
                junk = (sv2 < 1e3 * meps * max(anorm2, 1e-300)) & (
                    res2 > eps2 * max(anorm2, 1e-300))
                sv2 = torch.where(junk, torch.nan, sv2)
                res2 = torch.where(junk, torch.inf, res2)

            if svh is not None and len(conv_idx):
                ci = torch.as_tensor(conv_idx, device=device)
                svals = torch.cat([svals[ci].to(sv2.dtype), sv2])
                U = torch.cat([U[:, ci], U2], dim=1)
                Vv = torch.cat([Vv[:, ci], V2], dim=1)
                resn = torch.cat([resn[ci].to(res2.dtype), res2])
            else:
                svals, U, Vv, resn = sv2, U2, V2, res2

    # sort the triplets: largest first for LM, else ascending
    svals_h = svals.cpu().numpy()
    order = np.argsort(-svals_h) if which == "LM" else np.argsort(svals_h)
    svals_h = svals_h[order]
    resn_h = resn.cpu().numpy()[order]
    U_h = U.cpu().numpy()[:, order]
    V_h = Vv.cpu().numpy()[:, order]

    if raise_for_unconverged:
        eps_eff = eps if eps > 0 else 1e4 * meps
        bad = int(np.sum(resn_h > 10 * eps_eff * max(anorm_est, svals_h.max()
                                                     if len(svals_h) else 1)))
        if bad:
            raise PrimmeError(f"{bad}/{k} triplets unconverged "
                              f"(resnorms={resn_h})")

    stats_all["resnorms"] = resn_h
    if return_history:
        stats_all["hist"] = hist
    out = [svals_h]
    if return_singular_vectors:
        out = [U_h, svals_h, V_h.conj().T]
    if return_stats:
        out.append(stats_all)
    return tuple(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# svds parameter reflection (the ``primme_svds_params`` label surface):
# svds-level fields plus the two embedded stage configurations, addressed
# as ``primme.*`` / ``primmeStage2.*``
# ---------------------------------------------------------------------------

_SVDS_ALIASES = {
    "numSvals": "num_svals",
    "aNorm": "a_norm",
    "maxMatvecs": "max_matvecs",
    "maxBasisSize": "max_basis_size",
    "maxBlockSize": "max_block_size",
    "printLevel": "print_level",
    "targetShifts": "target_shifts",
    "methodStage2": "method_stage2",
    "iseed": "rng_seed",
}

_SVDS_TARGETS = ("primme_svds_largest", "primme_svds_smallest",
                 "primme_svds_closest_abs")
_SVDS_METHODS = ("default", "hybrid", "normalequations", "augmented")


@_dc.dataclass(frozen=True)
class SvdsParams:
    """SVD solver configuration (analogue of ``primme_svds_params``, minus
    the operator callbacks). ``primme`` / ``primme_stage2`` hold the
    embedded per-stage overrides as canonical-name dicts."""

    m: int = 0
    n: int = 0
    num_svals: int = 1
    target: str = "primme_svds_largest"
    target_shifts: tuple = ()
    eps: float = 0.0
    a_norm: float = 0.0
    max_matvecs: int = 0
    max_basis_size: int = 0
    max_block_size: int = 0
    print_level: int = 1
    locking: int = -1
    method: str = "hybrid"
    method_stage2: str = ""
    rng_seed: int = 0
    primme: dict = _dc.field(default_factory=dict)
    primme_stage2: dict = _dc.field(default_factory=dict)

    def with_(self, **kw) -> "SvdsParams":
        return _dc.replace(self, **kw)


def _svds_canonical(name: str) -> str:
    return _SVDS_ALIASES.get(name, name)


def svds_member_names() -> tuple:
    return tuple(f.name for f in _dc.fields(SvdsParams))


# a template params for validating/coercing embedded stage labels
_STAGE_TEMPLATE = PrimmeParams(n=0, num_evals=1)


def svds_set_member(sp: SvdsParams, name: str, value) -> SvdsParams:
    """Set an svds field by label. Dotted labels route into the embedded
    stage configs (``primme.maxBasisSize``,
    ``primmeStage2.maxInnerIterations``), validated and coerced by the
    eigensolver's own :func:`~primme_tpu_torch.params.set_member`."""
    if "." in name:
        head, rest = name.split(".", 1)
        if head not in ("primme", "primmeStage2"):
            raise KeyError(f"unknown svds parameter scope: {head!r}")
        probe = prm.set_member(_STAGE_TEMPLATE, rest, value)
        canon = prm._canonical(rest)
        tgt = "primme" if head == "primme" else "primme_stage2"
        d = dict(getattr(sp, tgt))
        d[canon] = getattr(probe, canon)
        return sp.with_(**{tgt: d})
    name = _svds_canonical(name)
    if name not in svds_member_names():
        raise KeyError(f"unknown primme_svds parameter: {name!r}")
    if name == "target":
        # the constant name, its integer code, or the code as a string
        # (the C ABI passes every value as text), validated now
        if isinstance(value, str) and value.lstrip("-").isdigit():
            value = int(value)
        if isinstance(value, (int, np.integer)):
            if not 0 <= int(value) < len(_SVDS_TARGETS):
                raise ValueError(
                    f"svds target code {int(value)} out of range "
                    f"0..{len(_SVDS_TARGETS) - 1}")
            value = _SVDS_TARGETS[int(value)]
        if value not in _SVDS_TARGETS:
            raise ValueError(f"unknown svds target {value!r}; expected "
                             f"one of {_SVDS_TARGETS} or its index")
    if name == "target_shifts":
        if isinstance(value, str):
            value = value.replace(",", " ").split()
        value = tuple(float(s) for s in value)
    elif isinstance(value, str) and name not in ("target", "method",
                                                 "method_stage2"):
        cur = getattr(sp, name)
        if isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
    if name == "method" and isinstance(value, str):
        # validated at set time, as primme_svds_set_method does
        value = value.replace("primme_svds_", "")
        if value not in _SVDS_METHODS:
            raise ValueError(f"unknown svds method {value!r}; expected "
                             f"one of {_SVDS_METHODS}")
    if name == "method_stage2" and isinstance(value, str) and value:
        # stage-2 presets are eigensolver methods
        value = value.replace("PRIMME_", "")
        if value not in Method.__members__:
            raise ValueError(
                f"unknown stage-2 method preset {value!r}; expected a "
                f"primme_preset_method name")
    return sp.with_(**{name: value})


def svds_get_member(sp: SvdsParams, name: str):
    """Get an svds field by label (a dotted label reads the embedded stage
    overrides; an unset one returns the stage default)."""
    if "." in name:
        head, rest = name.split(".", 1)
        tgt = {"primme": "primme", "primmeStage2": "primme_stage2"}[head]
        canon = prm._canonical(rest)
        d = getattr(sp, tgt)
        if canon in d:
            return d[canon]
        return prm.get_member(_STAGE_TEMPLATE, rest)
    return getattr(sp, _svds_canonical(name))


def svds_member_info(name: str) -> dict:
    """Type/default metadata (``primme_svds_member_info``)."""
    if "." in name:
        return prm.member_info(name.split(".", 1)[1])
    name = _svds_canonical(name)
    f = {fl.name: fl for fl in _dc.fields(SvdsParams)}.get(name)
    if f is None:
        raise KeyError(name)
    return {"name": name, "type": f.type, "default": f.default}


def svds_display_params(sp: SvdsParams) -> str:
    """Text dump (``primme_svds_display_params``)."""
    lines = [f"// {'-' * 51}",
             "//              primme_svds configuration",
             f"// {'-' * 51}"]
    for f in _dc.fields(SvdsParams):
        v = getattr(sp, f.name)
        if isinstance(v, dict):
            for kk, vv in v.items():
                scope = ("primme" if f.name == "primme"
                         else "primmeStage2")
                lines.append(f"primme_svds.{scope}.{kk} = {vv}")
        else:
            lines.append(f"primme_svds.{f.name} = {v}")
    return "\n".join(lines)


def svds_from_params(A, sp: SvdsParams, **extra):
    """Run :func:`svds` from an :class:`SvdsParams` configuration (the
    reference's configuration-struct-in, triplets-out flow); ``extra``
    (``device=`` among them) goes to :func:`svds`."""
    which = {"primme_svds_largest": "LM",
             "primme_svds_smallest": "SM",
             "primme_svds_closest_abs": float(
                 sp.target_shifts[0]) if sp.target_shifts else 0.0
             }[sp.target]
    s1, s2 = dict(sp.primme), dict(sp.primme_stage2)
    if sp.locking >= 0:
        # svds-level locking maps onto both embedded stage configs
        s1.setdefault("locking", int(sp.locking))
        s2.setdefault("locking", int(sp.locking))
    kw = dict(k=sp.num_svals, tol=sp.eps, which=which,
              method=(sp.method or "hybrid"), aNorm=sp.a_norm,
              maxBlockSize=sp.max_block_size, seed=sp.rng_seed,
              stage1_params=s1 or None,
              stage2_params=s2 or None)
    if sp.method_stage2:
        kw["methodStage2"] = sp.method_stage2
    if sp.max_matvecs:
        kw["maxiter"] = sp.max_matvecs
    if sp.max_basis_size:
        kw["ncv"] = sp.max_basis_size
    kw.update(extra)
    return svds(A, **kw)
