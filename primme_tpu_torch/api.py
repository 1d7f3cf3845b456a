"""User-facing API: scipy-style ``eigsh`` and ``eigs``.

PyTorch port of ``primme_tpu/api.py::eigsh`` with the surface ported so
far: sparse routing through :func:`~primme_tpu_torch.operators.rcm_banded`
and its permutation contract, ``which``/``sigma`` targets, the method
presets and keyword forwarding, generalized problems (``M``), orthogonality
constraints (``lock``), the refined and harmonic projections, ``v0``,
``return_stats``, a user convergence test (``convtest``, on tensors: see
``core.solver.prepare_window``), complex Hermitian input (complex64 and
complex128: dense, scipy sparse through the chooser, scipy
``LinearOperator`` or a port operator), a working ``dtype`` of f32, f64,
complex64 or complex128 (the operators are wrapped in a ``CastOperator``
when it differs from their own; a complex one over a real operator is
refused), the Jacobi preconditioner (``jacobi=True``, or an ``OPinv`` that is
a port operator), ``raise_for_unconverged`` and the probe-exhaustion
error, the reference's default method (DYNAMIC: measured GD+k/JDQMR
switching, :func:`~primme_tpu_torch.core.dynamic.solve_eigs_dynamic`),
``segment_outer``, the event stream (``monitor``, ``return_history``,
``printLevel``, ``monitor_inner``) and the profile (``profile``,
``time_breakdown``), and a half-precision basis (``dtype`` bf16 or f16:
the basis stored in half, every product and the projected problem in f32,
Rayleigh-Ritz against the basis' explicit Gram, the convergence bar
relaxed to ``4 eps(half)``), and the row-partitioned solve (``mesh``, a
1-D ``DeviceMesh``: :mod:`~primme_tpu_torch.distributed`).

``eigs`` is the port of the reference's ``eigs``: eigenpairs of a normal
(non-Hermitian) operator, complex Ritz values, with its whole surface.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from . import params as prm
from .params import PrimmeParams, Target, Method, set_method
from .operators import (CastOperator, JacobiPrecond, aslinearoperator,
                        default_device)
from .core.comm import allgather_rows
from .core.linalg import host_read, host_reads, real_dtype, scope, scoped
from .core.solver import solve_eigs

_WHICH_TO_TARGET = {
    "SA": Target.smallest, "SM": Target.closest_abs,
    "LA": Target.largest, "LM": Target.largest_abs,
    "CLT": Target.closest_leq, "CGT": Target.closest_geq,
}


class PrimmeError(RuntimeError):
    """Solver failure."""


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to primme_tpu_torch "
                               "yet (see ROADMAP.md)")


_HALF = (torch.bfloat16, torch.float16)


def _working_dtype(dtype: Any) -> Optional[torch.dtype]:
    """The solver's working dtype from a torch, numpy or named dtype
    (``"bfloat16"``, or the JAX package's ``jnp.bfloat16``, name bf16); f32,
    f64, complex64, complex128 and the half-precision basis (bf16, f16)
    are served."""
    if dtype is None:
        return None
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dtype = getattr(torch, name, None)
    if dtype not in (torch.float32, torch.float64, torch.complex64,
                     torch.complex128, *_HALF):
        raise _unported(f"a working dtype of {dtype}")
    return dtype


@scoped("pt_eigsh")
def eigsh(A: Any, k: int = 6, M: Any = None, sigma: Optional[float] = None,
          which: str = "LM", v0: Any = None, ncv: Optional[int] = None,
          maxiter: Optional[int] = None, tol: float = 0.0,
          OPinv: Any = None, return_eigenvectors: bool = True,
          mode: str = "normal", Minv: Any = None, lock: Any = None,
          return_stats: bool = False, maxBlockSize: int = 0,
          minRestartSize: int = 0, maxPrevRetain: int = -1,
          method: Optional[Any] = None, locking: Optional[bool] = None,
          maxMatvecs: Optional[int] = None, jacobi: Optional[bool] = None,
          raise_for_unconverged: bool = True, dtype: Any = None,
          seed: int = 0, projection: Any = None,
          return_history: bool = False, monitor: Any = None,
          mesh: Any = None, convtest: Any = None, printLevel: int = 0,
          maxInnerIterations: Optional[int] = None,
          time_breakdown: bool = False,
          segment_outer: Optional[int] = None,
          verify_spectrum: Optional[int] = None,
          monitor_inner: bool = False,
          profile: Optional[str] = None, device: Any = None,
          **primme_kwargs):
    """Find ``k`` eigenvalues/eigenvectors of the Hermitian operator ``A``
    (the reference's ``eigsh``, scipy calling convention with the PRIMME
    extensions). ``device`` is where the solve runs: the card
    (``"cuda"``) when it is None, which raises if there is no card; a
    solve on the CPU asks for ``device="cpu"``. ``mesh``, a 1-D
    ``DeviceMesh``, runs the row-partitioned solve: every rank of it calls
    with the same arguments, the mesh's device type places the blocks,
    and every rank returns the same arrays
    (:mod:`~primme_tpu_torch.distributed`). Returns numpy arrays, like the
    reference; ``stats["num_host_reads"]`` counts the call's waits for the
    card (:func:`~.core.linalg.host_read`)."""
    reads0 = host_reads()
    if mode != "normal":
        raise ValueError(f"only mode='normal' is supported (got {mode!r})")
    if Minv is not None:
        raise NotImplementedError(
            "Minv is not supported (reference parity: primme.pyx:350); "
            "pass OPinv for a preconditioner")
    wd = _working_dtype(dtype)
    if mesh is not None:
        from . import distributed as D
        device = D.mesh_device(mesh, device)
        sharded = mesh.size() > 1
    else:
        device = default_device(device, "eigsh")
        sharded = False

    perm = None
    import scipy.sparse as _sp

    if _sp.issparse(A):
        from .operators import rcm_banded, BandedOperator
        # with a mass matrix both operators keep the caller's order
        rb = None
        if M is None and sharded:
            # the JAX package's chooser under a mesh: the pure banded
            # layout (its shifts become neighbour exchanges), else the
            # halo-exchange row partition, else the gathered format
            cand = rcm_banded(A)
            if cand is not None and isinstance(cand[0], BandedOperator):
                rb = cand
            else:
                rb = D.HaloELLOperator.from_scipy(A, mesh, device=device)
        elif M is None:
            rb = rcm_banded(A)
        if rb is not None:
            Aop, perm = rb
        else:
            Aop = aslinearoperator(A)
    else:
        Aop = aslinearoperator(A)
    n = Aop.shape[0]
    comm = D.mesh_comm(mesh, n, device) if sharded else None
    if comm is not None and _sp.issparse(A) and rb is None:
        # each rank packs only its own rows of the gathered format
        Aop = D.GatheredOperator.from_scipy(A, comm)
    Aop = Aop.to(device)
    if Aop.shape[0] != Aop.shape[1]:
        raise ValueError("expected square operator")
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    Mop = aslinearoperator(M).to(device) if M is not None else None
    if comm is not None:
        Aop = D.shard_operator(Aop, comm)
        if Mop is not None:
            Mop = D.shard_operator(Mop, comm)

    if isinstance(which, str) and which.upper() in _WHICH_TO_TARGET:
        which = which.upper()
        target = _WHICH_TO_TARGET[which]
    else:
        try:
            sigma0 = float(which)
        except (TypeError, ValueError):
            raise ValueError(
                f"which must be one of {sorted(_WHICH_TO_TARGET)} or a "
                f"number, got {which!r}")
        if sigma is not None:
            raise ValueError("give a numeric `which` or `sigma`, not both")
        sigma, which, target = sigma0, "SM", Target.closest_abs
    shifts = ()
    if target not in (Target.smallest, Target.largest):
        shifts = (float(sigma) if sigma is not None else 0.0,)
        if which == "LM" and sigma is None:
            target = Target.largest_abs
            shifts = (0.0,)

    p = PrimmeParams(
        n=n, num_evals=k, target=target, target_shifts=shifts,
        eps=float(tol), max_basis_size=(ncv or 0),
        min_restart_size=minRestartSize, max_block_size=maxBlockSize,
        max_prev_retain=(maxPrevRetain if maxPrevRetain >= 0 else prm.UNSET),
        locking=(prm.UNSET if locking is None else int(locking)),
        rng_seed=seed)
    if maxiter is not None:
        p = p.with_(max_outer_iterations=int(maxiter))
    if maxMatvecs is not None:
        p = p.with_(max_matvecs=int(maxMatvecs))
    if verify_spectrum is not None:
        p = p.with_(verify_spectrum=int(verify_spectrum))
    K = None
    if OPinv is not None:
        K = aslinearoperator(OPinv).to(device)
        if comm is not None:
            K = D.shard_operator(K, comm)
    elif jacobi:
        d = Aop.diagonal()
        if d is None:
            raise ValueError("jacobi=True but operator has no diagonal()")
        K = JacobiPrecond(d)           # on the operator's device
    if wd is not None and wd != Aop.dtype:
        Aop = CastOperator(Aop, wd)
        if K is not None:
            K = CastOperator(K, wd)
    if Mop is not None and Mop.dtype != Aop.dtype:
        # the mass matrix works in the solve's precision
        Mop = CastOperator(Mop, Aop.dtype)

    meth = method
    if meth is None:
        meth = Method.DEFAULT_MIN_MATVECS
    elif isinstance(meth, str):
        meth = Method[meth.replace("PRIMME_", "")]
    if projection is not None:
        from .params import Projection
        if isinstance(projection, str):
            projection = Projection(projection.replace("primme_proj_", ""))
        p = p.with_(projection=projection)
    p = set_method(meth, p, has_precond=K is not None,
                   has_mass=Mop is not None)
    if maxInnerIterations is not None:
        p = p.with_(max_inner_iterations=int(maxInnerIterations))
    for label_, val_ in primme_kwargs.items():
        if prm._canonical(label_) in ("n", "num_evals", "target",
                                      "num_ortho_const", "hermitian"):
            raise ValueError(
                f"{label_!r} cannot be set through keyword forwarding — "
                f"it is derived from the operator and the k=/which=/"
                f"lock= arguments")
        p = prm.set_member(p, label_, val_)

    v0t = None
    if v0 is not None:
        v0n = np.asarray(v0)
        if v0n.ndim == 1:
            v0n = v0n[:, None]
        if perm is not None:
            v0n = v0n[perm, :]
        if comm is not None:
            v0n = comm.rows(v0n)
        v0t = host_read(torch.as_tensor(np.ascontiguousarray(v0n)).to,
                        device=device, dtype=Aop.dtype)
    oc = None
    if lock is not None:
        ocn = np.asarray(lock)
        if ocn.ndim == 1:
            ocn = ocn[:, None]
        if ocn.ndim != 2 or ocn.shape[0] != n:
            # `lock` is the reference binding's name for orthogonal
            # constraint vectors, not a flag: hard locking is locking=True
            raise ValueError(
                f"lock= must be an [n, c] array of orthogonal-constraint "
                f"vectors (n={n}); for hard locking pass locking=True. "
                f"Got shape {np.shape(lock)}")
        if perm is not None:
            ocn = ocn[perm, :]
        oc = host_read(torch.as_tensor(np.ascontiguousarray(
            ocn if comm is None else comm.rows(ocn))).to,
            device=device, dtype=Aop.dtype)
        p = prm.resolve_defaults(p.with_(num_ortho_const=int(ocn.shape[1])))

    history: dict = {"num_matvecs": [], "num_outer": [], "num_locked": [],
                     "num_converged": [], "basis_size": [], "event": [],
                     "num_inner": [], "hvals": [], "resnorms": [],
                     "inner": []}
    mon = monitor
    if mon is None and printLevel >= 2:
        mon = _text_monitor
    if return_history and mon is None:
        def mon(event, num_outer, num_matvecs, num_locked, num_converged,
                basis_size, num_inner, hvals, resnorms, inner_trace=None):
            history["event"].append(int(event))
            history["num_outer"].append(int(num_outer))
            history["num_matvecs"].append(int(num_matvecs))
            history["num_locked"].append(int(num_locked))
            history["num_converged"].append(int(num_converged))
            history["basis_size"].append(int(basis_size))
            history["num_inner"].append(int(num_inner))
            history["hvals"].append(np.asarray(hvals))
            history["resnorms"].append(np.asarray(resnorms))
            if inner_trace is not None:
                tr = np.asarray(inner_trace)
                history["inner"].append(tr[:min(int(num_inner),
                                                tr.shape[0])])

    segments: list = []

    def _run_solve(mon_=mon):
        if p.dynamic_method_switch:
            from .core.dynamic import solve_eigs_dynamic
            segments.clear()
            return solve_eigs_dynamic(
                Aop, p, B=Mop, K=K, v0=v0t, ortho_const=oc, dtype=wd,
                device=device, has_precond=K is not None, monitor=mon_,
                convtest=convtest, segment_log=segments, comm=comm)
        inner = None
        if p.max_inner_iterations != 0:
            from .core.inner import jdqmr_inner_solve
            inner = jdqmr_inner_solve
        itcap = 0
        # printLevel >= 4 reports inner iterations, as the reference's
        # default monitor does at primme_event_inner_iteration
        if (monitor_inner or printLevel >= 4) and mon_ is not None \
                and inner is not None:
            # a bounded buffer; past the cap the last row is overwritten
            # (the count stays exact through num_inner)
            mi = p.max_inner_iterations
            itcap = min(mi, 128) if mi > 0 else 128
        return solve_eigs(Aop, p, B=Mop, K=K, v0=v0t, ortho_const=oc,
                          inner_solve=inner, dtype=wd, device=device,
                          convtest=convtest, monitor=mon_,
                          segment_outer=segment_outer, inner_trace_cap=itcap,
                          comm=comm)

    t0 = time.perf_counter()
    res = _run_solve()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    resnorms = host_read(res.resnorms.cpu).numpy()
    anorm = float(res.stats.anorm_estimate)
    eps_eff = p.eps if p.eps > 0 else 1e4 * float(
        torch.finfo(res.evals.dtype).eps)
    if wd in _HALF:
        # a half-precision basis cannot resolve residuals below its eps
        eps_eff = max(eps_eff, 4 * float(torch.finfo(wd).eps))
    unconv = int(np.sum(~(resnorms <= 10 * max(eps_eff * max(anorm, 1e-300),
                                               1e-300))))
    if unconv > 0 and raise_for_unconverged:
        raise PrimmeError(
            f"{unconv}/{k} pairs unconverged (resnorms={resnorms})")
    if res.stats.probe_exhausted and raise_for_unconverged:
        raise PrimmeError(
            f"spectrum verification exhausted its round budget "
            f"({res.stats.num_probe_rounds} rounds) before confirming "
            f"the returned set is complete; the pairs converge but may "
            f"miss degenerate-cluster members. Increase verify_spectrum "
            f"or pass verify_spectrum=0 to skip verification.")

    stats = dataclasses.asdict(res.stats)
    stats["elapsed_time"] = elapsed
    # zero by construction: the projected solve is never solved on one
    # process and broadcast (the reference's numBroadcast)
    stats["num_broadcast"] = 0
    stats["volume_broadcast"] = 0
    if p.dynamic_method_switch:
        # the measured segments of the method switch: their methods and,
        # each, its seconds, digits gained, outer iterations and matvecs
        stats["method_trace"] = [r["method"] for r in segments]
        stats["dynamic_segments"] = list(segments)
    if (time_breakdown and return_stats) or profile:
        # the measured breakdown re-runs the solve once under the profiler
        # (without the user's monitor, which would see every event twice);
        # where the trace holds no device time, as on the CPU, the
        # estimate of profiling.time_breakdown stands in, labelled so
        from .profiling import measure_breakdown, time_breakdown as _tb
        measured = measure_breakdown(lambda: _run_solve(None), device=device)
        if not measured:
            measured = _tb(Aop, K, stats, mmax=p.max_basis_size,
                           blk=p.max_block_size,
                           cwin=min(p.max_basis_size, k + p.max_block_size),
                           dtype=(wd or Aop.dtype),
                           n=n if comm is None else comm.nl)
            measured["time_source"] = "estimated"
        if time_breakdown and return_stats:
            stats.update(measured)
    if profile:
        _deliver_profile(profile, measured, stats, mon)
    if return_history:
        stats["hist"] = {k_: (np.asarray(v_) if v_ and not isinstance(
            v_[0], np.ndarray) else v_) for k_, v_ in history.items()}
    with scope("pt_to_host"):
        out = [host_read(res.evals.cpu).numpy()]
        if return_eigenvectors:
            ev = host_read(allgather_rows(res.evecs, comm).cpu).numpy()
            if perm is not None:
                ev = ev[np.argsort(perm), :]
            out.append(ev)
    if return_stats:
        stats["num_host_reads"] = host_reads() - reads0
        out.append(stats)
    return tuple(out) if len(out) > 1 else out[0]


# event taxonomy of the reference's primme_event enum: 0 outer_iteration,
# 1 inner_iteration, 2 restart, 3 reset, 4 converged, 5 locked (7 profile)
_EV = {0: "OUT", 1: "INN", 2: "RST", 3: "RES", 4: "CNV", 5: "LCK"}


def _text_monitor(event, num_outer, num_matvecs, num_locked, num_converged,
                  basis_size, num_inner, hvals, resnorms, inner_trace=None,
                  msg=None, time=None):
    """The ``printLevel >= 2`` monitor: the reference's text lines (its
    ``default_monitor``), one per event, with per-inner-iteration ``INN``
    lines replayed from the recorded buffer and ``PRF`` lines for profile
    events."""
    if int(event) == 7:   # primme_event_profile
        print(f"PRF {msg} {float(time):.6f}s")
        return
    if inner_trace is not None and int(num_inner) > 0:
        tr = np.asarray(inner_trace)
        for i in range(min(int(num_inner), tr.shape[0])):
            al = tr[i, :, 2] > 0
            if not al.any():
                continue
            j = int(np.argmax(al))
            print(f"INN it={int(num_outer):5d} qmr={i:3d} "
                  f"alive={int(al.sum())} "
                  f"val[0]={tr[i, j, 0]:+.10e} "
                  f"eres[0]={tr[i, j, 1]:.3e}")
    ev = _EV.get(int(event), "?")
    print(f"{ev} it={int(num_outer):5d} mv={int(num_matvecs):6d} "
          f"lock={int(num_locked):3d} conv={int(num_converged):3d} "
          f"b={int(basis_size):3d} inner={int(num_inner):4d} "
          f"val[0]={float(np.asarray(hvals)[0]):+.10e} "
          f"res[0]={float(np.asarray(resnorms)[0]):.3e}")


def _deliver_profile(profile: str, measured: dict, stats: dict, mon):
    """``primme.profile``: the regex selects phase scopes; each match goes
    into ``stats["profile"]`` with its time and, to a monitor whose
    signature takes ``msg`` and ``time``, as a profile event (7). The
    signature decides, as in the reference, not a caught TypeError: an
    error inside the monitor propagates."""
    import inspect
    import re

    pat = re.compile(profile)
    scope_key = {"pt_matvec": "time_matvec", "pt_precond": "time_precond",
                 "pt_ortho": "time_ortho", "pt_dense": "time_dense",
                 "pt_other": "time_other"}
    prof = {sc: float(measured.get(tk, 0.0))
            for sc, tk in scope_key.items() if pat.search(sc)}
    stats["profile"] = prof
    stats["time_source"] = measured.get("time_source", "measured")
    if mon is None:
        return
    try:
        sig = inspect.signature(mon)
        takes_kw = all(
            kw in sig.parameters
            or any(pp.kind is inspect.Parameter.VAR_KEYWORD
                   for pp in sig.parameters.values())
            for kw in ("msg", "time"))
    except (TypeError, ValueError):
        takes_kw = True   # an uninspectable callable: attempt it
    if takes_kw:
        z = np.zeros(0)
        for name, secs in prof.items():
            mon(7, 0, stats.get("num_matvecs", 0), 0, 0, 0, 0, z, z,
                msg=name, time=secs)


_EIGS_WHICH = {"LM": Target.largest_abs, "SM": Target.closest_abs,
               "LR": Target.largest, "SR": Target.smallest,
               "CGT": Target.closest_geq, "CLT": Target.closest_leq}


def eigs(A: Any, k: int = 6, which: str = "LM",
         sigma: Optional[float] = None, tol: float = 0.0,
         ncv: Optional[int] = None, maxiter: Optional[int] = None,
         v0: Any = None, return_eigenvectors: bool = True,
         return_stats: bool = False, method: Optional[Any] = None,
         maxMatvecs: Optional[int] = None, OPinv: Any = None,
         raise_for_unconverged: bool = True, seed: int = 0,
         maxInnerIterations: Optional[int] = None,
         segment_outer: Optional[int] = None,
         locking: Optional[bool] = None, maxBlockSize: int = 0,
         lock: Any = None, device: Any = None):
    """Eigenpairs of a normal (non-Hermitian, ``A A^H = A^H A``) operator,
    with complex Ritz values: the reference's ``eigs`` (PRIMME's
    ``dprimme_normal``/``zprimme_normal``). ``which`` is one of LM, SM
    (closest to ``sigma`` in modulus), LR, SR, CGT and CLT (real part at
    or above, at or below ``sigma``); ``lock`` passes orthogonality
    constraint vectors, ``locking`` turns on hard locking,
    ``maxBlockSize`` sets the block. The method is GD_plusK unless
    ``method`` names another preset; a preset with inner iterations (the
    JD ones, such as ``"JDQMR"``) corrects with the projected block GMRES
    of :func:`~primme_tpu_torch.core.inner.normal_inner_solve`.

    ``A`` goes through :func:`aslinearoperator` (a dense matrix up to 8192
    rows, an :class:`ELLOperator` above; a port operator as it is), with
    no format chooser, as in the reference. The solve works in the
    complex type of ``A``'s precision; a real operator multiplies the
    complex block's two parts in one product. ``device`` is where the
    solve runs: the card when it is None, which raises if there is none.
    Returns numpy arrays: complex values, and vectors and stats when
    asked for. ``segment_outer`` re-enters the solver's loop every
    that-many outer iterations (:func:`~.core.solver.solve_eigs`).
    ``method="DYNAMIC"`` runs the DYNAMIC preset's parameters through
    ``solve_eigs`` without switching, as the reference's ``eigs`` does."""
    device = default_device(device, "eigs")
    Aop = aslinearoperator(A).to(device)
    n = Aop.shape[0]
    if Aop.shape[0] != Aop.shape[1]:
        raise ValueError("expected square operator")
    which = which.upper()
    if which not in _EIGS_WHICH:
        raise ValueError(f"which must be one of {sorted(_EIGS_WHICH)}")
    target = _EIGS_WHICH[which]
    shifts = ()
    if target in (Target.closest_abs, Target.largest_abs,
                  Target.closest_geq, Target.closest_leq):
        shifts = (float(sigma) if sigma is not None else 0.0,)
    cdt = torch.promote_types(Aop.dtype, torch.complex64)

    p = PrimmeParams(n=n, num_evals=k, target=target, target_shifts=shifts,
                     eps=float(tol), max_basis_size=(ncv or 0),
                     max_block_size=maxBlockSize,
                     locking=(prm.UNSET if locking is None else
                              int(locking)),
                     hermitian=False, rng_seed=seed)
    if maxiter is not None:
        p = p.with_(max_outer_iterations=int(maxiter))
    if maxMatvecs is not None:
        p = p.with_(max_matvecs=int(maxMatvecs))
    K = aslinearoperator(OPinv).to(device) if OPinv is not None else None
    meth = method or Method.GD_plusK
    if isinstance(meth, str):
        meth = Method[meth.replace("PRIMME_", "")]
    p = set_method(meth, p, has_precond=K is not None)
    if maxInnerIterations is not None:
        p = p.with_(max_inner_iterations=int(maxInnerIterations))
    inner = None
    if p.max_inner_iterations != 0:
        from .core.inner import normal_inner_solve
        inner = normal_inner_solve

    def block(x):
        t = np.array(x)
        if t.ndim == 1:
            t = t[:, None]
        return host_read(torch.from_numpy(np.ascontiguousarray(t)).to,
                         device=device, dtype=cdt)

    v0t = block(v0) if v0 is not None else None
    oc = None
    if lock is not None:
        oc = block(lock)
        if oc.ndim != 2 or oc.shape[0] != n:
            raise ValueError(
                f"lock= must be an [n, c] array of orthogonal-constraint "
                f"vectors (n={n}); for hard locking pass locking=True")
        p = prm.resolve_defaults(p.with_(num_ortho_const=int(oc.shape[1])))

    t0 = time.perf_counter()
    res = solve_eigs(Aop, p, K=K, v0=v0t, ortho_const=oc, dtype=cdt,
                     inner_solve=inner, device=device,
                     segment_outer=segment_outer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    resnorms = host_read(res.resnorms.cpu).numpy()
    if raise_for_unconverged:
        anorm = float(res.stats.anorm_estimate)
        eps_eff = p.eps if p.eps > 0 else 1e4 * float(
            torch.finfo(real_dtype(cdt)).eps)
        bad = int(np.sum(resnorms > 10 * eps_eff * max(anorm, 1e-300)))
        if bad:
            raise PrimmeError(f"{bad}/{k} pairs unconverged "
                              f"(resnorms={resnorms})")
    stats = dataclasses.asdict(res.stats)
    stats["elapsed_time"] = elapsed
    with scope("pt_to_host"):
        out = [host_read(res.evals.cpu).numpy()]
        if return_eigenvectors:
            out.append(host_read(res.evecs.cpu).numpy())
    if return_stats:
        out.append(stats)
    return tuple(out) if len(out) > 1 else out[0]
