"""User-facing API: scipy-style ``eigsh``.

PyTorch port of ``primme_tpu/api.py::eigsh`` with the surface ported so
far: sparse routing through :func:`~primme_tpu_torch.operators.rcm_banded`
and its permutation contract, ``which``/``sigma`` targets, the method
presets and keyword forwarding, ``v0``, ``return_stats``, a working
``dtype`` of f32 or f64 (the operator is wrapped in a ``CastOperator`` when
it differs from its own), ``raise_for_unconverged`` and the
probe-exhaustion error. Arguments of the reference that the port does not
serve yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from . import params as prm
from .params import PrimmeParams, Target, Method, set_method
from .operators import CastOperator, aslinearoperator
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


def _working_dtype(dtype: Any) -> Optional[torch.dtype]:
    """The solver's working dtype from a torch, numpy or named dtype; only
    f32 and f64 are served."""
    if dtype is None:
        return None
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dtype = getattr(torch, name, None)
    if dtype in (torch.bfloat16, torch.float16):
        raise _unported(f"the half-precision basis (dtype={dtype})")
    if dtype not in (torch.float32, torch.float64):
        raise _unported(f"a working dtype of {dtype}")
    return dtype


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
          mesh: Any = None, convtest: Any = None,
          maxInnerIterations: Optional[int] = None,
          time_breakdown: bool = False,
          verify_spectrum: Optional[int] = None,
          profile: Optional[str] = None, device: Any = None,
          **primme_kwargs):
    """Find ``k`` eigenvalues/eigenvectors of the Hermitian operator ``A``
    (the reference's ``eigsh``, scipy calling convention with the PRIMME
    extensions). ``device`` is where the solve runs: ``"cuda"`` when a
    card is present and ``device`` is None, else ``"cpu"``. Returns numpy
    arrays, like the reference."""
    if mode != "normal":
        raise ValueError(f"only mode='normal' is supported (got {mode!r})")
    for name, val in (("M (generalized problems)", M),
                      ("Minv", Minv), ("lock (orthogonal constraints)", lock),
                      ("mesh", mesh), ("monitor", monitor),
                      ("convtest", convtest), ("profile", profile)):
        if val is not None:
            raise _unported(name)
    if return_history:
        raise _unported("return_history")
    if time_breakdown:
        raise _unported("time_breakdown")
    wd = _working_dtype(dtype)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)

    perm = None
    import scipy.sparse as _sp

    if _sp.issparse(A):
        from .operators import rcm_banded
        rb = rcm_banded(A)
        if rb is not None:
            Aop, perm = rb
        else:
            Aop = aslinearoperator(A)
    else:
        Aop = aslinearoperator(A)
    Aop = Aop.to(device)
    n = Aop.shape[0]
    if Aop.shape[0] != Aop.shape[1]:
        raise ValueError("expected square operator")
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")

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
    elif jacobi:
        if Aop.diagonal() is None:
            raise ValueError("jacobi=True but operator has no diagonal()")
        raise _unported("JacobiPrecond")
    if wd is not None and wd != Aop.dtype:
        Aop = CastOperator(Aop, wd)
        if K is not None:
            K = CastOperator(K, wd)

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
    p = set_method(meth, p, has_precond=K is not None)
    if p.dynamic_method_switch:
        raise _unported("DYNAMIC method switching")
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
        v0t = torch.as_tensor(np.ascontiguousarray(v0n)).to(
            device=device, dtype=Aop.dtype)

    inner = None
    if p.max_inner_iterations != 0:
        from .core.inner import jdqmr_inner_solve
        inner = jdqmr_inner_solve

    t0 = time.perf_counter()
    res = solve_eigs(Aop, p, K=K, v0=v0t, inner_solve=inner, dtype=wd,
                     device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    resnorms = res.resnorms.cpu().numpy()
    anorm = float(res.stats.anorm_estimate)
    eps_eff = p.eps if p.eps > 0 else 1e4 * float(
        torch.finfo(res.evals.dtype).eps)
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
    out = [res.evals.cpu().numpy()]
    if return_eigenvectors:
        ev = res.evecs.cpu().numpy()
        if perm is not None:
            ev = ev[np.argsort(perm), :]
        out.append(ev)
    if return_stats:
        out.append(stats)
    return tuple(out) if len(out) > 1 else out[0]
