"""Support layer for the embedded-Python C/Fortran API
(``primme_tpu_torch/native/capi.cpp``).

The port of ``primme_tpu/capi_support.py``. The reference is a C library
first: ``dprimme``/``dprimme_svds`` (``include/primme_eigs.h:382-477``)
and an F77 shim (``src/eigs/primme_f77.c``), so C and Fortran codes call
it directly. This package's solver is Python and PyTorch; the native shim
(``native/capi.cpp``, built into ``libprimme_tpu_torch_capi``) embeds
CPython and forwards into this module. It gives C and Fortran programs
the same capability: hand over a CSR matrix (the test drivers' native
format, ``tests/COMMON/csr.c``) or a matvec callback (the library's own
``matrixMatvec`` contract) and receive eigenpairs or singular triplets.

The solves run on the card unless the environment variable
``PTPU_PLATFORM`` is ``cpu`` (any other non-empty value is refused, naming
the variable): the C surface is the f64 ``dprimme`` one, and the card has
native FP64. A CSR matrix becomes the operator ``eigsh``'s chooser or
``aslinearoperator`` picks (the sliced-ELL kernel's f64 entry point at the
sizes it takes over from the dense product); a matvec callback is a host
:class:`~primme_tpu_torch.operators.FunctionOperator`: each block leaves
the card for the C function and the result comes back, while the solve's
state stays on the card.

All buffer arguments arrive as raw addresses (int); vectors are written
back column-major (Fortran order), the reference's ``evecs`` layout, from
the solve's device. Every function returns 0 on success, -1 on error with
the message retrievable via :func:`last_error`.
"""

from __future__ import annotations

import ctypes
import enum
import os

import numpy as np

_last_error = ""


def last_error() -> str:
    return _last_error


def _set_error(e: BaseException) -> int:
    global _last_error
    _last_error = f"{type(e).__name__}: {e}"
    return -1


def _device():
    """Where the solves run: the card, or the CPU when ``PTPU_PLATFORM`` is
    ``cpu``."""
    from .operators import default_device

    plat = os.environ.get("PTPU_PLATFORM", "")
    if plat not in ("", "cpu"):
        raise ValueError(
            f"PTPU_PLATFORM={plat!r}: unset runs on the card, 'cpu' on the "
            "CPU; no other value is served")
    return default_device(plat or None, "the C ABI (PTPU_PLATFORM unset)")


def _arr(addr: int, ctype, count: int) -> np.ndarray:
    """View ``count`` elements of C type ``ctype`` at address ``addr``."""
    return np.ctypeslib.as_array(ctypes.cast(int(addr),
                                             ctypes.POINTER(ctype)),
                                 shape=(int(count),))


def _out(addr: int, count: int, values) -> None:
    """Write ``values`` (a numpy array or a tensor on any device) into the
    caller's ``count`` doubles at ``addr``, column-major."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    _arr(addr, ctypes.c_double, count)[:] = np.asarray(
        values, np.float64).reshape(-1, order="F")


def _csr(n_rows: int, n_cols: int, nnz: int, indptr: int, indices: int,
         data: int):
    import scipy.sparse as sp
    ip = _arr(indptr, ctypes.c_int64, n_rows + 1).copy()
    ix = _arr(indices, ctypes.c_int64, nnz).copy()
    dv = _arr(data, ctypes.c_double, nnz).copy()
    return sp.csr_matrix((dv, ix, ip), shape=(n_rows, n_cols))


_WHICH_EIG = {0: "SA", 1: "LA", 2: "CGT", 3: "CLT", 4: "SM", 5: "LM"}


def _which_str(which) -> str:
    """Accept a string or the F77 shim's integer code (0 smallest, 1
    largest, 2 closest_geq, 3 closest_leq, 4 closest_abs, 5 largest_abs:
    the ``primme_target`` enum order, ``include/primme_eigs.h:47-54``, and
    the order ``params.constant_info`` reports, so a value read back by
    ``params_get("target")`` feeds the F77 surface unchanged)."""
    if isinstance(which, (int, np.integer)):
        return _WHICH_EIG[int(which)]
    return str(which)


def _target_kw(which, sigma) -> dict:
    w = _which_str(which)
    kw = {"which": w}
    if w in ("SM", "CGT", "CLT", "LM"):
        # LM (largest_abs) also takes a shift: farthest FROM sigma (the
        # reference pairs primme_largest_abs with targetShifts)
        kw["sigma"] = float(sigma)
    return kw


def eigsh_csr(n: int, nnz: int, indptr: int, indices: int, data: int,
              k: int, which, tol: float, method: str, sigma: float,
              evals: int, evecs: int, resnorms: int) -> int:
    """Solve the Hermitian eigenproblem for a CSR matrix passed by
    address; write evals [k], evecs [n*k] column-major and the true
    residual norms [k]."""
    try:
        from . import eigsh

        A = _csr(n, n, nnz, indptr, indices, data)
        kw = _target_kw(which, sigma)
        if method:
            kw["method"] = method
        ev, X = eigsh(A, k=k, tol=float(tol), raise_for_unconverged=False,
                      device=_device(), **kw)
        R = A @ X - X * ev[None, :]
        _out(evals, k, ev)
        _out(evecs, n * k, X)
        _out(resnorms, k, np.linalg.norm(R, axis=0))
        return 0
    except Exception as e:  # noqa: BLE001 — boundary: report via last_error
        return _set_error(e)


# void matvec(const double *x, double *y, int blockSize, void *ctx)
# x, y: [n, blockSize] column-major — the reference's matrixMatvec
# contract (include/primme_eigs.h:170) restricted to f64/ld=n.
_MATVEC_T = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.c_int, ctypes.c_void_p)


def _host_matvec(n: int, fnaddr: int, ctx: int):
    """The C matvec at ``fnaddr`` as a function of an ``[n, k]`` numpy
    block: the block in Fortran order in, ``Y`` out."""
    fn = _MATVEC_T(int(fnaddr))
    ctxp = ctypes.c_void_p(int(ctx) or None)

    def call(Xh: np.ndarray) -> np.ndarray:
        Xf = np.asfortranarray(np.asarray(Xh, np.float64))
        Y = np.zeros_like(Xf, order="F")
        fn(Xf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
           Y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
           int(Xf.shape[1]), ctxp)
        return Y
    return call


def _callback_operator(n: int, fnaddr: int, ctx: int, device):
    """An operator around a C matvec function pointer, on ``device``: each
    application takes the block to the host, calls the C function on it
    and brings the result back (the host boundary the reference crosses
    for every user matvec)."""
    import torch
    from .operators import FunctionOperator, _on_host

    return FunctionOperator(
        _on_host(_host_matvec(n, fnaddr, ctx), n, np.dtype(np.float64)),
        (n, n), torch.float64, device=device)


def eigsh_matvec(n: int, fnaddr: int, ctx: int, k: int, which,
                 tol: float, method: str, sigma: float, maxiter: int,
                 evals: int, evecs: int, resnorms: int) -> int:
    """Solve with a user C matvec callback (``matrixMatvec`` contract)."""
    try:
        from . import eigsh

        dev = _device()
        A = _callback_operator(n, fnaddr, ctx, dev)
        kw = _target_kw(which, sigma)
        if method:
            kw["method"] = method
        if maxiter > 0:
            kw["maxMatvecs"] = int(maxiter)
        ev, X = eigsh(A, k=k, tol=float(tol), raise_for_unconverged=False,
                      device=dev, **kw)
        # true residuals through the user's own matvec
        R = _host_matvec(n, fnaddr, ctx)(X) - X * ev[None, :]
        _out(evals, k, ev)
        _out(evecs, n * k, X)
        _out(resnorms, k, np.linalg.norm(R, axis=0))
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


# ---------------------------------------------------------------------------
# Parameter-object surface: the C-ABI analogue of primme_params_create /
# primme_set_method / primme_set_member / primme_free
# (include/primme_eigs.h:461-477). A handle records its calls and replays
# them on a PrimmeParams sized for the true problem at run time, so method
# presets resolve for the real n while a member set AFTER set_method still
# overrides the preset, as in the reference; the whole configuration space
# is reachable from C and Fortran by string label.
# ---------------------------------------------------------------------------

_PARAMS: dict = {}
_NEXT_HANDLE = [1]


def params_create() -> int:
    """New parameter handle (> 0). ``n`` may be set by label or comes from
    the matrix at run time."""
    h = _NEXT_HANDLE[0]
    _NEXT_HANDLE[0] += 1
    _PARAMS[h] = {"ops": [], "jacobi": False, "n": 0}
    return h


def params_free(h: int) -> int:
    if _PARAMS.pop(int(h), None) is None:
        global _last_error
        _last_error = f"unknown params handle {h}"
        return -1
    return 0


def _params_build(st, n: int):
    """Replay the recorded call sequence on a fresh PrimmeParams sized for
    the actual problem."""
    from .params import PrimmeParams, Method, set_member, set_method

    p = PrimmeParams(n=max(int(n), 1))
    for op, a in st["ops"]:
        if op == "set":
            p = set_member(p, a[0], a[1])
        else:
            p = set_method(Method[a.replace("PRIMME_", "")], p,
                           has_precond=st["jacobi"])
    return p


def params_set(h: int, label: str, value: str) -> int:
    """Set a member by reference label (``maxBlockSize``,
    ``correction.maxInnerIterations``, ``targetShifts`` = space/comma
    list, ...). Extra labels beyond the reference surface: ``n`` (the
    problem size, validated against the matrix at run time) and
    ``jacobi`` (0/1: the built-in Jacobi preconditioner)."""
    try:
        st = _PARAMS[int(h)]
        if label == "jacobi":
            st["jacobi"] = bool(int(value))
            return 0
        if label == "n":
            st["n"] = int(value)
            return 0
        from .params import PrimmeParams, set_member

        # validate the label and value now (the reference's set_member
        # errors at call time, not at dprimme time)
        set_member(PrimmeParams(n=max(st["n"], 1)), label, value)
        st["ops"].append(("set", (label, value)))
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def params_set_method(h: int, name: str) -> int:
    """Apply a method preset (``primme_set_method``); reference constant
    names with or without the PRIMME_ prefix."""
    try:
        st = _PARAMS[int(h)]
        from .params import Method

        Method[str(name).replace("PRIMME_", "")]  # validate now
        st["ops"].append(("method", str(name)))
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def _constant(v) -> float:
    """An enum member's reference constant (``primme_constant_info``)."""
    from .params import constant_info

    for pref in ("primme_", "primme_proj_", "primme_init_"):
        try:
            return constant_info(pref + str(v.value))
        except KeyError:
            continue
    raise KeyError(f"no constant for {v!r}")


def params_get(h: int, label: str, out: int) -> int:
    """Read a member as a double (``primme_get_member`` on the numeric
    surface); enum members return their reference constant."""
    try:
        st = _PARAMS[int(h)]
        from .params import get_member

        if label == "n":
            # the stored value (0 = unset, the reference's struct default),
            # never the replay placeholder
            _arr(out, ctypes.c_double, 1)[0] = float(st["n"])
            return 0
        # with n unknown, replay against a large placeholder so the size
        # clamps (maxBasisSize = min(n, ...)) report no n=1 values; the run
        # replays at the true matrix size
        v = get_member(_params_build(st, st["n"] or (1 << 30)), label)
        if isinstance(v, enum.Enum):
            v = _constant(v)
        elif isinstance(v, tuple):
            v = v[0] if v else 0.0
        _arr(out, ctypes.c_double, 1)[0] = float(v)
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def params_display(h: int) -> int:
    """Print the configuration (``primme_display_params``)."""
    try:
        st = _PARAMS[int(h)]
        from .params import display_params

        print(display_params(_params_build(st, st["n"] or (1 << 30))))
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def eigsh_run(h: int, n: int, nnz: int, indptr: int, indices: int,
              data: int, evals: int, evecs: int, resnorms: int) -> int:
    """Parameterized solve (the ``dprimme(evals, evecs, resnorms,
    params)`` analogue): run the stored configuration against a CSR
    matrix; writes evals/resnorms [numEvals] and evecs [n*numEvals]
    column-major."""
    try:
        st = _PARAMS[int(h)]
        from .core.solver import solve_eigs
        from .operators import aslinearoperator, JacobiPrecond
        from .params import resolve_defaults

        if st["n"] and int(st["n"]) != int(n):
            raise ValueError(
                f"params n={st['n']} does not match matrix n={n}")
        dev = _device()
        Aop = aslinearoperator(_csr(n, n, nnz, indptr, indices, data)).to(dev)
        K = JacobiPrecond(Aop.diagonal()) if st["jacobi"] else None
        # resolve before reading max_inner_iterations (it may still be the
        # UNSET sentinel when no method preset was applied)
        p = resolve_defaults(_params_build(st, int(n)))
        if p.dynamic_method_switch:
            # PRIMME_DYNAMIC through the handle: the measured GD+k <-> JDQMR
            # switching the Python API delivers
            from .core.dynamic import solve_eigs_dynamic

            res = solve_eigs_dynamic(Aop, p, K=K, device=dev,
                                     has_precond=K is not None)
        else:
            inner = None
            if p.max_inner_iterations != 0:
                from .core.inner import jdqmr_inner_solve

                inner = jdqmr_inner_solve
            res = solve_eigs(Aop, p, K=K, inner_solve=inner, device=dev)
        k = p.num_evals
        _out(evals, k, res.evals)
        _out(evecs, n * k, res.evecs)
        _out(resnorms, k, res.resnorms)
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


# ---------------------------------------------------------------------------
# svds parameter-object surface: the primme_svds_params_create /
# primme_svds_set_method / primme_svds_set_member analogue
# (include/primme_svds.h) over the svds reflection layer (SvdsParams +
# svds_set_member, with the embedded primme.* / primmeStage2.* labels).
# ---------------------------------------------------------------------------

_SVDS_PARAMS: dict = {}


def svds_params_create() -> int:
    try:
        from .svds import SvdsParams

        h = _NEXT_HANDLE[0]
        _NEXT_HANDLE[0] += 1
        _SVDS_PARAMS[h] = {"sp": SvdsParams(), "m1": ""}
        return h
    except Exception as e:  # noqa: BLE001
        _set_error(e)
        return -1


def svds_params_free(h: int) -> int:
    if _SVDS_PARAMS.pop(int(h), None) is None:
        global _last_error
        _last_error = f"unknown svds params handle {h}"
        return -1
    return 0


def svds_params_set(h: int, label: str, value: str) -> int:
    """Set an svds member by reference label (``numSvals``, ``eps``,
    ``target`` = primme_svds_largest/smallest/closest_abs or its int code,
    and embedded ``primme.*`` / ``primmeStage2.*`` stage labels); applied
    at once (validation at call time, as in the reference)."""
    try:
        from .svds import svds_set_member

        st = _SVDS_PARAMS[int(h)]
        st["sp"] = svds_set_member(st["sp"], label, value)
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def svds_params_set_method(h: int, method: str, m1: str, m2: str) -> int:
    """``primme_svds_set_method(method, methodStage1, methodStage2)``;
    empty strings keep the per-method defaults. A failed call leaves the
    handle as it was."""
    try:
        from .svds import svds_set_member
        from .params import Method

        st = _SVDS_PARAMS[int(h)]
        sp, m1_new = st["sp"], st["m1"]
        if method:
            # the reference resets the embedded stage configs before
            # applying the preset: stage members set before the call are
            # cleared, those set after it override the preset
            sp = svds_set_member(sp.with_(primme={}, primme_stage2={}),
                                 "method", method)
            m1_new = ""
        if m2:
            sp = svds_set_member(sp, "methodStage2", m2)
        if m1:
            Method[str(m1).replace("PRIMME_", "")]  # validate now
            m1_new = str(m1)
        st["sp"], st["m1"] = sp, m1_new
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def svds_params_get(h: int, label: str, out: int) -> int:
    try:
        from .svds import (svds_get_member, _SVDS_TARGETS,
                           _SVDS_METHODS)
        from .params import Method

        v = svds_get_member(_SVDS_PARAMS[int(h)]["sp"], label)
        if isinstance(v, tuple):
            v = v[0] if v else 0.0
        if isinstance(v, enum.Enum):
            # embedded stage labels (primme.projection, primme.target, ...)
            # hold the eigensolver's enum members: their reference codes
            v = _constant(v)
        if isinstance(v, str):
            # enum-valued string members read back as their reference
            # constant codes (primme_svds_get_member's enum integers)
            if v in _SVDS_TARGETS:
                v = _SVDS_TARGETS.index(v)
            elif v in _SVDS_METHODS:
                v = _SVDS_METHODS.index(v)
            elif v in Method.__members__:
                # method_stage2 holds an eigensolver preset: its
                # primme_preset_method code
                v = list(Method.__members__).index(v)
            elif v == "":
                v = -1.0   # unset method_stage2
            else:
                raise TypeError(
                    f"{label} is a string member ({v!r}); the numeric "
                    f"get surface cannot return it")
        _arr(out, ctypes.c_double, 1)[0] = float(v)
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def svds_run(h: int, m: int, n: int, nnz: int, indptr: int, indices: int,
             data: int, svals: int, u: int, v: int, resnorms: int) -> int:
    """Parameterized svds solve over a CSR matrix (the
    ``dprimme_svds(svals, svecs, resNorms, params)`` call shape): writes
    svals/resnorms [numSvals], U [m*k] and V [n*k] column-major."""
    try:
        from .svds import svds_from_params

        st = _SVDS_PARAMS[int(h)]
        sp_ = st["sp"]
        if (sp_.m and int(sp_.m) != int(m)) or \
                (sp_.n and int(sp_.n) != int(n)):
            raise ValueError(
                f"params m={sp_.m} n={sp_.n} do not match the matrix "
                f"{m}x{n}")
        extra = {"return_stats": True, "raise_for_unconverged": False,
                 "device": _device()}
        if st["m1"]:
            extra["methodStage1"] = st["m1"]
        A = _csr(m, n, nnz, indptr, indices, data)
        U, s, Vt, stats = svds_from_params(A, sp_, **extra)
        k = sp_.num_svals
        _out(svals, k, s)
        _out(u, m * k, U)
        _out(v, n * k, Vt.conj().T)
        _out(resnorms, k, np.asarray(stats["resnorms"], np.float64))
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)


def svds_csr(m: int, n: int, nnz: int, indptr: int, indices: int,
             data: int, k: int, which, tol: float,
             svals: int, u: int, v: int) -> int:
    """Singular triplets of a CSR matrix; writes svals [k], U [m*k] and
    V [n*k] column-major (the ``dprimme_svds`` analogue)."""
    try:
        from . import svds

        A = _csr(m, n, nnz, indptr, indices, data)
        w = which if isinstance(which, str) else (
            "LM" if int(which) else "SM")
        U, s, Vt = svds(A, k=k, tol=float(tol), which=w, device=_device())
        _out(svals, k, s)
        _out(u, m * k, U)
        _out(v, n * k, Vt.T)
        return 0
    except Exception as e:  # noqa: BLE001
        return _set_error(e)
