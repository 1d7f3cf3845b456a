"""Golden-file test harness: run the reference's config files.

PyTorch port of ``primme_tpu/testharness.py``: the reference's
config-driven test driver (``tests/driver.c`` +
``tests/COMMON/shared_utils.c:364`` parsing and
``tests/COMMON/ioandtest.c:70-135`` solution checking) against this
package: parse a ``tests/tests/test_???`` config, build the operator from
the named ``.mtx`` (``aslinearoperator``: a dense matrix up to 8192 rows,
else an :class:`~primme_tpu_torch.operators.ELLOperator` on the sliced-ELL
kernel's native FP64 entry point), map the ``primme.*`` fields onto
:class:`~primme_tpu_torch.params.PrimmeParams`, solve on ``device`` (the
card unless the caller passes ``device="cpu"``), and verify

* eigenvector orthonormality  < sqrt(macheps),
* recomputed residual norms  <= eps * ||A|| (with slack),
* angle to the stored golden eigenvectors (``sol_???_double``) bounded.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import torch

from .params import PrimmeParams, Target, Method, Projection, set_method
from .operators import aslinearoperator, JacobiPrecond, default_device
from .core.solver import solve_eigs

_TARGET_MAP = {
    "primme_smallest": Target.smallest,
    "primme_largest": Target.largest,
    "primme_closest_abs": Target.closest_abs,
    "primme_closest_geq": Target.closest_geq,
    "primme_closest_leq": Target.closest_leq,
    "primme_largest_abs": Target.largest_abs,
}

_PROJ_MAP = {
    "primme_proj_RR": Projection.RR,
    "primme_proj_refined": Projection.refined,
    "primme_proj_harmonic": Projection.harmonic,
}


@dataclass
class TestConfig:
    matrix_file: str = ""
    check_x_file: str = ""
    save_x_file: str = ""
    prec_choice: str = "noprecond"
    shift: float = 0.0
    method: Optional[Method] = None
    fields: dict = field(default_factory=dict)   # primme.* -> raw string
    is_svds: bool = False          # config targets the svds driver
    svds_method: str = ""          # 'method = primme_svds_*' line, stripped


def parse_config(path: str) -> TestConfig:
    """Parse a ``tests/tests/test_???`` driver config
    (``read_driver_params``/``read_solver_params``,
    ``tests/COMMON/shared_utils.c``)."""
    cfg = TestConfig()
    for line in open(path):
        line = line.split("//")[0].strip()
        if not line or "=" not in line:
            continue
        k, v = [x.strip() for x in line.split("=", 1)]
        if k == "driver.matrixFile":
            cfg.matrix_file = v
        elif k == "driver.checkXFile":
            cfg.check_x_file = v
        elif k == "driver.saveXFile":
            cfg.save_x_file = v
        elif k == "driver.PrecChoice":
            cfg.prec_choice = v
        elif k == "driver.shift":
            cfg.shift = float(v)
        elif k == "method":
            # svds drivers use 'method = primme_svds_*' (consumed by
            # run_svds_config); only eigs preset names map to Method
            if v.startswith("primme_svds"):
                cfg.svds_method = v.replace("primme_svds_", "")
                cfg.is_svds = True
            else:
                cfg.method = Method[v.replace("PRIMME_", "")]
        elif k.startswith("primme.") or k.startswith("primme_svds."):
            if k.startswith("primme_svds."):
                cfg.is_svds = True
            cfg.fields[k.split(".", 1)[1]] = v
    return cfg


def read_sol_evecs(path: str) -> np.ndarray:
    """Read the stored golden eigenvectors
    (``readBinaryEvecsAndPrimmeParams``, ``tests/COMMON/ioandtest.c:159``):
    header [signed sizeof(SCALAR), n, cols] then column-major n x cols."""
    raw = open(path, "rb").read()
    size_marker = np.frombuffer(raw[:8], dtype="<f8")[0]
    if size_marker == 8.0:
        dt, ss = np.dtype("<f8"), 8
    elif size_marker == -16.0:
        dt, ss = np.dtype("<c16"), 16
    else:
        raise ValueError(f"unknown scalar marker {size_marker} in {path}")
    hdr = np.frombuffer(raw[: 3 * ss], dtype=dt)
    n, cols = int(hdr[1].real), int(hdr[2].real)
    X = np.frombuffer(raw[3 * ss: (3 + n * cols) * ss], dtype=dt)
    return X.reshape(cols, n).T.copy()


def write_sol_evecs(path: str, X: np.ndarray) -> None:
    """Write eigenvectors in the reference's golden-solution binary format
    (``writeBinaryEvecsAndPrimmeParams``, ``tests/COMMON/ioandtest.c:210``):
    header [signed sizeof(SCALAR), n, cols] then column-major n x cols.
    The marker scalar is ``+sizeof`` for real, ``-sizeof`` for complex (the
    reference's ``2*Re(i*i)+1`` trick). The trailing raw ``primme_params``
    struct blob the reference appends is for its own driver's reuse and is
    not read back by any solution check; it is omitted here.

    Files written this way are readable both by :func:`read_sol_evecs` and
    by the reference's ``readBinaryEvecsAndPrimmeParams``
    (``ioandtest.c:159``), which only consumes the header + vectors.
    """
    X = np.asarray(X)
    if np.iscomplexobj(X):
        dt, marker = np.dtype("<c16"), -16.0
        X = X.astype(np.complex128)
    else:
        dt, marker = np.dtype("<f8"), 8.0
        X = X.astype(np.float64)
    n, cols = X.shape
    with open(path, "wb") as f:
        np.array([marker, n, cols], dtype=dt).tofile(f)
        X.T.astype(dt).tofile(f)        # column-major payload


def write_sol_svecs(path: str, U: np.ndarray, V: np.ndarray) -> None:
    """Write singular vectors in the reference's golden format
    (``writeBinaryEvecsAndPrimmeSvdsParams``,
    ``tests/COMMON/ioandtest.c:412``): header [signed sizeof, m, n, cols]
    then U (m x cols) and V (n x cols), column-major."""
    U, V = np.asarray(U), np.asarray(V)
    if np.iscomplexobj(U) or np.iscomplexobj(V):
        dt, marker = np.dtype("<c16"), -16.0
        U, V = U.astype(np.complex128), V.astype(np.complex128)
    else:
        dt, marker = np.dtype("<f8"), 8.0
        U, V = U.astype(np.float64), V.astype(np.float64)
    (m, cols), (n, colsV) = U.shape, V.shape
    if cols != colsV:
        raise ValueError(f"U has {cols} columns but V has {colsV}")
    with open(path, "wb") as f:
        np.array([marker, m, n, cols], dtype=dt).tofile(f)
        U.T.astype(dt).tofile(f)
        V.T.astype(dt).tofile(f)


def build_params(cfg: TestConfig, n: int) -> PrimmeParams:
    f = cfg.fields
    p = PrimmeParams(n=n)
    if "numEvals" in f:
        p = p.with_(num_evals=int(f["numEvals"]))
    if "eps" in f:
        p = p.with_(eps=float(f["eps"]))
    if "maxBasisSize" in f:
        p = p.with_(max_basis_size=int(f["maxBasisSize"]))
    if "minRestartSize" in f:
        p = p.with_(min_restart_size=int(f["minRestartSize"]))
    if "maxBlockSize" in f:
        p = p.with_(max_block_size=int(f["maxBlockSize"]))
    if "maxMatvecs" in f:
        p = p.with_(max_matvecs=int(f["maxMatvecs"]))
    if "restarting.maxPrevRetain" in f:
        p = p.with_(max_prev_retain=int(f["restarting.maxPrevRetain"]))
    if "target" in f:
        p = p.with_(target=_TARGET_MAP[f["target"]])
    if "targetShifts" in f:
        p = p.with_(target_shifts=tuple(
            float(x) for x in f["targetShifts"].split()))
    if "projection.projection" in f:
        p = p.with_(projection=_PROJ_MAP[f["projection.projection"]])
    if "locking" in f:
        p = p.with_(locking=int(f["locking"]))
    if "correction.maxInnerIterations" in f:
        p = p.with_(max_inner_iterations=int(
            f["correction.maxInnerIterations"]))
    return p


# extra matvec budget granted for the spectrum-verification probe rounds
# (the reference's budgets predate this capability; see core/solver.py)
_PROBE_ALLOWANCE = 4000


class CheckResult:
    def __init__(self):
        self.ok = True
        self.messages = []
        # solution captured for the CLI driver (primme_tpu_torch.driver)
        self.evals = None        # eigen- or singular values
        self.rnorms = None       # recomputed residual norms
        self.stats = None        # solver Stats (eigs configs)

    def check(self, cond, msg):
        if not cond:
            self.ok = False
            self.messages.append(msg)

    def __repr__(self):
        return "OK" if self.ok else "; ".join(self.messages)


def run_config(path: str, base_dir: str = None, mv_slack: float = 2.0,
               eps_slack: float = 5.0, dtype=None,
               save_x_file: str = None, device=None) -> CheckResult:
    """Run one golden-file config and check the solution
    (``check_solution``, ``tests/COMMON/ioandtest.c:70-135``).

    ``dtype=complex``: run the config in doublecomplex the way the
    reference suite runs every ``test_0??`` twice
    (``tests/Makefile:98-101``) — the matrix is cast and the complex
    code path is exercised against the ``sol_???_doublecomplex`` golden.

    ``save_x_file``: write the computed eigenvectors in the reference's
    golden binary format (``driver.saveXFile``, ``tests/driver.c:280``);
    defaults to the config's own ``driver.saveXFile`` if set, resolved
    against ``base_dir`` like every other ``driver.*`` path (an explicit
    ``save_x_file`` argument is used verbatim).

    ``device``: where the solve runs, the card when None (raising if
    there is none); ``"cpu"`` runs on the CPU.
    """
    import scipy.io as sio
    import scipy.sparse as sp

    device = default_device(device, "run_config")
    base_dir = base_dir or os.path.join(os.path.dirname(path), "..")
    cfg = parse_config(path)
    A = sp.csr_matrix(sio.mmread(os.path.join(base_dir, cfg.matrix_file)))
    is_complex = np.iscomplexobj(A.data) or (
        dtype is not None
        and np.issubdtype(np.dtype(dtype), np.complexfloating))
    if is_complex:
        A = A.astype(np.complex128)
    n = A.shape[0]
    p = build_params(cfg, n)
    # budget slack: counts differ from the reference's by implementation.
    # The spectrum-verification probe (a capability the reference lacks)
    # costs extra matvecs on top; its budget is granted separately so the
    # solve itself is held to mv_slack * the reference's own budget.
    if p.max_matvecs < (1 << 60):
        p = p.with_(max_matvecs=int(p.max_matvecs * mv_slack)
                    + _PROBE_ALLOWANCE)

    K = None
    has_prec = cfg.prec_choice not in ("noprecond", "")
    if has_prec:
        # the reference test driver applies a FIXED 1/(diag - shift)
        # jacobi preconditioner (tests/COMMON/shared_utils.c jacobi path),
        # not re-shifted per Ritz value
        d = A.diagonal() - cfg.shift      # complex where the matrix is
        K = JacobiPrecond(np.where(np.abs(d) < 1e-10, 1.0, d),
                          use_shifts=False).to(device)

    meth = cfg.method or Method.DEFAULT_METHOD
    p = set_method(meth, p, has_precond=has_prec)

    inner = None
    if p.max_inner_iterations != 0 and not p.dynamic_method_switch:
        from .core.inner import jdqmr_inner_solve as inner

    Aop = aslinearoperator(A).to(device)
    wd = torch.complex128 if is_complex else None
    if p.dynamic_method_switch:
        from .core.dynamic import solve_eigs_dynamic
        res = solve_eigs_dynamic(Aop, p, K=K, has_precond=has_prec,
                                 dtype=wd, device=device)
    else:
        res = solve_eigs(Aop, p, K=K, inner_solve=inner, dtype=wd,
                         device=device)

    evals = res.evals.cpu().numpy()
    evecs = res.evecs.cpu().numpy()
    k = p.num_evals

    save = save_x_file or (
        os.path.join(base_dir, cfg.save_x_file) if cfg.save_x_file else "")
    if save:
        write_sol_evecs(save, evecs)

    out = CheckResult()
    out.evals, out.stats = evals, res.stats
    meps = np.finfo(np.float64).eps
    anorm = max(float(np.abs(evals).max()),
                float(res.stats.anorm_estimate), 1e-300)
    eps = p.eps if p.eps > 0 else 1e4 * meps

    # 1. orthonormality < sqrt(macheps) (ioandtest.c:101)
    G = evecs.conj().T @ evecs
    out.check(np.abs(G - np.eye(k)).max() < np.sqrt(meps),
              f"orthonormality {np.abs(G - np.eye(k)).max():.2e}")

    # 2. residual norms <= eps * |A| (with slack; ioandtest.c:108)
    R = A @ evecs - evecs * evals[None, :]
    rn = np.linalg.norm(R, axis=0)
    out.rnorms = rn
    out.check(rn.max() <= eps_slack * eps * anorm * np.sqrt(k),
              f"residuals {rn.max():.2e} > {eps_slack * eps * anorm:.2e}")

    # 3. angle vs stored golden eigenvectors (ioandtest.c:125-135)
    suffix = "_doublecomplex" if is_complex else "_double"
    solfile = os.path.join(base_dir, cfg.check_x_file + suffix)
    if os.path.exists(solfile):
        Xs = read_sol_evecs(solfile)
        # projection of each computed vector onto the golden span
        C = Xs.conj().T @ evecs                       # [cols, k]
        proj = np.linalg.norm(C, axis=0)
        sin_angle = np.sqrt(np.maximum(0.0, 1.0 - proj ** 2))
        # Davis-Kahan style bound, like the reference's
        # bound = aNorm * eps / delta with delta the minimum separation
        # of the returned eigenvalues (ioandtest.c:88-91,141)
        sv = np.sort(np.real(evals))
        delta = float(np.diff(sv).min()) if k >= 2 else anorm
        delta = max(delta, 1e-300)
        # floor: golden vectors are themselves only residual-accurate
        bound = max(np.sqrt(2.0) * eps_slack * eps * anorm / delta, 1e-6)
        out.check(sin_angle.max() < bound,
                  f"angle to golden evecs {sin_angle.max():.2e} "
                  f"> {bound:.2e}")
    return out


def run_all(tests_dir: str, pattern: str = r"test_0\d\d$", device=None):
    """Run every matching config; returns {name: CheckResult}."""
    out = {}
    for name in sorted(os.listdir(tests_dir)):
        if re.match(pattern, name):
            out[name] = run_config(os.path.join(tests_dir, name),
                                   device=device)
    return out


# ---------------------------------------------------------------------------
# SVDS golden configs (test_2??, driversvds.c)
# ---------------------------------------------------------------------------

def read_sol_svecs(path: str):
    """Read stored golden singular vectors
    (``readBinaryEvecsAndPrimmeSvdsParams``,
    ``tests/COMMON/ioandtest.c:349``): header [sizeof, m, n, cols], then
    U (m x cols) and V (n x cols), column-major."""
    raw = open(path, "rb").read()
    marker = np.frombuffer(raw[:8], dtype="<f8")[0]
    if marker == 8.0:
        dt, ss = np.dtype("<f8"), 8
    elif marker == -16.0:
        dt, ss = np.dtype("<c16"), 16
    else:
        raise ValueError(f"unknown scalar marker {marker} in {path}")
    hdr = np.frombuffer(raw[: 4 * ss], dtype=dt)
    m, n, cols = int(hdr[1].real), int(hdr[2].real), int(hdr[3].real)
    off = 4 * ss
    U = np.frombuffer(raw[off: off + m * cols * ss], dtype=dt)
    U = U.reshape(cols, m).T.copy()
    off += m * cols * ss
    V = np.frombuffer(raw[off: off + n * cols * ss], dtype=dt)
    V = V.reshape(cols, n).T.copy()
    return U, V


def run_svds_config(path: str, base_dir: str = None,
                    eps_slack: float = 5.0, dtype=None,
                    save_x_file: str = None, device=None) -> CheckResult:
    """Run one SVD golden-file config (test_2??; driver
    ``tests/driversvds.c``). ``dtype=complex`` runs the doublecomplex
    variant (``tests/Makefile:98-101``). ``save_x_file`` writes the
    computed triplets in the reference's golden binary format
    (``driver.saveXFile``, ``driversvds.c``). ``device`` as in
    :func:`run_config`."""
    import scipy.io as sio
    import scipy.sparse as sp
    from .svds import svds as svds_fn

    device = default_device(device, "run_svds_config")
    base_dir = base_dir or os.path.join(os.path.dirname(path), "..")
    cfg = parse_config(path)
    A = sp.csr_matrix(sio.mmread(os.path.join(base_dir, cfg.matrix_file)))
    is_complex = np.iscomplexobj(A.data) or (
        dtype is not None
        and np.issubdtype(np.dtype(dtype), np.complexfloating))
    if is_complex:
        A = A.astype(np.complex128)
    f = cfg.fields
    k = int(f.get("numSvals", 6))
    eps = float(f.get("eps", 1e-6))
    tgt = f.get("target", "primme_svds_largest")
    if tgt == "primme_svds_closest_abs":
        # numeric `which` = closest_abs about the (first) target shift
        which = float(str(f.get("targetShifts", "0")).split()[0])
    elif tgt in ("primme_svds_largest", "primme_svds_smallest"):
        which = "LM" if tgt == "primme_svds_largest" else "SM"
    else:
        raise KeyError(f"unknown primme_svds.target: {tgt!r}")
    # svds-level solver fields beyond the reference configs' own usage
    # (numSvals/eps/target/printLevel) forward to svds() — silently
    # ignoring a config key would misreport the config's behavior
    extra = {}
    if "maxBlockSize" in f:
        extra["maxBlockSize"] = int(f["maxBlockSize"])
    if "maxBasisSize" in f:
        extra["ncv"] = int(f["maxBasisSize"])
    if "aNorm" in f:
        extra["aNorm"] = float(f["aNorm"])
    maxiter = int(f.get("maxMatvecs", 250000))
    known = {"numSvals", "eps", "target", "targetShifts", "printLevel",
             "maxBlockSize", "maxBasisSize", "maxMatvecs", "aNorm"}
    unknown = [kk for kk in f
               if "." not in kk and kk not in known]
    if unknown:
        raise KeyError(f"unsupported primme_svds config keys: {unknown}")
    method = cfg.svds_method or "hybrid"

    # jacobi PrecChoice -> diag(A^H A) preconditioner for stage 1
    # (driversvds.c jacobi builds 1/diag of the normal-equations operator)
    prec = {}
    if cfg.prec_choice == "jacobi":
        tall = A.shape[0] >= A.shape[1]
        # stage-1 operator is A^H A (n x n) when tall, A A^H (m x m) when
        # wide: diag via column sums vs row sums of |a_ij|^2 respectively
        d = np.asarray(A.multiply(A.conj()).sum(
            axis=0 if tall else 1)).ravel().real
        K = JacobiPrecond(np.where(d < 1e-300, 1.0, d),
                          use_shifts=False).to(device)
        prec = {"precAHA": K} if tall else {"precAAH": K}

    # embedded per-stage labels (primme_svds.primme.* /
    # primme_svds.primmeStage2.*) route through the svds reflection layer
    s1 = {kk.split(".", 1)[1]: vv for kk, vv in f.items()
          if kk.startswith("primme.")}
    s2 = {kk.split(".", 1)[1]: vv for kk, vv in f.items()
          if kk.startswith("primmeStage2.")}

    # budget comparable to the reference's own consumption on these
    # configs (measured: 136k matvecs on test_203, 162k on test_204)
    # the harness does its own residual/golden checking below; report a
    # failed CheckResult rather than raising mid-harness
    U, svals, Vt, sv_stats = svds_fn(
        A, k=k, tol=eps, which=which, method=method,
        maxiter=maxiter, stage1_params=s1 or None,
        stage2_params=s2 or None, return_stats=True,
        raise_for_unconverged=False, device=device, **prec, **extra)
    save = save_x_file or (
        os.path.join(base_dir, cfg.save_x_file) if cfg.save_x_file else "")
    if save:
        write_sol_svecs(save, U, Vt.conj().T)
    out = CheckResult()
    out.evals = svals
    # flat per-stage dict (stage1_num_matvecs / stage2_num_matvecs...);
    # the driver sums the stages for its matvec aggregate
    out.stats = sv_stats
    sref = np.linalg.svd(A.toarray(), compute_uv=False)
    anorm = sref[0]

    # residuals (the library's own criterion)
    R1 = A @ Vt.conj().T - U * svals[None, :]
    R2 = A.conj().T @ U - Vt.conj().T * svals[None, :]
    rn = np.sqrt(np.linalg.norm(R1, axis=0) ** 2
                 + np.linalg.norm(R2, axis=0) ** 2)
    out.rnorms = rn
    out.check(rn.max() <= eps_slack * eps * anorm * np.sqrt(k),
              f"residuals {rn.max():.2e}")

    # singular values: every returned value must lie in the true spectrum
    # (membership, not exact-set equality — on pathological clusters like
    # rect.mtx's 1e-9 quadruple the reference itself returns different
    # cluster members run-to-run, and its stored golden solution misses a
    # true value too)
    svtol = max(100 * eps * anorm, 1e-8 * anorm)
    memb = np.array([np.abs(sref - v).min() for v in svals])
    out.check(memb.max() < svtol, f"svals err {memb.max():.2e}")
    # and the extremes must be found exactly
    if which == "LM":
        out.check(abs(np.max(svals) - sref[0]) < svtol,
                  f"largest sval missed: {np.max(svals)} vs {sref[0]}")
    elif which == "SM":
        out.check(abs(np.min(svals) - np.min(sref)) < svtol,
                  f"smallest sval missed: {np.min(svals)} vs {np.min(sref)}")
    else:
        # numeric which (closest_abs about a shift): the closest true
        # singular value to the shift must be in the returned set
        close = sref[np.argmin(np.abs(sref - float(which)))]
        out.check(np.abs(svals - close).min() < svtol,
                  f"closest sval to {which} missed: {close}")

    # angles vs stored golden vectors (skip when the returned set differs
    # legitimately inside a cluster)
    suffix = "svds_doublecomplex" if is_complex else "svds_double"
    solfile = os.path.join(base_dir, cfg.check_x_file + suffix)
    if os.path.exists(solfile):
        Us, Vs = read_sol_svecs(solfile)
        gold_sv = np.linalg.norm(np.asarray(A @ Vs), axis=0)
        same_set = all(np.abs(gold_sv - v).min() < svtol for v in svals)
        if same_set:
            pu = np.linalg.norm(Us.conj().T @ U, axis=0)
            pv = np.linalg.norm(Vs.conj().T @ Vt.conj().T, axis=0)
            sa = np.sqrt(np.maximum(0, 1 - np.minimum(pu, pv) ** 2)).max()
            out.check(sa < max(1e-3, 1e4 * eps),
                      f"angle to golden svecs {sa:.2e}")
    return out
