#!/usr/bin/env python3
"""The JAX package's counts for ``chip_smoke.py``'s sparse-format phases,
computed on the CPU: the constants the smoke run holds the port to.

For each phase it builds the phase's matrix with ``chip_smoke.py``'s own
function and runs ``primme_tpu.eigsh`` with the phase's arguments
(``chip_smoke.SOLVE_KWARGS``, tol 1e-5, seed 0; x64 on, the solve in the
matrix's type, f32 unless said):

* ``banded``: the 64^3 27-point Laplacian in grid order (the chooser's
  banded branch);
* ``hybrid``: ``chip_smoke.hybrid_matrix(64, 0)`` (the DIA+ELL branch);
* ``ell``: ``chip_smoke.scattered_matrix(262144, 0)`` in f64, passed as
  the ``ELLOperator`` that the reference's ``aslinearoperator`` builds for
  it once its chooser returns None (that chooser first tries the windowed
  pack, whose count array alone takes 2.1 GB at this size; the port's run
  on the card checks the chooser's verdict itself). f64, because the
  reference's f32 solve of this matrix stagnates (2000 matvecs here, 5975
  at n = 65,536, where its f64 solve takes 518): its f64 counts and
  eigenvalues are the converging algorithm's;
* ``ell_f32``: the same in f32, the stagnating run, for the record;
* ``northstar``: ``benches/northstar.py``'s two stages on the 128^3
  stencil (``chip_smoke.NS_*``): the f32 ``solve_eigs`` (x64 off, as the
  bench runs it) and the f64 ``refine_eigsh`` with
  ``ChebyshevPrecond.from_operator(A64, degree=8)``;
* ``generalized``: ``eigsh(K, M=M)`` on ``chip_smoke.fem_q1(64)``;
* ``interior``: each solve of ``chip_smoke.INTERIOR_SOLVES`` on
  ``chip_smoke.interior_matrix(INTERIOR_N[solve])``; ``--interior-n N
  ...`` runs every solve at each given size instead, ``--interior-solve``
  only the named ones (a solve that does not converge within its
  ``maxMatvecs`` prints its error);
* ``svds``: each solve of ``chip_smoke.SVDS_SOLVES`` (``primme_tpu.svds``
  with the phase's arguments, seed 0) on
  ``chip_smoke.grounded_incidence(SVD_GRID)`` in the solve's type: each
  stage's matvecs and probe counters, the singular values and their
  largest distance from the closed form; ``--svd-grid N ...`` runs at
  other grids, ``--svds-solve`` only the named solves;
* ``complex``: phases 24-27's calls (``--complex-solve`` only the named
  ones): ``dia_c64`` and ``dia_c128`` the ``eigsh`` of
  ``chip_smoke.magnetic_laplacian(MAG_GRID)`` in complex64 at tol 1e-5
  and in complex128 at tol 1e-10 (the chooser's banded branch);
  ``ell_c64`` and ``ell_c128`` that of
  ``chip_smoke.complex_scattered_matrix(262144, 0)`` in each type, passed
  as the ``ELLOperator`` its ``aslinearoperator`` builds; ``svds`` the
  ``svds`` of ``chip_smoke.magnetic_svd_matrix(MAG_GRID)`` in complex128
  with ``COMPLEX_SVDS_KWARGS``: counts, values and their distance from the
  closed form (``--mag-grid N`` runs at another grid);
* ``normal``: phases 28-30's calls (``--normal-solve`` only the named
  ones): ``primme_tpu.eigs`` with ``chip_smoke.NORMAL_KWARGS`` on
  ``chip_smoke.convection_diffusion`` for each solve of
  ``chip_smoke.NORMAL_SOLVES`` (``ell_f64``, ``ell_c64``, ``dia_f32``),
  passed as the ``ELLOperator`` its ``aslinearoperator`` builds or, for
  ``dia_f32``, as ``BandedOperator.from_scipy``. Counts, the values and
  their largest distance from the closed form (set-matched), the largest
  residual norm (``--normal-grid N`` runs every solve at another grid).
* ``dynamic``: phase 31's configuration (``bench.py``'s headline: the
  ``chip_smoke.GRID``^3 stencil with the shift-aware Jacobi, k=10, tol
  1e-5, block 2, basis 24, restart 14, locking off, ``v0`` from
  ``default_rng(0)``; x64 off, as ``bench.py`` runs) through the JAX
  package's ``solve_eigs`` with GD_Olsen_plusK (the count phase 31's
  matvec gate takes beside JDQMR_ETol's 1710) and through its own
  ``solve_eigs_dynamic``: counts, values against the closed form and the
  method trace, which depends on the host's clock and is printed, not
  held (``--dynamic-grid N`` runs at another grid).
* ``capi``: phase 36's two calls as the JAX package's ``capi_support``
  runs them (``eigsh_csr``'s ``eigsh`` and ``eigsh_run``'s
  ``solve_eigs_dynamic`` with the Jacobi preconditioner and the handle's
  calls replayed, numEvals, eps and the default method, on
  ``chip_smoke._laplacian7(CAPI_GRID, 0)``), with their counts, which the
  C surface does not return.
* ``jacobi``: phase 39's five calls (``chip_smoke.REF_JACOBI``'s names):
  phase 24's ``eigsh`` with ``jacobi=True``; the same at
  ``JACOBI_NORMAL_GRID``^3 with a fixed ``JacobiPrecond(diag,
  use_shifts=False)`` as ``OPinv``; ``eigs`` with a
  ``JacobiPrecond`` of the operator's diagonal on the Ginzburg-Landau and
  the f64 convection-diffusion operators at ``JACOBI_NORMAL_GRID``^3;
  ``testharness.run_config`` of ``chip_smoke.magnetic_config``.
* ``half``: phase 40's ``eigsh(k=HALF_K, dtype=bf16 | f16)`` of
  ``chip_smoke.laplacian27(GRID, 0)`` in the chooser's RCM order (the
  matrix phase 40 hands the solver) at tol 4 eps(half), as the JAX
  package's ``ELLOperator``.
* ``halfop``: phase 47's solves (``chip_smoke.HALFOP_SOLVES``;
  ``--halfop-solve`` only the named ones), each with the operator in its
  half type and ``tol = 4 eps(half)``, under the working type it names
  (None: a half basis over the half operator): the ``GRID``^3
  ``Stencil3DOperator`` with ``bench.py``'s headline arguments
  (``jacobi=True``, ``v0`` from ``default_rng(0)``); the ``ELLOperator``
  of phase 4's matrix in the chooser's RCM order; the ``BandedOperator``
  of phase 11's grid-order matrix; the last two with
  ``chip_smoke.SOLVE_KWARGS`` (``k`` from ``chip_smoke.HALFOP_K`` where it
  names the solve). Counts, probe verdicts, values against the
  closed form and the largest true residual (f64, the exact matrix).
* ``shardhalf``: phase 49's calls (``chip_smoke.SHARDHALF_SOLVES``;
  ``--shardhalf-solve`` only the named ones, ``svds`` for the svds call)
  under a 2-device CPU mesh (``--xla_force_host_platform_device_count=2``
  is set before JAX starts): ``eigsh(mesh=)`` of the half ``GRID``^3
  stencil as ``halfop``'s, the half ``BandedOperator`` of phase 11's
  matrix, and a ``HaloELLOperator`` of phase 4's matrix (its pack for the
  mesh, in its RCM order) built with half values, each with ``halfop``'s
  arguments (``k`` from ``chip_smoke.SHARDHALF_K``); then ``svds(mesh=)``
  of the f16 ``ELLOperator`` of ``grounded_incidence(SHARDHALF_SVD_GRID)``
  with ``chip_smoke.SHARDHALF_SVDS`` at ``tol = 4 eps(f16)``.

Prints one JSON object per phase (``num_matvecs``, the eigenvalues and
their largest distance from the closed form or scipy where there is one,
the chosen operator's class, seconds; the north star also its polish
iterations). Run from the repository root, on a machine with JAX (no card
needed):

    python3 tools/torch_smoke_refs.py [--phase banded|hybrid|ell|ell_f32|
        northstar|generalized|interior|svds] [--interior-n N ...]
        [--interior-solve refined|harmonic|jdqr ...] [--svd-grid N ...]
        [--svds-solve lm|augmented|sm ...] [--phase complex
        [--complex-solve dia_c64|dia_c128|ell_c64|ell_c128|svds ...]
        [--mag-grid N]] [--phase normal [--normal-solve ell_f64|ell_c64|
        dia_f32 ...] [--normal-grid N]] [--phase dynamic
        [--dynamic-grid N]] [--phase capi|jacobi|half]
        [--phase halfop [--halfop-solve NAME ...]]
        [--phase shardhalf [--shardhalf-solve NAME ...]]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("banded", "hybrid", "ell",
                                        "ell_f32", "northstar",
                                        "generalized", "interior", "svds",
                                        "complex", "normal", "dynamic",
                                        "capi", "jacobi", "half", "halfop",
                                        "shardhalf"),
                    action="append")
    ap.add_argument("--interior-n", type=int, nargs="+")
    ap.add_argument("--interior-solve", nargs="+")
    ap.add_argument("--svd-grid", type=int, nargs="+")
    ap.add_argument("--svds-solve", nargs="+")
    ap.add_argument("--complex-solve", nargs="+")
    ap.add_argument("--mag-grid", type=int)
    ap.add_argument("--normal-solve", nargs="+")
    ap.add_argument("--normal-grid", type=int)
    ap.add_argument("--dynamic-grid", type=int)
    ap.add_argument("--halfop-solve", nargs="+")
    ap.add_argument("--shardhalf-solve", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if "shardhalf" in (args.phase or ()):
        # phase 49's mesh: two CPU devices (before JAX starts)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   "--xla_force_host_platform_device_count"
                                   "=2").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import chip_smoke as CS
    import primme_tpu as pt
    from primme_tpu import operators as JO

    for phase in args.phase or ("banded", "hybrid", "ell", "ell_f32"):
        t0 = time.perf_counter()
        if phase in ("northstar", "generalized", "interior", "svds",
                     "complex", "normal", "dynamic", "capi", "jacobi",
                     "half", "halfop", "shardhalf"):
            for rec in globals()["_" + phase](CS, pt, np, args):
                rec.update(phase=phase, seconds=time.perf_counter() - t0)
                print(json.dumps(rec), flush=True)
            continue
        if phase == "banded":
            A = CS.laplacian27_grid(CS.GRID)[0]
        elif phase == "hybrid":
            A = CS.hybrid_matrix(CS.GRID, 0)
        else:
            A = CS.scattered_matrix(CS.GRID ** 3, 0)
            A = JO.ELLOperator.from_scipy(
                A.astype(np.float64) if phase == "ell" else A)
        if phase.startswith("ell"):
            chosen = type(A).__name__
        else:
            chosen = type(JO.rcm_banded(A)[0]).__name__
        w, _, st = pt.eigsh(A, tol=1e-5, seed=0, **CS.SOLVE_KWARGS)
        print(json.dumps({"phase": phase, "operator": chosen,
                          "num_matvecs": int(st["num_matvecs"]),
                          "num_probe_matvecs": int(st["num_probe_matvecs"]),
                          "evals": [float(x) for x in np.sort(np.asarray(w))],
                          "seconds": time.perf_counter() - t0}), flush=True)


def _northstar(CS, pt, np, args):
    import jax
    import jax.numpy as jnp
    from primme_tpu.core.inner import jdqmr_inner_solve
    from primme_tpu.core.solver import solve_eigs
    from primme_tpu.refine import refine_eigsh

    m, k = CS.NS_GRID, CS.NS_K
    n = m ** 3
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        A32 = pt.Stencil3DOperator(m, m, m, dtype=jnp.float32)
        K32 = pt.JacobiPrecond(A32.diagonal())
        p = pt.PrimmeParams(n=n, num_evals=k, eps=1e-5, max_basis_size=24,
                            max_block_size=2, min_restart_size=k + 4,
                            max_matvecs=60000, locking=0)
        p = pt.set_method(pt.Method.JDQMR_ETol, p, has_precond=True)
        v0 = jnp.asarray(np.random.default_rng(0).normal(size=(n, 2)),
                         jnp.float32)
        r = solve_eigs(A32, p, K=K32, v0=v0, dtype=jnp.float32,
                       inner_solve=jdqmr_inner_solve, segment_outer=100)
        X32 = np.asarray(r.evecs)
    t32 = time.perf_counter() - t0
    A64 = pt.Stencil3DOperator(m, m, m, dtype=jnp.float64)
    K64 = pt.ChebyshevPrecond.from_operator(A64, degree=CS.NS_DEGREE)
    t0 = time.perf_counter()
    ev, _, st = refine_eigsh(A64, X32, tol=CS.NS_TOL, OPinv=K64,
                             maxiter=200, return_stats=True)
    lam, _ = CS.stencil_eigenvalues(m, k)
    yield {"f32_num_matvecs": int(r.stats.num_matvecs),
           "f32_num_probe_matvecs": int(r.stats.num_probe_matvecs),
           "f32_s": t32, "num_refine_iters": int(st["num_refine_iters"]),
           "polish_s": time.perf_counter() - t0,
           "max_res_over_anorm": float(st["resnorms"].max()
                                       / st["anorm_estimate"]),
           "chebyshev_interval": [float(K64.a), float(K64.b)],
           "eval_err": float(np.abs(np.sort(ev) - lam).max()),
           "evals": [float(x) for x in np.sort(ev)]}


def _generalized(CS, pt, np, args):
    K, M, ev, _ = CS.fem_q1(CS.FEM_GRID)
    w, _, st = pt.eigsh(K, M=M, tol=1e-5, seed=0, **CS.SOLVE_KWARGS)
    w = np.sort(np.asarray(w))
    yield {"num_matvecs": int(st["num_matvecs"]),
           "num_probe_matvecs": int(st["num_probe_matvecs"]),
           "eval_err": float(np.abs(w - ev[:len(w)]).max()),
           "evals": [float(x) for x in w]}


def _interior(CS, pt, np, args):
    import scipy.sparse.linalg as sla

    for name, kw in CS.INTERIOR_SOLVES.items():
        if args.interior_solve and name not in args.interior_solve:
            continue
        for n in args.interior_n or [CS.INTERIOR_N[name]]:
            A = CS.interior_matrix(n)
            ref = np.sort(sla.eigsh(A.astype(np.float64),
                                    k=CS.INTERIOR_KWARGS["k"],
                                    sigma=CS.INTERIOR_SIGMA,
                                    return_eigenvectors=False))
            try:
                w, _, st = pt.eigsh(A, tol=1e-5, seed=0,
                                    **CS.INTERIOR_KWARGS, **kw)
            except pt.PrimmeError as e:
                yield {"solve": name, "n": n, "error": str(e)}
                continue
            w = np.sort(np.asarray(w))
            yield {"solve": name, "n": n,
                   "num_matvecs": int(st["num_matvecs"]),
                   "eval_err": float(np.abs(w - ref).max()),
                   "evals": [float(x) for x in w]}


def _svds(CS, pt, np, args):
    for name, (kw, dtype) in CS.SVDS_SOLVES.items():
        if args.svds_solve and name not in args.svds_solve:
            continue
        for N in args.svd_grid or [CS.SVD_GRID]:
            A, sv = CS.grounded_incidence(N, dtype=dtype)
            t0 = time.perf_counter()
            _, s, _, st = pt.svds(A, seed=0, return_stats=True,
                                  raise_for_unconverged=False, **kw)
            s = np.sort(np.asarray(s, np.float64))
            ref = sv[-len(s):] if kw["which"] == "LM" else sv[:len(s)]
            stages = {key: int(st[key]) for key in sorted(st)
                      if key.endswith(("num_matvecs", "num_probe_matvecs",
                                       "num_probe_rounds", "probe_exhausted",
                                       "num_outer_iterations"))}
            yield {"solve": name, "svd_grid": N, "dtype": dtype,
                   "shape": list(A.shape), **stages,
                   "max_resnorm": float(np.max(st["resnorms"])),
                   "eval_err": float(np.abs(s - ref).max()),
                   "svals": [float(x) for x in s],
                   "solve_s": time.perf_counter() - t0}


def _complex(CS, pt, np, args):
    from primme_tpu import operators as JO

    N = args.mag_grid or CS.MAG_GRID
    solves = ("dia_c64", "dia_c128", "ell_c64", "ell_c128", "svds")
    for name in solves:
        if args.complex_solve and name not in args.complex_solve:
            continue
        t0 = time.perf_counter()
        dtype = "complex64" if name.endswith("c64") else "complex128"
        if name == "svds":
            A, sv = CS.magnetic_svd_matrix(N)
            _, s, _, st = pt.svds(A, seed=0, return_stats=True,
                                  raise_for_unconverged=False,
                                  **CS.COMPLEX_SVDS_KWARGS)
            s = np.sort(np.asarray(s, np.float64))
            yield {"solve": name, "mag_grid": N, "shape": list(A.shape),
                   **{key: int(st[key]) for key in sorted(st)
                      if key.endswith(("num_matvecs", "num_probe_matvecs",
                                       "num_probe_rounds", "probe_exhausted",
                                       "num_outer_iterations"))},
                   "max_resnorm": float(np.max(st["resnorms"])),
                   "eval_err": float(np.abs(s - sv[:len(s)]).max()),
                   "svals": [float(x) for x in s],
                   "solve_s": time.perf_counter() - t0}
            continue
        if name.startswith("dia"):
            A, ev, _ = CS.magnetic_laplacian(N, dtype=dtype)
            chosen = type(JO.rcm_banded(A)[0]).__name__
            tol = 1e-5 if dtype == "complex64" else 1e-10
        else:
            A = JO.ELLOperator.from_scipy(
                CS.complex_scattered_matrix(CS.GRID ** 3, 0, dtype=dtype))
            chosen, ev, tol = type(A).__name__, None, 1e-5
        w, _, st = pt.eigsh(A, tol=tol, seed=0, **CS.SOLVE_KWARGS)
        w = np.sort(np.asarray(w, np.float64))
        yield {"solve": name, "operator": chosen, "tol": tol,
               "num_matvecs": int(st["num_matvecs"]),
               "num_probe_matvecs": int(st["num_probe_matvecs"]),
               "num_probe_rounds": int(st["num_probe_rounds"]),
               "eval_err": (None if ev is None
                            else float(np.abs(w - ev[:len(w)]).max())),
               "evals": [float(x) for x in w],
               "solve_s": time.perf_counter() - t0}


def _normal(CS, pt, np, args):
    from primme_tpu import operators as JO

    for name, (N, coef, dtype, tol, method, fmt) in \
            CS.NORMAL_SOLVES.items():
        if args.normal_solve and name not in args.normal_solve:
            continue
        N = args.normal_grid or N
        t0 = time.perf_counter()
        A, lam, anorm = CS.convection_diffusion(N, coef, dtype=dtype)
        op = (JO.BandedOperator.from_scipy(A) if fmt == "banded"
              else JO.ELLOperator.from_scipy(A))
        w, V, st = pt.eigs(op, tol=tol, method=method, seed=0,
                           return_stats=True, raise_for_unconverged=False,
                           **CS.NORMAL_KWARGS)
        w, V = np.asarray(w), np.asarray(V, np.complex128)
        R = A.astype(np.complex128) @ V - V * w[None, :]
        yield {"solve": name, "grid": N, "dtype": dtype, "tol": tol,
               "method": method, "operator": type(op).__name__,
               "num_matvecs": int(st["num_matvecs"]),
               "num_outer_iterations": int(st["num_outer_iterations"]),
               "num_inner_iterations": int(st["num_inner_iterations"]),
               "anorm": anorm,
               "eval_err": CS.match_values(w, lam[:len(w)]),
               "max_residual": float(np.linalg.norm(R, axis=0).max()),
               "evals": [[float(x.real), float(x.imag)] for x in w],
               "solve_s": time.perf_counter() - t0}


def _dynamic(CS, pt, np, args):
    import jax
    import jax.numpy as jnp
    from primme_tpu.core.dynamic import solve_eigs_dynamic
    from primme_tpu.core.solver import solve_eigs

    m = args.dynamic_grid or CS.GRID
    n = m ** 3
    lam, _ = CS.stencil_eigenvalues(m, 10)
    with jax.enable_x64(False):
        A = pt.Stencil3DOperator(m, m, m, dtype=jnp.float32)
        K = pt.JacobiPrecond(A.diagonal())
        p = pt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                            max_block_size=2, min_restart_size=14,
                            max_matvecs=16000, locking=0)
        v0 = jnp.asarray(np.random.default_rng(0).normal(size=(n, 2)),
                         jnp.float32)
        for name in ("GD_Olsen_plusK", "DYNAMIC"):
            t0 = time.perf_counter()
            trace = []
            if name == "DYNAMIC":
                r = solve_eigs_dynamic(
                    A, p.with_(dynamic_method_switch=True), K=K, v0=v0,
                    dtype=jnp.float32, method_trace=trace)
            else:
                pg = pt.set_method(pt.Method.GD_Olsen_plusK, p,
                                   has_precond=True)
                r = solve_eigs(A, pg, K=K, v0=v0, dtype=jnp.float32)
            w = np.sort(np.asarray(r.evals))
            yield {"solve": name, "grid": m,
                   "num_matvecs": int(r.stats.num_matvecs),
                   "num_probe_matvecs": int(r.stats.num_probe_matvecs),
                   "num_outer_iterations":
                       int(r.stats.num_outer_iterations),
                   "probe_verified": bool(r.stats.probe_verified)
                   if hasattr(r.stats, "probe_verified") else None,
                   "eval_err": float(np.abs(w - lam).max()),
                   "method_trace": trace, "solve_s": time.perf_counter() - t0}



def _capi(CS, pt, np, args):
    from primme_tpu import operators as JO
    from primme_tpu.capi_support import _params_build
    from primme_tpu.core.dynamic import solve_eigs_dynamic
    from primme_tpu.params import resolve_defaults

    A = CS._laplacian7(CS.CAPI_GRID, 0)
    lam, _ = CS.stencil_eigenvalues(CS.CAPI_GRID, CS.CAPI_K)
    t0 = time.perf_counter()
    w, _, st = pt.eigsh(A, k=CS.CAPI_K, which="SA", tol=CS.CAPI_TOL,
                        raise_for_unconverged=False, return_stats=True)
    w = np.sort(np.asarray(w))
    yield {"solve": "csr", "num_matvecs": int(st["num_matvecs"]),
           "method_trace": st.get("method_trace"),
           "eval_err": float(np.abs(w - lam).max()),
           "solve_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    Aop = JO.aslinearoperator(A)
    # the handle's calls, replayed as capi_support's eigsh_run replays them
    st = {"ops": [("set", ("numEvals", str(CS.CAPI_K))),
                  ("set", ("eps", str(CS.CAPI_TOL))),
                  ("method", "PRIMME_DEFAULT_METHOD")],
          "jacobi": True, "n": 0}
    p = resolve_defaults(_params_build(st, A.shape[0]))
    r = solve_eigs_dynamic(Aop, p, K=JO.JacobiPrecond(Aop.diagonal()),
                           has_precond=True)
    w = np.sort(np.asarray(r.evals))
    yield {"solve": "run", "operator": type(Aop).__name__,
           "dynamic": bool(p.dynamic_method_switch),
           "num_matvecs": int(r.stats.num_matvecs),
           "eval_err": float(np.abs(w - lam).max()),
           "solve_s": time.perf_counter() - t0}


def _jacobi(CS, pt, np, args):
    import tempfile

    from primme_tpu import operators as JO
    from primme_tpu import testharness

    t0 = time.perf_counter()
    L, ev, _ = CS.magnetic_laplacian(CS.MAG_GRID, dtype="complex64")
    w, _, st = pt.eigsh(L, tol=1e-5, seed=0, jacobi=True, **CS.SOLVE_KWARGS)
    w = np.sort(np.asarray(w, np.float64))
    yield {"solve": "magnetic", "num_matvecs": int(st["num_matvecs"]),
           "num_preconds": int(st["num_preconds"]),
           "eval_err": float(np.abs(w - ev[:len(w)]).max()),
           "solve_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    L, ev, _ = CS.magnetic_laplacian(CS.JACOBI_NORMAL_GRID,
                                     dtype="complex64")
    w, _, st = pt.eigsh(L, tol=1e-5, seed=0,
                        OPinv=JO.JacobiPrecond(L.diagonal(),
                                               use_shifts=False),
                        **CS.SOLVE_KWARGS)
    w = np.sort(np.asarray(w, np.float64))
    yield {"solve": "magnetic_fixed", "grid": CS.JACOBI_NORMAL_GRID,
           "num_matvecs": int(st["num_matvecs"]),
           "num_preconds": int(st["num_preconds"]),
           "eval_err": float(np.abs(w - ev[:len(w)]).max()),
           "solve_s": time.perf_counter() - t0}
    N = CS.JACOBI_NORMAL_GRID
    for name, coef, dtype, tol in (("gl", CS.GL_COEF, "complex64", 1e-5),
                                   ("cd", 1.0, "float64", 1e-8)):
        t0 = time.perf_counter()
        A, lam, anorm = CS.convection_diffusion(N, coef, dtype=dtype)
        op = JO.ELLOperator.from_scipy(A)
        w, V, st = pt.eigs(op, tol=tol, method="JDQMR", seed=0,
                           OPinv=JO.JacobiPrecond(op.diagonal()),
                           return_stats=True, raise_for_unconverged=False,
                           **CS.NORMAL_KWARGS)
        w, V = np.asarray(w), np.asarray(V, np.complex128)
        R = A.astype(np.complex128) @ V - V * w[None, :]
        yield {"solve": name, "grid": N, "dtype": dtype, "tol": tol,
               "num_matvecs": int(st["num_matvecs"]),
               "num_preconds": int(st["num_preconds"]),
               "eval_err": CS.match_values(w, lam[:len(w)]),
               "max_residual": float(np.linalg.norm(R, axis=0).max()),
               "anorm": anorm, "solve_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, ev, _ = CS.magnetic_config(tmp)
        r = testharness.run_config(cfg, base_dir=tmp)
    w = np.sort(np.asarray(r.evals, np.float64))
    yield {"solve": "harness", "ok": bool(r.ok),
           "num_matvecs": int(r.stats.num_matvecs),
           "eval_err": float(np.abs(w - ev[:len(w)]).max()),
           "solve_s": time.perf_counter() - t0}


def _half(CS, pt, np, args):
    import jax.numpy as jnp

    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from primme_tpu import operators as JO

    A, ev = CS.laplacian27(CS.GRID, 0)
    # the matrix phase 40 solves: the chooser's RCM order of A, passed as
    # the operator (the JAX package's own windowed operator of it takes
    # tens of GB on the CPU); the JAX package's ELLOperator of it
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    A = A[perm][:, perm].tocsr()
    op = JO.ELLOperator.from_scipy(A)
    kw = dict(CS.SOLVE_KWARGS, k=CS.HALF_K)
    for half in ("bfloat16", "float16"):
        t0 = time.perf_counter()
        tol = 4 * float(jnp.finfo(jnp.dtype(half)).eps)
        w, X, st = pt.eigsh(op, tol=tol, seed=0, dtype=jnp.dtype(half),
                            return_stats=True, raise_for_unconverged=False,
                            **{k: v for k, v in kw.items()
                               if k != "return_stats"})
        w, X = np.asarray(w), np.asarray(X, np.float64)
        R = A.astype(np.float64) @ X - X * w[None, :]
        yield {"solve": half, "tol": tol,
               "num_matvecs": int(st["num_matvecs"]),
               "values_dtype": str(w.dtype),
               "max_residual": float(np.linalg.norm(R, axis=0).max()),
               "eval_err": float(np.abs(np.sort(w) - ev[:len(w)]).max()),
               "solve_s": time.perf_counter() - t0}


def _halfop(CS, pt, np, args):
    import jax.numpy as jnp

    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from primme_tpu import operators as JO

    for name in args.halfop_solve or CS.HALFOP_SOLVES:
        kind, half, working = CS.HALFOP_SOLVES[name]
        t0 = time.perf_counter()
        hd = jnp.dtype(half)
        tol = 4 * float(jnp.finfo(hd).eps)
        wd = None if working is None else jnp.dtype(working)
        if kind == "stencil":
            op = JO.Stencil3DOperator(CS.GRID, CS.GRID, CS.GRID, dtype=hd)
            A = CS._laplacian7(CS.GRID, None)
            ev = CS.stencil_eigenvalues(CS.GRID, CS.GRID ** 3)[0]
            v0 = np.random.default_rng(0).normal(size=(CS.GRID ** 3, 2))
            kw = dict(k=10, which="SA", ncv=24, maxBlockSize=2,
                      minRestartSize=14, locking=False, jacobi=True,
                      maxMatvecs=16000, v0=v0.astype(np.float32),
                      method="PRIMME_JDQMR_ETol")
        else:
            if kind == "ell":
                A, ev = CS.laplacian27(CS.GRID, 0)
                perm = np.asarray(reverse_cuthill_mckee(
                    A, symmetric_mode=True))
                A = A[perm][:, perm].tocsr()
                cols, vals = JO.ELLOperator._pack(A)
                op = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd))
            else:
                A, ev = CS.laplacian27_grid(CS.GRID)
                B = JO.BandedOperator.from_scipy(A.todia())
                op = JO.BandedOperator(B.offsets, B.vals.astype(hd), B.shape)
            kw = {k: v for k, v in CS.SOLVE_KWARGS.items()
                  if k != "return_stats"}
            if name in CS.HALFOP_K:
                kw["k"] = CS.HALFOP_K[name]
        w, X, st = pt.eigsh(op, tol=tol, seed=0, dtype=wd,
                            return_stats=True, raise_for_unconverged=False,
                            **kw)
        w, X = np.asarray(w, np.float64), np.asarray(X, np.float64)
        R = A.astype(np.float64) @ X - X * w[None, :]
        yield {"solve": name, "operator": type(op).__name__, "half": half,
               "working": working, "tol": tol,
               "num_matvecs": int(st["num_matvecs"]),
               "num_probe_matvecs": int(st["num_probe_matvecs"]),
               "probe_verified": int(st.get("probe_verified", -1)),
               "probe_exhausted": int(st["probe_exhausted"]),
               "max_residual": float(np.linalg.norm(R, axis=0).max()),
               "eval_err": float(np.abs(
                   np.asarray(ev)[None, :] - w[:, None]).min(axis=1).max()),
               "evals": np.sort(w).tolist(),
               "solve_s": time.perf_counter() - t0}



def _shardhalf(CS, pt, np, args):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from primme_tpu import operators as JO
    from primme_tpu.distributed import HaloELLOperator as JaxHalo

    mesh = Mesh(np.array(jax.devices()[:2]), ("rows",))
    names = args.shardhalf_solve or [*CS.SHARDHALF_SOLVES, "svds"]
    for name in names:
        t0 = time.perf_counter()
        if name == "svds":
            hd = jnp.float16
            A, _ = CS.grounded_incidence(CS.SHARDHALF_SVD_GRID,
                                         dtype="float32")
            cols, vals = JO.ELLOperator._pack(A)
            colsT, valsT = JO.ELLOperator._pack(A.T.tocsr())
            op = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd),
                                shape=A.shape, colsT=colsT,
                                valsT=jnp.asarray(valsT).astype(hd))
            tol = 4 * float(jnp.finfo(hd).eps)
            with mesh:
                _, s, _, st = pt.svds(op, tol=tol, seed=0, mesh=mesh,
                                      return_stats=True,
                                      raise_for_unconverged=False,
                                      **CS.SHARDHALF_SVDS)
            yield {"solve": name, "tol": tol,
                   "num_matvecs": int(st["stage1_num_matvecs"]
                                      + st.get("stage2_num_matvecs", 0)),
                   "stage1_num_matvecs": int(st["stage1_num_matvecs"]),
                   "stage2_num_matvecs": int(st.get("stage2_num_matvecs",
                                                    0)),
                   "svals": np.sort(np.asarray(s, np.float64)).tolist(),
                   "solve_s": time.perf_counter() - t0}
            continue
        kind, half, working = CS.SHARDHALF_SOLVES[name]
        hd = jnp.dtype(half)
        tol = 4 * float(jnp.finfo(hd).eps)
        wd = None if working is None else jnp.dtype(working)
        perm = None
        if kind == "stencil":
            op = JO.Stencil3DOperator(CS.GRID, CS.GRID, CS.GRID, dtype=hd)
            A = CS._laplacian7(CS.GRID, None)
            ev = CS.stencil_eigenvalues(CS.GRID, CS.GRID ** 3)[0]
            v0 = np.random.default_rng(0).normal(size=(CS.GRID ** 3, 2))
            kw = dict(k=10, which="SA", ncv=24, maxBlockSize=2,
                      minRestartSize=14, locking=False, jacobi=True,
                      maxMatvecs=16000, v0=v0.astype(np.float32),
                      method="PRIMME_JDQMR_ETol")
        else:
            if kind == "dia":
                A, ev = CS.laplacian27_grid(CS.GRID)
                B = JO.BandedOperator.from_scipy(A.todia())
                op = JO.BandedOperator(B.offsets, B.vals.astype(hd), B.shape)
            else:
                A, ev = CS.laplacian27(CS.GRID, 0)
                h0, perm = JaxHalo.from_scipy(A, mesh)
                op = JaxHalo(h0.cols, h0.vals.astype(hd), h0.diag.astype(hd),
                             h0.shape, h0.halo, mesh=mesh, hrows=h0.hrows)
                A = A[perm][:, perm].tocsr()
            kw = {k: v for k, v in CS.SOLVE_KWARGS.items()
                  if k != "return_stats"}
            if name in CS.SHARDHALF_K:
                kw["k"] = CS.SHARDHALF_K[name]
        with mesh:
            w, X, st = pt.eigsh(op, tol=tol, seed=0, dtype=wd, mesh=mesh,
                                return_stats=True,
                                raise_for_unconverged=False, **kw)
        w, X = np.asarray(w, np.float64), np.asarray(X, np.float64)
        R = A.astype(np.float64) @ X - X * w[None, :]
        yield {"solve": name, "operator": type(op).__name__, "half": half,
               "working": working, "tol": tol, "rcm": perm is not None,
               "num_matvecs": int(st["num_matvecs"]),
               "num_probe_matvecs": int(st["num_probe_matvecs"]),
               "probe_exhausted": int(st["probe_exhausted"]),
               "max_residual": float(np.linalg.norm(R, axis=0).max()),
               "eval_err": float(np.abs(
                   np.asarray(ev)[None, :] - w[:, None]).min(axis=1).max()),
               "evals": np.sort(w).tolist(),
               "solve_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
