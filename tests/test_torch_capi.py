"""The port's C/Fortran ABI (``primme_tpu_torch/native/capi.cpp`` over
``primme_tpu_torch.capi_support``) against the JAX package's, on the CPU
(``PTPU_PLATFORM=cpu``): the JAX package's own C program
(``native/test_capi.c``, compiled unchanged) and Fortran program
(``native/test_f90.f90``, where gfortran exists) linked against the port's
``libprimme_tpu_torch_capi``; the port's full-size smoke program
(``primme_tpu_torch/native/capi_smoke.c``) at a small size; and
``tests/test_capi.py``'s in-process cases through both packages side by
side, with each entry point's results compared. The native tests skip
without a compiler or CPython's headers, as ``tests/test_capi.py`` does.

Tolerances: values within 1e-8 of each other and of the closed forms
(tol 1e-10 solves of well-separated spectra); residual norms at the
solver's bar."""

import ctypes
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke as CS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the C ABI runs on the card unless PTPU_PLATFORM=cpu asks for the CPU
    monkeypatch.setenv("PTPU_PLATFORM", "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toolchain():
    if shutil.which("g++") is None or (shutil.which("gcc") is None
                                       and shutil.which("cc") is None):
        pytest.skip("native toolchain not present")
    if not os.path.exists(os.path.join(sysconfig.get_paths()["include"],
                                       "Python.h")):
        pytest.skip("CPython headers not present")


def _run(prog, *args):
    env = CS.capi_env(platform="cpu")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([prog, *args], env=env, capture_output=True,
                          text=True, timeout=600)


def test_reference_c_program_against_port_library(tmp_path):
    """``native/test_capi.c``, compiled unchanged against the port's
    library: every entry mode (CSR, matvec callback, F77, svds, both
    parameter handles) against the analytic Laplacian spectrum."""
    _toolchain()
    prog = CS.build_c_program(os.path.join(REPO, "native", "test_capi.c"),
                              str(tmp_path / "test_capi"))
    r = _run(prog)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CAPI OK" in r.stdout


@pytest.mark.skipif(shutil.which("gfortran") is None,
                    reason="gfortran not present")
def test_reference_f90_program_against_port_library(tmp_path):
    """``native/test_f90.f90`` (the underscore ABI with CHARACTER labels)
    against the port's library."""
    _toolchain()
    from primme_tpu_torch import native

    lib = native.capi_library()
    d, f = os.path.split(lib)
    prog = str(tmp_path / "test_f90")
    r = subprocess.run(["gfortran", "-O2", "-o", prog,
                        os.path.join(REPO, "native", "test_f90.f90"),
                        f"-L{d}", f"-l:{f}", f"-Wl,-rpath,{d}"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    r = _run(prog)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "F90 OK" in r.stdout


def test_capi_smoke_program_on_the_cpu(tmp_path):
    """``capi_smoke.c`` (``chip_smoke.py`` phase 37's program) at a small
    size: every call's written results against the closed forms."""
    _toolchain()
    prog = CS.build_c_program(
        os.path.join(REPO, "primme_tpu_torch", "native", "capi_smoke.c"),
        str(tmp_path / "capi_smoke"))
    A = CS._laplacian7(12, 0)       # n = 1728: dense in both packages
    Amv = CS._laplacian7(6, 1)
    B, sv = CS.grounded_incidence(5)
    for name, M in (("lap.bin", A), ("mv.bin", Amv), ("inc.bin", B)):
        CS.write_csr_bin(str(tmp_path / name), M)
    k, ks, tol = 4, 3, 1e-10
    r = _run(prog, str(tmp_path), str(k), repr(tol), str(ks))
    assert r.returncode == 0 and "capi_smoke OK" in r.stdout, \
        r.stdout + r.stderr
    for name, M, grid in (("csr", A, 12), ("f77", A, 12), ("matvec", Amv, 6),
                          ("run", A, 12)):
        raw = np.fromfile(str(tmp_path / f"out_{name}.bin"))
        lam, anorm = CS.stencil_eigenvalues(grid, k)
        CS.check_eig_output(name, M, raw[:k], raw[k:2 * k],
                            raw[2 * k:].reshape(M.shape[0], k, order="F"),
                            lam, anorm, tol)
    m, n = B.shape
    for name in ("svds", "svds_run"):
        raw = np.fromfile(str(tmp_path / f"out_{name}.bin"))
        off = 2 * ks if name == "svds_run" else ks
        s = raw[:ks]
        U = raw[off:off + m * ks].reshape(m, ks, order="F")
        V = raw[off + m * ks:].reshape(n, ks, order="F")
        assert np.abs(np.sort(s) - sv[-ks:]).max() <= 1e-8 * sv[-1]
        assert np.linalg.norm(B @ V - U * s[None, :], axis=0).max() \
            <= 10 * tol * sv[-1]


def _modules():
    from primme_tpu import capi_support as jcs
    from primme_tpu_torch import capi_support as tcs
    return {"jax": jcs, "port": tcs}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_params_handle_surface_python_level(pkg):
    """``tests/test_capi.py``'s handle case through each package: unset
    ``n`` reads back 0, never the replay placeholder; enum-valued svds
    members read back as reference constant codes; invalid values fail at
    set time."""
    cs = _modules()[pkg]
    params = (__import__("primme_tpu.params", fromlist=["Method"])
              if pkg == "jax" else
              __import__("primme_tpu_torch.params", fromlist=["Method"]))
    h = cs.params_create()
    out = np.zeros(1)
    assert cs.params_get(h, "n", out.ctypes.data) == 0 and out[0] == 0.0
    assert cs.params_set(h, "numEvals", "3") == 0
    assert cs.params_get(h, "n", out.ctypes.data) == 0 and out[0] == 0.0
    assert cs.params_set(h, "n", "500") == 0
    assert cs.params_get(h, "n", out.ctypes.data) == 0 and out[0] == 500.0
    assert cs.params_set(h, "noSuchMember", "1") == -1
    assert cs.params_set_method(h, "PRIMME_JDQMR") == 0
    assert cs.params_get(h, "target", out.ctypes.data) == 0
    assert out[0] == params.constant_info("primme_smallest")
    assert cs.params_free(h) == 0 and cs.params_free(h) == -1
    hs = cs.svds_params_create()
    assert cs.svds_params_set(hs, "target", "-1") == -1
    assert cs.svds_params_set(hs, "target", "3") == -1
    assert cs.svds_params_set(hs, "method", "normaleqations") == -1
    assert cs.svds_params_set_method(hs, "primme_svds_bogus", "", "") == -1
    assert cs.svds_params_set_method(hs, "primme_svds_hybrid", "",
                                     "PRIMME_JDQMR") == 0
    assert cs.svds_params_get(hs, "methodStage2", out.ctypes.data) == 0
    assert out[0] == float(list(params.Method.__members__).index("JDQMR"))
    assert cs.svds_params_get(hs, "method", out.ctypes.data) == 0
    assert out[0] == 1.0                      # primme_svds_hybrid
    assert cs.svds_params_free(hs) == 0


def _csr_args(A):
    ip = A.indptr.astype(np.int64)
    ix = A.indices.astype(np.int64)
    dv = A.data.astype(np.float64)
    return (ip, ix, dv), (ip.ctypes.data, ix.ctypes.data, dv.ctypes.data)


def test_f77_target_codes_follow_primme_target_order():
    """``tests/test_capi.py``'s target-code case through both packages: the
    integer codes follow the ``primme_target`` order, and closest_abs
    (4) and largest_abs (5) about sigma = 2 give each package the same
    values."""
    from primme_tpu_torch.params import constant_info

    mods = _modules()
    for name in ("smallest", "largest", "closest_geq", "closest_leq",
                 "closest_abs", "largest_abs"):
        code = constant_info("primme_" + name)
        assert mods["port"]._which_str(code) == mods["jax"]._which_str(code)
    n = 60
    d = np.linspace(1.0, 6.0, n)
    A = sp.diags(d).tocsr().astype(np.float64)
    keep, (ip, ix, dv) = _csr_args(A)
    for code, exp in ((4, d[np.argsort(np.abs(d - 2.0))][:2]),
                      (5, d[np.argsort(-np.abs(d - 2.0))][:2])):
        for cs in mods.values():
            ev, X, rn = np.zeros(2), np.zeros(2 * n), np.zeros(2)
            rc = cs.eigsh_csr(n, A.nnz, ip, ix, dv, 2, code, 1e-9, "", 2.0,
                              ev.ctypes.data, X.ctypes.data, rn.ctypes.data)
            assert rc == 0, cs.last_error()
            assert np.abs(np.sort(ev) - np.sort(exp)).max() < 1e-7


def test_entry_points_match_reference():
    """``eigsh_csr``, ``eigsh_matvec`` (a ctypes callback as the C
    function), ``eigsh_run`` (JDQMR with the Jacobi handle label) and
    ``svds_csr``/``svds_run`` in-process through both packages on the
    same buffers: the written values agree with each other and the closed
    forms, the vectors are column-major unit vectors with the written
    residual norms."""
    mods = _modules()
    A = CS._laplacian7(10, 3)
    n, k = A.shape[0], 3
    lam, anorm = CS.stencil_eigenvalues(10, k)
    keep, (ip, ix, dv) = _csr_args(A)

    @ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                      ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                      ctypes.c_void_p)
    def matvec(x, y, bs, ctx):
        X = np.ctypeslib.as_array(x, shape=(bs * n,)).reshape(n, bs,
                                                              order="F")
        Y = np.ctypeslib.as_array(y, shape=(bs * n,))
        Y[:] = (A @ X).reshape(-1, order="F")

    fn = ctypes.cast(matvec, ctypes.c_void_p).value
    got = {}
    for pkg, cs in mods.items():
        for call in ("csr", "matvec", "run"):
            ev, X, rn = np.zeros(k), np.zeros(n * k), np.zeros(k)
            if call == "csr":
                rc = cs.eigsh_csr(n, A.nnz, ip, ix, dv, k, "SA", 1e-10, "",
                                  0.0, ev.ctypes.data, X.ctypes.data,
                                  rn.ctypes.data)
            elif call == "matvec":
                rc = cs.eigsh_matvec(n, fn, 0, k, "SA", 1e-10, "", 0.0, 0,
                                     ev.ctypes.data, X.ctypes.data,
                                     rn.ctypes.data)
            else:
                h = cs.params_create()
                assert cs.params_set(h, "numEvals", str(k)) == 0
                assert cs.params_set(h, "eps", "1e-10") == 0
                assert cs.params_set(h, "jacobi", "1") == 0
                assert cs.params_set_method(h, "PRIMME_JDQMR") == 0
                rc = cs.eigsh_run(h, n, A.nnz, ip, ix, dv, ev.ctypes.data,
                                  X.ctypes.data, rn.ctypes.data)
                cs.params_free(h)
            assert rc == 0, (pkg, call, cs.last_error())
            V = X.reshape(n, k, order="F")
            R = A @ V - V * ev[None, :]
            assert np.abs(np.linalg.norm(V, axis=0) - 1).max() <= 1e-8
            assert np.linalg.norm(R, axis=0).max() <= 10 * 1e-10 * anorm
            assert rn.max() <= 10 * 1e-10 * anorm
            assert np.abs(np.sort(ev) - lam).max() <= 1e-8
            got[pkg, call] = np.sort(ev)
    for call in ("csr", "matvec", "run"):
        assert np.abs(got["port", call] - got["jax", call]).max() <= 1e-8
    B, sv = CS.grounded_incidence(4)
    m, nb = B.shape
    keepb, (bp, bx, bv) = _csr_args(B)
    for pkg, cs in mods.items():
        s, u, v, r = (np.zeros(2), np.zeros(m * 2), np.zeros(nb * 2),
                      np.zeros(2))
        assert cs.svds_csr(m, nb, B.nnz, bp, bx, bv, 2, "LM", 1e-10,
                           s.ctypes.data, u.ctypes.data,
                           v.ctypes.data) == 0, cs.last_error()
        assert np.abs(np.sort(s) - sv[-2:]).max() <= 1e-8 * sv[-1]
        h = cs.svds_params_create()
        assert cs.svds_params_set(h, "numSvals", "2") == 0
        assert cs.svds_params_set(h, "eps", "1e-10") == 0
        assert cs.svds_params_set(h, "target", "primme_svds_smallest") == 0
        assert cs.svds_run(h, m, nb, B.nnz, bp, bx, bv, s.ctypes.data,
                           u.ctypes.data, v.ctypes.data,
                           r.ctypes.data) == 0, cs.last_error()
        U, V = u.reshape(m, 2, order="F"), v.reshape(nb, 2, order="F")
        assert np.abs(np.sort(s) - sv[:2]).max() <= 1e-8 * sv[-1]
        assert np.linalg.norm(B @ V - U * s[None, :], axis=0).max() \
            <= 10 * 1e-10 * sv[-1]
        cs.svds_params_free(h)


def test_platform_variable(monkeypatch):
    """``PTPU_PLATFORM``: ``cpu`` runs on the CPU, another value is refused
    naming the variable, unset means the card (without one, the call
    reports that instead of running elsewhere)."""
    from primme_tpu_torch import capi_support as cs

    A = sp.diags(np.linspace(1, 2, 20)).tocsr()
    keep, (ip, ix, dv) = _csr_args(A)
    ev, X, rn = np.zeros(1), np.zeros(20), np.zeros(1)
    args = (20, A.nnz, ip, ix, dv, 1, "SA", 1e-8, "", 0.0, ev.ctypes.data,
            X.ctypes.data, rn.ctypes.data)
    assert cs.eigsh_csr(*args) == 0 and abs(ev[0] - 1.0) <= 1e-7
    monkeypatch.setenv("PTPU_PLATFORM", "tpu")
    assert cs.eigsh_csr(*args) == -1
    assert "PTPU_PLATFORM" in cs.last_error()
    if not torch.cuda.is_available():
        monkeypatch.delenv("PTPU_PLATFORM")
        assert cs.eigsh_csr(*args) == -1
        assert "runs on the card" in cs.last_error()
