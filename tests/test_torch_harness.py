"""The config-file harness and driver in the port
(``primme_tpu_torch.testharness`` and ``python -m
primme_tpu_torch.driver``) against the JAX package's, on the CPU.

``tests/test_harness.py``'s four cases run against the port (the driver
with ``--device cpu``): the golden-solution round trips (bit for bit), the
driver's save-then-check loop on an eigs config and its svds config. The
golden files each package writes are read back by the other's readers bit
for bit; ``parse_config`` and ``build_params`` give the reference's fields;
a config with no ``method`` line (``DEFAULT_METHOD``, so DYNAMIC) and the
Jacobi ``PrecChoice`` runs through both packages' ``run_config``: both
checks pass and the values agree within 1e-9 of each other (the config's
eps is 1e-10), matvecs within ``MV_SLACK`` = 2x. The reference's own golden
configs run only where its test directory exists, behind the skip of
``tests/test_golden.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import primme_tpu.testharness as JH
import primme_tpu_torch.testharness as TH
from primme_tpu_torch.testharness import (read_sol_evecs, write_sol_evecs,
                                          read_sol_svecs, write_sol_svecs)
from test_golden import TESTS   # the reference's config directory

MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sol_evecs_roundtrip(tmp_path, dtype):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(37, 5)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.normal(size=X.shape)
    p = str(tmp_path / "sol")
    write_sol_evecs(p, X)
    Y = read_sol_evecs(p)
    assert Y.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(X, Y)
    # the JAX package's reader and writer agree with the port's
    np.testing.assert_array_equal(JH.read_sol_evecs(p), X)
    JH.write_sol_evecs(p + "_j", X)
    assert open(p, "rb").read() == open(p + "_j", "rb").read()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sol_svecs_roundtrip(tmp_path, dtype):
    rng = np.random.default_rng(1)
    U = rng.normal(size=(23, 4)).astype(dtype)
    V = rng.normal(size=(17, 4)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        U = U + 1j * rng.normal(size=U.shape)
        V = V + 1j * rng.normal(size=V.shape)
    p = str(tmp_path / "solsvds")
    write_sol_svecs(p, U, V)
    U2, V2 = read_sol_svecs(p)
    np.testing.assert_array_equal(U, U2)
    np.testing.assert_array_equal(V, V2)
    U3, V3 = JH.read_sol_svecs(p)
    np.testing.assert_array_equal(U, U3)
    np.testing.assert_array_equal(V, V3)
    JH.write_sol_svecs(p + "_j", U, V)
    assert open(p, "rb").read() == open(p + "_j", "rb").read()


def _write_config(tmp_path, mtx_name, save_name=None, check_name=None,
                  extra=("primme.target = primme_largest",
                         "method               = PRIMME_GD_Olsen_plusK"),
                  prec="noprecond", eps="1.000000e-09"):
    lines = [
        f"driver.matrixFile    = {mtx_name}",
        f"driver.PrecChoice    = {prec}",
        "primme.numEvals = 3",
        f"primme.eps = {eps}",
        "primme.maxBasisSize = 20",
        "primme.maxMatvecs = 4000",
        *extra,
    ]
    if save_name:
        lines.insert(1, f"driver.saveXFile     = {save_name}")
    if check_name:
        lines.insert(1, f"driver.checkXFile    = {check_name}")
    cfg = tmp_path / "test_cfg"
    cfg.write_text("\n".join(lines) + "\n")
    return str(cfg)


def _write_matrix(tmp_path):
    import scipy.io as sio
    import scipy.sparse as sp
    rng = np.random.default_rng(2)
    n = 60
    d = np.sort(rng.uniform(1.0, 10.0, size=n))
    # tridiagonal symmetric: well-separated extremes
    A = sp.diags([np.full(n - 1, 0.3), d, np.full(n - 1, 0.3)],
                 [-1, 0, 1]).tocsr()
    sio.mmwrite(str(tmp_path / "mat.mtx"), A)
    return A


def test_driver_cli_save_and_check(tmp_path, capsys):
    """The CLI solves a config, saves the solution in the golden binary
    format, and a second run checks against that file (the reference's
    saveXFile -> checkXFile loop)."""
    from primme_tpu_torch import driver

    A = _write_matrix(tmp_path)
    save = str(tmp_path / "sol_new")
    cfg = _write_config(tmp_path, "mat.mtx", save_name=save)
    rc = driver.main([cfg, "--base-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "solution check: OK" in out
    assert "Eval[3]" in out

    X = read_sol_evecs(save)
    assert X.shape == (60, 3)
    evals_true = np.linalg.eigvalsh(A.toarray())[-3:]
    rq = np.diag(X.T @ (A @ X))
    np.testing.assert_allclose(np.sort(rq), evals_true, rtol=1e-8)

    shutil.copy(save, save + "_double")
    cfg2 = _write_config(tmp_path, "mat.mtx", check_name="sol_new")
    rc2 = driver.main([cfg2, "--base-dir", str(tmp_path), "--device", "cpu"])
    assert rc2 == 0


def test_driver_cli_svds(tmp_path, capsys):
    from primme_tpu_torch import driver
    import scipy.io as sio
    import scipy.sparse as sp
    B = sp.random(40, 25, density=0.3, random_state=7, format="csr")
    sio.mmwrite(str(tmp_path / "rectsmall.mtx"), B)
    save = str(tmp_path / "sol_svds_new")
    cfg = tmp_path / "test_svds_cfg"
    cfg.write_text("\n".join([
        "driver.matrixFile    = rectsmall.mtx",
        f"driver.saveXFile     = {save}",
        "driver.PrecChoice    = noprecond",
        "primme_svds.numSvals = 2",
        "primme_svds.eps = 1e-8",
        "primme_svds.target = primme_svds_largest",
        "method = primme_svds_hybrid",
    ]) + "\n")
    rc = driver.main([str(cfg), "--base-dir", str(tmp_path),
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Sval[2]" in out
    U, V = read_sol_svecs(save)
    assert U.shape == (40, 2) and V.shape == (25, 2)
    s_true = np.linalg.svd(B.toarray(), compute_uv=False)[:2]
    s_rq = np.linalg.norm(np.asarray(B @ V), axis=0)
    np.testing.assert_allclose(np.sort(s_rq), np.sort(s_true), rtol=1e-7)


def test_driver_without_device_needs_a_card(tmp_path, capsys):
    # the CLI solves on the card by default and never falls back to the
    # CPU: without a card it fails with a message
    from primme_tpu_torch import driver

    _write_matrix(tmp_path)
    cfg = _write_config(tmp_path, "mat.mtx")
    rc = driver.main([cfg, "--base-dir", str(tmp_path)])
    err = capsys.readouterr().err
    if torch.cuda.is_available():
        assert rc == 0
    else:
        assert rc == 1 and "device" in err


def test_parse_and_build_params_match_reference(tmp_path):
    cfg = tmp_path / "test_full"
    cfg.write_text("\n".join([
        "// a comment line",
        "driver.matrixFile    = m.mtx   // trailing comment",
        "driver.checkXFile    = sol_001",
        "driver.PrecChoice    = jacobi",
        "driver.shift         = 0.5",
        "primme.numEvals = 4",
        "primme.eps = 1e-11",
        "primme.maxBasisSize = 15",
        "primme.minRestartSize = 6",
        "primme.maxBlockSize = 2",
        "primme.maxMatvecs = 900",
        "primme.restarting.maxPrevRetain = 2",
        "primme.target = primme_closest_abs",
        "primme.targetShifts = 1.5 2.5",
        "primme.projection.projection = primme_proj_refined",
        "primme.locking = 1",
        "primme.correction.maxInnerIterations = 7",
        "method = PRIMME_JDQMR",
    ]) + "\n")
    t, j = TH.parse_config(str(cfg)), JH.parse_config(str(cfg))
    for f in ("matrix_file", "check_x_file", "save_x_file", "prec_choice",
              "shift", "fields", "is_svds", "svds_method"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.method.name == j.method.name
    pt, pj = TH.build_params(t, 100), JH.build_params(j, 100)
    for f in ("num_evals", "eps", "max_basis_size", "min_restart_size",
              "max_block_size", "max_matvecs", "max_prev_retain",
              "target_shifts", "locking", "max_inner_iterations"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.target.name == pj.target.name
    assert pt.projection.name == pj.projection.name


def test_run_config_default_method(tmp_path):
    """No ``method`` line: DEFAULT_METHOD resolves to DYNAMIC, which both
    harnesses run through ``solve_eigs_dynamic``, with the reference
    driver's fixed Jacobi preconditioner."""
    A = _write_matrix(tmp_path)
    cfg = _write_config(tmp_path, "mat.mtx", prec="jacobi", eps="1e-10",
                        extra=("primme.target = primme_smallest",))
    rt = TH.run_config(cfg, base_dir=str(tmp_path), device="cpu")
    rj = JH.run_config(cfg, base_dir=str(tmp_path))
    assert rt.ok, repr(rt)
    assert rj.ok, repr(rj)
    truth = np.linalg.eigvalsh(A.toarray())[:3]
    np.testing.assert_allclose(np.sort(rt.evals), truth, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.sort(rt.evals), np.sort(rj.evals),
                               rtol=0, atol=1e-9)
    mt, mj = rt.stats.num_matvecs, int(rj.stats.num_matvecs)
    assert mt <= MV_SLACK * mj and mj <= MV_SLACK * mt


# --- the reference's golden configs (only where its test tree exists) ----

EIGS_REAL = ["test_001", "test_002", "test_003", "test_004", "test_005",
             "test_006", "test_007"]
EIGS_COMPLEX = ["test_101", "test_102", "test_103", "test_104", "test_105",
                "test_106"]
SVDS_ALL = ["test_201", "test_202", "test_203", "test_204", "test_205",
            "test_206", "test_207"]
_golden = pytest.mark.skipif(not os.path.isdir(TESTS),
                             reason="reference test configs not present")


@_golden
@pytest.mark.parametrize("name", EIGS_REAL)
@pytest.mark.parametrize("dtype", ["double", "doublecomplex"])
def test_eigs_golden(name, dtype):
    r = TH.run_config(os.path.join(TESTS, name), device="cpu",
                      dtype=(complex if dtype == "doublecomplex" else None))
    assert r.ok, repr(r)


@_golden
@pytest.mark.parametrize("name", EIGS_COMPLEX)
def test_eigs_golden_complex(name):
    r = TH.run_config(os.path.join(TESTS, name), device="cpu")
    assert r.ok, repr(r)


@_golden
@pytest.mark.parametrize("name", SVDS_ALL)
def test_svds_golden(name):
    r = TH.run_svds_config(os.path.join(TESTS, name), device="cpu")
    assert r.ok, repr(r)
