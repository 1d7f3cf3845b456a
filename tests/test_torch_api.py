"""The port's entry points take the reference's path or refuse by name:
the format chooser picks the reference's format (never a substitute),
``eigsh`` serves ``M``, ``lock`` and the refined and harmonic projections
and raises NotImplementedError for the arguments that are not ported."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.operators import aslinearoperator, rcm_banded
from test_torch_problems import laplacian27_permuted


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the solve is a long chain of small ops: beside parallel test
    # workers, extra intra-op threads only contend for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lap1d(n):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1], format="csr").astype(np.float32)


def _windowed_case():
    return laplacian27_permuted(16)[0]


def test_chooser_names_the_unported_banded_format():
    # the banded branch, once refused by name, is the reference's
    from primme_tpu.operators import rcm_banded as jrcm

    jop, jperm = jrcm(_lap1d(5000))
    top, tperm = rcm_banded(_lap1d(5000))
    assert isinstance(top, ptt.BandedOperator) and tperm is None is jperm
    assert top.offsets == jop.offsets
    assert np.array_equal(top.vals.numpy(), np.asarray(jop.vals))
    # complex values take the same branch as in the reference; a type
    # neither package serves is refused by name
    jop, _ = jrcm(_lap1d(5000).astype(np.complex64))
    top, tperm = rcm_banded(_lap1d(5000).astype(np.complex64))
    assert top.dtype == torch.complex64 and tperm is None
    assert np.array_equal(top.vals.numpy(), np.asarray(jop.vals))
    with pytest.raises(NotImplementedError, match="BandedOperator"):
        rcm_banded(_lap1d(5000).astype(np.int32))


def test_chooser_picks_windowed_like_the_reference():
    from primme_tpu.operators import rcm_banded as jrcm, WindowedELLOperator

    A = _windowed_case()
    jop, jperm = jrcm(A)
    top, tperm = rcm_banded(A)
    assert isinstance(jop, WindowedELLOperator)
    assert isinstance(top, ptt.WindowedELLOperator)
    assert np.array_equal(jperm, tperm) and jop.meta == top.meta


def test_aslinearoperator_passes_port_operators_only():
    # a port operator passes through; small dense and sparse inputs become
    # a DenseOperator (test_torch_dense_ops.py), a large sparse matrix an
    # ELLOperator and a scipy LinearOperator a FunctionOperator, as in the
    # reference
    import scipy.sparse.linalg as spla

    op, _ = rcm_banded(_windowed_case())
    assert aslinearoperator(op) is op
    assert isinstance(aslinearoperator(_lap1d(100)), ptt.DenseOperator)
    assert isinstance(aslinearoperator(np.eye(4)), ptt.DenseOperator)
    assert isinstance(aslinearoperator(_lap1d(9000)), ptt.ELLOperator)
    assert isinstance(aslinearoperator(spla.aslinearoperator(np.eye(4))),
                      ptt.FunctionOperator)


# M, lock and projection are served, since the eleventh slice the
# event stream (monitor, return_history, printLevel, monitor_inner),
# the profile (profile, time_breakdown), DYNAMIC and segment_outer, and
# since the twelfth the bf16 basis (dtype): their cases keep their places
# (and ids) and check that the call runs (a lock vector of unit norm: the
# constraints are used as given, orthonormal, as in the reference;
# ``print`` as a monitor receives the reference's keyword arguments, which
# it does not take; the bf16 solve returns f32 values and vectors, as the
# reference's). mesh is served since the thirteenth slice
# (tests/test_torch_sharding.py): its case keeps its place and id and
# checks that a value that is not a 1-D DeviceMesh is refused by name.
SERVED = ("M", "lock", "projection", "monitor", "return_history",
          "time_breakdown", "profile", "method", "printLevel",
          "segment_outer", "monitor_inner", "dtype")


@pytest.mark.parametrize("kwargs", [
    {"M": sp.identity(4096, format="csr")}, {"mesh": "x"},
    {"monitor": print}, {"return_history": True},
    {"time_breakdown": True}, {"profile": "pt_"},
    {"lock": np.ones(4096) / 64.0},
    {"dtype": torch.bfloat16}, {"method": "PRIMME_DYNAMIC"},
    {"projection": "refined"}, {"printLevel": 2}, {"segment_outer": 5},
    {"monitor_inner": True}])
def test_eigsh_refuses_unported_arguments(kwargs):
    name = next(iter(kwargs))
    call = lambda: ptt.eigsh(  # noqa: E731
        _windowed_case(), k=2, which="SA", device="cpu", maxMatvecs=50,
        raise_for_unconverged=False, **kwargs)
    if name == "monitor":
        with pytest.raises(TypeError, match="'event' is an invalid keyword"):
            call()
        return
    if name == "mesh":
        with pytest.raises(TypeError, match="mesh must be a one-dimensional"):
            call()
        return
    if name in SERVED:
        w, X = call()
        assert w.shape == (2,) and np.all(np.isfinite(w))
        if name == "lock":      # orthogonal to the unit constraint
            assert np.abs(X.sum(axis=0) / 64.0).max() <= 1e-5
        if name == "dtype":     # stored in bf16, returned in f32
            assert w.dtype == X.dtype == np.float32
        return
    with pytest.raises(NotImplementedError):
        call()


def test_eigsh_minv_keeps_the_reference_refusal():
    with pytest.raises(NotImplementedError, match="Minv is not supported"):
        ptt.eigsh(_windowed_case(), k=2, which="SA", device="cpu",
                  Minv=np.eye(4096))


def test_eigsh_without_device_needs_a_card(monkeypatch):
    # an entry point of the port runs on the card unless asked otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.eigsh(_windowed_case(), k=2, which="SA", maxMatvecs=50,
                  raise_for_unconverged=False)
    w = ptt.eigsh(_windowed_case(), k=2, which="SA", maxMatvecs=50,
                  raise_for_unconverged=False, device="cpu",
                  return_eigenvectors=False)
    assert w.shape == (2,) and np.all(np.isfinite(w))


def test_solve_eigs_without_device_needs_a_card(monkeypatch, tmp_path):
    # solve_eigs, solve_eigs_dynamic and load_operator run on the card
    # unless asked otherwise, and no operator is moved quietly
    import scipy.io as sio
    from primme_tpu_torch.core.dynamic import solve_eigs_dynamic

    A = _lap1d(300)
    op = ptt.ELLOperator.from_scipy(A)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, ptt.PrimmeParams(
        n=300, num_evals=2, eps=1e-4, max_matvecs=50))
    path = str(tmp_path / "lap.mtx")
    sio.mmwrite(path, A)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for solve in (ptt.solve_eigs, solve_eigs_dynamic):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            solve(op, p)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.io.load_operator(path)
    assert ptt.io.load_operator(path, device="cpu").device.type == "cpu"
    r = ptt.solve_eigs(op, p, device="cpu")
    assert r.evals.device.type == "cpu" and np.all(np.isfinite(
        r.evals.numpy()))
    # an operator or preconditioner that lives elsewhere raises by name
    away = ptt.ELLOperator.from_scipy(A).to("meta")
    with pytest.raises(ValueError, match=r'A\.to\(device\).*device="meta"'):
        ptt.solve_eigs(away, p, device="cpu")
    with pytest.raises(ValueError, match=r"K\.to\(device\)"):
        ptt.solve_eigs(op, p, K=ptt.JacobiPrecond(away.diagonal()),
                       device="cpu")


def test_eigsh_default_method_on_cpu_finds_smallest():
    # GD_Olsen_plusK (the default preset) through the same format
    A, ev = laplacian27_permuted(16)
    w = ptt.eigsh(A, k=2, which="SA", tol=1e-4, device="cpu",
                  return_eigenvectors=False)
    assert np.abs(np.sort(w) - ev[:2]).max() <= 1e-3
