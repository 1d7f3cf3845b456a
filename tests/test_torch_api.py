"""The port's entry points refuse what this slice does not carry, in the
places the reference would have taken another path: the format chooser
never substitutes a format, and ``eigsh`` raises NotImplementedError for
the arguments that are not ported."""

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
    with pytest.raises(NotImplementedError, match="BandedOperator"):
        rcm_banded(_lap1d(5000))


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
    # a DenseOperator (test_torch_dense_ops.py); the unported branches
    # raise, naming themselves
    import scipy.sparse.linalg as spla

    op, _ = rcm_banded(_windowed_case())
    assert aslinearoperator(op) is op
    assert isinstance(aslinearoperator(_lap1d(100)), ptt.DenseOperator)
    assert isinstance(aslinearoperator(np.eye(4)), ptt.DenseOperator)
    with pytest.raises(NotImplementedError, match="ELLOperator"):
        aslinearoperator(_lap1d(9000))
    with pytest.raises(NotImplementedError, match="FunctionOperator"):
        aslinearoperator(spla.aslinearoperator(np.eye(4)))


@pytest.mark.parametrize("kwargs", [
    {"M": "x"}, {"mesh": "x"}, {"monitor": print}, {"return_history": True},
    {"time_breakdown": True}, {"profile": "pt_"}, {"lock": np.ones(4096)},
    {"dtype": torch.bfloat16}, {"method": "PRIMME_DYNAMIC"},
    {"projection": "refined"}])
def test_eigsh_refuses_unported_arguments(kwargs):
    with pytest.raises(NotImplementedError):
        ptt.eigsh(_windowed_case(), k=2, which="SA", device="cpu",
                  maxMatvecs=50, raise_for_unconverged=False, **kwargs)


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


def test_eigsh_default_method_on_cpu_finds_smallest():
    # GD_Olsen_plusK (the default preset) through the same format
    A, ev = laplacian27_permuted(16)
    w = ptt.eigsh(A, k=2, which="SA", tol=1e-4, device="cpu",
                  return_eigenvectors=False)
    assert np.abs(np.sort(w) - ev[:2]).max() <= 1e-3
