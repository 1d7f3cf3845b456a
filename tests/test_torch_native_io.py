"""The port's MatrixMarket I/O (``primme_tpu_torch.io``) and native parse
and ELL pack (``primme_tpu_torch.native``, its own copy of
``mmio_ell.cpp`` built at first use) against the JAX package's ``io`` and
``native`` and against scipy, on ``.mtx`` files written to ``tmp_path``
from seeded matrices: real and complex, symmetric, Hermitian and general,
square and rectangular. ``tests/test_native.py``'s parse and ELL-pack cases
without its fixed files.

Tolerance: none for the parse and the pack (the same C++ source and the
same file give the same arrays); the ELL product against the port's
``ELLOperator`` to 1e-12 of the largest output."""

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from primme_tpu import io as jio
from primme_tpu import native as jnative
from primme_tpu_torch import io as tio
from primme_tpu_torch import native as tnative
import primme_tpu_torch as ptt


def _matrix(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "rect":
        return sp.random(90, 70, density=0.08, random_state=seed,
                         format="csr")
    n = 120
    A = sp.random(n, n, density=0.05, random_state=seed, format="csr")
    if kind.startswith("complex"):
        A = A + 1j * sp.random(n, n, density=0.05, random_state=seed + 1,
                               format="csr")
    if kind == "symmetric":
        A = A + A.T + sp.diags(rng.uniform(1, 2, n))
    elif kind == "hermitian":
        A = A + A.conj().T + sp.diags(rng.uniform(1, 2, n))
    return A.tocsr()


KINDS = ["symmetric", "general", "rect", "complex", "hermitian"]


def _file(tmp_path, kind):
    A = _matrix("complex" if kind == "hermitian" else kind)
    if kind == "hermitian":
        A = (A + A.conj().T + sp.identity(A.shape[0])).tocsr()
    path = str(tmp_path / f"{kind}.mtx")
    sio.mmwrite(path, A)
    return path, A


@pytest.mark.skipif(not tnative.available(), reason="no C++ compiler")
@pytest.mark.parametrize("kind", KINDS)
def test_parse_matches_reference_and_scipy(tmp_path, kind):
    path, A = _file(tmp_path, kind)
    res = tnative.read_mtx_coo(path)
    assert res is not None
    m, n, rows, cols, vals = res
    assert (m, n) == A.shape
    A_native = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    d = abs(A_native - sp.csr_matrix(tio.read_mtx(path)))
    assert (d.max() if d.nnz else 0.0) == 0.0
    d = abs(A_native - A)
    assert (d.max() if d.nnz else 0.0) <= 1e-15 * abs(A).max()
    ref = jnative.read_mtx_coo(path)
    assert ref is not None
    for a, b in zip(res, ref):
        assert np.array_equal(a, b)


@pytest.mark.skipif(not tnative.available(), reason="no C++ compiler")
@pytest.mark.parametrize("kind", KINDS)
def test_ell_pack_matches_reference_and_product(tmp_path, kind):
    path, A = _file(tmp_path, kind)
    m, n, rows, cols, vals = tnative.read_mtx_coo(path)
    ec, ev = tnative.coo_to_ell(m, rows, cols, vals)
    jc, jv = jnative.coo_to_ell(m, rows, cols, vals)
    assert np.array_equal(ec, jc) and np.array_equal(ev, jv)
    assert ec.dtype == np.int32 and ec.shape == ev.shape
    x = np.random.default_rng(0).normal(size=(n, 2)) + 0j
    y_ell = (ev[:, :, None] * x[ec]).sum(axis=1)    # the padded ELL product
    op = tio.load_operator(path, device="cpu")
    assert isinstance(op, ptt.ELLOperator) and op.shape == (m, n)
    y = op.matmat(torch.as_tensor(x)).numpy()
    assert np.abs(y - y_ell).max() <= 1e-12 * np.abs(y_ell).max()


@pytest.mark.parametrize("kind", KINDS)
def test_read_mtx_matches_reference(tmp_path, kind):
    path, _ = _file(tmp_path, kind)
    a, b = tio.read_mtx(path), jio.read_mtx(path)
    assert type(a) is type(b) and a.dtype == b.dtype
    assert abs(a - b).max() == 0.0
    assert np.array_equal(tio.read_mtx(path, dense=True),
                          jio.read_mtx(path, dense=True))


def test_native_library_builds_into_the_package(tmp_path):
    """The libraries build into ``primme_tpu_torch/_build`` under a name
    with the source's hash (the reference's ``native/`` is not written);
    an unparsable file reads as None."""
    import os

    if not tnative.available():
        pytest.skip("no C++ compiler")
    lib = tnative.native_library()
    assert os.path.dirname(lib).endswith(os.path.join("primme_tpu_torch",
                                                      "_build"))
    assert os.path.basename(lib).startswith("libprimme_tpu_torch_native-")
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix market file\n")
    assert tnative.read_mtx_coo(str(bad)) is None
