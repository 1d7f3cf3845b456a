"""The port's 7-point 3-D Laplacian (primme_tpu_torch Stencil3DOperator and
ops/stencil3d.py) against the JAX package's Stencil3DOperator on the same
numpy blocks, and the port's rule for an operator that holds no array.

Tolerance: 4 eps(dtype) max|y|. Both sides compute 6 g, subtract the
neighbours axis by axis in the same order and scale, one IEEE rounding per
operation, so the results are expected to agree bit for bit; the tests
assert the tolerance and, separately, that they do agree bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import stencil_from_jax
from primme_tpu_torch.ops import stencil3d as ST

GRIDS = [(5, 6, 7), (1, 4, 3), (16, 16, 16)]
DTYPES = [np.float32, np.float64]


def _tdt(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _pair(grid, dtype, scale):
    jop = JO.Stencil3DOperator(*grid, dtype=dtype, scale=scale)
    top = ptt.Stencil3DOperator(*grid, dtype=_tdt(dtype), scale=scale,
                                device="cpu")
    return jop, top


def _block(grid, k, dtype, seed=0):
    n = int(np.prod(grid))
    return np.random.default_rng(seed + k).normal(size=(n, k)).astype(dtype)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 11])
@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_matches_reference(grid, k, dtype, scale):
    jop, top = _pair(grid, dtype, scale)
    assert top.shape == jop.shape and top.dtype == _tdt(dtype)
    X = _block(grid, k, dtype)
    yj = np.asarray(jop.matmat(jnp.asarray(X)))
    for fn in ("matmat", "rmatmat"):
        y = getattr(top, fn)(torch.as_tensor(X)).numpy()
        assert y.dtype == yj.dtype == dtype and y.shape == yj.shape
        tol = 4 * np.finfo(dtype).eps * np.abs(yj).max()
        assert np.abs(y - yj).max() <= tol, fn
    d = top.diagonal()
    assert d.dtype == _tdt(dtype)
    assert np.array_equal(d.numpy(), np.asarray(jop.diagonal()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil_is_bitwise_the_reference(dtype):
    # also at a scale that is not a power of two, which rounds to dtype
    for grid in GRIDS:
        for scale in (1.0, 0.5, 0.1):
            jop, top = _pair(grid, dtype, scale)
            X = _block(grid, 2, dtype, seed=5)
            y = top.matmat(torch.as_tensor(X)).numpy()
            assert np.array_equal(y, np.asarray(jop.matmat(jnp.asarray(X))))


def test_stencil_casts_the_block_to_its_dtype():
    # the reference computes in the operator's dtype and returns it
    grid = (5, 6, 7)
    jop, top = _pair(grid, np.float32, 1.0)
    X = _block(grid, 2, np.float64)
    y = top.matmat(torch.as_tensor(X))
    assert y.dtype == torch.float32
    assert np.array_equal(y.numpy(), np.asarray(jop.matmat(jnp.asarray(X))))


def test_stencil_column_slice_and_nan():
    # a column slice of a wider block (rows 5 apart) gives the product of
    # its copy; a NaN reaches exactly the point and its six neighbours
    grid = (5, 6, 7)
    _, top = _pair(grid, np.float32, 1.0)
    W = torch.as_tensor(_block(grid, 5, np.float32))
    W[(2 * 6 + 3) * 7 + 4, 1] = float("nan")
    y = top.matmat(W[:, 1:3])
    assert torch.equal(torch.nan_to_num(y), torch.nan_to_num(
        top.matmat(W[:, 1:3].contiguous())))
    hit = torch.isnan(y[:, 0]).reshape(grid).nonzero().tolist()
    want = [[2, 3, 4], [1, 3, 4], [3, 3, 4], [2, 2, 4], [2, 4, 4],
            [2, 3, 3], [2, 3, 5]]
    assert sorted(hit) == sorted(want) and not torch.isnan(y[:, 1]).any()


def test_stencil_cpu_makes_no_launch():
    _, top = _pair((16, 16, 16), np.float32, 1.0)
    before, by_entry = ST.LAUNCHES, dict(ST.KERNEL_LAUNCHES)
    top.matmat(torch.ones((4096, 2)))
    ST.matmat(torch.ones((4096, 1), dtype=torch.float64), 16, 16, 16)
    assert ST.LAUNCHES == before and ST.KERNEL_LAUNCHES == by_entry


def test_stencil_wrapper_checks_shape():
    with pytest.raises(ValueError, match="shape"):
        ST.matmat(torch.ones((10, 2)), 2, 2, 2)
    with pytest.raises(ValueError, match="shape"):
        ST.matmat_reference(torch.ones(8), 2, 2, 2)


def test_stencil_device_rule(monkeypatch):
    # the operator holds no array: it states its device, the card unless
    # the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.Stencil3DOperator(4, 4, 4)
    op = ptt.Stencil3DOperator(4, 4, 4, device="cpu")
    assert op.device == torch.device("cpu")
    assert op.to("cpu").device == torch.device("cpu")
    assert op.diagonal().device == torch.device("cpu")
    assert ptt.CastOperator(op, torch.float64).device == torch.device("cpu")


def test_operator_without_array_states_its_device():
    class Bare(ptt.LinearOperator):
        shape = (3, 3)
        dtype = torch.float32

    with pytest.raises(TypeError, match="states no device"):
        Bare().device


def test_stencil_to_moves_the_device():
    # .to() reaches the operator through nn.Module._apply, also inside a
    # CastOperator (the meta device stands in for the card here)
    op = ptt.Stencil3DOperator(2, 2, 2, device="cpu")
    assert op.to("meta") is op and op.device == torch.device("meta")
    op = ptt.Stencil3DOperator(2, 2, 2, device="cpu")
    cast = ptt.CastOperator(op, torch.float64).to("meta")
    assert op.device == cast.device == torch.device("meta")
    assert op.diagonal().device == torch.device("meta")


@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil_from_jax(dtype):
    jop = JO.Stencil3DOperator(3, 4, 5, dtype=dtype, scale=0.25)
    top = stencil_from_jax(jop, "cpu")
    assert (top.nx, top.ny, top.nz, top.scale) == (3, 4, 5, 0.25)
    assert top.dtype == _tdt(dtype) and top.device == torch.device("cpu")
    X = _block((3, 4, 5), 3, dtype)
    assert np.array_equal(top.matmat(torch.as_tensor(X)).numpy(),
                          np.asarray(jop.matmat(jnp.asarray(X))))
