"""The value types of the port's surface: every operator constructor that
``primme_tpu`` exports, in each of f16, bf16, f32, f64, complex64 and
complex128, against the JAX package's on the CPU, on the same seeded
inputs (a bf16 array carried across by ``convert.tensor_from_numpy``).

For each case one of two holds:

* both packages build the operator and compute the same product of a
  random block of the operator's type, within ``TOL`` of the largest
  entry of the JAX package's product (one rounding of the half type per
  operation, sums in f32 in another order, an f16 contraction under
  ``jit``: a few units in the half's last place; f32's and f64's own
  round-off elsewhere); or
* the port refuses the case by name, naming a Queue C entry of
  ``ROADMAP.md`` that records the JAX package as wrong there (:data:`REFUSED`,
  empty now: every case is served).

``WindowedELLOperator`` casts its values to f32 in the JAX package (its
f64 rides on the f32x2 ``vals_lo``, which the port replaces by native
FP64: ``tests/test_torch_surface.py``); both packages compute that f32
product from the real part of what they are given. The test matrix's
values (2, -1, 0.5) are exact in every type, so the JAX package's f32
values are the same in all six cases: its interpreted Pallas kernel runs
once, on one block that the six cases share (:func:`_windowed_reference`),
and each case asserts that its JAX operator holds those f32 values.
"""

import os
import re
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import primme_tpu
from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch import convert as CV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float16", "bfloat16", "float32", "float64", "complex64",
          "complex128")
CTORS = ("BandedOperator", "BlockELLOperator", "ChebyshevPrecond",
         "DenseOperator", "DiagonalOperator", "ELLOperator",
         "FunctionOperator", "JacobiPrecond", "Stencil3DOperator",
         "WindowedELLOperator")
TOL = {"float16": 8 * 2.0 ** -10, "bfloat16": 8 * 2.0 ** -7,
       "float32": 1e-5, "complex64": 1e-5, "float64": 1e-12,
       "complex128": 1e-12}
# (constructor, dtype) -> the Queue C entry that records the JAX package
# as wrong there, which the port's refusal names
REFUSED: dict = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, dt):
    """A seeded array of type ``dt`` for both packages: the JAX array and
    the port's tensor (bf16 through the bits of its uint16 view)."""
    a = rng.normal(size=shape)
    if dt.startswith("complex"):
        a = a + 1j * rng.normal(size=shape)
    j = jnp.asarray(a).astype(jnp.dtype(dt))
    return j, CV.tensor_from_numpy(np.asarray(j))


WINDOWED_N = 256          # WE.pack's smallest packable band


def _windowed_matrix():
    n = WINDOWED_N
    return sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                     0.5 * np.ones(n - 7), 0.5 * np.ones(n - 7)],
                    [0, 1, -1, 7, -7], format="csr").astype(np.float32)


def _block_rng(ctor, dt):
    return np.random.default_rng(zlib.crc32(f"{ctor}:{dt}".encode()))


@pytest.fixture(scope="module")
def _windowed_reference():
    """The JAX package's windowed product shared by the six cases: its f32
    values (the same in all six types), the f32 block every case applies
    (JAX array and tensor) and the product, one call of the interpreted
    Pallas kernel."""
    pk = JO.WindowedELLOperator.from_scipy(_windowed_matrix())
    Xj, Xt = _rand(np.random.default_rng(zlib.crc32(b"WindowedELL")),
                   (WINDOWED_N, 2), "float32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Y = np.asarray(pk.matmat(Xj), np.float64)
    return np.asarray(pk.vals), Xt, Y


def _pair(ctor, dt, rng):
    """``(jax_operator, port_operator)`` of ``ctor`` in type ``dt``."""
    tdt = getattr(torch, dt)
    if ctor == "DenseOperator":
        Mj, Mt = _rand(rng, (30, 30), dt)
        return JO.DenseOperator(Mj), ptt.DenseOperator(Mt)
    if ctor == "DiagonalOperator":
        dj, d_t = _rand(rng, (30,), dt)
        return JO.DiagonalOperator(dj), ptt.DiagonalOperator(d_t)
    if ctor == "BandedOperator":
        offs = (-3, 0, 2, 5)
        vj, vt = _rand(rng, (len(offs), 40), dt)
        return JO.BandedOperator(offs, vj), ptt.BandedOperator(offs, vt)
    if ctor == "ELLOperator":
        A = sp.random(40, 40, density=0.15, random_state=1, format="csr")
        cols, _ = JO.ELLOperator._pack(A)
        vj, _ = _rand(rng, cols.shape, dt)
        jop = JO.ELLOperator(cols, vj)
        return jop, CV.ell_from_jax(jop)
    if ctor == "BlockELLOperator":
        A = sp.random(48, 48, density=0.05, random_state=2, format="csr")
        jb = JO.BlockELLOperator.from_scipy(A, block_size=8)
        vj, _ = _rand(rng, jb.bvals.shape, dt)
        jop = JO.BlockELLOperator(jb.bcols, vj, jb.shape)
        return jop, CV.block_ell_from_jax(jop)
    if ctor == "JacobiPrecond":
        dj, _ = _rand(rng, (30,), dt)
        jop = JO.JacobiPrecond(dj.at[3].set(1e-12))   # the eps clamp
        return jop, CV.jacobi_from_jax(jop)
    if ctor == "ChebyshevPrecond":
        Q = np.linalg.qr(rng.normal(size=(30, 30)))[0]
        M = (Q * np.linspace(0.2, 9.0, 30)) @ Q.T
        Mj = jnp.asarray(M).astype(jnp.dtype(dt))
        Mt = CV.tensor_from_numpy(np.asarray(Mj))
        return (JO.ChebyshevPrecond(JO.DenseOperator(Mj), (0.5, 10.0),
                                    degree=3),
                ptt.ChebyshevPrecond(ptt.DenseOperator(Mt), (0.5, 10.0),
                                     degree=3))
    if ctor == "FunctionOperator":
        Mj, Mt = _rand(rng, (30, 30), dt)
        return (JO.FunctionOperator(lambda X: Mj @ X, (30, 30),
                                    jnp.dtype(dt)),
                ptt.FunctionOperator(lambda X: Mt @ X, (30, 30), tdt,
                                     device="cpu"))
    if ctor == "Stencil3DOperator":
        return (JO.Stencil3DOperator(3, 4, 5, dtype=jnp.dtype(dt),
                                     scale=1.5),
                ptt.Stencil3DOperator(3, 4, 5, dtype=tdt, scale=1.5,
                                      device="cpu"))
    if ctor == "WindowedELLOperator":
        pk = JO.WindowedELLOperator.from_scipy(_windowed_matrix())
        vj = jnp.asarray(pk.vals).astype(jnp.dtype(dt))
        if dt.startswith("complex"):
            vj = vj + 1j * vj       # an imaginary part both packages drop
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return (JO.WindowedELLOperator(pk.scal, pk.offs, vj, pk.meta),
                    ptt.WindowedELLOperator(np.asarray(pk.scal),
                                            np.asarray(pk.offs),
                                            np.asarray(vj), pk.meta))
    raise KeyError(ctor)


def _case(ctor, dt):
    """Case ``(ctor, dt)``: both operators, the port's block and the JAX
    package's product of the same block (f64 or complex128 numpy)."""
    rng = _block_rng(ctor, dt)
    jop, top = _pair(ctor, dt, rng)
    # the product's type: the operator's (the JAX windowed one is f32)
    odt = str(jnp.dtype(jop.dtype))
    Xj, Xt = _rand(rng, (top.shape[1], 2), odt)
    Yj = np.asarray(jnp.asarray(jop.matmat(Xj)).astype(
        jnp.complex128 if odt.startswith("complex") else jnp.float64))
    return jop, top, Xt, Yj


@pytest.fixture(scope="module", autouse=True)
def _cases():
    """Every served case but the windowed ones (:func:`_windowed_reference`)
    built and its JAX product computed in threads, started when the
    module's first test starts: (ctor, dt) -> a future of :func:`_case`."""
    pool = ThreadPoolExecutor(8)
    futures = {(c, dt): pool.submit(_case, c, dt) for c in CTORS
               for dt in DTYPES if c != "WindowedELLOperator"
               and (c, dt) not in REFUSED}
    pool.shutdown(wait=False)
    yield futures
    for f in futures.values():
        f.exception()


def test_every_exported_constructor_is_walked():
    """:data:`CTORS` is every operator class ``primme_tpu`` exports but the
    abstract ``LinearOperator``; every entry of :data:`REFUSED` names a
    Queue C entry that ``ROADMAP.md`` holds."""
    exported = {n for n in dir(primme_tpu)
                if isinstance(getattr(primme_tpu, n), type)
                and issubclass(getattr(primme_tpu, n), JO.LinearOperator)}
    assert exported - {"LinearOperator"} == set(CTORS)
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        queue_c = f.read().split("### Queue C", 1)[1].split("\n### ", 1)[0]
    for entry in REFUSED.values():
        assert re.search(rf"\b{entry}\b", queue_c), entry


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ctor", CTORS)
def test_constructor_dtype_matches_reference(ctor, dt, request, _cases):
    if (ctor, dt) in REFUSED:
        with pytest.raises(NotImplementedError, match=REFUSED[ctor, dt]):
            _pair(ctor, dt, _block_rng(ctor, dt))
        return
    if ctor == "WindowedELLOperator":
        # the shared product: the same f32 values, the shared block
        jop, top = _pair(ctor, dt, _block_rng(ctor, dt))
        vals32, Xt, Yj = request.getfixturevalue("_windowed_reference")
        assert np.array_equal(np.asarray(jop.vals), vals32)
    else:
        jop, top, Xt, Yj = _cases[ctor, dt].result()
    odt = str(jnp.dtype(jop.dtype))
    Y = top.matmat(Xt)
    if ctor != "WindowedELLOperator":
        assert top.dtype == getattr(torch, dt)
        assert Y.dtype == getattr(torch, odt)
    Y = Y.to(torch.complex128 if Y.is_complex() else torch.float64).numpy()
    # an f16 clamp of 1e-10 is 0: x / 0 is infinite in both packages
    fin = np.isfinite(Yj)
    assert np.array_equal(fin, np.isfinite(Y))
    assert np.array_equal(Y[~fin], Yj[~fin]) or np.isnan(Yj[~fin]).all()
    scale = max(float(np.abs(Yj[fin]).max()), 1e-30)
    assert np.abs(Y[fin] - Yj[fin]).max() <= TOL[odt] * scale
