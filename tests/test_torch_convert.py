"""Carry-over from the JAX package (primme_tpu_torch/convert.py) and the
port's package boundary. Conversions are exact: arrays bit-identical,
dataclass fields equal; an f64 windowed operator's f32 (hi, lo) pair
becomes one f64 array equal to hi + lo, which is the matrix entry within
2**-48 relative and exactly where the entry is an f32 number."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from primme_tpu import params as jp
from primme_tpu.operators import WindowedELLOperator as JWindowed
from primme_tpu_torch import params as tp
from primme_tpu_torch.operators import WindowedELLOperator
from primme_tpu_torch.convert import (block_from_numpy, params_from_jax,
                                      windowed_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _band(n, bw, seed, dtype):
    rng = np.random.default_rng(seed)
    diags = rng.integers(-bw, bw + 1, 8)
    A = sp.diags([rng.normal(size=n - abs(d)) for d in diags],
                 list(diags), shape=(n, n), format="csr")
    return A.astype(dtype)


def test_windowed_from_jax_is_bit_identical():
    jop = JWindowed.from_scipy(_band(3000, 700, 2, np.float32))
    top = windowed_from_jax(jop)
    assert top.meta == jop.meta and top.shape == jop.shape
    for name in ("scal", "offs", "vals"):
        a = np.asarray(getattr(jop, name))
        b = getattr(top, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    X = np.random.default_rng(0).normal(size=(3000, 2)).astype(np.float32)
    y = top.matmat(torch.as_tensor(X)).numpy()
    yref = _band(3000, 700, 2, np.float64) @ X.astype(np.float64)
    assert np.abs(y - yref).max() <= 1e-5 * np.abs(yref).max()


@pytest.mark.parametrize("case", ["band3000", "lap16_f32_entries"])
def test_windowed_from_jax_f64(case):
    if case == "band3000":
        A = _band(3000, 700, 2, np.float64)
    else:
        from test_torch_problems import laplacian27_permuted
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        A = laplacian27_permuted(16)[0].astype(np.float64)
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        A = A[perm][:, perm].tocsr()
    jop = JWindowed.from_scipy(A)
    assert jop.vals_lo is not None
    top = windowed_from_jax(jop)
    assert top.meta == jop.meta and top.dtype == torch.float64
    for name in ("scal", "offs"):
        a = np.asarray(getattr(jop, name))
        assert a.tobytes() == getattr(top, name).numpy().tobytes(), name
    hilo = np.asarray(jop.vals, np.float64) + np.asarray(jop.vals_lo,
                                                         np.float64)
    assert np.array_equal(top.vals.numpy(), hilo)
    # the same positions as the port's own f64 pack of the matrix
    own = WindowedELLOperator.from_scipy(A).vals.numpy()
    if case == "band3000":
        assert np.all(np.abs(own - hilo) <= 2.0 ** -48 * np.abs(own))
    else:                                     # entries 26 and -1
        assert np.array_equal(own, hilo)
    n = A.shape[0]
    X = np.random.default_rng(0).normal(size=(n, 2))
    y = top.matmat(torch.as_tensor(X)).numpy()
    yref = A @ X
    assert np.abs(y - yref).max() <= 5e-14 * np.abs(yref).max()


@pytest.mark.parametrize("method", ["JDQMR_ETol", "GD_Olsen_plusK",
                                    "LOBPCG_OrthoBasis", "JDQR"])
def test_params_from_jax(method):
    pj = jp.set_method(jp.Method[method], jp.PrimmeParams(
        n=1000, num_evals=5, target=jp.Target.largest, max_block_size=2,
        target_shifts=(0.5,), internal_dtype=jnp.bfloat16))
    pt = params_from_jax(pj)
    assert isinstance(pt, tp.PrimmeParams)
    assert pt == tp.set_method(tp.Method[method], tp.PrimmeParams(
        n=1000, num_evals=5, target=tp.Target.largest, max_block_size=2,
        target_shifts=(0.5,), internal_dtype=torch.bfloat16))
    assert dataclasses.asdict(pt)["projectors"] == \
        dataclasses.asdict(pj)["projectors"]


def test_block_from_numpy():
    X = np.arange(12, dtype=np.float64).reshape(4, 3)
    t = block_from_numpy(X, "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.shape == (4, 3)
    assert np.array_equal(t.numpy(), X.astype(np.float32))
    Xf = np.asfortranarray(X)
    assert np.array_equal(block_from_numpy(Xf, "cpu").numpy(), X)


def test_import_loads_no_jax():
    code = ("import sys, primme_tpu_torch, primme_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('primme_tpu.')"
            " or m == 'primme_tpu']; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_disables_tf32():
    import primme_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
