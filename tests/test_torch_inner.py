"""The port's JDQMR inner solver (primme_tpu_torch/core/inner.py) against
the JAX package's on one fixed outer state given to both.

In f64 the two run the same recurrences on the same inputs, so the
iteration and matvec counts must be equal and the correction agree to
1e-9 relative (sums in another order, amplified by at most a few dozen
QMR steps)."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from primme_tpu import params as jp
from primme_tpu.core import inner as ji
from primme_tpu.core import solver as js
from primme_tpu.operators import DenseOperator
from primme_tpu_torch import LinearOperator
from primme_tpu_torch.convert import params_from_jax
from primme_tpu_torch.core import inner as ti
from primme_tpu_torch.core import solver as ts


class _Dense(LinearOperator):
    def __init__(self, A):
        super().__init__()
        self.register_buffer("A", torch.as_tensor(A))
        self.shape = tuple(A.shape)
        self.dtype = self.A.dtype

    def matmat(self, X):
        return self.A @ X


def _state(n, lockmax, num_locked, anorm, outer, nmv, jax_side):
    if jax_side:
        z = jnp.zeros((n, lockmax), jnp.float64)
        stats = types.SimpleNamespace(
            num_outer_iterations=jnp.int32(outer),
            anorm_estimate=jnp.asarray(anorm, jnp.float64),
            num_matvecs=jnp.int32(nmv))
        return types.SimpleNamespace(num_locked=jnp.int32(num_locked),
                                     evecs=z, Bevecs=z, stats=stats)
    stats = types.SimpleNamespace(num_outer_iterations=outer,
                                  anorm_estimate=anorm, num_matvecs=nmv)
    return types.SimpleNamespace(num_locked=num_locked,
                                 evecs=torch.zeros((n, lockmax),
                                                   dtype=torch.float64),
                                 stats=stats)


@pytest.mark.parametrize("valid", [(True, True), (True, False)])
@pytest.mark.parametrize("method", ["JDQMR_ETol", "JDQMR"])
def test_jdqmr_inner_solve_matches_reference(valid, method):
    rng = np.random.default_rng(0)
    n, blk, m = 400, 2, 10
    # symmetric test matrix with a known, well spread spectrum
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.linspace(0.1, 40.0, n)) @ Q.T
    # outer state: Ritz pairs of a random m-dimensional subspace
    V = np.linalg.qr(rng.standard_normal((n, m)))[0]
    w, Z = np.linalg.eigh(V.T @ A @ V)
    X = V @ Z[:, :blk]
    lam = w[:blk]
    R = A @ X - X * lam
    res = np.linalg.norm(R, axis=0)
    vmask = np.array(valid)

    p = jp.set_method(jp.Method[method],
                      jp.PrimmeParams(n=n, num_evals=4, max_block_size=blk,
                                      eps=1e-8))
    cfg_j = js.make_config(p)
    cfg_t = ts.make_config(params_from_jax(p))
    anorm = 40.0

    sj = _state(n, cfg_j.lockmax, 0, anorm, 3, 50, True)
    f = lambda a: jnp.asarray(a, jnp.float64)   # noqa: E731
    out_j = ji.jdqmr_inner_solve(
        cfg_j, DenseOperator(f(A)), None, None, sj, f(X), f(X), f(R),
        f(lam), f(res), jnp.asarray(vmask), f(1e-8 * anorm), evals=f(lam))

    st = _state(n, cfg_t.lockmax, 0, anorm, 3, 50, False)
    t = torch.as_tensor
    out_t = ti.jdqmr_inner_solve(
        cfg_t, _Dense(A), None, None, st, t(X), t(X), t(R), t(lam), t(res),
        t(vmask), 1e-8 * anorm, evals=t(lam))

    sol_j, its_j, nmv_j, nprec_j = (np.asarray(x) for x in out_j)
    sol_t, its_t, nmv_t, nprec_t, trace_t = out_t
    assert trace_t is None      # no inner_trace_cap, no step buffer
    assert (int(its_j), int(nmv_j), int(nprec_j)) == (its_t, nmv_t, nprec_t)
    assert its_t > 1
    sol_t = sol_t.numpy()
    assert np.abs(sol_t - sol_j).max() <= 1e-9 * np.abs(sol_j).max()
    assert np.all(sol_t[:, ~vmask] == 0)
