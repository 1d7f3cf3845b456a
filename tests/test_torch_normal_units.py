"""The normal-operator units of the port against the JAX package on the same
numpy inputs, on the CPU: the complex branch of ``target_sort_keys`` for all
six targets (with ties between conjugate pairs; keys equal to the last
place, orders equal), ``solve_H_normal`` on the same masked ``H`` (values
within 1e-12 in complex128, the subspaces through ``|Z^H Z_ref|``, the same
pad mask; a group of equal keys, such as a real matrix's conjugate pair at
SR, compared as a set), ``normal_inner_solve`` on a fixed state (``sol``
within 1e-12 of max|sol| in complex128, equal ``its``/``nmv``/``nprec``),
and the non-Hermitian ``H``'s row panel: after an expansion ``H = V^H A V``
holds ``gram(X, W)`` in its new rows, which differ from the mirror of its
new columns that a Hermitian ``H`` takes."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu import operators as JO
from primme_tpu import params as JP
from primme_tpu.core import inner as JI
from primme_tpu.core import linalg as JL
from primme_tpu.core import solver as JS
from primme_tpu_torch import convert
from primme_tpu_torch.core import inner as TI
from primme_tpu_torch.core import linalg as TL
from primme_tpu_torch.core import solver as TS
from primme_tpu_torch.params import Target

TARGETS = [Target.smallest, Target.largest, Target.closest_abs,
           Target.largest_abs, Target.closest_geq, Target.closest_leq]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _normal(n, seed, real=False):
    """A random normal matrix: complex, or real with conjugate pairs."""
    rng = np.random.default_rng(seed)
    if real:
        a, b = rng.normal(size=n // 2), rng.normal(size=n // 2)
        blocks = np.zeros((n, n))
        for j in range(n // 2):
            blocks[2 * j:2 * j + 2, 2 * j:2 * j + 2] = [[a[j], b[j]],
                                                        [-b[j], a[j]]]
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        return Q @ blocks @ Q.T
    Q = np.linalg.qr(rng.normal(size=(n, n))
                     + 1j * rng.normal(size=(n, n)))[0]
    d = rng.normal(size=n) + 1j * rng.normal(size=n)
    return (Q * d[None, :]) @ Q.conj().T


@pytest.mark.parametrize("target", TARGETS)
def test_complex_sort_keys(target):
    # conjugate pairs (equal real parts, equal |w - s| for a real shift)
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=6), rng.normal(size=6)
    w = np.concatenate([a + 1j * b, a - 1j * b, [0.25 + 0j, 0.25 + 1j]])
    shifts = np.array([0.25, -0.5])
    jt = JP.Target(target.value)
    for sidx in (0, 1, 5):
        kt = TL.target_sort_keys(_t(w), target, _t(shifts), sidx)
        kj = np.asarray(JL.target_sort_keys(jnp.asarray(w), jt,
                                            jnp.asarray(shifts),
                                            jnp.asarray(sidx)))
        assert kt.dtype == torch.float64
        # |w - s| may round differently in the last place (hypot)
        np.testing.assert_allclose(kt.numpy(), kj, rtol=4.5e-16, atol=0)
        order = torch.argsort(kt, stable=True).numpy()
        np.testing.assert_array_equal(order, np.argsort(kj, kind="stable"))


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("b", [1, 7, 12])
def test_solve_H_normal(target, real, b):
    mmax = 12
    A = _normal(mmax, 2, real=real).astype(np.complex128)
    # entries past the active block must not matter
    H = A.copy()
    H[b:, :] = 99.0
    H[:, b:] = -7.0
    shifts = np.array([0.3])
    st = TL.solve_H_normal(_t(H), b, target, _t(shifts), 0)
    sj = JL.solve_H_normal(jnp.asarray(H), jnp.asarray(b),
                           JP.Target(target.value), jnp.asarray(shifts),
                           jnp.asarray(0))
    act = st.active.numpy()
    np.testing.assert_array_equal(act, np.asarray(sj.active))
    assert act.sum() == b and act[:b].all()
    wt, wj = st.hvals.numpy(), np.asarray(sj.hvals)
    assert (wt[b:] == wj[b:]).all()
    Zt, Zj = st.hvecs.numpy(), np.asarray(sj.hvecs)
    assert not Zt[:, b:].any() and not Zj[:, b:].any()
    assert np.abs(Zt.conj().T @ Zt - np.diag(act)).max() <= 1e-12
    # a real matrix's conjugate pairs tie in SR/LR keys (and in |w - s|
    # for a real shift): roundoff orders each such pair, so each group of
    # equal keys is compared as a set, and the subspaces of the sorted
    # vectors at each group's end: |Z_j^H Z_ref,j| has singular values 1
    keys = TL.target_sort_keys(_t(wj[:b]), target, _t(shifts), 0).numpy()
    scale = 1e-12 * max(np.abs(wj[:b]).max(), 1.0)
    ends = [j + 1 for j in range(b - 1) if keys[j + 1] - keys[j] > scale]
    starts = [0] + ends
    for lo, hi in zip(starts, ends + [b]):
        assert CS.match_values(wt[lo:hi], wj[lo:hi]) <= scale
        sv = np.linalg.svd(Zt[:, :hi].conj().T @ Zj[:, :hi],
                           compute_uv=False)
        assert np.abs(sv - 1).max() <= 1e-10
    # the values are the active block's eigenvalues
    ev = np.linalg.eigvals(A[:b, :b])
    assert CS.match_values(wt[:b], ev) <= 1e-12 * np.abs(ev).max()


def _inner_case(blk, valid, max_inner, with_K, nlocked):
    n = 90
    rng = np.random.default_rng(5)
    A = _normal(n, 4)
    X = np.linalg.qr(rng.normal(size=(n, blk))
                     + 1j * rng.normal(size=(n, blk)))[0]
    lam = np.einsum("nb,nb->b", X.conj(), A @ X)
    R = A @ X - X * lam
    res = np.linalg.norm(R, axis=0)
    p = JP.resolve_defaults(JP.PrimmeParams(
        n=n, num_evals=4, hermitian=False, eps=1e-9, max_block_size=blk,
        locking=1 if nlocked else 0))
    p = JP.set_method(JP.Method.JDQMR, p, has_precond=with_K)
    if max_inner:
        p = p.with_(max_inner_iterations=max_inner)
    cfgj = JS.make_config(p)
    cfgt = TS.make_config(convert.params_from_jax(p))
    evecs = np.zeros((n, cfgj.lockmax), complex)
    if nlocked:
        # locked vectors orthogonal to X
        Ql = rng.normal(size=(n, nlocked)) + 1j * rng.normal(size=(n, nlocked))
        Ql = Ql - X @ (X.conj().T @ Ql)
        evecs[:, :nlocked] = np.linalg.qr(Ql)[0]
    Kd = 1.0 / (np.abs(np.diag(A)) + 2.0) if with_K else None
    sj = types.SimpleNamespace(evecs=jnp.asarray(evecs), Bevecs=None,
                               num_locked=jnp.asarray(nlocked, jnp.int32))
    st = types.SimpleNamespace(evecs=_t(evecs), Bevecs=None,
                               num_locked=nlocked)
    tol = 1e-9 * 3.0
    outj = JI.normal_inner_solve(
        cfgj, JO.DenseOperator(jnp.asarray(A)), None,
        JO.DiagonalOperator(jnp.asarray(Kd)) if with_K else None, sj,
        jnp.asarray(X), jnp.asarray(X), jnp.asarray(R), jnp.asarray(lam),
        jnp.asarray(res), jnp.asarray(valid), jnp.asarray(tol))
    outt = TI.normal_inner_solve(
        cfgt, ptt.DenseOperator(A), None,
        ptt.DiagonalOperator(Kd) if with_K else None, st, _t(X), _t(X),
        _t(R), _t(lam), _t(res), _t(np.asarray(valid)), tol)
    return outj, outt


@pytest.mark.parametrize("blk,valid,max_inner,with_K,nlocked", [
    (1, [True], 0, False, 0),
    (3, [True, True, False], 0, False, 0),
    (2, [True, True], 4, True, 0),
    (2, [True, False], 0, False, 2),
])
def test_normal_inner_solve(blk, valid, max_inner, with_K, nlocked):
    outj, outt = _inner_case(blk, valid, max_inner, with_K, nlocked)
    assert tuple(int(x) for x in outj[1:]) == outt[1:4]
    assert outt[4] is None       # the GMRES solve records no steps
    assert outt[1] > 0
    solj, solt = np.asarray(outj[0]), outt[0].numpy()
    assert np.abs(solt - solj).max() <= 1e-12 * np.abs(solj).max()


def test_row_panel_is_gram_of_new_block():
    # one expansion of a normal solve: H's new rows are X^H W, not the
    # mirror of its new columns
    n = 60
    A = _normal(n, 6)
    p = ptt.resolve_defaults(ptt.PrimmeParams(n=n, num_evals=3, eps=1e-9,
                                              hermitian=False,
                                              target=Target.largest_abs,
                                              target_shifts=(0.0,)))
    op = ptt.DenseOperator(A)
    cfg, shifts, s = TS.setup_solver(op, p, device="cpu")
    assert s.V.dtype == torch.complex128 and s.locked_vals.is_complex()
    win, stats = TS.prepare_window(cfg, s, shifts)
    assert win.sol.hvals.is_complex()
    s = TS._replace(s, stats=stats)
    b0 = s.b
    s = TS.do_expand(cfg, op, None, None, s, win, shifts)
    b = s.b
    assert b > b0
    V, W, H = s.V[:, :b], s.W[:, :b], s.H[:b, :b]
    # the whole active block is V^H A V
    assert torch.allclose(H, V.mH @ W, rtol=0, atol=1e-12)
    rows = TL.gram(s.V[:, b0:b], s.W)[:, :b]
    assert torch.equal(s.H[b0:b, :b], rows)
    mirror = TL.gram(s.V, s.W[:, b0:b]).mH[:, :b]
    assert float((rows - mirror).abs().max()) > 1e-2
