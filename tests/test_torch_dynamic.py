"""The reference's default method in the port against the JAX package on
the same numpy inputs, on the CPU: DYNAMIC GD+k/JDQMR switching
(``core/dynamic.py``) and segmented solves (``solve_eigs(segment_outer=)``).

* ``tests/test_eigsh.py::test_segmented_solve_bit_identical`` held in the
  port (a segmented solve returns exactly the unsegmented values,
  residuals and matvecs), and its values within 1e-10 of the JAX
  package's;
* ``test_dynamic_method`` and ``test_dynamic_reprobes_idle_method``
  through both packages: values within 1e-8 of the dense spectrum and of
  each other, matvecs within ``MV_SLACK`` = 2x of each other;
* the method trace: it depends on wall-clock times, so both packages'
  ``time.perf_counter`` are replaced by the same fixed-step clock and both
  start from the JAX package's seed-0 block as ``v0`` (the packages'
  random streams differ); the two traces are then equal over at least
  their first 6 segments;
* ``eigs`` with ``segment_outer`` (bit-identical) and with
  ``method="DYNAMIC"``, which the reference's ``eigs`` runs as the
  DYNAMIC preset without switching: values within 1e-8 of the JAX
  package's from the same start.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu
import primme_tpu_torch as ptt

MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tridiag():
    # tests/test_eigsh.py's fixture
    n = 300
    d = np.linspace(1, 100, n)
    A = sp.diags([d, 0.3 * np.ones(n - 1), 0.3 * np.ones(n - 1)],
                 [0, 1, -1]).tocsr()
    return A, np.linalg.eigvalsh(A.toarray())


def _reprobe_matrix():
    # test_dynamic_reprobes_idle_method's matrix
    n = 500
    return sp.diags([np.full(n - 1, -1.), np.linspace(1., 2., n),
                     np.full(n - 1, -1.)], [-1, 0, 1]).tocsr()


def _jax_start(n, cols, dtype="float64"):
    """The JAX package's seed-0 start block (``init_basis``'s draw)."""
    import jax
    import jax.numpy as jnp
    from primme_tpu.core.solver import _rand_block

    key = jax.random.split(jax.random.PRNGKey(0))[1]
    return np.array(_rand_block(key, n, cols, jnp.dtype(dtype)))


def _dynamic(pkg, A, k, eps, v0=None, trace=None):
    """``solve_eigs_dynamic`` of ``pkg`` (the JAX package or the port) on
    ``A``, k smallest, from ``v0``; returns (evals, num_matvecs)."""
    n = A.shape[0]
    if pkg == "jax":
        import jax.numpy as jnp
        from primme_tpu.core.dynamic import solve_eigs_dynamic
        from primme_tpu.operators import aslinearoperator
        from primme_tpu.params import PrimmeParams, Target
        p = PrimmeParams(n=n, num_evals=k, target=Target.smallest, eps=eps,
                         dynamic_method_switch=1)
        res = solve_eigs_dynamic(
            aslinearoperator(A), p, method_trace=trace,
            v0=None if v0 is None else jnp.asarray(v0))
        return np.asarray(res.evals), int(res.stats.num_matvecs)
    from primme_tpu_torch.core.dynamic import solve_eigs_dynamic
    p = ptt.PrimmeParams(n=n, num_evals=k, target=ptt.Target.smallest,
                         eps=eps, dynamic_method_switch=1)
    log = []
    res = solve_eigs_dynamic(
        ptt.aslinearoperator(A), p, segment_log=log, device="cpu",
        v0=None if v0 is None else torch.from_numpy(v0))
    if trace is not None:
        trace.extend(r["method"] for r in log)
    return res.evals.numpy(), res.stats.num_matvecs


def _close(vals, expect, tol):
    scale = max(1.0, float(np.abs(expect).max()))
    return np.abs(np.sort(vals) - np.sort(expect)).max() < tol * scale


def test_segmented_solve_bit_identical():
    import jax.numpy as jnp
    from primme_tpu.core.solver import solve_eigs as jsolve
    from primme_tpu.operators import DenseOperator as JDense
    from primme_tpu_torch.core.solver import solve_eigs

    rng = np.random.default_rng(3)
    n = 180
    Ad = np.diag(np.arange(1.0, n + 1)) + 0.02 * rng.normal(size=(n, n))
    Ad = (Ad + Ad.T) / 2
    kw = dict(n=n, num_evals=5, eps=1e-10, max_basis_size=20,
              max_block_size=2, max_matvecs=6000, locking=1)
    p = ptt.set_method(ptt.Method.GD_Olsen_plusK, ptt.PrimmeParams(**kw),
                       has_precond=False)
    A = ptt.DenseOperator(torch.from_numpy(Ad))
    r1 = solve_eigs(A, p, dtype=torch.float64)
    r2 = solve_eigs(A, p, dtype=torch.float64, segment_outer=5)
    np.testing.assert_array_equal(r1.evals.numpy(), r2.evals.numpy())
    np.testing.assert_array_equal(r1.resnorms.numpy(), r2.resnorms.numpy())
    np.testing.assert_array_equal(r1.evecs.numpy(), r2.evecs.numpy())
    assert r1.stats.num_matvecs == r2.stats.num_matvecs
    truth = np.sort(np.linalg.eigvalsh(Ad))[:5]
    assert np.abs(np.sort(r2.evals.numpy()) - truth).max() < 1e-8

    pj = primme_tpu.set_method(primme_tpu.Method.GD_Olsen_plusK,
                               primme_tpu.PrimmeParams(**kw),
                               has_precond=False)
    rj = jsolve(JDense(jnp.asarray(Ad)), pj, dtype=jnp.float64,
                segment_outer=5)
    np.testing.assert_allclose(np.sort(r2.evals.numpy()),
                               np.sort(np.asarray(rj.evals)), rtol=0,
                               atol=1e-10)
    assert r2.stats.num_matvecs <= MV_SLACK * int(rj.stats.num_matvecs)


def test_segmented_solve_with_inner_iterations_and_probe(tridiag):
    # the JDQMR path with the probe on (its generator and counters carried
    # in the state across segments): bit-identical, segment length 1 and 7
    A, ref = tridiag
    runs = [ptt.eigsh(A, k=4, which="SA", tol=1e-10, method="JDQMR",
                      return_stats=True, device="cpu", segment_outer=seg)
            for seg in (None, 1, 7)]
    for vals, vecs, st in runs[1:]:
        np.testing.assert_array_equal(vals, runs[0][0])
        np.testing.assert_array_equal(vecs, runs[0][1])
        for key in ("num_matvecs", "num_outer_iterations", "num_restarts",
                    "num_probe_matvecs", "num_inner_iterations"):
            assert st[key] == runs[0][2][key], key
    assert _close(runs[0][0], ref[:4], 1e-9)


def test_dynamic_method(tridiag):
    A, ref = tridiag
    kw = dict(k=5, which="SA", tol=1e-9, method=ptt.Method.DYNAMIC,
              return_stats=True, maxMatvecs=5000,
              raise_for_unconverged=False)
    vt, _, st = ptt.eigsh(A, device="cpu", **kw)
    vj, _, sj = primme_tpu.eigsh(A, **dict(kw, method=primme_tpu.Method
                                           .DYNAMIC))
    assert _close(vt, ref[:5], 1e-8) and _close(vj, ref[:5], 1e-8)
    assert _close(vt, vj, 1e-8)
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]
    assert sj["num_matvecs"] <= MV_SLACK * st["num_matvecs"]


def test_dynamic_reprobes_idle_method():
    A = _reprobe_matrix()
    ref = np.sort(np.linalg.eigvalsh(A.toarray()))[:10]
    out = {}
    for pkg in ("port", "jax"):
        trace = []
        vals, mv = _dynamic(pkg, A, 10, 1e-12, trace=trace)
        assert np.abs(np.sort(vals) - ref).max() < 1e-8, pkg
        # enough segments ran to exercise re-probing, and after the
        # initial exploration the loser still shows up in the trace
        assert len(trace) >= 8, (pkg, trace)
        assert "gd" in trace[2:] and "jd" in trace[2:], (pkg, trace)
        out[pkg] = (vals, mv)
    assert _close(out["port"][0], out["jax"][0], 1e-8)
    assert out["port"][1] <= MV_SLACK * out["jax"][1]
    assert out["jax"][1] <= MV_SLACK * out["port"][1]


class _FixedStepClock:
    """``time`` with a ``perf_counter`` that advances one second a call:
    every measured segment then lasts one second, and the method choice
    depends only on the digits each segment converged."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def test_dynamic_trace_fake_clock(monkeypatch):
    import primme_tpu.core.dynamic as jdyn
    import primme_tpu_torch.core.dynamic as tdyn

    monkeypatch.setattr(jdyn, "time", _FixedStepClock())
    monkeypatch.setattr(tdyn, "time", _FixedStepClock())
    A = _reprobe_matrix()
    v0 = _jax_start(A.shape[0], 1)
    ref = np.sort(np.linalg.eigvalsh(A.toarray()))[:10]
    traces = {}
    for pkg in ("port", "jax"):
        trace = []
        vals, _ = _dynamic(pkg, A, 10, 1e-12, v0=v0, trace=trace)
        assert np.abs(np.sort(vals) - ref).max() < 1e-8, pkg
        traces[pkg] = trace
    m = min(len(traces["port"]), len(traces["jax"]))
    assert m >= 6, traces
    assert traces["port"][:m] == traces["jax"][:m], traces


def _normal_matrix():
    # tests/test_normal.py's fixture
    rng = np.random.default_rng(0)
    n = 120
    Q = np.linalg.qr(rng.normal(size=(n, n))
                     + 1j * rng.normal(size=(n, n)))[0]
    d = rng.normal(size=n) + 1j * rng.normal(size=n)
    return (Q * d[None, :]) @ Q.conj().T, d


def test_eigs_segment_outer_and_dynamic():
    A, d = _normal_matrix()
    v0 = _jax_start(A.shape[0], 1, "complex128")
    kw = dict(k=4, which="LM", tol=1e-10, return_stats=True, v0=v0)
    w1, X1, s1 = ptt.eigs(A, device="cpu", **kw)
    w2, X2, s2 = ptt.eigs(A, device="cpu", segment_outer=3, **kw)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(X1, X2)
    assert s1["num_matvecs"] == s2["num_matvecs"]
    # DYNAMIC: the reference's eigs applies the preset and does not switch
    wt, _, st = ptt.eigs(A, device="cpu", method="DYNAMIC", **kw)
    wj, _, sj = primme_tpu.eigs(A, method="DYNAMIC", **kw)
    top = d[np.argsort(-np.abs(d))][:4]
    for w in (wt, np.asarray(wj)):
        assert max(np.abs(w - t).min() for t in top) < 1e-8
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]
    assert sj["num_matvecs"] <= MV_SLACK * st["num_matvecs"]
