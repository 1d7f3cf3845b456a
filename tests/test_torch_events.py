"""The solver's event stream in the port against the JAX package on the
same numpy inputs, on the CPU: ``eigsh(monitor=)`` with the reference's
event taxonomy (0 outer, 1 inner, 2 restart, 3 reset, 4 converged, 5
locked), ``monitor_inner``'s per-inner-iteration buffer, ``return_history``,
the ``printLevel`` text lines, and ``svds``' per-stage stream.

``tests/test_eigsh.py::test_monitor_event_taxonomy``,
``test_monitor_inner_iterations`` and
``tests/test_svds.py::test_svds_monitor_and_history`` run through both
packages with their own assertions. The eigsh solves start from the JAX
package's seed-0 block, passed as ``v0`` to both (the packages' random
streams differ; the JAX package's run is then the one its own test makes).
Between the packages: the event kinds as sets, ``sum(num_inner)`` equal
to each package's own stat, the history's keys equal and its length (one
record an outer iteration) within ``MV_SLACK`` = 2x, as the matvecs are
held; the text monitor's lines under ``printLevel`` 2 and 4 carry the
reference's prefixes and field layout.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu
import primme_tpu_torch as ptt

MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
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


@pytest.fixture(scope="module")
def rect():
    # tests/test_svds.py's fixture
    rng = np.random.default_rng(0)
    m, n = 200, 150
    U = np.linalg.qr(rng.normal(size=(m, n)))[0]
    V = np.linalg.qr(rng.normal(size=(n, n)))[0]
    sv = np.linspace(1, 50, n)[::-1]
    return U @ np.diag(sv) @ V.T, np.sort(sv)


def _jax_start(n):
    """The JAX package's seed-0 start block (``init_basis``'s draw)."""
    import jax
    import jax.numpy as jnp
    from primme_tpu.core.solver import _rand_block

    key = jax.random.split(jax.random.PRNGKey(0))[1]
    return np.array(_rand_block(key, n, 1, jnp.float64))


def _eigsh(pkg, A, **kw):
    kw.setdefault("v0", _jax_start(A.shape[0]))
    if pkg == "port":
        return ptt.eigsh(A, device="cpu", **kw)
    return primme_tpu.eigsh(A, **kw)


def _close(vals, expect, tol=1e-7):
    scale = max(1.0, float(np.abs(expect).max()))
    return np.abs(np.sort(vals) - np.sort(expect)).max() < tol * scale


def test_monitor_event_taxonomy(tridiag):
    A, ref = tridiag
    kinds, kinds_soft = {}, {}
    for pkg in ("port", "jax"):
        events = []

        def mon(event, num_inner, **kw):
            events.append((int(event), int(num_inner)))

        vals, _, st = _eigsh(pkg, A, k=6, which="SA", tol=1e-10,
                             method="JDQMR", ncv=10, monitor=mon,
                             return_stats=True, raise_for_unconverged=False)
        assert _close(vals, ref[:6]), pkg
        kinds[pkg] = {e for e, _ in events}
        assert kinds[pkg] <= {0, 1, 2, 3, 4, 5}
        assert 5 in kinds[pkg]                     # pairs locked
        assert any(e == 1 and ni > 0 for e, ni in events)
        assert sum(ni for _, ni in events) == st["num_inner_iterations"]
        # one event an outer iteration (restarts and probes included)
        assert len(events) >= st["num_outer_iterations"]

        # soft locking: restarts are not shadowed by lock events
        events.clear()
        _eigsh(pkg, A, k=6, which="SA", tol=1e-10, method="JDQMR", ncv=10,
               locking=0, monitor=mon, raise_for_unconverged=False)
        kinds_soft[pkg] = {e for e, _ in events}
        assert 2 in kinds_soft[pkg]               # restart events (ncv=10)
    assert kinds["port"] == kinds["jax"]
    assert kinds_soft["port"] == kinds_soft["jax"]


def test_monitor_inner_iterations(tridiag):
    A, ref = tridiag
    for pkg in ("port", "jax"):
        rows = []

        def mon(event, num_inner, inner_trace=None, **kw):
            if inner_trace is not None and int(num_inner) > 0:
                tr = np.asarray(inner_trace)
                rows.append((int(num_inner), tr[:min(int(num_inner),
                                                     tr.shape[0])]))

        vals, _, st = _eigsh(pkg, A, k=4, which="SA", tol=1e-10,
                             method="JDQMR", monitor=mon, monitor_inner=True,
                             return_stats=True, raise_for_unconverged=False)
        assert _close(vals, ref[:4]), pkg
        assert rows, f"{pkg}: no inner traces delivered"
        assert sum(ni for ni, _ in rows) == st["num_inner_iterations"]
        for ni, tr in rows:
            assert tr.ndim == 3 and tr.shape[2] == 3
            # the first recorded step has an alive column and a finite
            # eigenresidual estimate
            assert (tr[0, :, 2] > 0).any()
            alive0 = tr[0, :, 2] > 0
            assert np.isfinite(tr[0, alive0, :2]).all()
            # alive flags are 0 or 1 and the buffer is [cap, blk, 3]
            assert set(np.unique(tr[:, :, 2])) <= {0.0, 1.0}


def test_return_history(tridiag):
    A, ref = tridiag
    hist = {}
    for pkg in ("port", "jax"):
        vals, _, st = _eigsh(pkg, A, k=4, which="SA", tol=1e-10,
                             method="JDQMR", return_history=True,
                             monitor_inner=True, return_stats=True)
        assert _close(vals, ref[:4]), pkg
        h = st["hist"]
        n = len(h["event"])
        assert all(len(h[key]) == n for key in
                   ("num_matvecs", "num_outer", "num_locked",
                    "num_converged", "basis_size", "num_inner", "hvals",
                    "resnorms")), pkg
        assert int(np.sum(h["num_inner"])) == st["num_inner_iterations"]
        # the matvec counter is monotone and ends within the solve's
        assert np.all(np.diff(h["num_matvecs"]) >= 0)
        assert h["num_matvecs"][-1] <= st["num_matvecs"]
        hist[pkg] = h
    assert set(hist["port"]) == set(hist["jax"])
    nt, nj = len(hist["port"]["event"]), len(hist["jax"]["event"])
    assert nt <= MV_SLACK * nj and nj <= MV_SLACK * nt
    # each record holds the window's first min(cwin, k) values
    for key in ("hvals", "resnorms"):
        assert ({np.shape(r) for r in hist["port"][key]}
                == {np.shape(r) for r in hist["jax"][key]} == {(4,)})
    # the inner replay: one [num_inner, blk, 3] slice per record
    assert len(hist["port"]["inner"]) == nt
    assert sum(len(r) for r in hist["port"]["inner"]) == \
        int(np.sum(hist["port"]["num_inner"]))


_LINE = re.compile(
    r"^(OUT|INN|RST|RES|CNV|LCK) it=\s*\d+ mv=\s*\d+ lock=\s*\d+ "
    r"conv=\s*\d+ b=\s*\d+ inner=\s*\d+ val\[0\]=[+-]\d\.\d{10}e[+-]\d\d "
    r"res\[0\]=\d\.\d{3}e[+-]\d\d$")
_INN = re.compile(r"^INN it=\s*\d+ qmr=\s*\d+ alive=\d+ "
                  r"val\[0\]=[+-]\d\.\d{10}e[+-]\d\d "
                  r"eres\[0\]=\d\.\d{3}e[+-]\d\d$")


@pytest.mark.parametrize("level", [2, 4])
def test_print_level_lines(tridiag, capsys, level):
    A, _ = tridiag
    prefixes = {}
    for pkg in ("port", "jax"):
        _eigsh(pkg, A, k=3, which="SA", tol=1e-8, method="JDQMR",
               printLevel=level, maxMatvecs=600,
               raise_for_unconverged=False)
        if pkg == "jax":
            import jax
            jax.effects_barrier()
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
        assert lines, pkg
        for ln in lines:
            assert _LINE.match(ln) or (level >= 4 and _INN.match(ln)), \
                (pkg, ln)
        # the inner-iteration replay lines appear only at printLevel >= 4
        qmr = [ln for ln in lines if " qmr=" in ln]
        assert bool(qmr) == (level >= 4), pkg
        prefixes[pkg] = {ln.split()[0] for ln in lines}
    assert prefixes["port"] == prefixes["jax"]


def test_svds_monitor_and_history(rect):
    A, sv = rect
    lens = {}
    for pkg in ("port", "jax"):
        seen = []

        def mon(stage, event, num_outer, num_matvecs, num_locked,
                num_converged, basis_size, num_inner, svals, resnorms):
            seen.append((stage, int(event)))

        kw = dict(k=3, which="SM", tol=1e-9, monitor=mon, return_stats=True,
                  return_history=True)
        if pkg == "port":
            _, s, _, st = ptt.svds(A, device="cpu", **kw)
        else:
            _, s, _, st = primme_tpu.svds(A, **kw)
        stages = {sgt for sgt, _ in seen}
        assert 1 in stages, pkg   # stage-1 (normal equations) events
        h = st["hist"]
        assert len(h["stage"]) == len(seen) and len(h["svals"]) == len(seen)
        # history values on the TRIPLET scale: stage 1 records sqrt(theta)
        smax = sv[-1]
        for sgt, sval_rec in zip(h["stage"], h["svals"]):
            assert np.nanmax(np.abs(np.asarray(sval_rec, float))) < 3 * smax
        assert np.abs(np.sort(s) - sv[:3]).max() < 1e-7 * sv[-1]
        lens[pkg] = (len(seen), set(h))
    assert lens["port"][1] == lens["jax"][1]
    nt, nj = lens["port"][0], lens["jax"][0]
    assert nt <= MV_SLACK * nj and nj <= MV_SLACK * nt


def test_svds_segment_outer(rect):
    A, sv = rect
    runs = [ptt.svds(A, k=3, which="SM", tol=1e-9, device="cpu",
                     return_stats=True, segment_outer=seg)
            for seg in (None, 4)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for stage in ("stage1", "stage2"):
        assert (runs[0][3][f"{stage}_num_matvecs"]
                == runs[1][3][f"{stage}_num_matvecs"])
