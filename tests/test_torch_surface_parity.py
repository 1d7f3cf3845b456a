"""The port's last surface against the JAX package, on the CPU (x64 on, as
``tests/conftest.py`` sets it), on the same numpy inputs:

* ``to_dense()`` of every operator type, f32 and f64 and, where the type
  serves it, complex64 and complex128; within 1e-5 (single) or 1e-12
  (double) of the largest entry of the JAX package's matrix;
* ``ELLOperator.from_coo`` (repeated entries summed; square and
  rectangular) against the JAX package's ``from_coo(...).to_dense()`` and
  scipy, to the same tolerance;
* ``solve_eigs(debug=True)``: both packages print a line an outer
  iteration with the same fields, from a shared ``v0`` and the probe off,
  as many lines, with equal ``it``/``b``/``lock``/``nconv``/``nunc``;
* ``solve_eigs(generator=)``: a CPU generator seeded ``s`` gives the
  results of ``rng_seed=s`` bit for bit;
* ``PTPU_PROBE_ITERS=2`` and ``PTPU_PROBE_DEBUG=2`` in a child process of
  each package: the probe's matvecs drop in both, and both print the
  reference's probe-round and probe-iteration lines with its fields.
"""

import os
import re
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from primme_tpu import operators as JO
from primme_tpu import params as jp
from primme_tpu.core.inner import jdqmr_inner_solve as j_jdqmr
from primme_tpu.core.solver import solve_eigs as j_solve
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import params_from_jax
from primme_tpu_torch.core.inner import jdqmr_inner_solve as t_jdqmr
from primme_tpu_torch.core.solver import solve_eigs as t_solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = ("float32", "float64")
ALL = REAL + ("complex64", "complex128")
TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12,
       "complex128": 1e-12}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, dt):
    a = rng.normal(size=shape)
    if np.dtype(dt).kind == "c":
        a = a + 1j * rng.normal(size=shape)
    return a.astype(dt)


def _sparse(rng, m, n, dt, density=0.15):
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    if np.dtype(dt).kind == "c":
        A = A + 1j * sp.random(m, n, density=density, random_state=rng,
                               format="csr")
    return A.astype(dt)


def _banded(rng, n, dt):
    offs = (-3, 0, 2, 5)
    return sp.diags([_rand(rng, n - abs(o), dt) for o in offs], offs,
                    format="csr")


def _windowed_matrix(dt):
    # a band of half-width 7: WE.pack's smallest packable case (n = 256)
    n = 256
    return sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                     0.5 * np.ones(n - 7), 0.5 * np.ones(n - 7)],
                    [0, 1, -1, 7, -7], format="csr").astype(dt)


def _columns(op, n, dt, width=8):
    """The JAX package's ``to_dense()`` taken 8 identity columns at a time:
    its f32 windowed product unrolls a loop a column in the Pallas kernel
    (interpreted on the CPU), so the whole identity at once does not
    compile in a test's time."""
    import jax

    eye = jnp.eye(n, dtype=dt)
    mm = jax.jit(op.matmat)
    return np.concatenate([np.asarray(mm(eye[:, j:j + width]))
                           for j in range(0, n, width)], axis=1)


def _pair(kind, dt):
    """``(jax_dense, port_operator)`` of one operator type, built from the
    same numpy inputs."""
    rng = np.random.default_rng(zlib.crc32(f"{kind}:{dt}".encode()))
    tdt = getattr(torch, dt)
    if kind == "dense":
        M = _rand(rng, (30, 30), dt)
        return JO.DenseOperator(M).to_dense(), ptt.DenseOperator(M)
    if kind == "diagonal":
        d = _rand(rng, (30,), dt)
        return JO.DiagonalOperator(d).to_dense(), ptt.DiagonalOperator(d)
    if kind in ("ell", "ell_rect"):
        A = _sparse(rng, 40, 40 if kind == "ell" else 23, dt)
        return (JO.ELLOperator.from_scipy(A).to_dense(),
                ptt.ELLOperator.from_scipy(A))
    if kind == "block_ell":
        A = _sparse(rng, 48, 48, dt, density=0.05)
        return (JO.BlockELLOperator.from_scipy(A, 8).to_dense(),
                ptt.BlockELLOperator.from_scipy(A, 8))
    if kind == "banded":
        A = _banded(rng, 40, dt)
        return (JO.BandedOperator.from_scipy(A).to_dense(),
                ptt.BandedOperator.from_scipy(A))
    if kind == "windowed":
        A = _windowed_matrix(dt)
        return (_columns(JO.WindowedELLOperator.from_scipy(A), 256, dt),
                ptt.WindowedELLOperator.from_scipy(A))
    if kind == "stencil":
        return (JO.Stencil3DOperator(5, 4, 3, dtype=dt, scale=1.5).to_dense(),
                ptt.Stencil3DOperator(5, 4, 3, dtype=tdt, scale=1.5,
                                      device="cpu"))
    if kind == "function":
        M = _rand(rng, (30, 30), dt)
        Mj, Mt = jnp.asarray(M), torch.from_numpy(M)
        return (JO.FunctionOperator(lambda X: Mj @ X, M.shape, dt).to_dense(),
                ptt.FunctionOperator(lambda X: Mt @ X, M.shape, tdt,
                                     device="cpu"))
    if kind == "jacobi":
        d = _rand(rng, (30,), dt)
        d[3] = 1e-12                       # the eps clamp
        return JO.JacobiPrecond(d).to_dense(), ptt.JacobiPrecond(d)
    if kind == "chebyshev":
        Q = np.linalg.qr(rng.normal(size=(30, 30)))[0]
        M = ((Q * np.linspace(0.2, 9.0, 30)) @ Q.T).astype(dt)
        return (JO.ChebyshevPrecond(JO.DenseOperator(M), (0.5, 10.0),
                                    degree=5).to_dense(),
                ptt.ChebyshevPrecond(ptt.DenseOperator(M), (0.5, 10.0),
                                     degree=5))
    if kind == "sum":
        A, R = _banded(rng, 40, dt), _sparse(rng, 40, 40, dt, density=0.05)
        return (JO.SumOperator([JO.BandedOperator.from_scipy(A),
                                JO.ELLOperator.from_scipy(R)]).to_dense(),
                ptt.SumOperator([ptt.BandedOperator.from_scipy(A),
                                 ptt.ELLOperator.from_scipy(R)]))
    if kind == "cast":
        # an operator of the other precision, cast to dt
        other = {"float32": "float64", "float64": "float32",
                 "complex64": "complex128", "complex128": "complex64"}[dt]
        M = _rand(rng, (30, 30), other)
        return (JO.CastOperator(JO.DenseOperator(M), dt).to_dense(),
                ptt.CastOperator(ptt.DenseOperator(M), tdt))
    raise KeyError(kind)


TYPES = {"dense": ALL, "diagonal": ALL, "ell": ALL, "ell_rect": ALL,
         "block_ell": ALL, "banded": ALL, "windowed": REAL, "stencil": REAL,
         "function": ALL, "jacobi": ALL, "chebyshev": REAL, "sum": ALL,
         "cast": ALL}


@pytest.mark.parametrize("kind,dt", [(k, d) for k, ds in TYPES.items()
                                     for d in ds])
def test_to_dense_matches_reference(kind, dt):
    ref, op = _pair(kind, dt)
    ref = np.asarray(ref)
    D = op.to_dense()
    assert isinstance(D, torch.Tensor) and D.device == torch.device("cpu")
    assert D.dtype == getattr(torch, dt)
    assert tuple(D.shape) == ref.shape == tuple(op.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(D.numpy() - ref).max() <= TOL[dt] * scale


def test_dense_to_dense_is_its_matrix():
    M = np.arange(12.0).reshape(3, 4)
    op = ptt.DenseOperator(M)
    assert op.to_dense() is op.A


@pytest.mark.parametrize("shape", [(30, 30), (30, 17)])
@pytest.mark.parametrize("dt", REAL + ("complex128",))
def test_from_coo_matches_reference(shape, dt):
    rng = np.random.default_rng(11)
    m, n = shape
    nnz = 120
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    rows[:5], cols[:5] = rows[5:10], cols[5:10]    # repeated entries
    vals = _rand(rng, (nnz,), dt)
    ref = np.asarray(JO.ELLOperator.from_coo(rows, cols, vals,
                                             shape).to_dense())
    op = ptt.ELLOperator.from_coo(rows, cols, vals, shape)
    assert isinstance(op, ptt.ELLOperator) and op.shape == shape
    assert op.device == torch.device("cpu")
    D = op.to_dense().numpy()
    truth = sp.coo_matrix((vals, (rows, cols)), shape=shape).toarray()
    scale = float(np.abs(truth).max())
    assert np.abs(D - ref).max() <= TOL[dt] * scale
    assert np.abs(D - truth).max() <= TOL[dt] * scale


def _tridiag(n=200):
    return sp.diags([np.arange(1, n + 1.0), 0.3 * np.ones(n - 1),
                     0.3 * np.ones(n - 1)], [0, 1, -1], format="csr")


_FIELDS = ("it", "b", "lock", "nconv", "nunc", "res0", "hv0", "mincol",
           "VtQ", "minQ", "minconvX")


def _parse(lines):
    out = []
    for ln in lines:
        kv = dict(re.findall(r"(\w+)=(\S+)", ln))
        assert tuple(kv) == _FIELDS, ln
        out.append(kv)
    return out


@pytest.mark.parametrize("method", ["GD_Olsen_plusK", "JDQMR_ETol"])
def test_debug_lines_match_reference(method, capfd):
    import jax

    n = 200
    A = _tridiag(n)
    p = jp.set_method(getattr(jp.Method, method), jp.PrimmeParams(
        n=n, num_evals=3, eps=1e-8, max_basis_size=16, max_block_size=1,
        verify_spectrum=0))
    v0 = np.random.default_rng(0).normal(size=(n, 1))
    jin, tin = (j_jdqmr, t_jdqmr) if method == "JDQMR_ETol" else (None, None)
    capfd.readouterr()
    rj = j_solve(JO.ELLOperator.from_scipy(A), p, v0=jnp.asarray(v0),
                 debug=True, inner_solve=jin)
    jax.effects_barrier()
    jl = capfd.readouterr().out.splitlines()
    rt = t_solve(ptt.ELLOperator.from_scipy(A), params_from_jax(p),
                 v0=torch.as_tensor(v0), device="cpu", debug=True,
                 inner_solve=tin)
    tl = capfd.readouterr().out.splitlines()
    assert int(rj.stats.num_outer_iterations) == rt.stats.num_outer_iterations
    pj, pt = _parse(jl), _parse(tl)
    assert len(pj) == len(pt) >= rt.stats.num_outer_iterations > 0
    for a, b in zip(pj, pt):
        assert [a[k] for k in _FIELDS[:5]] == [b[k] for k in _FIELDS[:5]]
    # without debug, nothing is printed
    t_solve(ptt.ELLOperator.from_scipy(A), params_from_jax(p),
            v0=torch.as_tensor(v0), device="cpu", inner_solve=tin)
    assert capfd.readouterr().out == ""


def test_generator_equals_rng_seed_bit_for_bit():
    # no v0: the initial basis, block_ortho's replacements and the probe
    # all draw from the stream
    n = 200
    op = ptt.ELLOperator.from_scipy(_tridiag(n))
    p = ptt.set_method(ptt.Method.JDQMR_ETol, ptt.PrimmeParams(
        n=n, num_evals=3, eps=1e-8, max_basis_size=16, max_block_size=2))
    kw = dict(device="cpu", inner_solve=t_jdqmr)
    r1 = t_solve(op, p.with_(rng_seed=7), **kw)
    r2 = t_solve(op, p.with_(rng_seed=0), **kw,
                 generator=torch.Generator().manual_seed(7))
    r0 = t_solve(op, p.with_(rng_seed=0), **kw)
    assert r1.stats.num_probe_rounds > 0
    for a, b in ((r1.evals, r2.evals), (r1.evecs, r2.evecs),
                 (r1.resnorms, r2.resnorms)):
        assert torch.equal(a, b)
    assert r1.stats == r2.stats
    assert not torch.equal(r0.evecs, r1.evecs)


_CHILD = textwrap.dedent("""
    import os, sys
    import numpy as np, scipy.sparse as sp
    n = 200
    A = sp.diags([np.arange(1, n + 1.0), 0.3 * np.ones(n - 1),
                  0.3 * np.ones(n - 1)], [0, 1, -1], format="csr")
    v0 = np.random.default_rng(0).normal(size=(n, 1))
    kw = dict(n=n, num_evals=3, eps=1e-8, max_basis_size=16,
              max_block_size=1)
    if sys.argv[1] == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from primme_tpu import operators as O, params as P
        from primme_tpu.core.solver import solve_eigs
        p = P.set_method(P.Method.GD_Olsen_plusK, P.PrimmeParams(**kw))
        r = solve_eigs(O.ELLOperator.from_scipy(A), p, v0=jnp.asarray(v0))
        jax.effects_barrier()
    else:
        import torch
        import primme_tpu_torch as T
        p = T.set_method(T.Method.GD_Olsen_plusK, T.PrimmeParams(**kw))
        r = T.solve_eigs(T.ELLOperator.from_scipy(A), p,
                         v0=torch.as_tensor(v0), device="cpu")
    print("PROBE_MATVECS", int(r.stats.num_probe_matvecs),
          int(r.stats.num_probe_rounds), flush=True)
""")


def _child(pkg, env):
    e = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **env)
    out = subprocess.run([sys.executable, "-c", _CHILD, pkg], env=e,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    mv, rounds = map(int, re.search(r"PROBE_MATVECS (\d+) (\d+)",
                                    out).groups())
    return out, mv, rounds


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_probe_env_switches_in_a_child(pkg):
    env0 = {"PTPU_PROBE_ITERS": "32", "PTPU_PROBE_DEBUG": ""}
    _, mv32, r32 = _child(pkg, env0)
    out, mv2, r2 = _child(pkg, {"PTPU_PROBE_ITERS": "2",
                                "PTPU_PROBE_DEBUG": "2"})
    assert r32 > 0 and r2 > 0
    assert mv2 < mv32, (mv2, mv32)
    rounds = [ln for ln in out.splitlines() if ln.startswith("probe round")]
    its = [ln for ln in out.splitlines() if ln.startswith("  it ")]
    assert len(rounds) == r2
    for ln in rounds:
        assert re.fullmatch(r"probe round \d+: found=\S+ valid=\S+ "
                            r"clean=\d+ mv=\d+ bar=\S+", ln), ln
    assert its
    for ln in its:
        m = re.fullmatch(r"  it (\d+): key0=\S+ bar=\S+ stall=\d+ srvp=\d+",
                         ln)
        assert m and int(m.group(1)) < 2, ln
