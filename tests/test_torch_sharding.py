"""The port's row-partitioned solves (``eigsh(mesh=)``, ``svds(mesh=)``,
``dryrun_multichip``) against the JAX package's sharded runs and the
port's unsharded ones.

``tests/test_sharding.py``'s four cases run through both packages: the
JAX package on a mesh of the first 4 of the conftest's 8 CPU devices, the
port on 4 gloo ranks, and again on 2 (``test_torch_ranks.world_solves``,
one spawned world each), each held at the JAX test's tolerance. Then the
port sharded against the port unsharded from the same seed (f64 values
within 1e-10, matvecs within ``mv_slack=2``: the order of summation
differs, so the runs are not bitwise equal), the halo chooser's solve on
``_band_matrix(2048, 150, 2, seed=7)`` with vectors in the caller's order,
every rank's bytes equal, DYNAMIC under per-rank clocks following rank
0's method trace, and ``dryrun_multichip`` on 2 and 4 ranks.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import primme_tpu as pt
import primme_tpu_torch as ptt
from primme_tpu_torch import distributed as D

from test_torch_ranks import band_matrix, run_world, tridiag

MV_SLACK = 2


@pytest.fixture(scope="module")
def mesh4():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return Mesh(np.array(devs[:4]), ("rows",))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solves")
    return {4: run_world(tmp, 4, "world_solves", True),
            2: run_world(tmp, 2, "world_solves", False)}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's sharded run of a case, once for both ``P``."""
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("rows",))
    with mesh4:
        if case == "tridiag":
            return pt.eigsh(tridiag(), k=4, which="SA", tol=1e-9, mesh=mesh4,
                            raise_for_unconverged=False)[0]
        if case == "stencil":
            return pt.eigsh(pt.Stencil3DOperator(16, 8, 8, dtype=np.float32),
                            k=3, which="SA", tol=1e-4, mesh=mesh4,
                            jacobi=True, raise_for_unconverged=False)[0]
        if case == "svds_lm":
            M = np.random.default_rng(5).normal(size=(256, 160))
            return pt.svds(M, k=3, which="LM", tol=1e-9, mesh=mesh4)[1]
        M = np.random.default_rng(6).normal(size=(250, 158))
        return pt.svds(M, k=3, which="SM", tol=1e-9, mesh=mesh4)[1]


def _ax(N):
    return 2 - 2 * np.cos(np.pi * np.arange(1, N + 1) / (N + 1))


@pytest.mark.parametrize("P", [4, 2])
def test_eigsh_sharded_matches_single(mesh4, worlds, P):
    A = tridiag()
    ref = np.linalg.eigvalsh(A.toarray())
    wj = _jax_run("tridiag")
    w = worlds[P][0]["tridiag"]["w"]
    assert np.abs(np.sort(w) - ref[:4]).max() < 1e-7
    assert np.abs(np.sort(wj) - ref[:4]).max() < 1e-7
    assert np.abs(np.sort(w) - np.sort(wj)).max() < 1e-7


@pytest.mark.parametrize("P", [4, 2])
def test_stencil_sharded(mesh4, worlds, P):
    lam = np.sort((_ax(16)[:4, None, None] + _ax(8)[None, :4, None]
                   + _ax(8)[None, None, :4]).ravel())[:3]
    wj = _jax_run("stencil")
    w = worlds[P][0]["stencil"]["w"]
    assert np.abs(np.sort(w) - lam).max() < 1e-2
    assert np.abs(np.sort(wj) - lam).max() < 1e-2


@pytest.mark.parametrize("P", [4, 2])
def test_svds_stage1_sharded(mesh4, worlds, P):
    M = np.random.default_rng(5).normal(size=(256, 160))
    sref = np.linalg.svd(M, compute_uv=False)
    sj = _jax_run("svds_lm")
    s = worlds[P][0]["svds_lm"]["s"]
    assert np.abs(np.sort(s) - np.sort(sref)[-3:]).max() < 1e-7 * sref[0]
    assert np.abs(np.sort(sj) - np.sort(sref)[-3:]).max() < 1e-7 * sref[0]


@pytest.mark.parametrize("P", [4, 2])
def test_svds_two_stage_hybrid_sharded(mesh4, worlds, P):
    M = np.random.default_rng(6).normal(size=(250, 158))
    sref = np.sort(np.linalg.svd(M, compute_uv=False))
    _, s1, _ = ptt.svds(M, k=3, which="SM", tol=1e-9, device="cpu")
    sj = _jax_run("svds_sm")
    r = worlds[P][0]["svds_sm"]
    U, s, Vt = r["U"], r["s"], r["Vt"]
    for vals in (s, sj):
        assert np.abs(np.sort(vals) - sref[:3]).max() < 1e-7 * sref[-1]
    assert np.abs(np.sort(s) - np.sort(s1)).max() < 1e-7 * sref[-1]
    R1 = M @ Vt.conj().T - U * s[None, :]
    R2 = M.T @ U - Vt.conj().T * s[None, :]
    rn = np.sqrt((R1 ** 2).sum(0) + (R2 ** 2).sum(0))
    assert rn.max() < 1e-7 * sref[-1]


@pytest.mark.parametrize("P", [4, 2])
def test_sharded_matches_unsharded_port(worlds, P):
    """The same seed sharded and unsharded: f64 values within 1e-10 and
    matvecs within ``MV_SLACK``; the sharded stats count the sums made."""
    torch.set_num_threads(1)
    w1, _, st1 = ptt.eigsh(tridiag(), k=4, which="SA", tol=1e-9,
                           device="cpu", raise_for_unconverged=False,
                           return_stats=True)
    r = worlds[P][0]["tridiag"]
    assert np.abs(np.sort(r["w"]) - np.sort(w1)).max() <= 1e-10
    mv, mv1 = r["mv"], st1["num_matvecs"]
    assert mv <= MV_SLACK * mv1 and mv1 <= MV_SLACK * mv
    assert r["gsum"] > 0


def test_eigsh_mesh_uses_halo_and_matches(worlds):
    """``tests/test_distributed.py``'s end-to-end case: 301 distinct
    offsets defeat the banded chooser, the halo partition takes it, and
    the vectors come back in the caller's order."""
    A = band_matrix(2048, 150, 2, seed=7)
    ref = np.linalg.eigvalsh(A.toarray())
    r = worlds[4][0]["band"]
    assert r["exchanges"] > 0          # the halo operator's products
    vals, vecs = r["w"], r["V"]
    assert np.abs(np.sort(vals) - ref[:4]).max() < 1e-6
    R = A @ vecs - vecs * vals[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6 * np.abs(ref).max()
    op = D.pack(A, 4)
    assert op is not None and op.halo <= 512


@pytest.mark.parametrize("P", [4, 2])
def test_time_breakdown_under_a_mesh(worlds, P):
    # no device trace on the CPU: the estimate, on each rank's rows
    for r in worlds[P]:
        assert r["breakdown"]["source"] == "estimated"
        assert r["breakdown"]["matvec"] > 0


@pytest.mark.parametrize("P", [4, 2])
def test_every_rank_returns_the_same_bytes(worlds, P):
    digests = {r["digest"] for r in worlds[P]}
    assert len(digests) == 1
    for r in worlds[P][1:]:
        for case in ("tridiag", "svds_sm"):
            for key, val in worlds[P][0][case].items():
                if isinstance(val, np.ndarray):
                    assert np.array_equal(r[case][key], val), (case, key)


def test_dynamic_follows_rank0(worlds):
    """Per-rank clocks time the segments differently; every rank follows
    rank 0's choices and returns the same values."""
    runs = [r["dynamic"] for r in worlds[4]]
    assert all(r["trace"] == runs[0]["trace"] for r in runs)
    assert len(set(runs[0]["trace"])) == 2
    assert any(r["seconds"] != runs[0]["seconds"] for r in runs[1:])
    for r in runs[1:]:
        assert np.array_equal(r["w"], runs[0]["w"])
    ref = np.linalg.eigvalsh(tridiag(300).toarray())[:5]
    assert np.abs(np.sort(runs[0]["w"]) - ref).max() < 1e-7


@pytest.mark.parametrize("P", [2, 4])
def test_dryrun_multichip(P):
    # spawns its own P ranks (outside a process group) and asserts inside
    assert D.dryrun_multichip(P, device="cpu") == {}
