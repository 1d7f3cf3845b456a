"""The halo-exchange row partition (``primme_tpu_torch.distributed``)
against the JAX package's (``primme_tpu.distributed``).

Each case of ``tests/test_distributed.py`` through both packages: the JAX
package on a mesh of the first 4 of the conftest's 8 CPU devices, the port
on 4 gloo ranks (one spawned world, ``test_torch_ranks.world_halo``, for
every case). The packs are equal array for array; the sharded products
agree with the JAX package's and with scipy to 1e-12 relative in f64; an
inner rank sends exactly two ``[h, k]`` segments a product and gathers
nothing; the interior rows do not read the exchanged rows.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from primme_tpu.distributed import HaloELLOperator as JaxHalo
from primme_tpu_torch import distributed as D

from test_torch_ranks import (band_matrix, block_diagonal, rcm_case,
                              run_world)

NR = 4


@pytest.fixture(scope="module")
def mesh4():
    devs = jax.devices()
    if len(devs) < NR:
        pytest.skip(f"needs {NR} virtual devices")
    return Mesh(np.array(devs[:NR]), ("rows",))


def _jax_product(op, X, mesh):
    Xd = jax.device_put(X, NamedSharding(mesh, P("rows", None)))
    with mesh:
        return np.asarray(jax.jit(op.matmat)(Xd))


CASES = {"band": (lambda: band_matrix(1024, 3, 3), False, 1, 8),
         "blockdiag": (block_diagonal, False, 3, 4),
         "rcm": (rcm_case, True, 6, 4)}


@pytest.fixture(scope="module")
def world(mesh4, tmp_path_factory):
    """The port's 4 ranks, once for the module, with the JAX package's
    band operator carried across by rank."""
    jop, _ = JaxHalo.from_scipy(band_matrix(1024, 3, 3), mesh4,
                                try_rcm=False)

    arrays = SimpleNamespace(      # the JAX operator's arrays as numpy
        cols=np.asarray(jop.cols), vals=np.asarray(jop.vals),
        diag=np.asarray(jop.diag), halo=jop.halo, hrows=jop.hrows,
        shape=jop.shape)
    return run_world(tmp_path_factory.mktemp("halo"), NR, "world_halo",
                     arrays)


def _gather(world, case, key):
    return np.concatenate([r[case][key] for r in world])


@pytest.mark.parametrize("case", list(CASES))
def test_pack_parity(mesh4, world, case):
    make, rcm, _, _ = CASES[case]
    A = make()
    jop, jperm = JaxHalo.from_scipy(A, mesh4, try_rcm=rcm)
    pk = D.pack(A, NR, try_rcm=rcm)
    for name in ("cols", "vals", "diag"):
        ref = np.asarray(getattr(jop, name))
        assert np.array_equal(getattr(pk, name), ref), name
        # each rank holds its rows of the same arrays
        assert np.array_equal(_gather(world, case, name), ref), name
    assert pk.halo == jop.halo == world[0][case]["halo"]
    assert pk.hrows == jop.hrows == world[0][case]["hrows"]
    if jperm is None:
        assert pk.perm is None and world[0][case]["perm"] is None
    else:
        assert np.array_equal(pk.perm, jperm)
        assert np.array_equal(world[0][case]["perm"], jperm)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_product(mesh4, world, case):
    make, rcm, seed, k = CASES[case]
    A = make()
    n = A.shape[0]
    X = np.random.default_rng(seed).normal(size=(n, k))
    jop, perm = JaxHalo.from_scipy(A, mesh4, try_rcm=rcm)
    Xp = X if perm is None else X[perm]
    Yj = _jax_product(jop, Xp, mesh4)
    Y = _gather(world, case, "Y")
    ref = A @ X if perm is None else (A @ X)[perm]
    scale = abs(A).sum(axis=1).max()
    assert np.abs(Y - ref).max() <= 1e-12 * scale
    assert np.abs(Y - Yj).max() <= 1e-12 * scale


def test_band_halo_and_rcm_shrink(world):
    band, rcm = world[0]["band"], world[0]["rcm"]
    assert band["perm"] is None and 0 < band["halo"] <= 6
    assert 0 < band["hrows"] <= band["halo"]
    assert rcm["perm"] is not None and rcm["halo"] <= 64


def test_communication_contract(world):
    """An inner rank sends exactly its two ``[h, k]`` boundary segments a
    product, the edge ranks one, and no rank all-gathers the block; the
    block-diagonal matrix has no halo and sends nothing."""
    for r in world:
        b = r["band"]
        assert b["gathers"] == 0 and r["blockdiag"]["gathers"] == 0
        n_nb = (b["rank"] > 0) + (b["rank"] < NR - 1)
        assert b["sends"] == [(b["halo"], 8)] * n_nb
        assert r["blockdiag"]["halo"] == 0 and r["blockdiag"]["sends"] == []
    inner = world[1]["band"]
    assert sum(a * c for a, c in inner["sends"]) == 2 * inner["halo"] * 8


def test_pack_rejections():
    A = sp.eye(1001, format="csr")
    assert D.pack(A, NR) is None
    assert JaxHalo.from_scipy(A, Mesh(np.array(jax.devices()[:NR]),
                                      ("rows",))) is None
    n = 256
    B = (sp.eye(n) + sp.coo_matrix(
        (np.ones(n), (np.arange(n), n - 1 - np.arange(n))),
        shape=(n, n))).tocsr()
    r = D.pack(B, NR)
    assert r is None or r.halo <= n // NR
    j = JaxHalo.from_scipy(B, Mesh(np.array(jax.devices()[:NR]), ("rows",)))
    assert (r is None) == (j is None)


def test_overlap_interior_reads_no_halo(world):
    """With the exchanged rows replaced by NaN, the interior rows come out
    equal to the full product's and the boundary rows read the NaN (on
    the ranks that have a neighbour)."""
    for r in world:
        ov = r["overlap"]
        assert ov["interior_rows"] > 0
        assert ov["interior_equal"]
        assert ov["boundary_nan"]
    assert world[0]["band"]["split"]


def test_unsharded_matmat_matches_jax():
    A = band_matrix(1024, 3, 3)
    X = np.random.default_rng(1).normal(size=(1024, 8))
    jop, _ = JaxHalo.from_scipy(A, None, try_rcm=False)
    op, perm = D.HaloELLOperator.from_scipy(A, None, try_rcm=False)
    assert perm is None
    Y = op.matmat(torch.as_tensor(X)).numpy()
    Yj = np.asarray(jop.matmat(X))
    assert np.abs(Y - Yj).max() <= 1e-12 * abs(A).sum(axis=1).max()


def test_halo_ell_from_jax_by_rank(world, mesh4):
    """``convert.halo_ell_from_jax`` keeps each rank's rows of the JAX
    package's arrays, and its product is the port's own pack's."""
    jop, _ = JaxHalo.from_scipy(band_matrix(1024, 3, 3), mesh4,
                                try_rcm=False)
    assert np.array_equal(_gather(world, "from_jax", "cols"),
                          np.asarray(jop.cols))
    assert np.array_equal(_gather(world, "from_jax", "vals"),
                          np.asarray(jop.vals))
    assert np.array_equal(_gather(world, "from_jax", "Y"),
                          _gather(world, "band", "Y"))
