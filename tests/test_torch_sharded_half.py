"""Half-precision operators (f16, bf16) under ``mesh=``: the port's
row-partitioned products and solves against the JAX package's sharded
ones.

The JAX package runs on a mesh of the first 4 of the conftest's 8 CPU
devices; the port on one spawned world of 4 gloo ranks for the module
(``test_torch_ranks.world_sharded_half``). Both packages get the same
seeded numpy inputs: the port's operators are the JAX package's carried
across by ``primme_tpu_torch/convert.py`` (a bf16 array through the bits
of its ``uint16`` view). Sizes: the 16 x 8 x 8 stencil, ``band_matrix(1024,
3, 3)`` (as a ``BandedOperator``, a ``HaloELLOperator``, a gathered
``ELLOperator`` and the ``JacobiPrecond`` of its diagonal) and the 200 x
120 incidence of ``test_torch_ranks.incidence`` for ``svds``.

Tolerances. A sharded product against the JAX package's: one unit in the
half's last place at ``max|y|`` for a half result (the JAX function under
``jax.jit`` may contract an f16 ``a * b +- c`` on a CPU with native f16
arithmetic, and the sliced ELL sums in f32 in another order), ``1e-5
max|y|`` for an f32 one (a half operator given an f32 block computes in
f32 from its half values, on the kernels' mixed entry points). Against
the port's own unsharded product, bit for bit for the stencil, the banded
form, the Jacobi rows and the gathered ELL (each row's arithmetic is the
same). Solves: the half basis' gates of ``tests/test_torch_half_ops.py``
(every true residual, in f64 against the half operator's exact matrix,
and each value's distance to the spectrum below ``16 eps(half) ||A||``),
matvecs within 2x of the JAX package's, and every rank's bytes equal.
"""

import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import primme_tpu
from primme_tpu import operators as JO
from primme_tpu.distributed import HaloELLOperator as JaxHalo
from primme_tpu_torch import convert as CV

from test_torch_ranks import (HALF_BAND, HALF_GRID, HALF_K, HALF_SOLVE_KW,
                              HALF_SOLVES, HALVES, band_matrix, half_tol,
                              incidence, run_world)

NR = 4
MV_SLACK = 2


def _eps(half):
    return float(jnp.finfo(jnp.dtype(half)).eps)


def _mesh():
    devs = jax.devices()
    if len(devs) < NR:
        pytest.skip(f"needs {NR} virtual devices")
    return Mesh(np.array(devs[:NR]), ("rows",))


def _half_matrix(A, half):
    """``A`` (f32) with every entry rounded to the half type, in f64: the
    exact matrix of the half operator built from it."""
    B = A.tocsr().copy()
    B.data = np.asarray(jnp.asarray(B.data).astype(jnp.dtype(half))
                        .astype(jnp.float64))
    return B


def _stencil_matrix():
    def T(m):
        return sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                        [-1, 0, 1])
    nx, ny, nz = HALF_GRID
    I = sp.identity
    return (sp.kron(sp.kron(T(nx), I(ny)), I(nz))
            + sp.kron(sp.kron(I(nx), T(ny)), I(nz))
            + sp.kron(sp.kron(I(nx), I(ny)), T(nz))).tocsr()


@functools.lru_cache(maxsize=None)
def _jax_ops(half):
    """The JAX package's half operators of this file, by name."""
    hd = jnp.dtype(half)
    A = band_matrix(*HALF_BAND).astype(np.float32)
    B = JO.BandedOperator.from_scipy(sp.dia_matrix(A))
    banded = JO.BandedOperator(B.offsets, B.vals.astype(hd), B.shape)
    cols, vals = JO.ELLOperator._pack(A)
    h0, _ = JaxHalo.from_scipy(A, _mesh(), try_rcm=False)
    halo = JaxHalo(h0.cols, h0.vals.astype(hd), h0.diag.astype(hd),
                   h0.shape, h0.halo, mesh=_mesh(), hrows=h0.hrows)
    M = incidence()
    mc, mv = JO.ELLOperator._pack(M)
    mcT, mvT = JO.ELLOperator._pack(M.T.tocsr())
    return {"stencil": JO.Stencil3DOperator(*HALF_GRID, dtype=hd),
            "banded": banded,
            "jacobi": JO.JacobiPrecond(banded.diagonal()),
            "ell": JO.ELLOperator(cols, jnp.asarray(vals).astype(hd)),
            "halo": halo,
            "svd": JO.ELLOperator(mc, jnp.asarray(mv).astype(jnp.float16),
                                  shape=M.shape, colsT=mcT,
                                  valsT=jnp.asarray(mvT).astype(jnp.float16))}


def _halo_arrays(jop):
    """A JAX ``HaloELLOperator``'s arrays as numpy (bf16 as numpy's
    ``bfloat16`` extension type), as ``convert.halo_ell_from_jax`` reads
    them."""
    return SimpleNamespace(cols=np.asarray(jop.cols), vals=np.asarray(jop.vals),
                           diag=np.asarray(jop.diag), halo=jop.halo,
                           hrows=jop.hrows, shape=jop.shape)


def _jax_product(fn, X, *args):
    mesh = _mesh()
    Xd = jax.device_put(X, NamedSharding(mesh, P("rows", None)))
    with mesh:
        return np.asarray(jax.jit(fn)(Xd, *args).astype(jnp.float32))


def _blocks():
    """The products' f32 blocks (the world draws the same)."""
    rng = np.random.default_rng(11)
    return {"stencil": rng.standard_normal((int(np.prod(HALF_GRID)),
                                            HALF_K)).astype(np.float32),
            "band": rng.standard_normal((HALF_BAND[0], HALF_K)
                                        ).astype(np.float32)}


def _solve_case(name):
    """The JAX package's call of one of ``HALF_SOLVES`` (or ``svds_f16``)
    under the mesh, the exact matrix and its spectrum."""
    if name == "svds_f16":
        jop = _jax_ops("float16")["svd"]
        M = _half_matrix(incidence(), "float16")

        def run():
            with _mesh():
                return primme_tpu.svds(
                    jop, k=3, which="LM", tol=half_tol("float16"),
                    mesh=_mesh(), return_stats=True,
                    raise_for_unconverged=False)
        return run, M, np.linalg.svd(M.toarray(), compute_uv=False)
    kind, half, working = HALF_SOLVES[name]
    ops = _jax_ops(half)
    kw = dict(HALF_SOLVE_KW, tol=half_tol(half), mesh=_mesh(),
              dtype=None if working is None else jnp.dtype(working))
    if kind == "stencil":
        A = _stencil_matrix()
        kw["OPinv"] = JO.JacobiPrecond(ops["stencil"].diagonal())
    else:
        A = _half_matrix(band_matrix(*HALF_BAND).astype(np.float32), half)

    def run():
        with _mesh():
            return primme_tpu.eigsh(ops[kind], **kw)
    return run, A, np.linalg.eigvalsh(A.toarray())


SOLVES = list(HALF_SOLVES) + ["svds_f16"]


@pytest.fixture(scope="module", autouse=True)
def jax_solves():
    """The JAX package's sharded solves of this file, started side by side
    in threads when the module's first test starts (XLA releases the
    interpreter while it compiles): name -> a future of the result."""
    _mesh()
    pool = ThreadPoolExecutor(len(SOLVES))
    futures = {name: pool.submit(_solve_case(name)[0]) for name in SOLVES}
    pool.shutdown(wait=False)
    yield futures
    for f in futures.values():
        f.result()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's 4 ranks, once for the module: the JAX package's
    operators carried across by ``convert.py``."""
    ops = {}
    for half in HALVES:
        j = _jax_ops(half)
        ops[half] = {"stencil": CV.stencil_from_jax(j["stencil"],
                                                    device="cpu"),
                     "banded": CV.banded_from_jax(j["banded"]),
                     "jacobi": CV.jacobi_from_jax(j["jacobi"]),
                     "ell": CV.ell_from_jax(j["ell"])}
    ops["float16"]["svd"] = CV.ell_from_jax(_jax_ops("float16")["svd"])
    halo = {half: _halo_arrays(_jax_ops(half)["halo"]) for half in HALVES}
    return run_world(tmp_path_factory.mktemp("sharded_half"), NR,
                     "world_sharded_half", ops, halo)


def _gather(world, half, key):
    return np.concatenate([r["products"][half][key]["Y"] for r in world])


# ---------------------------------------------------------------------------
# convert.halo_ell_from_jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", HALVES)
def test_halo_ell_from_jax_carries_half_values(half):
    """The JAX package's ``HaloELLOperator`` with half values through
    ``convert.halo_ell_from_jax`` (one rank): its values and diagonal bit
    for bit, its layout's values the same half values (built from their
    exact f32 values), its product within one half ulp of the JAX
    package's unsharded one."""
    A = band_matrix(*HALF_BAND).astype(np.float32)
    hd = jnp.dtype(half)
    h0, _ = JaxHalo.from_scipy(A, None, try_rcm=False)
    jop = JaxHalo(h0.cols, h0.vals.astype(hd), h0.diag.astype(hd), h0.shape,
                  h0.halo, hrows=h0.hrows)
    top = CV.halo_ell_from_jax(jop)
    dt = getattr(torch, half)
    bits = CV.tensor_from_numpy(np.asarray(jop.vals)).view(torch.int16)
    assert top.vals.dtype == dt and torch.equal(top.vals.view(torch.int16),
                                                bits)
    assert top.diag.dtype == dt and torch.equal(
        top.diag.view(torch.int16),
        CV.tensor_from_numpy(np.asarray(jop.diag)).view(torch.int16))
    assert top.dtype == dt and top.all_vals.dtype == dt
    # the layout's stored values (its slices' padding aside)
    jv = np.asarray(jop.vals.astype(jnp.float32))
    lv = top.all_vals.float().numpy()
    assert np.array_equal(np.sort(lv[lv != 0]), np.sort(jv[jv != 0]))
    X = _blocks()["band"]
    Xj = jnp.asarray(X).astype(hd)
    Y = top.matmat(CV.tensor_from_numpy(np.asarray(Xj)))
    Yj = np.asarray(jop.matmat(Xj).astype(jnp.float32))
    assert Y.dtype == dt
    ymax = np.abs(Yj).max()
    assert np.abs(Y.float().numpy() - Yj).max() <= _ulp(ymax, half)


def _ulp(y, half):
    """One unit in the half's last place at |y|."""
    return float(np.exp2(np.floor(np.log2(y))) * _eps(half))


# ---------------------------------------------------------------------------
# the sharded products
# ---------------------------------------------------------------------------

PRODUCTS = ["stencil", "banded", "halo", "ell", "jacobi"]


@pytest.mark.parametrize("block", ["half", "f32"])
@pytest.mark.parametrize("name", PRODUCTS)
@pytest.mark.parametrize("half", HALVES)
def test_sharded_product_matches_jax(world, half, name, block):
    """Each sharded half product, gathered over the ranks, against the
    JAX package's sharded product of the same operator and block: a half
    block gives a half result, an f32 block an f32 one (the stencil alone
    casts the block to its type, in both packages)."""
    j = _jax_ops(half)[name]
    hd = jnp.dtype(half)
    X = _blocks()["stencil" if name == "stencil" else "band"]
    Xj = jnp.asarray(X).astype(hd if block == "half" else jnp.float32)
    if name == "jacobi":
        s = jnp.stack([j.d[5].astype(Xj.dtype), jnp.asarray(0.7, Xj.dtype)])
        Yj = _jax_product(j.matmat_shifted, Xj, s)
    else:
        Yj = _jax_product(j.matmat, Xj)
    Y = _gather(world, half, f"{name}_{block}")
    out = world[0]["products"][half][f"{name}_{block}"]["dtype"]
    half_out = block == "half" or name == "stencil"
    assert out == str(getattr(torch, half) if half_out else torch.float32)
    # f16's guard eps is 0: the column whose shift equals d[5] is infinite
    # there (NaN for a zero x), in both packages alike
    fin = np.isfinite(Yj)
    assert np.array_equal(np.isfinite(Y), fin)
    assert np.array_equal(Y[~fin], Yj[~fin], equal_nan=True)
    ymax = np.abs(Yj[fin]).max()
    bar = _ulp(ymax, half) if half_out else 1e-5 * ymax
    assert np.abs(Y[fin] - Yj[fin]).max() <= bar


@pytest.mark.parametrize("half", HALVES)
def test_no_sharded_product_casts_an_f32_block(world, half):
    """Given an f32 block, every sharded form hands its kernels the f32
    block (their mixed entry points, the half values as they are) and
    returns f32; the stencil alone casts it to its type, as both packages'
    unsharded stencils do. Each form is the one ``shard_operator`` picks,
    and the stencil, banded, Jacobi and gathered products equal the
    unsharded operator's rows bit for bit, with either block."""
    dt = str(getattr(torch, half))
    f32 = str(torch.float32)
    kernel = {"stencil": "stencil3d.matmat", "banded": "dia.matmat",
              "halo": "windowed_ell.matmat", "ell": "windowed_ell.matmat",
              "jacobi": "jacobi.shifted"}
    for r in world:
        p = r["products"][half]
        assert p["types"] == {"stencil": "ShardedStencil3D",
                              "banded": "ShardedBanded",
                              "halo": "HaloELLOperator",
                              "ell": "GatheredOperator",
                              "jacobi": "JacobiPrecond"}
        for name in PRODUCTS:
            for block in ("half", "f32"):
                rec = p[f"{name}_{block}"]
                want = dt if block == "half" or name == "stencil" else f32
                assert rec["blocks"] == [(kernel[name], want)], (name, block)
                if name != "halo":
                    assert rec["bitwise"], (name, block)


@pytest.mark.parametrize("half", HALVES)
def test_exchanges_of_half_blocks(world, half):
    """The halo, stencil and banded products exchange boundary rows in
    the block's type and gather nothing: ``h k`` elements to each
    neighbour (``2 h k`` on an inner rank), ``h`` the halo width, one
    x-plane, the largest offset; the gathered ELL all-gathers once."""
    halo = _jax_ops(half)["halo"].halo
    h = {"halo": halo, "stencil": HALF_GRID[1] * HALF_GRID[2], "banded": 3}
    for r, rec in enumerate(world):
        n_nb = (r > 0) + (r < NR - 1)
        for name, width in h.items():
            for block in ("half", "f32"):
                p = rec["products"][half][f"{name}_{block}"]
                assert p["gathers"] == 0
                assert p["sent"] == n_nb * width * HALF_K, (name, block)
        assert rec["products"][half]["ell_half"]["gathers"] == 1


# ---------------------------------------------------------------------------
# the sharded solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SOLVES)
def test_sharded_half_solve_matches_jax(world, jax_solves, name):
    """Each solve through both packages under a mesh: the half basis'
    gates on both, values set-matched within their residual bounds, and
    the port's matvecs within 2x of the JAX package's."""
    _, A, spectrum = _solve_case(name)
    half = "float16" if name == "svds_f16" else HALF_SOLVES[name][1]
    floor = 16 * _eps(half) * np.abs(spectrum).max()
    r = world[0]["solves"][name]
    res = jax_solves[name].result()
    if name == "svds_f16":
        Uj, sj, Vhj, stj = res
        jmv = stj["stage1_num_matvecs"] + stj.get("stage2_num_matvecs", 0)
        for U, s, Vh in ((r["U"], r["s"], r["Vh"]), (Uj, sj, Vhj)):
            U, s, V = (np.asarray(x, np.float64) for x in (U, s,
                                                           np.asarray(Vh).T))
            rn = np.hypot(np.linalg.norm(A @ V - U * s, axis=0),
                          np.linalg.norm(A.T @ U - V * s, axis=0))
            assert rn.max() < floor
            assert np.abs(np.sort(s)[::-1] - spectrum[:3]).max() < floor
    else:
        wj, Vj, stj = res
        jmv = stj["num_matvecs"]
        for w, V in ((r["w"], r["V"]), (wj, Vj)):
            w, V = np.asarray(w, np.float64), np.asarray(V, np.float64)
            rn = np.linalg.norm(A @ V - V * w[None, :], axis=0)
            xn = np.linalg.norm(V, axis=0)
            assert rn.max() < floor
            dist = np.abs(spectrum[None, :] - w[:, None]).min(axis=1)
            assert np.all(dist <= rn / xn + 1e-12 * floor)
    assert jmv / MV_SLACK <= r["mv"] <= MV_SLACK * jmv


def test_every_rank_returns_the_same_bytes(world):
    assert len({r["digest"] for r in world}) == 1
    for r in world[1:]:
        for name in SOLVES:
            for key, val in world[0]["solves"][name].items():
                if isinstance(val, np.ndarray):
                    assert np.array_equal(r["solves"][name][key], val)
