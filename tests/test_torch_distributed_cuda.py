"""The row-partitioned solve on the card: 2 ranks share it over gloo
(NCCL refuses two ranks on one device) and run the halo product and a
small ``eigsh(mesh=)``; the same world on the CPU gives the comparison.
This file imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_distributed_cuda.py

Tolerances: the card's sliced-ELL kernel and the CPU's plain version sum
each row in their own order, so the f64 products agree to 1e-12 of the
row sums' bound; the solves to 1e-9 (tol 1e-9, values of size <= 60).
Every test here needs a card and skips without one."""

import numpy as np
import pytest
import torch

from test_torch_ranks import band_matrix, run_world


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    tmp = tmp_path_factory.mktemp("card")
    return {kind: run_world(tmp / kind, 2, "world_card", kind=kind)
            for kind in ("cuda", "cpu")}


@pytest.mark.cuda
def test_halo_product_on_the_card(runs):
    A = band_matrix(1024, 3, 3)
    X = np.random.default_rng(1).normal(size=(1024, 8))
    card = np.concatenate([r["halo"]["Y"] for r in runs["cuda"]])
    host = np.concatenate([r["halo"]["Y"] for r in runs["cpu"]])
    scale = abs(A).sum(axis=1).max()
    assert np.abs(card - A @ X).max() <= 1e-12 * scale
    assert np.abs(card - host).max() <= 1e-12 * scale
    for r in runs["cuda"]:
        h = r["halo"]
        # the sliced-ELL kernel ran every layout: 3 launches when split
        assert h["launches"] == (3 if h["split"] else 1)
        assert h["sends"] == [(h["halo"], 8)] and h["gathers"] == 0


@pytest.mark.cuda
def test_eigsh_mesh_on_the_card(runs):
    A = band_matrix(2048, 150, 2, seed=7)
    ref = np.linalg.eigvalsh(A.toarray())[:4]
    card, host = runs["cuda"], runs["cpu"]
    assert np.array_equal(card[0]["w"], card[1]["w"])
    assert np.abs(np.sort(card[0]["w"]) - ref).max() < 1e-9 * 60
    assert np.abs(np.sort(card[0]["w"]) - np.sort(host[0]["w"])).max() \
        < 1e-9 * 60
    V, w = card[0]["V"], card[0]["w"]
    R = A @ V - V * w[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6 * np.abs(ref).max()
