"""The half and mixed entry points of the hand-written kernels on the
sharded layouts of ``mesh=``, on the card: 2 ranks share it over gloo
(NCCL refuses two ranks on one device), each launch held bit for bit
against the unsharded launch of the same operator and block
(``test_torch_ranks.world_sharded_half_card``). This file imports no jax,
so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sharded_half_cuda.py

Cases, in f16 and bf16, each with a half block and an f32 one (the mixed
entry points): the stencil on its window of x-planes, the DIA kernel on
the banded window, the shift-aware and the plain Jacobi on a rank's rows
at a 16-byte aligned start of the diagonal (n = 2048) and at an unaligned
one (n = 2002), and the halo operator's interior, top and bottom layouts,
each launched into its ``out=`` row slice and into a block of its own. No
tolerance: each row's arithmetic is the unsharded launch's. The halo
operator's whole product, gathered, against the unsharded ``ELLOperator``
of the same values: within one unit in the half's last place at
``max|y|`` for a half block, 1e-5 ``max|y|`` for an f32 one (the layouts
differ). Every test here needs a card and skips without one."""

import numpy as np
import pytest
import torch

from test_torch_ranks import HALVES, run_world

SUFFIX = {"float16": "f16", "bfloat16": "bf16"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    from primme_tpu_torch.ops import build
    for name in ("stencil3d", "dia", "jacobi", "windowed_ell"):
        build.load(name)              # once, before the ranks load them
    return run_world(tmp_path_factory.mktemp("half_card"), 2,
                     "world_sharded_half_card", kind="cuda")


def _entry(prefix, half, block):
    return f"{prefix}_{SUFFIX[half]}" + ("_f32" if block == "f32" else "")


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["half", "f32"])
@pytest.mark.parametrize("half", HALVES)
def test_stencil_and_dia_windows_bit_for_bit(ranks, half, block):
    for r in ranks:
        st = r[f"stencil_{half}_{block}"]
        assert st["bitwise"]
        # the stencil casts an f32 block to its type: its half entry point
        assert st["launches"] == {_entry("stencil3d", half, "half"): 1}
        dia = r[f"dia_{half}_{block}"]
        assert dia["bitwise"]
        assert dia["launches"] == {_entry("dia", half, block): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2002])
@pytest.mark.parametrize("block", ["half", "f32"])
@pytest.mark.parametrize("half", HALVES)
def test_jacobi_rows_bit_for_bit(ranks, half, block, n):
    """Rank 1's diagonal starts 2048 bytes in (aligned) at n = 2048 and
    2002 bytes in (not) at n = 2002: the same bits either way, on the run
    kernel (its loads of the diagonal take any address)."""
    for r in ranks:
        c = r[f"jacobi_{n}_{half}_{block}"]
        assert c["bitwise"] and c["run_kernel"]
        assert c["launches"] == {_entry("jacobi_shifted", half, block): 1,
                                 _entry("jacobi", half, block): 1}
    offs = [r[f"jacobi_{n}_{half}_{block}"]["d_offset_bytes"] for r in ranks]
    assert offs == ([0, 0] if n == 2048 else [0, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["half", "f32"])
@pytest.mark.parametrize("half", HALVES)
def test_halo_layouts_into_row_slices(ranks, half, block):
    entry = _entry("windowed_ell_spmm", half, block)
    for r in ranks:
        c = r[f"halo_layouts_{half}_{block}"]
        assert c["split"] and c["bitwise"]
        # interior, top and bottom into the slices, then each on its own
        assert c["launches"] == {entry: 6}
    h = ranks[0][f"halo_{half}_{block}"]
    assert h["dtype"] == str(getattr(torch, half) if block == "half"
                             else torch.float32)
    ymax = np.abs(h["Y_ell"]).max()
    eps = float(torch.finfo(getattr(torch, half)).eps)
    bar = (np.exp2(np.floor(np.log2(ymax))) * eps if block == "half"
           else 1e-5 * ymax)
    assert np.abs(h["Y"] - h["Y_ell"]).max() <= bar
