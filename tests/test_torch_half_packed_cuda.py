"""The packed half operations of the port's f16 and bf16 kernels
(``primme_tpu_torch/csrc/half2.cuh``: mul.rn, add.rn and sub.rn on f16x2
and bf16x2) against f32 arithmetic on the exact operands rounded once to
the half type (torch's half arithmetic, and the kernels' plain versions),
on every pair of 16-bit patterns (2^32 pairs a type and operation; the
test-only kernel ``tools/half_packed_check.cu``, built here as
``chip_smoke.py`` phase 48 builds it). Tolerance: none; two NaN results
match, everything else by bits. This file imports no jax, so that it runs
where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_half_packed_cuda.py

It needs a card and skips without one."""

import pytest
import torch

import chip_smoke as CS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_packed_half_ops_match_f32_rounded_once(card):
    ops, secs = CS.half_packed_check(card)
    assert sorted(ops) == sorted(f"{t} {op}" for t in ("float16", "bfloat16")
                                 for op in CS.HALF_CHECK_OPS)
    for name, r in ops.items():
        assert r["pairs"] == 2 ** 32
        assert r["mismatches"] == 0, (name, r)
        assert r["first_mismatch"] is None, (name, r)
        # NaN inputs (and inf - inf, 0 * inf) give NaN in both
        assert r["both_nan"] > 0, (name, r)
    assert secs["run_s"] < 60
