"""Carry objects over from the JAX package, as numpy.

The tests use these so that both packages compute on the same operator
and configuration. Nothing here imports jax: a JAX array converts through
``np.asarray``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import params as prm
from .operators import WindowedELLOperator


def params_from_jax(p) -> prm.PrimmeParams:
    """A ``primme_tpu.params.PrimmeParams`` as the port's dataclass, field
    by field (enums by value)."""
    kw = {}
    for f in dataclasses.fields(prm.PrimmeParams):
        v = getattr(p, f.name)
        if isinstance(v, enum.Enum):
            v = type(getattr(prm.PrimmeParams(), f.name))(v.value)
        elif f.name == "projectors":
            v = prm.Projectors(**dataclasses.asdict(v))
        elif f.name == "internal_dtype" and v is not None:
            v = getattr(torch, np.dtype(v).name)
        kw[f.name] = v
    return prm.PrimmeParams(**kw)


def windowed_from_jax(op, device=None) -> WindowedELLOperator:
    """A ``primme_tpu`` ``WindowedELLOperator`` as the port's, with
    bit-identical ``scal``/``offs`` and the same ``meta``. An f32 operator
    keeps ``vals`` bit for bit; an f64 one (an f32 hi/lo pair in the
    reference) becomes one f64 ``vals = hi + lo``, the sum the reference's
    CPU path of ``matmat_ds`` forms. That sum equals the matrix entry to
    within 2**-48 relative (the tail is rounded to f32), and exactly where
    the entry is an f32 number."""
    vals = np.asarray(op.vals)
    if op.vals_lo is not None:
        vals = vals.astype(np.float64) + np.asarray(op.vals_lo, np.float64)
    out = WindowedELLOperator(np.asarray(op.scal), np.asarray(op.offs),
                              vals, op.meta)
    return out.to(device) if device is not None else out


def block_from_numpy(X, device, dtype=None) -> torch.Tensor:
    """An ``[n, k]`` numpy block as a tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(X))
    return t.to(device=device, dtype=dtype or t.dtype)
