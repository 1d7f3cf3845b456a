"""Carry objects over from the JAX package, as numpy.

The tests use these so that both packages compute on the same operator
and configuration; the operators carry real, complex and half values
alike. Nothing here imports jax: a JAX array converts through
``np.asarray``, and a bfloat16 one (numpy's ``bfloat16`` extension type,
which torch does not read) through the ``uint16`` view of its bits
(:func:`tensor_from_numpy`), so the bits stay the same.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import params as prm
from .operators import (BandedOperator, BlockELLOperator, ChebyshevPrecond,
                        DenseOperator, ELLOperator, JacobiPrecond,
                        Stencil3DOperator, SumOperator, WindowedELLOperator)


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array (or a JAX array, through ``np.asarray``) as a CPU
    tensor of its type, bit for bit: a ``bfloat16`` array through the
    ``uint16`` view of its bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


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


def svds_params_from_jax(sp):
    """A ``primme_tpu.svds.SvdsParams`` as the port's, field by field (the
    embedded stage overrides as plain dicts, each value as it is)."""
    from .svds import SvdsParams

    kw = {}
    for f in dataclasses.fields(SvdsParams):
        v = getattr(sp, f.name)
        kw[f.name] = dict(v) if isinstance(v, dict) else v
    return SvdsParams(**kw)


def windowed_from_jax(op, device=None) -> WindowedELLOperator:
    """A ``primme_tpu`` ``WindowedELLOperator`` as the port's: its packed
    arrays go through the port's constructor, which compacts them, and
    ``meta`` stays. An f32 operator gives the compact arrays that the
    port's own packing of the same matrix gives, bit for bit; an f64 one
    (an f32 hi/lo pair in the reference) compacts one f64 ``vals = hi +
    lo``, the sum the reference's CPU path of ``matmat_ds`` forms. That
    sum equals the matrix entry to within 2**-48 relative (the tail is
    rounded to f32), and exactly where the entry is an f32 number."""
    vals = np.asarray(op.vals)
    if op.vals_lo is not None:
        vals = vals.astype(np.float64) + np.asarray(op.vals_lo, np.float64)
    out = WindowedELLOperator(np.asarray(op.scal), np.asarray(op.offs),
                              vals, op.meta)
    return out.to(device) if device is not None else out


def stencil_from_jax(op, device=None) -> Stencil3DOperator:
    """A ``primme_tpu`` ``Stencil3DOperator`` as the port's: the same grid,
    scale and dtype. ``device`` follows the port's rule (None: the card)."""
    return Stencil3DOperator(op.nx, op.ny, op.nz,
                             dtype=getattr(torch, np.dtype(op.dtype).name),
                             scale=op._scale, device=device)


def jacobi_from_jax(K, device=None) -> JacobiPrecond:
    """A ``primme_tpu`` ``JacobiPrecond`` as the port's: its diagonal as
    numpy, ``eps`` and ``use_shifts``."""
    out = JacobiPrecond(tensor_from_numpy(K.d), eps=K.eps,
                        use_shifts=K.use_shifts)
    return out.to(device) if device is not None else out


def _on(op, device):
    return op.to(device) if device is not None else op


def banded_from_jax(op, device=None) -> BandedOperator:
    """A ``primme_tpu`` ``BandedOperator`` as the port's: the same offsets
    in the same order and the same ``vals``."""
    return _on(BandedOperator(op.offsets, tensor_from_numpy(op.vals),
                              op.shape), device)


def ell_from_jax(op, device=None) -> ELLOperator:
    """A ``primme_tpu`` ``ELLOperator`` as the port's: the matrix its
    padded rows hold (the zero-valued padding dropped), laid out by the
    port's ``from_scipy``. Its ``A^H`` layout is built from that matrix
    with conjugated values, so it equals the reference's ``valsT`` (stored
    unconjugated, conjugated at each ``rmatmat``) conjugated. Half values
    go through ``from_coo``, which keeps their type."""
    cols, vals = np.asarray(op.cols), np.asarray(op.vals)
    keep = vals != 0
    return _on(ELLOperator.from_coo(np.nonzero(keep)[0], cols[keep],
                                    tensor_from_numpy(vals[keep]), op.shape),
               device)


def dense_from_jax(op, device=None) -> DenseOperator:
    """A ``primme_tpu`` ``DenseOperator`` as the port's: the same matrix,
    in its type (real or complex)."""
    return _on(DenseOperator(tensor_from_numpy(op.A)), device)


def block_ell_from_jax(op, device=None) -> BlockELLOperator:
    """A ``primme_tpu`` ``BlockELLOperator`` as the port's: the same block
    columns and blocks, and the transposed layout where it has one."""
    t = op.bcolsT is not None
    return _on(BlockELLOperator(
        np.asarray(op.bcols), tensor_from_numpy(op.bvals), op.shape,
        np.asarray(op.bcolsT) if t else None,
        tensor_from_numpy(op.bvalsT) if t else None), device)


def sum_from_jax(op, device=None) -> SumOperator:
    """A ``primme_tpu`` ``SumOperator`` as the port's, each part converted
    by its own function."""
    conv = {"BandedOperator": banded_from_jax, "ELLOperator": ell_from_jax,
            "BlockELLOperator": block_ell_from_jax}
    return _on(SumOperator([conv[type(o).__name__](o) for o in op.ops]),
               device)


def chebyshev_from_jax(K, A, device=None) -> ChebyshevPrecond:
    """A ``primme_tpu`` ``ChebyshevPrecond`` as the port's over ``A``, the
    port's counterpart of the operator it wraps: the same interval,
    ``sigma`` and degree."""
    return _on(ChebyshevPrecond(A, (float(K.a), float(K.b)),
                                degree=K.degree, sigma=float(K.sigma)),
               device)


def halo_ell_from_jax(op, mesh=None):
    """A ``primme_tpu.distributed.HaloELLOperator`` as the port's on this
    rank of ``mesh`` (a 1-D ``DeviceMesh``; None: one rank): its global
    arrays carried across (the values and the diagonal through
    :func:`tensor_from_numpy`, bit for bit: f16 and bf16 too), this rank's
    rows kept, on the mesh's device. The partition is the port's
    (``mesh``), which must have as many ranks as the operator was packed
    for."""
    from .distributed import HaloELLOperator, HaloPack, mesh_comm

    cols = np.asarray(op.cols)
    pk = HaloPack(cols, tensor_from_numpy(op.vals),
                  tensor_from_numpy(op.diag), int(op.halo),
                  int(op.hrows or 0), None)
    comm = None if mesh is None else mesh_comm(mesh, cols.shape[0])
    out = HaloELLOperator.from_pack(pk, comm)
    return out if comm is None else out.to(comm.device)


def block_from_numpy(X, device, dtype=None) -> torch.Tensor:
    """An ``[n, k]`` numpy block (bfloat16 too) as a tensor on
    ``device``."""
    t = tensor_from_numpy(X)
    return t.to(device=device, dtype=dtype or t.dtype)
