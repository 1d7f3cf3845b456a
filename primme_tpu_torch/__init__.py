"""primme_tpu_torch: the PyTorch/CUDA port of primme_tpu.

A second package beside the JAX reference ``primme_tpu``, for an NVIDIA
Hopper card. It runs two paths end to end, each product and
preconditioner apply through a hand-written ``sm_90a`` CUDA kernel, and
the block Davidson solve (JDQMR or GD+k) with the spectrum-verification
probe as plain PyTorch:

* ``bench.py``'s headline: the 7-point Laplacian :class:`Stencil3DOperator`
  (``csrc/stencil3d.cu``) with the shift-aware :class:`JacobiPrecond`
  (``csrc/jacobi.cu``), through ``solve_eigs`` or ``eigsh(...,
  jacobi=True)``;
* sparse ``eigsh`` in f32 and f64: the format chooser (``rcm_banded``)
  packs a band-reducible matrix into the windowed-slot ELL layout, whose
  product runs ``csrc/windowed_ell.cu`` (native FP64 for an f64 matrix).

Small dense and sparse inputs become a :class:`DenseOperator`.
``eigsh(dtype=...)`` solves in another precision than the operator's
through :class:`CastOperator`.

f32 products run in full f32: TF32 is disabled at import, the
counterpart of the reference's ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .params import (PrimmeParams, Target, Projection, InitBasisMode,  # noqa: E402
                     ConvTest, Method, Projectors, set_method,
                     resolve_defaults)
from .operators import (LinearOperator, WindowedELLOperator,  # noqa: E402
                        CastOperator, Stencil3DOperator, JacobiPrecond,
                        DenseOperator, DiagonalOperator, rcm_banded,
                        aslinearoperator, apply_precond)
from .core.solver import solve_eigs, EigsResult, Stats  # noqa: E402
from .api import eigsh, PrimmeError  # noqa: E402

__all__ = [
    "PrimmeParams", "Target", "Projection", "InitBasisMode", "ConvTest",
    "Method", "Projectors", "set_method", "resolve_defaults",
    "LinearOperator", "WindowedELLOperator", "CastOperator",
    "Stencil3DOperator", "JacobiPrecond", "DenseOperator", "DiagonalOperator",
    "rcm_banded", "aslinearoperator", "apply_precond", "solve_eigs", "EigsResult",
    "Stats", "eigsh", "PrimmeError",
]
