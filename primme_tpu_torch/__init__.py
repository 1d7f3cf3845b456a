"""primme_tpu_torch: the PyTorch/CUDA port of primme_tpu.

A second package beside the JAX reference ``primme_tpu``, for an NVIDIA
Hopper card. It runs sparse ``eigsh`` end to end, in f32 and in f64: the
format chooser (``rcm_banded``) packs a band-reducible matrix into the
windowed-slot ELL layout, every product goes through a hand-written
``sm_90a`` CUDA kernel (``csrc/windowed_ell.cu``, native FP64 for an f64
matrix), and the block JDQMR solve with the spectrum-verification probe
runs as plain PyTorch. ``eigsh(dtype=...)`` solves in another precision
than the matrix's through :class:`CastOperator`.

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
                        CastOperator, rcm_banded, aslinearoperator,
                        apply_precond)
from .core.solver import solve_eigs, EigsResult, Stats  # noqa: E402
from .api import eigsh, PrimmeError  # noqa: E402

__all__ = [
    "PrimmeParams", "Target", "Projection", "InitBasisMode", "ConvTest",
    "Method", "Projectors", "set_method", "resolve_defaults",
    "LinearOperator", "WindowedELLOperator", "CastOperator", "rcm_banded",
    "aslinearoperator", "apply_precond", "solve_eigs", "EigsResult",
    "Stats", "eigsh", "PrimmeError",
]
