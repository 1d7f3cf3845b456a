"""primme_tpu_torch: the PyTorch/CUDA port of primme_tpu.

A second package beside the JAX reference ``primme_tpu``, for an NVIDIA
Hopper card. It runs these paths end to end, each product and
preconditioner apply through a hand-written ``sm_90a`` CUDA kernel (the
BlockELL product excepted), and the block Davidson solve (JDQMR or GD+k)
with the spectrum-verification probe as plain PyTorch:

* ``bench.py``'s headline: the 7-point Laplacian :class:`Stencil3DOperator`
  (``csrc/stencil3d.cu``) with the shift-aware :class:`JacobiPrecond`
  (``csrc/jacobi.cu``), through ``solve_eigs`` or ``eigsh(...,
  jacobi=True)``;
* sparse ``eigsh`` in f32 and f64 through the reference's format chooser
  (``rcm_banded``, then ``aslinearoperator``): a banded matrix becomes a
  :class:`BandedOperator` (``csrc/dia.cu``), a banded one with a scattered
  remainder the DIA+ELL :class:`SumOperator`, a band-reducible one the
  windowed-slot ELL layout and any other large one an :class:`ELLOperator`
  (both on ``csrc/windowed_ell.cu``'s sliced-ELL kernel, native FP64 for
  an f64 matrix), a block-clustered one a :class:`BlockELLOperator` (plain
  PyTorch, as the reference's XLA einsum).

Small dense and sparse inputs become a :class:`DenseOperator`, a scipy
``LinearOperator`` a :class:`FunctionOperator` applied on the host.
``eigsh(dtype=...)`` solves in another precision than the operator's
through :class:`CastOperator`. ``eigsh`` also serves generalized problems
(``M=``), orthogonality constraints (``lock=``) and the refined and
harmonic projections; :func:`refine_eigsh` polishes an f32 solve's pairs
in native FP64 on the card, with a :class:`ChebyshevPrecond` over the f64
operator's own kernel (the north star: the 128^3 Laplacian to a true
residual of 1e-10).

:func:`svds` computes singular triplets of a rectangular operator by the
reference's two stages: the normal equations (``A^T A`` or ``A A^T``),
then the augmented operator ``[[0, A^T], [A, 0]]``, each with its own
convergence test through ``solve_eigs(convtest=)``. A large sparse ``A``
is an :class:`ELLOperator` with its ``A`` and ``A^T`` layouts on the
sliced-ELL kernel, a small one a :class:`DenseOperator`;
:class:`SvdsParams` and ``svds_*`` carry the reference's
``primme_svds_params`` reflection.

:func:`eigs` finds eigenpairs of a normal (non-Hermitian) operator, with
complex Ritz values (projected ``eig`` on the host, GD_plusK or a JD
preset whose inner solve is a projected block GMRES), through the same
DIA and sliced-ELL kernels: a real matrix on the real view of the
complex basis, a complex one on the complex entry points.

``eigsh(method="DYNAMIC")`` (the reference's default method) switches
between GD+k and JDQMR by measurement (:mod:`.core.dynamic`);
``segment_outer`` resumes a solve from the host every N outer iterations;
``monitor``/``return_history``/``printLevel`` give the solver's event
stream and ``profile``/``time_breakdown`` its device time by phase
(:mod:`.profiling`); ``python -m primme_tpu_torch.driver CONFIG`` runs the
reference's config files (:mod:`.testharness`).

The C/Fortran ABI (``ptpu_*``: CSR, matvec callback and parameter-handle
entry points, F77 bindings) embeds CPython and forwards into
:mod:`.capi_support`; :func:`primme_tpu_torch.native.capi_library` builds
``libprimme_tpu_torch_capi``, whose solves run on the card unless
``PTPU_PLATFORM=cpu``. :mod:`.io` and :mod:`.native` read MatrixMarket
files. ``eigsh(dtype=torch.bfloat16 or torch.float16)`` stores the basis
in half precision and computes in f32.

Complex Hermitian input (complex64 and complex128) runs as the real does:
the DIA and sliced-ELL kernels have complex entry points (the adjoint
``A^H`` conjugating), and so has the Jacobi kernel (a complex
:class:`JacobiPrecond`, or a real one given ``eigs``' complex Ritz
shifts); ``eigsh`` returns real eigenvalues and complex vectors, ``svds``
returns ``Vh = V^H``. A real operator multiplies a
complex block's two parts in one launch of its real product.

``eigsh(mesh=)`` and ``svds(mesh=)`` run the row-partitioned solve over
``torch.distributed`` (a 1-D ``DeviceMesh``; :mod:`.distributed`'s
halo-exchange ``HaloELLOperator`` and ``dryrun_multichip``): every
reduction over rows summed over the ranks, the reference's ``nLocal``
model.

f32 products run in full f32: TF32 is disabled at import, the
counterpart of the reference's ``Precision.HIGHEST``; Grams of f32 and
complex64 blocks are summed in double.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .params import (PrimmeParams, Target, Projection, InitBasisMode,  # noqa: E402
                     ConvTest, Method, Projectors, set_method,
                     resolve_defaults, set_member, get_member, member_info,
                     member_names, display_params)
from .operators import (LinearOperator, WindowedELLOperator,  # noqa: E402
                        CastOperator, Stencil3DOperator, JacobiPrecond,
                        DenseOperator, DiagonalOperator, BandedOperator,
                        ELLOperator, BlockELLOperator, FunctionOperator,
                        SumOperator, ChebyshevPrecond, dia_ell_hybrid,
                        rcm_banded, aslinearoperator, apply_precond)
from .core.solver import solve_eigs, EigsResult, Stats  # noqa: E402
from .api import eigsh, eigs, PrimmeError  # noqa: E402
from .refine import refine_eigsh  # noqa: E402
from .svds import (svds, SvdsParams, svds_set_member,  # noqa: E402
                   svds_get_member, svds_member_info, svds_display_params,
                   svds_from_params, svds_member_names)
from . import io, native, profiling, testharness  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PrimmeParams", "Target", "Projection", "InitBasisMode", "ConvTest",
    "Method", "Projectors", "set_method", "resolve_defaults", "set_member",
    "get_member", "member_info", "member_names", "display_params",
    "LinearOperator", "WindowedELLOperator", "CastOperator",
    "Stencil3DOperator", "JacobiPrecond", "DenseOperator", "DiagonalOperator",
    "BandedOperator", "ELLOperator", "BlockELLOperator", "FunctionOperator",
    "SumOperator", "ChebyshevPrecond", "dia_ell_hybrid", "rcm_banded",
    "aslinearoperator", "apply_precond", "solve_eigs", "EigsResult",
    "Stats", "eigsh", "eigs", "PrimmeError", "refine_eigsh", "svds",
    "SvdsParams",
    "svds_set_member", "svds_get_member", "svds_member_info",
    "svds_display_params", "svds_from_params", "svds_member_names",
    "__version__",
]
