"""The 7-point 3-D Laplacian product: ``Y = scale * (6 X - sum of the six
grid neighbours)`` on an ``nx x ny x nz`` grid with Dirichlet edges, for an
``[n, k]`` block whose rows are the grid points in the JAX package's order
(row ``(i*ny + j)*nz + l``, i.e. ``X.reshape(nx, ny, nz, k)``).

* :func:`matmat_reference` — plain PyTorch, the reference's order of
  operations (``primme_tpu/operators.py::Stencil3DOperator.matmat``);
* :func:`matmat` — the kernel wrapper: on a CUDA tensor it launches the
  hand-written Hopper kernel (``csrc/stencil3d.cu``) or raises; on a CPU
  tensor, where no kernel exists, it runs :func:`matmat_reference`;
* :func:`plan` — the kernel's launch: columns a point holds, load width,
  tile and grid (split into several launches where it passes CUDA's
  limits); :func:`launch` — the kernel under a given plan.

The kernel takes X's row stride, so a column slice of a wider block needs
no copy; its columns must be adjacent. ``LAUNCHES`` counts the wrapper's
kernel launches, ``KERNEL_LAUNCHES`` the same by entry point and
``VECTOR_LAUNCHES`` those of them that loaded X in vectors (``vw > 1``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

LAUNCHES = 0         # kernel launches made by matmat
# the entry point of each dtype and the C type of its scale (a half
# kernel takes the f32 value of the half scale)
_ENTRY = {torch.float32: ("stencil3d_f32", ctypes.c_float),
          torch.float64: ("stencil3d_f64", ctypes.c_double),
          torch.float16: ("stencil3d_f16", ctypes.c_float),
          torch.bfloat16: ("stencil3d_bf16", ctypes.c_float)}
KERNEL_LAUNCHES = {e: 0 for e, _ in _ENTRY.values()}
VECTOR_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
TILE_L = 32          # threads of a block along l (one warp): the kernel's kTileL
MAX_TJ = 8           # tile rows along j: the kernel's kMaxTJ
MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and .z
MAX_DIM = 2 ** 30    # nx, ny, nz: the kernel indexes a grid line in 32 bits


def _check(X, nx, ny, nz):
    if X.ndim != 2 or X.shape[0] != nx * ny * nz:
        raise ValueError(f"X shape {tuple(X.shape)} is not [{nx * ny * nz}, k] "
                         f"for the {nx}x{ny}x{nz} grid")


def matmat_reference(X, nx, ny, nz, scale=1.0):
    """Plain PyTorch ``Y = scale * (6 g - sum of neighbours)`` in X's dtype:
    ``out = 6 g``, then per axis 0, 1, 2 ``out = out - g(+1) - g(-1)`` with
    0 outside the grid, then ``scale * out``; ``scale`` rounds to X's dtype
    first, as the reference's weakly typed scalar does. In a half type each
    operation rounds to it, as the JAX function computed op by op does."""
    _check(X, nx, ny, nz)
    k = X.shape[1]
    g = X.reshape(nx, ny, nz, k)
    out = 6.0 * g
    for ax in range(3):
        m = g.shape[ax]
        edge = torch.zeros_like(g.narrow(ax, 0, 1))
        up = torch.cat([g.narrow(ax, 1, m - 1), edge], dim=ax)
        down = torch.cat([edge, g.narrow(ax, 0, m - 1)], dim=ax)
        out = out - up - down
    # scale rounded to X's dtype, as a Python float: exact, no device copy
    return (float(torch.tensor(scale, dtype=X.dtype)) * out).reshape(-1, k)


def column_group(k):
    """Columns a point holds: the largest of 8, 4, 2, 1 that divides k (the
    kernels are compiled for these); the k / kc column groups run as
    separate planes of blocks."""
    return next(c for c in (8, 4, 2, 1) if k % c == 0)


def vector_width(kc, ldx, align, size):
    """Elements of X per load: the widest of 8, 4, 2, 1 whose bytes (at
    most 16) divide the point's ``kc`` columns, the row stride ``ldx`` and
    X's address (``align`` = its ``data_ptr() % 16``); 1 is the scalar
    path. Eight only for a 2-byte (half) type."""
    return next((w for w in (8, 4, 2) if w * size <= 16 and kc % w == 0
                 and ldx % w == 0 and align % (w * size) == 0), 1)


class Plan(NamedTuple):
    kc: int        # columns of a point (divides k)
    vw: int        # elements of X per load; 1 is the scalar path (a half
                   # type's 2 kc: two points a thread)
    tj: int        # tile rows along j: blocks of 32 x tj threads
    tl: int        # tile points along l: 32, fewer where threads share one,
                   # 64 where a thread takes two (vw = 2 kc)
    tiles_j: int   # tiles along j
    groups: int    # column groups, k / kc
    grid: tuple    # (tiles along l, tiles along j, planes x groups)
    launches: tuple  # ((j tile, pair) offsets, (gx, gy, gz)) of each launch


def _pieces(total):
    """``[0, total)`` in pieces of at most ``MAX_GRID_YZ``: (start, size)."""
    return [(a, min(MAX_GRID_YZ, total - a))
            for a in range(0, total, MAX_GRID_YZ)]


def plan(nx, ny, nz, k, ldx, align, size, kc=None) -> Plan:
    """The launch for an ``nx x ny x nz`` grid of ``k`` columns, X's rows
    ``ldx`` elements apart at an address with ``align = data_ptr % 16``,
    ``size`` bytes an element: ``kc`` columns a point (by default
    :func:`column_group`), loaded :func:`vector_width` at a time; a point
    wider than 16 bytes shared by threads, 16 bytes each; in a half type
    (``size`` 2), where two adjacent points along l are one aligned run
    (X's rows ``kc`` <= 4 apart, ``nz`` even, X aligned to ``4 kc``
    bytes), two points a thread, one load of ``vw = 2 kc`` halves a tap;
    tiles of ``tl x tj`` points; a grid of (l tile, j tile, plane x column group), one
    block each. Where the grid's last two extents pass CUDA's 65535, it
    runs as several launches, each over at most 65535 j tiles and 65535
    (plane, column group) pairs from the offsets it is given; otherwise as
    one. Raises ValueError on a shape the kernel does not take."""
    if min(nx, ny, nz, k) < 1 or max(nx, ny, nz) > MAX_DIM or k >= 2 ** 31:
        raise ValueError(f"grid {nx}x{ny}x{nz} at k={k} is outside the "
                         f"kernel's range (1..{MAX_DIM} a side, k < 2**31)")
    kc = column_group(k) if kc is None else kc
    if kc not in (1, 2, 4, 8) or k % kc:
        raise ValueError(f"{kc} columns a point: not 1, 2, 4 or 8 dividing "
                         f"k={k}")
    if size == 2 and kc <= 4 and ldx == kc and nz % 2 == 0 \
            and align % (4 * kc) == 0:   # two points a thread, one run
        vw, tl = 2 * kc, 2 * TILE_L
    else:
        vw = vector_width(kc, ldx, align, size)
        tl = TILE_L // max(1, kc * size // 16)
    tj = min(MAX_TJ, 1 << (ny - 1).bit_length())
    tiles_l, tiles_j, groups = -(-nz // tl), -(-ny // tj), k // kc
    if nx * groups >= 2 ** 31:
        raise ValueError(f"{nx * groups} (plane, column group) pairs are "
                         "outside the kernel's range (< 2**31)")
    launches = tuple(((y0, z0), (tiles_l, gy, gz))
                     for y0, gy in _pieces(tiles_j)
                     for z0, gz in _pieces(nx * groups))
    return Plan(kc, vw, tj, tl, tiles_j, groups,
                (tiles_l, tiles_j, nx * groups), launches)


def _stencil_fn(entry, scale_type):
    """The C entry point ``entry`` of ``csrc/stencil3d.cu``."""
    from . import build
    fn = getattr(build.load("stencil3d"), entry)
    if fn.argtypes is None:
        # X, Y; nx, ny, nz, k; ldx; scale; kc, vw, tj; grid x, y, z;
        # j tile and pair offsets; stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong, scale_type] + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def card_plan(X, nx, ny, nz) -> Plan:
    """The plan :func:`matmat` launches the CUDA tensor X with."""
    return plan(nx, ny, nz, X.shape[1], max(X.stride(0), 1),
                X.data_ptr() % 16, X.element_size())


def launch(X, Y, nx, ny, nz, scale, p: Plan):
    """Launches the kernel of X's dtype on the current stream under plan
    ``p`` (each of its launches): ``Y = A X`` into the contiguous ``[n, k]``
    Y. Counts nothing (:func:`matmat` does); raises when a launch is
    refused."""
    entry, scale_type = _ENTRY[X.dtype]
    fn = _stencil_fn(entry, scale_type)
    if X.dtype in (torch.float16, torch.bfloat16):
        # the f32 value of the half scale, as the plain version rounds it
        scale = float(torch.tensor(scale, dtype=X.dtype))
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        for (y0, z0), grid in p.launches:
            rc = fn(X.data_ptr(), Y.data_ptr(), nx, ny, nz, X.shape[1],
                    max(X.stride(0), 1), float(scale), p.kc, p.vw, p.tj,
                    *grid, y0, z0, stream)
            if rc != 0:
                raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def matmat(X, nx, ny, nz, scale=1.0):
    """``Y = A X`` for the 7-point Laplacian of an ``nx x ny x nz`` grid, in
    X's dtype (f32, f64, f16 or bf16). CUDA tensors: the hand-written kernel of
    ``csrc/stencil3d.cu`` on the current stream, launched as :func:`plan`
    says (raises on a bad argument, a refused shape or a refused launch).
    CPU tensors: :func:`matmat_reference`. ``LAUNCHES`` counts one a call,
    however many launches its plan makes."""
    global LAUNCHES
    if X.device.type == "cpu":
        return matmat_reference(X, nx, ny, nz, scale)
    if X.device.type != "cuda":
        raise ValueError(f"stencil3d matmat: unsupported device {X.device}")
    _check(X, nx, ny, nz)
    if X.dtype not in _ENTRY:
        raise TypeError(f"X has dtype {X.dtype}, expected float32, float64, "
                        "float16 or bfloat16")
    k = X.shape[1]
    ldx = X.stride(0)
    if k > 1 and X.stride(1) != 1:
        raise ValueError("X's columns are not adjacent (stride "
                         f"{tuple(X.stride())})")
    if ldx < k:
        raise ValueError(f"X's rows overlap (row stride {ldx} < {k} columns)")
    Y = torch.empty((nx * ny * nz, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    p = card_plan(X, nx, ny, nz)
    launch(X, Y, nx, ny, nz, scale, p)
    entry = _ENTRY[X.dtype][0]
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    VECTOR_LAUNCHES[entry] += p.vw > 1
    return Y
