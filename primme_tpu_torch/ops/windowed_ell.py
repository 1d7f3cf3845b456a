"""Windowed-slot ELL SpMM: the sparse product for band-reducible matrices.

The packed format is the JAX package's (``primme_tpu/ops/pallas_windowed.py``,
whose ``pack`` is copied here verbatim so that the format chooser accepts
and rejects the same matrices): nnz are binned by diagonal offset
(col - row) into BINW-wide bins and stored slot-ELL per RB-row bucket; a
slot's column is

    c = scal[b]*WB + scal[nrb + b*S + s]*128 + 128*(r // 128) + offs[b, s, r] - pad

for row ``r`` of bucket ``b``. Most slots of a bucket are padding (S is the
worst row of each diagonal bin, summed over the bins), so the card never
reads this layout: :func:`compact` turns it into a warp-sliced ELL layout
without padding slots (:class:`SlicedELL`), which keeps the rows in the
packed order and each row's non-zero slots in slot order with their
absolute columns. :func:`from_csr` builds the same layout straight from a
CSR matrix (the general sparse format, ``ELLOperator``). Two functions
apply it:

* :func:`matmat_reference` — plain PyTorch, the same terms summed in the
  same order as the kernel;
* :func:`matmat` — the kernel wrapper: on a CUDA tensor it launches the
  hand-written Hopper kernel (``csrc/windowed_ell.cu``) or raises; on a CPU
  tensor, where no kernel exists, it runs :func:`matmat_reference`.

Values are f32 or f64 in the packed layout. The reference carries f64 as
an f32x2 hi/lo pair (Mosaic has no 64-bit vectors); here an f64 matrix
packs one f64 ``vals`` array and its product runs the kernel's native FP64
entry point. A layout built from CSR (:func:`from_csr`) may also hold
complex64 or complex128 values, each type with its own entry point (the
reference computes complex sparse products outside Pallas, in XLA), or the
half types f16 and bf16 (the reference's half ``ELLOperator``, whose
einsum XLA sums in f32 and rounds once): the kernel and the plain version
sum a half layout's terms in f32 and round the row's sum once to the half
type. A half layout given an f32 or f64 block (a half basis hands a half
operator f32 blocks) takes a mixed entry point
(``windowed_ell_spmm_f16_f32``, ...): the reference's einsum promotes
there, so the half values are
widened and the sum runs, and stays, in the block's type.

The kernel has two paths (:data:`PATHS`): ``"ring"`` streams each group
of slices through a shared-memory ring (one block an SM), ``"direct"``
lets each warp read its slice straight from device memory (small blocks,
many an SM). :func:`choose_path` picks one per layout from its mean slice
width, which the arrays' shapes give (``len(cols) / (32 slices)``,
fixed when :func:`compact` or :func:`from_csr` builds the layout): narrow
layouts, up to :data:`NARROW_WIDTH` slots a slice, take the direct path.

``LAUNCHES`` counts the wrapper's kernel launches, ``KERNEL_LAUNCHES``
the same launches by entry point, so a run can show that its products went
through the kernel of its precision, and ``DIRECT_LAUNCHES`` those of them
that took the direct path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

RB = 1024            # rows per bucket (8 sublane rows x 128 lanes)
BINW = 256           # diagonal-offset bin width
WREL = BINW + 256    # per-slot relative offset range
RT = RB // 128
WBLK = 8192          # window block quantum (lanes)
MAX_WB = 49152       # VMEM guard for the double-buffered window block
SLICE = 32           # rows per slice of the compact layout: one warp

LAUNCHES = 0         # kernel launches made by matmat
# the same launches by entry point of csrc/windowed_ell.cu
_ENTRY = {torch.float32: "windowed_ell_spmm_f32",
          torch.float64: "windowed_ell_spmm_f64",
          torch.float16: "windowed_ell_spmm_f16",
          torch.bfloat16: "windowed_ell_spmm_bf16",
          torch.complex64: "windowed_ell_spmm_c64",
          torch.complex128: "windowed_ell_spmm_c128"}
# half values with a wider real block: (vals dtype, X dtype) -> entry
_MIXED = {(h, b): f"windowed_ell_spmm_{hs}_{bs}"
          for h, hs in ((torch.float16, "f16"), (torch.bfloat16, "bf16"))
          for b, bs in ((torch.float32, "f32"), (torch.float64, "f64"))}
KERNEL_LAUNCHES = dict.fromkeys([*_ENTRY.values(), *_MIXED.values()], 0)
DIRECT_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
_HALF = (torch.float16, torch.bfloat16)   # summed in f32
PATHS = ("ring", "direct")
# mean slots a slice at or under which a layout takes the direct path: the
# smoke's layouts up to 17.9 (rows of 1-2, 7, the scatters' 16.7) ran
# faster on it at k = 1 and 2, the permuted 27-point Laplacian (26.6)
# slower at k >= 2 (tools/torch_ell_paths.py, tools/torch_kernel_variants.py)
NARROW_WIDTH = 20.0


class WindowedELL(NamedTuple):
    scal: np.ndarray    # [nrb + nrb*S] i32: window block idx ++ rel bases
    offs: np.ndarray    # [nrb, S, RT, 128] i32 relative offsets
    vals: np.ndarray    # [nrb, S, RT, 128] f32 or f64
    nrb: int
    S: int
    npad: int
    n: int
    pad: int
    WB: int             # window width (lanes, multiple of WBLK)


def pack(A, dtype=np.float32) -> Optional[WindowedELL]:
    """Pack a scipy sparse matrix; returns None when the matrix is not
    band-reducible enough for the VMEM window budget (caller falls back
    to another format).

    ``vals`` has the type ``dtype`` names, f32 or f64; ``scal``, ``offs``
    and the meta do not depend on it. The acceptance rules are the
    reference's, f64's halved window included, so that both packages take
    the same matrices."""
    import scipy.sparse as sp

    C = sp.coo_matrix(A)
    if C.shape[0] != C.shape[1]:
        return None
    f64 = np.dtype(dtype) == np.dtype(np.float64)
    n = C.shape[0]
    nrb = -(-n // RB)
    npad = nrb * RB
    r = C.row.astype(np.int64)
    c = C.col.astype(np.int64)
    vdt = np.float64 if f64 else np.float32
    v = C.data.astype(vdt)
    d = c - r
    dmin = int(d.min())
    binid = (d - dmin) // BINW
    nb = int(binid.max()) + 1
    bucket = r // RB

    order = np.lexsort((c, binid, r))
    r2, c2, v2 = r[order], c[order], v[order]
    b2, g2 = bucket[order], binid[order]
    grp = r2 * nb + g2
    new = np.ones(len(grp), bool)
    new[1:] = grp[1:] != grp[:-1]
    gidx = np.cumsum(new) - 1
    sizes = np.zeros(gidx[-1] + 1, np.int64)
    np.add.at(sizes, gidx, 1)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank = np.arange(len(grp)) - starts[gidx]

    cnt = np.zeros((n, nb), np.int32)
    np.add.at(cnt, (r, binid), 1)
    S_per = np.zeros((nrb, nb), np.int32)
    for bkt in range(nrb):
        S_per[bkt] = cnt[bkt * RB:(bkt + 1) * RB].max(axis=0)
    S = -(-int(S_per.sum(axis=1).max()) // 8) * 8
    if S * RB * nrb > 16 * max(C.nnz, 1):
        return None        # slot padding explosion: not worth this path
    slot_off = np.zeros((nrb, nb), np.int32)
    for bkt in range(nrb):
        slot_off[bkt] = np.concatenate([[0], np.cumsum(S_per[bkt])[:-1]])

    slot = slot_off[b2, g2] + rank
    rloc = r2 - b2 * RB

    pad = max(0, -((dmin // 128) * 128)) + 128
    bases = np.zeros((nrb, S), np.int32)
    used = np.zeros((nrb, S), bool)
    for bkt in range(nrb):
        for g in range(nb):
            s0, ct = slot_off[bkt, g], S_per[bkt, g]
            if ct == 0:
                continue
            bases[bkt, s0:s0 + ct] = (bkt * RB + dmin + g * BINW) // 128 * 128
            used[bkt, s0:s0 + ct] = True
    # padded/unused slots must not widen the bucket window: park them on
    # the bucket's first used base (their vals are 0, contribution 0)
    for bkt in range(nrb):
        if used[bkt].any():
            first = bases[bkt][used[bkt]][0]
            bases[bkt][~used[bkt]] = first

    offs = np.zeros((nrb, S, RB), np.int32)
    vals = np.zeros((nrb, S, RB), vdt)
    off_rel = c2 - bases[b2, slot] - (rloc // 128) * 128
    assert off_rel.min() >= 0 and off_rel.max() < WREL
    offs[b2, slot, rloc] = off_rel
    vals[b2, slot, rloc] = v2
    basesp = bases + pad
    # Each bucket reads TWO ADJACENT aligned window blocks of width WB
    # (BlockSpec index maps are in block-width units, so per-bucket
    # starts are WB-quantized; two consecutive blocks cover any band of
    # width <= WB regardless of alignment). Find the smallest WB.
    bmin = basesp.min(axis=1)
    bmax = basesp.max(axis=1) + WREL
    span = int((bmax - bmin).max())
    WB = -(-span // WBLK) * WBLK
    # The halved f64 limit is the reference's: its f64 kernel streams two
    # f32 window buffers through VMEM. The card has no such budget, but
    # the limit stays until a measurement re-decides it (ROADMAP Queue
    # A 7), so that both packages accept and reject the same matrices.
    if WB > (MAX_WB // 2 if f64 else MAX_WB):
        return None        # band too wide for the VMEM window
    wblk = bmin // WB
    rel = (basesp - (wblk * WB)[:, None]) // 128   # in [0, 2*WB/128)
    assert int(rel.max()) * 128 + WREL <= 2 * WB
    scal = np.concatenate([wblk, rel.reshape(-1)]).astype(np.int32)
    return WindowedELL(scal=scal,
                       offs=offs.reshape(nrb, S, RT, 128),
                       vals=vals.reshape(nrb, S, RT, 128),
                       nrb=nrb, S=S, npad=npad, n=n, pad=pad, WB=WB)


def _check_meta(meta, scal, offs, vals):
    nrb, S, npad, n, pad, WB = meta
    if npad != nrb * RB or n > npad:
        raise ValueError(f"inconsistent windowed-ELL meta {tuple(meta)}")
    if tuple(scal.shape) != (nrb + nrb * S,):
        raise ValueError(f"scal shape {tuple(scal.shape)} != ({nrb + nrb * S},)")
    for name, t in (("offs", offs), ("vals", vals)):
        if tuple(t.shape) != (nrb, S, RT, 128):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(nrb, S, RT, 128)}")


class SlicedELL(NamedTuple):
    """The packed operator without its padding slots, as the kernel reads
    it. Slice ``i`` holds rows ``32i .. 32i+31`` (one warp, one row per
    lane) and stores its entries slot-major: entry ``j`` of row ``32i + l``
    lies at ``slice_ptr[i] + 32*j + l``, for ``j < rowlen[row]``. A slice
    spans ``32 * width`` entries, ``width`` being its longest row; shorter
    rows leave padding entries (column 0, value 0) that nothing reads."""
    slice_ptr: np.ndarray   # [ceil(n/32) + 1] i64, first entry of each slice
    rowlen: np.ndarray      # [n] i32
    cols: np.ndarray        # [E] i32, absolute columns in [0, n)
    vals: np.ndarray        # [E] f32 or f64 (from CSR also complex)


def compact(scal, offs, vals, meta) -> SlicedELL:
    """The :class:`SlicedELL` layout of a packed operator. A row's entries
    are its slots with a non-zero value, in slot order; the zero-valued
    slots are the padding (parked padding slots may point outside
    ``[0, n)``, every kept column is checked to lie inside). Vectorised:
    each entry's rank in its row is a cumulative sum over the slots."""
    nrb, S, npad, n, pad, WB = (int(x) for x in meta)
    scal, offs, vals = np.asarray(scal), np.asarray(offs), np.asarray(vals)
    _check_meta(meta, scal, offs, vals)
    keep = (vals != 0).reshape(nrb, S, RB)
    rank = np.cumsum(keep, axis=1,                     # 1 + rank in the row
                     dtype=np.int16 if S < 2 ** 15 else np.int32)
    nsl = -(-n // SLICE)
    rowlen = rank[:, -1, :].reshape(-1)[:nsl * SLICE]  # rows >= n hold none
    width = rowlen.reshape(nsl, SLICE).max(axis=1).astype(np.int64)
    slice_ptr = np.zeros(nsl + 1, np.int64)
    np.cumsum(SLICE * width, out=slice_ptr[1:])
    # kept slots by flat index into [nrb, S, RB]; RB = 2**10
    idx = np.flatnonzero(keep)
    bs, r = idx >> 10, idx & (RB - 1)                  # b*S + s, row in bucket
    row = (bs // S) * RB + r
    base = (scal[:nrb].astype(np.int64)[:, None] * WB - pad
            + 128 * scal[nrb:].reshape(nrb, S).astype(np.int64)).reshape(-1)
    col = base[bs] + (r & ~127) + offs.reshape(-1)[idx]
    if len(col) and (col.min() < 0 or col.max() >= n or row.max() >= n):
        raise ValueError("a non-zero slot lies outside the matrix")
    pos = (slice_ptr[row >> 5] + SLICE * (rank.reshape(-1)[idx] - 1)
           + (row & (SLICE - 1)))
    E = int(slice_ptr[-1])
    cols = np.zeros(E, np.int32)
    cvals = np.zeros(E, vals.dtype)
    cols[pos] = col
    cvals[pos] = vals.reshape(-1)[idx]
    return SlicedELL(slice_ptr, rowlen[:n].astype(np.int32), cols, cvals)


def from_csr(A, dtype) -> SlicedELL:
    """The :class:`SlicedELL` layout of an ``m x n`` scipy sparse matrix,
    straight from its CSR form: ``ceil(m/32)`` slices of its ``m`` rows, a
    row's entries its stored entries in CSR order (an explicit zero stays
    an entry) with their columns as they are (in ``[0, n)``), and values of
    the numpy type ``dtype``. Rows may be empty, and so may whole slices
    (width 0) and the matrix. Vectorised: entry ``j`` of row ``r`` lands at
    ``slice_ptr[r // 32] + 32 j + r % 32``."""
    import scipy.sparse as sp

    C = sp.csr_matrix(A)
    m = C.shape[0]
    indptr = C.indptr.astype(np.int64)
    rowlen = np.diff(indptr)
    nsl = -(-m // SLICE)
    padded = np.zeros(nsl * SLICE, np.int64)
    padded[:m] = rowlen
    slice_ptr = np.zeros(nsl + 1, np.int64)
    np.cumsum(SLICE * padded.reshape(nsl, SLICE).max(axis=1, initial=0),
              out=slice_ptr[1:])
    rows = np.repeat(np.arange(m, dtype=np.int64), rowlen)
    rank = np.arange(C.nnz, dtype=np.int64) - indptr[rows]
    pos = slice_ptr[rows >> 5] + SLICE * rank + (rows & (SLICE - 1))
    E = int(slice_ptr[-1])
    cols = np.zeros(E, np.int32)
    vals = np.zeros(E, dtype)
    cols[pos] = C.indices
    vals[pos] = C.data
    return SlicedELL(slice_ptr, rowlen.astype(np.int32), cols, vals)


def _check_layout(slice_ptr, rowlen, cols, vals, X, ncols):
    """The layout's arrays agree, and ``X`` is ``[ncols, k]`` (``ncols``
    None: as many columns as rows). Returns ``(rows, ncols)``."""
    n = rowlen.shape[0]
    if rowlen.ndim != 1 or tuple(slice_ptr.shape) != (-(-n // SLICE) + 1,):
        raise ValueError(f"slice_ptr shape {tuple(slice_ptr.shape)} != "
                         f"({-(-n // SLICE) + 1},) for {n} rows")
    if cols.ndim != 1 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"cols shape {tuple(cols.shape)} and vals shape "
                         f"{tuple(vals.shape)} differ")
    ncols = n if ncols is None else int(ncols)
    if X.ndim != 2 or X.shape[0] != ncols:
        raise ValueError(f"X shape {tuple(X.shape)} is not [{ncols}, k]")
    return n, ncols


def matmat_reference(slice_ptr, rowlen, cols, vals, X, ncols=None):
    """Plain PyTorch ``Y = A X`` for an ``[ncols, k]`` block (``ncols``
    None: a square layout), in the type of ``vals`` (f32, f64, f16, bf16,
    complex64 or complex128), ``Y``
    with the layout's rows: slot ``j`` at a time, rows with ``j < rowlen``
    add ``v * X[col]`` as the kernel does, in the same order; a half
    layout's terms in f32, the sum rounded once to the half type (given an
    f32 or f64 X, the terms and the sum in X's type). The counterpart of
    the JAX package's CPU path of ``matmat_ds``."""
    n, _ = _check_layout(slice_ptr, rowlen, cols, vals, X, ncols)
    k = X.shape[1]
    dev = X.device
    if (vals.dtype, X.dtype) in _MIXED:
        acc = out = X.dtype
    else:
        acc = torch.float32 if vals.dtype in _HALF else vals.dtype
        out = vals.dtype
    Xf = X.to(out).to(acc)
    va = vals.to(acc)
    rows = torch.arange(n, device=dev)
    first = slice_ptr[rows // SLICE] + rows % SLICE    # entry 0 of each row
    y = torch.zeros((n, k), dtype=acc, device=dev)
    for j in range(int(rowlen.max()) if n else 0):
        on = rowlen > j
        e = torch.where(on, first + SLICE * j, 0)
        term = va[e, None] * Xf[cols[e]]
        y = torch.where(on[:, None], y + term, y)
    return y.to(out)


def mean_width(slice_ptr, cols) -> float:
    """Slots a slice on average: the layout's ``E`` entries (``len(cols)``)
    over 32 times its slices (``len(slice_ptr) - 1``); 0 for no slice.
    Shapes alone: no array is read, wherever it lies."""
    slices = slice_ptr.shape[0] - 1
    return cols.shape[0] / (SLICE * slices) if slices > 0 else 0.0


def choose_path(slice_ptr, cols) -> str:
    """The kernel's path for a layout: ``"direct"`` where its
    :func:`mean_width` is at most ``NARROW_WIDTH``, else ``"ring"``."""
    return "direct" if mean_width(slice_ptr, cols) <= NARROW_WIDTH \
        else "ring"


def _spmm_fn(entry):
    """The C entry point ``entry`` of ``csrc/windowed_ell.cu``."""
    from . import build
    fn = getattr(build.load("windowed_ell"), entry)
    if fn.argtypes is None:
        # slice_ptr, rowlen, cols, vals, X, Y; n, k, direct; stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def matmat(slice_ptr, rowlen, cols, vals, X, ncols=None, out=None,
           path=None):
    """``Y = A X`` for an ``[ncols, k]`` block of the type of ``vals`` (f32,
    f64, f16, bf16, complex64 or complex128; f32 or f64 for half values,
    ``Y`` in X's type) on the :class:`SlicedELL` arrays of an ``m x
    ncols`` matrix (``ncols`` None: square); ``Y`` is ``[m, k]``. CUDA
    tensors: the hand-written kernel of ``csrc/windowed_ell.cu`` for that
    type, launched on the current stream (raises on a bad argument or a
    refused launch).
    CPU tensors: :func:`matmat_reference`. ``out``: a contiguous ``[m,
    k]`` tensor the product is written into and returned (a row slice of a
    larger block: the halo operator writes its layouts' rows in place).
    ``path``: one of :data:`PATHS`, the layout's :func:`choose_path` when
    None (both give the same result bit for bit)."""
    global LAUNCHES
    if path is not None and path not in PATHS:
        raise ValueError(f"path {path!r} is not one of {PATHS}")
    if X.device.type == "cpu":
        Y = matmat_reference(slice_ptr, rowlen, cols, vals, X, ncols)
        return Y if out is None else out.copy_(Y)
    if X.device.type != "cuda":
        raise ValueError(f"windowed-ELL matmat: unsupported device {X.device}")
    n, _ = _check_layout(slice_ptr, rowlen, cols, vals, X, ncols)
    if vals.dtype not in _ENTRY:
        raise TypeError(f"vals has dtype {vals.dtype}, expected float32, "
                        "float64, float16, bfloat16, complex64 or "
                        "complex128")
    mixed = _MIXED.get((vals.dtype, X.dtype))
    for name, t, dt in (("slice_ptr", slice_ptr, torch.int64),
                        ("rowlen", rowlen, torch.int32),
                        ("cols", cols, torch.int32),
                        ("vals", vals, vals.dtype),
                        ("X", X, X.dtype if mixed else vals.dtype)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, t in (("cols", cols), ("vals", vals)):
        if t.data_ptr() % 16:       # the kernel copies them in bulk
            raise ValueError(f"{name} is not 16-byte aligned")
    if path is None:
        path = choose_path(slice_ptr, cols)
    k = X.shape[1]
    if out is None:
        Y = torch.empty((n, k), dtype=X.dtype, device=X.device)
    else:
        if (tuple(out.shape) != (n, k) or out.dtype != X.dtype
                or out.device != X.device or not out.is_contiguous()):
            raise ValueError(f"out is {tuple(out.shape)} {out.dtype} on "
                             f"{out.device}, expected a contiguous "
                             f"[{n}, {k}] {X.dtype} on {X.device}")
        Y = out
    if Y.numel() == 0:
        return Y
    entry = mixed or _ENTRY[X.dtype]
    fn = _spmm_fn(entry)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(slice_ptr.data_ptr(), rowlen.data_ptr(), cols.data_ptr(),
                vals.data_ptr(), X.data_ptr(), Y.data_ptr(), n, k,
                int(path == "direct"), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    DIRECT_LAUNCHES[entry] += path == "direct"
    return Y
