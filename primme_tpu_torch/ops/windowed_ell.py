"""Windowed-slot ELL SpMM: the sparse product for band-reducible matrices.

The packed format is the JAX package's (``primme_tpu/ops/pallas_windowed.py``,
whose ``pack`` is copied here verbatim so that the format chooser accepts
and rejects the same matrices): nnz are binned by diagonal offset
(col - row) into BINW-wide bins and stored slot-ELL per RB-row bucket; a
slot's column is

    c = scal[b]*WB + scal[nrb + b*S + s]*128 + 128*(r // 128) + offs[b, s, r] - pad

for row ``r`` of bucket ``b``. Three functions apply it:

* :func:`matmat_reference` — plain PyTorch gather with the same formula;
* :func:`matmat` — the kernel wrapper: on a CUDA tensor it launches the
  hand-written Hopper kernel (``csrc/windowed_ell.cu``) or raises; on a CPU
  tensor, where no kernel exists, it runs :func:`matmat_reference`.

Values are f32 or f64. The reference carries f64 as an f32x2 hi/lo pair
(Mosaic has no 64-bit vectors); here an f64 matrix packs one f64 ``vals``
array and its product runs the kernel's native FP64 entry point.

``LAUNCHES`` counts the wrapper's kernel launches, and ``KERNEL_LAUNCHES``
the same launches by entry point, so a run can show that its products went
through the kernel of its precision.
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

LAUNCHES = 0         # kernel launches made by matmat
# the same launches by entry point of csrc/windowed_ell.cu
KERNEL_LAUNCHES = {"windowed_ell_spmm_f32": 0, "windowed_ell_spmm_f64": 0}
_ENTRY = {torch.float32: "windowed_ell_spmm_f32",
          torch.float64: "windowed_ell_spmm_f64"}


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


def matmat_reference(meta, scal, offs, vals, X):
    """Plain PyTorch ``Y = A X`` for an ``[n, k]`` block, in the type of
    ``vals`` (f32 or f64): the gather the kernel performs, slot by slot in
    the same order, with columns outside ``[0, n)`` (parked padding slots)
    contributing nothing. The counterpart of the JAX package's CPU path of
    ``matmat_ds``."""
    nrb, S, npad, n, pad, WB = (int(x) for x in meta)
    _check_meta(meta, scal, offs, vals)
    k = X.shape[1]
    dev = X.device
    scal = scal.to(torch.int64)
    rel = scal[nrb:].reshape(nrb, S)
    rowoff = 128 * (torch.arange(RB, device=dev) // 128)          # [RB]
    base = scal[:nrb, None] * WB + rel * 128 - pad                 # [nrb, S]
    offs = offs.reshape(nrb, S, RB)
    vals = vals.reshape(nrb, S, RB)
    Xf = X.to(vals.dtype)
    y = torch.zeros((nrb, RB, k), dtype=vals.dtype, device=dev)
    for s in range(S):
        c = base[:, s, None] + rowoff[None, :] + offs[:, s]       # [nrb, RB]
        inb = (c >= 0) & (c < n)
        v = torch.where(inb, vals[:, s], 0.0)
        g = Xf[c.clamp(0, n - 1)]                                  # [nrb, RB, k]
        y = y + v[:, :, None] * g
    return y.reshape(npad, k)[:n]


def _spmm_fn(entry):
    from . import build
    lib = build.load("windowed_ell")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        # scal, offs, vals, X, Y; nrb, S, n, pad, WB, k; stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def matmat(meta, scal, offs, vals, X):
    """``Y = A X`` for an ``[n, k]`` block of the type of ``vals`` (f32 or
    f64). CUDA tensors: the hand-written kernel of ``csrc/windowed_ell.cu``
    for that type, launched on the current stream (raises on a bad
    argument or a refused launch). CPU tensors: :func:`matmat_reference`."""
    global LAUNCHES
    if X.device.type == "cpu":
        return matmat_reference(meta, scal, offs, vals, X)
    if X.device.type != "cuda":
        raise ValueError(f"windowed-ELL matmat: unsupported device {X.device}")
    nrb, S, npad, n, pad, WB = (int(x) for x in meta)
    _check_meta(meta, scal, offs, vals)
    if X.ndim != 2 or X.shape[0] != n:
        raise ValueError(f"X shape {tuple(X.shape)} is not [{n}, k]")
    if vals.dtype not in _ENTRY:
        raise TypeError(f"vals has dtype {vals.dtype}, expected float32 "
                        "or float64")
    for name, t, dt in (("scal", scal, torch.int32), ("offs", offs, torch.int32),
                        ("vals", vals, vals.dtype), ("X", X, vals.dtype)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    k = X.shape[1]
    Y = torch.empty((n, k), dtype=X.dtype, device=X.device)
    if k == 0:
        return Y
    entry = _ENTRY[X.dtype]
    fn = _spmm_fn(entry)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(scal.data_ptr(), offs.data_ptr(), vals.data_ptr(),
                X.data_ptr(), Y.data_ptr(), nrb, S, n, pad, WB, k, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    return Y
