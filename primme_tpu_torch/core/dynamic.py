"""DYNAMIC method switching: measured GD+k against JDQMR.

PyTorch port of ``primme_tpu/core/dynamic.py``. The reference's
``PRIMME_DYNAMIC`` keeps an analytic cost model fed by timers inside the
iteration; the port, as the JAX package, measures what the model
estimates: the solver runs in segments of ``_SEG_OUTER`` outer iterations
(:func:`~.solver.run_segment`'s ``seg_end``), each segment is timed on the
host (on the card it ends in a device synchronisation), scored by the
digits of residual reduction it bought (plus locked pairs), and the method
with the better measured digits a second is kept, with the reference's
hysteresis so that the choice does not flap.

Both method variants share one state geometry (basis, restart and block
sizes, ``max_prev_retain``), so the solver state passes from one to the
other as it is.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..params import PrimmeParams, Method, set_method
from . import comm as cm
from .linalg import block_ortho
from .solver import (EigsResult, counted_sums, setup_solver, extract_result,
                     make_config, prepare_window, run_segment)


_SEG_OUTER = 10          # outer iterations a measured segment
_HYSTERESIS = 1.04       # switch only on a >4% advantage (main_iter.c:1221)
_REPROBE_EVERY = 4       # re-measure the idle method every N settled segments


def _progress_score(cfg, resnorms, num_locked, anorm, eps):
    """Total "digits" converged: locked pairs count full depth; basis
    targets count their residual reduction below ||A||."""
    tol = max(eps if eps > 0 else 1e-12, 1e-300) * max(anorm, 1e-300)
    depth = np.log10(max(anorm, 1e-300) / tol)
    res = np.maximum(np.asarray(resnorms, dtype=np.float64), 1e-300)
    digits = np.clip(np.log10(max(anorm, 1e-300) / res), 0.0, depth)
    take = max(0, min(len(res), cfg.ne - int(num_locked)))
    return float(num_locked) * depth + float(np.sum(digits[:take]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm(cfg, A, B, K, s, shifts):
    """Pay the one-time costs of both methods' loops before anything is
    timed (the reference compiles both loops here): the kernels' builds at
    first use and the cuBLAS/cuSOLVER handles and workspaces. Runs one
    product, a shifted preconditioner apply (the one both loops make), a
    block orthogonalization and a window on copies; the solver state and
    its generator are left as they are."""
    from ..operators import apply_precond

    X = s.V[:, :cfg.blk].clone()
    _ = A.matmat(X)
    if B is not None:
        _ = B.matmat(X)
    if K is not None:
        sig = torch.zeros((cfg.blk,), dtype=s.prev_ritz.dtype,
                          device=X.device)
        _ = apply_precond(K, X, sig)
    block_ortho(X, s.V, None, cfg.blk, torch.Generator().manual_seed(0))
    prepare_window(cfg, s, shifts)
    _sync(X.device)


def solve_eigs_dynamic(A, p: PrimmeParams, *, B=None, K=None, v0=None,
                       ortho_const=None, generator=None, dtype=None,
                       device=None, has_precond=None, debug: bool = False,
                       monitor=None, convtest=None, segment_log=None,
                       comm=None) -> EigsResult:
    """Eigensolve with runtime GD+k <-> JDQMR switching (reference
    ``solve_eigs_dynamic``). ``monitor`` and ``convtest`` pass through to
    every segment (:func:`~.solver.run_segment`). ``segment_log``: an
    optional list; a record of every measured segment is appended: its
    ``method`` (``"gd"`` or ``"jd"``; over the records, the reference's
    ``method_trace``), ``seconds``, ``digits`` gained, and the ``outer``
    iterations and ``matvecs`` it ran.

    ``device``, ``generator`` and ``debug`` are :func:`~.solver.solve_eigs`'s:
    the card unless ``device="cpu"`` is asked, the operators on that device.
    ``comm`` runs the row-sharded solve (:func:`~.solver.solve_eigs`).
    Each rank times its own segments, so the ranks' clocks disagree: rank
    0 chooses the next method and every rank follows its choice."""
    with cm.installed(comm):
        n0 = comm.num_global_sum if comm is not None else 0
        v0_ = comm.volume_global_sum if comm is not None else 0
        res = _solve_dynamic(A, p, B, K, v0, ortho_const, generator, dtype,
                             device, has_precond, debug, monitor, convtest,
                             segment_log, comm)
    return counted_sums(res, comm, n0, v0_)


def _solve_dynamic(A, p, B, K, v0, ortho_const, generator, dtype, device,
                   has_precond, debug, monitor, convtest, segment_log,
                   comm) -> EigsResult:
    from .inner import jdqmr_inner_solve

    if has_precond is None:
        has_precond = K is not None

    # Two method variants over one state geometry: resolve the GD+k
    # variant first, then pin its shape-determining fields on the JDQMR one.
    base = p.with_(dynamic_method_switch=False)
    p_gd = set_method(Method.GD_Olsen_plusK, base, has_precond=has_precond,
                      has_mass=B is not None)
    meth_jd = (Method.JDQMR_ETol if p.target.is_extreme else Method.JDQMR)
    p_jd = set_method(meth_jd, base.with_(
        max_basis_size=p_gd.max_basis_size,
        min_restart_size=p_gd.min_restart_size,
        max_block_size=p_gd.max_block_size,
        locking=p_gd.locking), has_precond=has_precond,
        has_mass=B is not None)
    p_jd = p_jd.with_(max_prev_retain=p_gd.max_prev_retain)

    cfg_gd = make_config(p_gd)
    cfg_jd = make_config(p_jd)
    cfg, shifts, s = setup_solver(A, p_gd, B=B, K=K, v0=v0,
                                  ortho_const=ortho_const, dtype=dtype,
                                  device=device, generator=generator)
    dev = s.V.device

    def _run(meth, s, end):
        if meth == "gd":
            return run_segment(cfg_gd, A, B, K, None, shifts, s, convtest,
                               seg_end=end, monitor=monitor, debug=debug)
        return run_segment(cfg_jd, A, B, K, jdqmr_inner_solve, shifts, s,
                           convtest, seg_end=end, monitor=monitor,
                           debug=debug)

    _warm(cfg_gd, A, B, K, s, shifts)

    def snapshot(s):
        win, _ = prepare_window(cfg_gd, s, shifts)
        return (win.cands.resnorms.cpu().numpy(), int(s.num_locked),
                float(s.stats.anorm_estimate))

    rates = {"gd": None, "jd": None}
    current = "gd"   # the reference also starts on GD+k (main_iter.c:2135)
    max_outer = min(p.max_outer_iterations, (1 << 31) - 1)
    max_mv = min(p.max_matvecs, (1 << 31) - 1)

    prev_snap = None
    segs_since_probe = 0   # segments since the idle method last ran
    while True:
        it0 = s.stats.num_outer_iterations
        if s.done or s.give_up or it0 >= max_outer or \
                s.stats.num_matvecs >= max_mv:
            break
        res_b, lock_b, anorm_b = prev_snap or snapshot(s)
        score_b = _progress_score(cfg_gd, res_b, lock_b, max(anorm_b, 1e-30),
                                  p.eps)
        mv0 = s.stats.num_matvecs
        t0 = time.perf_counter()
        s = _run(current, s, it0 + _SEG_OUTER)
        _sync(dev)
        dt = max(time.perf_counter() - t0, 1e-9)
        res_a, lock_a, anorm_a = prev_snap = snapshot(s)
        score_a = _progress_score(cfg_gd, res_a, lock_a, max(anorm_a, 1e-30),
                                  p.eps)
        rate = max(score_a - score_b, 0.0) / dt
        if segment_log is not None:
            segment_log.append({
                "method": current, "seconds": dt,
                "digits": score_a - score_b,
                "outer": s.stats.num_outer_iterations - it0,
                "matvecs": s.stats.num_matvecs - mv0})
        rates[current] = (rate if rates[current] is None
                          else 0.5 * (rates[current] + rate))

        other = "jd" if current == "gd" else "gd"
        if rates[other] is None:
            current = other           # initial exploration of both methods
            segs_since_probe = 0
        elif rates[other] > _HYSTERESIS * (rates[current] or 0.0):
            current = other
            segs_since_probe = 0
        elif segs_since_probe >= _REPROBE_EVERY:
            # the idle method's rate is stale (its last measurement may
            # predate a regime change): force one measured segment on it
            # so that switching stays live
            current = other
            segs_since_probe = 0
        else:
            segs_since_probe += 1
        if comm is not None:
            current = ("gd", "jd")[comm.broadcast_int(
                ("gd", "jd").index(current))]

    return extract_result(cfg_gd, s, shifts)
