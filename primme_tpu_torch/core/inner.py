"""Inner correction-equation solver: projected simplified QMR (JDQMR).

PyTorch port of ``primme_tpu/core/inner.py::jdqmr_inner_solve``: per
block column x with residual r and shift sigma it solves

    (I-BQQ')(I-Bxx')(A - sigma B)(I-xx'B)(I-QQ'B) s = -r

by Hermitian simplified QMR with PRIMME's dynamic eigenpair monitoring
(the Delta/Beta/Phi/Psi/Gamma recurrences) for the adaptive stopping
rules. Converged columns are frozen with an ``alive`` mask, as in the
reference, so every step applies the operator to the full ``[n, blk]``
block. The reference's ``lax.while_loop`` is a host loop here: its
condition (any column alive) is read back once per step. With SkewQ and a
preconditioner (JDQR) the right projector on the locked vectors is the
skew projector ``(I - Qhat M^{-1} Q^H)``, ``Qhat = K^{-1} B Q``, with the
small ``M = Q^H Qhat`` LU-factorized once per call.

:func:`normal_inner_solve` is the port of the reference's inner solver
for normal (non-Hermitian) operators, a projected block GMRES(m) with
complex shifts; its Arnoldi vectors stay on the device, and its small
Hessenberg and Givens work runs on the host.
"""

from __future__ import annotations

import torch

from ..params import ConvTest, Target
from .comm import col_dots, global_sum
from .linalg import (bcomb, gram, host_read, real_dtype, machine_eps,
                     prefix_project, scoped, scoped_mv)


def _dots(X, Y):
    """Per-column Re(x_j^H y_j), summed over the ranks of a sharded
    solve."""
    return col_dots(X, Y).real


@scoped("pt_inner")
def jdqmr_inner_solve(cfg, A, B, K, s, X, BX, R, sigma, res, valid, tol,
                      evals=None):
    """Solve the block correction equation with projected sQMR.

    ``X``/``BX`` are the Ritz vectors, ``R`` their residuals, ``sigma``
    the shifts, ``res`` the residual norms, ``valid`` the active-column
    mask, ``tol`` the outer convergence tolerance. ``s`` supplies
    ``num_locked``, ``evecs`` and ``stats`` (``num_outer_iterations``,
    ``anorm_estimate``, ``num_matvecs``).

    Returns ``(sol, n_inner_its, n_matvec_cols, n_precond_cols,
    trace)``: ``trace`` is None, or with ``cfg.inner_trace_cap > 0`` the
    ``[cap, blk, 3]`` device buffer of each step's (value, eigenresidual
    estimate, alive) row, the last slot overwritten past the cap (the
    reference's replay of ``primme_event_inner_iteration``).
    """
    from ..operators import apply_precond

    if evals is None:
        evals = sigma

    n, blk = X.shape
    dtype = X.dtype
    dev = X.device
    rdt = real_dtype(dtype)
    meps = machine_eps(dtype)
    tiny = torch.finfo(rdt).tiny
    if cfg.conv_test == ConvTest.decreasing_LTolerance:
        touch = s.stats.num_outer_iterations
    else:
        touch = s.num_locked
    touch = float(min(touch, 40))

    lam = torch.where(torch.isfinite(evals) & valid, evals, 0).to(rdt)
    shift = torch.where(torch.isfinite(sigma) & valid, sigma, 0).to(rdt)
    vmaskf = valid.to(dtype)[None, :]

    has_lockedQ = cfg.locking or cfg.noc > 0
    Q, BQ = s.evecs, (s.Bevecs if B is not None else s.evecs)
    nlockq = cfg.noc + s.num_locked

    # skew-Q projector state (factorize.c:83-183)
    skew_lu = None
    Qhat = None
    if cfg.skewQ and cfg.rightQ and K is not None and has_lockedQ:
        qmask = torch.arange(Q.shape[1], device=dev) < nlockq
        Qhat = apply_precond(K, BQ, None) * qmask.to(dtype)[None, :]
        Mq = gram(Q, Qhat) + torch.diag((~qmask).to(dtype))
        skew_lu = host_read(torch.linalg.lu_factor, Mq)

    def apply_A_proj(D):
        W = scoped_mv(A, D)
        BD = scoped_mv(B, D) if B is not None else D
        W = W - BD * shift[None, :].to(dtype)
        if cfg.leftQ and has_lockedQ:
            W = prefix_project(BQ, Q, W, nlockq)
        if cfg.leftX:
            W = W - BX * col_dots(X, W)[None, :]
        return W

    if K is not None and cfg.skewX:
        KinvBx = apply_precond(K, BX, shift)
        xKinvBx = col_dots(X, KinvBx)
        xKinvBx = torch.where(torch.abs(xKinvBx) < tiny, 1.0, xKinvBx)
    else:
        KinvBx = None
        xKinvBx = None

    def apply_K_proj(G):
        Y = apply_precond(K, G, shift) if K is not None else G
        if skew_lu is not None:
            ov = gram(Q, Y)
            Y = Y - bcomb(Qhat, torch.linalg.lu_solve(*skew_lu, ov))
        elif cfg.rightQ and has_lockedQ:
            Y = prefix_project(BQ, Q, Y, nlockq)
        if KinvBx is not None:
            ov = col_dots(X, Y)
            Y = Y - KinvBx * (ov / xKinvBx)[None, :]
        elif cfg.olsen:
            Y = Y - BX * col_dots(X, Y)[None, :]
        return Y

    # --- stopping configuration (inner_solve.c:211-252) ---------------------
    eps = cfg.eps if cfg.eps > 0 else 1e4 * meps
    anorm = max(float(s.stats.anorm_estimate), 1e-30)
    floor_tol = max(2 * meps, 0.0) * anorm
    conv_tol = max(eps, 2 * meps) * anorm
    if cfg.conv_test == ConvTest.decreasing_LTolerance:
        LTol = max(floor_tol, max(cfg.rel_tol_base, 1.1) ** (-touch))
        LTol_factor = 1.0
        ETol_factor = 0.0
        ETol = 0.0
    elif cfg.conv_test in (ConvTest.adaptive, ConvTest.adaptive_ETolerance):
        LTol = floor_tol
        LTol_factor = 1.8 ** (-touch)
        ETol_factor = LTol_factor
        ETol = 0.1 if cfg.conv_test == ConvTest.adaptive_ETolerance else 0.0
    else:  # full_LTolerance
        LTol = floor_tol
        LTol_factor = 1.0
        ETol_factor = 0.0
        ETol = 0.0
    adaptive = cfg.conv_test in (ConvTest.adaptive,
                                 ConvTest.adaptive_ETolerance)

    if cfg.max_inner > 0:
        max_its_static = cfg.max_inner
    else:
        max_its_static = max(min(cfg.n, 1000), 1)
    remaining = max(cfg.max_matvecs - s.stats.num_matvecs, 1)
    max_its = min(max_its_static, remaining // max(blk, 1) + 1)

    def zr():
        return torch.zeros((blk,), dtype=rdt, device=dev)

    g = -R * vmaskf
    d = apply_K_proj(g)
    rho_prev = _dots(g, d)
    tau_prev = torch.clamp(res.to(rdt), min=tiny)
    tau_init = tau_prev
    normBx = (_dots(BX, BX) if (B is not None and adaptive)
              else torch.ones((blk,), dtype=rdt, device=dev))
    sol = torch.zeros_like(X)
    delta = torch.zeros_like(X)
    alive = valid.clone()
    theta_prev = zr()
    Beta, Delta, Phi, Psi, Gamma = zr(), zr(), zr(), zr(), zr()
    eval_prev = lam
    eres_prev = zr()
    its = nmv = nprec = 0
    n_alive = host_read(int, alive.sum())
    tcap = cfg.inner_trace_cap
    trace = (torch.zeros((tcap, blk, 3), dtype=rdt, device=dev)
             if tcap > 0 else None)

    while its < max_its and n_alive > 0:
        am = alive
        w = apply_A_proj(d * am.to(dtype)[None, :])
        sigma_p = _dots(d, w)
        bad = (~torch.isfinite(sigma_p)) | (sigma_p == 0)
        alpha = torch.where(bad, 1.0,
                            rho_prev / torch.where(bad, 1.0, sigma_p))
        bad = bad | (~torch.isfinite(alpha)) | (torch.abs(alpha) < meps) \
            | (torch.abs(alpha) > 1.0 / meps)
        first = its == 0
        if first:
            # dead-on-first-iteration columns return sol = r
            sol = torch.where((bad & am)[None, :], -g, sol)
        upd = am & ~bad
        updr = upd.to(rdt)
        g = g - w * (alpha * updr).to(dtype)[None, :]

        gnorm = torch.sqrt(torch.clamp(_dots(g, g), min=0.0))
        theta = gnorm / tau_prev
        c2 = 1.0 / (1.0 + theta * theta)
        tau = tau_prev * theta * torch.sqrt(c2)
        gamma = c2 * theta_prev ** 2
        eta = alpha * c2
        gamma_eff = torch.where(upd, gamma, 1.0)
        eta_eff = torch.where(upd, eta, 0.0)
        delta = delta * gamma_eff.to(dtype)[None, :] \
            + d * eta_eff.to(dtype)[None, :]
        sol = sol + delta * updr.to(dtype)[None, :]

        # --- convergence decisions (inner_solve.c:427-585) ---------------
        stop = bad | (torch.abs(rho_prev) == 0)
        if not first:
            stop = stop | (tau < LTol)

        if adaptive:
            dot_sol = _dots(sol, scoped_mv(B, sol) if B is not None else sol)
            Delta_n = gamma * Delta + eta * rho_prev
            Beta_n = Beta - Delta_n
            Phi_n = gamma * gamma * Phi + eta * eta * sigma_p
            Psi_n = gamma * Psi + gamma * Phi
            Gamma_n = Gamma + 2.0 * Psi_n + Phi_n
            Bn = 1.0 + dot_sol
            eval_upd = shift + (lam - shift + 2 * Beta_n + Gamma_n) / Bn
            eres2 = (tau * tau) / Bn \
                + normBx * (lam - shift + Beta_n) ** 2 / Bn \
                - (eval_upd - shift) ** 2
            eres = torch.sqrt(torch.where(eres2 < 0, tau * tau / Bn, eres2))

            if not first:
                stop = stop | (tau_prev <= eres) | (eres_prev <= tau)
            if cfg.target == Target.smallest:
                stop = stop | (eval_upd > eval_prev)
            elif cfg.target == Target.largest:
                stop = stop | (eval_upd < eval_prev)
            elif cfg.target == Target.closest_abs:
                stop = stop | (torch.abs(lam - eval_upd) > tau_init + eres)
            if ETol > 0 and not first:
                stop = stop | (eres < ETol * tau_init)
            e_term = eres / ETol_factor if ETol_factor > 0 else torch.inf
            isconv = torch.minimum(tau / LTol_factor,
                                   torch.as_tensor(e_term, dtype=rdt,
                                                   device=dev)) < conv_tol
            if not first:
                stop = stop | isconv
            kf = (am & ~stop).to(rdt)
            nkf = 1.0 - kf
            Beta = Beta_n * kf + Beta * nkf
            Delta = Delta_n * kf + Delta * nkf
            Phi = Phi_n * kf + Phi * nkf
            Psi = Psi_n * kf + Psi * nkf
            Gamma = Gamma_n * kf + Gamma * nkf
            eval_prev = eval_upd * kf + eval_prev * nkf
            eres_prev = eres * kf + eres_prev * nkf
            trace_val, trace_res = eval_upd, eres
        else:
            sqit = (its + 1.0) ** 0.5
            isconv = (tau / LTol_factor) * sqit < conv_tol
            if not first:
                stop = stop | isconv
            trace_val, trace_res = lam, tau
        if trace is not None:
            trace[min(its, tcap - 1)] = torch.stack(
                [trace_val.to(rdt), trace_res.to(rdt), am.to(rdt)], dim=-1)

        alive_next = am & ~stop

        # --- next direction ------------------------------------------------
        y = apply_K_proj(g * alive_next.to(dtype)[None, :])
        rho = _dots(g, y)
        beta = torch.where(rho_prev != 0, rho / rho_prev, 0.0)
        beta_eff = torch.where(alive_next, beta, 1.0)
        d = y + d * beta_eff.to(dtype)[None, :]
        anf = alive_next.to(rdt)
        annf = 1.0 - anf

        # one host read per step: the loop condition and the counters
        n_am, n_alive = host_read(torch.Tensor.tolist,
                                  torch.stack((am.sum(), alive_next.sum())))
        nmv += n_am
        nprec += n_alive
        rho_prev = rho * anf + rho_prev * annf
        tau_prev = tau * anf + tau_prev * annf
        theta_prev = theta * anf + theta_prev * annf
        alive = alive_next
        its += 1

    sol = sol * vmaskf
    # A zero solution (e.g. stopped immediately) falls back to the residual
    # so the outer basis still gets an expansion direction.
    solnorm = torch.sqrt(_dots(sol, sol))
    sol = torch.where((solnorm < tiny)[None, :] & (vmaskf != 0), R, sol)
    n_prec0 = host_read(int, valid.sum()) if K is not None else 0
    return sol, its, nmv, nprec + n_prec0, trace


@scoped("pt_inner")
def normal_inner_solve(cfg, A, B, K, s, X, BX, R, sigma, res, valid, tol,
                       evals=None):
    """Inner correction solver for normal (non-Hermitian) operators
    (reference ``normal_inner_solve``): projected block GMRES(m) on

        (I - x x^H)(A - sigma)(I - x x^H) s = -r ,   sigma complex,

    right-preconditioned by ``K`` (fixed, so no flexible variant), one
    ``[n, blk]`` product a step. Each column stops once its GMRES residual
    falls to ``max(0.1 res, 0.33 tol)``; a stopped column is frozen, as in
    the reference. The Arnoldi basis ``[m+1, n, blk]`` and its two-pass
    classical Gram-Schmidt stay on the device; the Hessenberg column and
    its norm come to the host once a step (which also decides the loop,
    the reference's ``fori_loop`` over all ``m`` steps, whose dead steps
    change nothing), where the complex Givens rotations, the rotated
    right-hand side and, at the end, the triangular solves over the steps
    each column took run in double. The Arnoldi inner products are the
    complex ``x^H y``.

    Interface of :func:`jdqmr_inner_solve`. Returns ``(sol, its,
    n_matvec_cols, n_precond_cols, None)``: it records no steps.
    """
    from ..operators import apply_precond

    n, blk = X.shape
    dtype = X.dtype
    dev = X.device
    rdt = real_dtype(dtype)
    tiny = torch.finfo(rdt).tiny
    shift = torch.where(torch.isfinite(sigma) & valid, sigma, 0).to(dtype)
    vmaskf = valid.to(dtype)[None, :]

    has_lockedQ = cfg.locking or cfg.noc > 0
    Q = s.evecs
    nlockq = cfg.noc + s.num_locked

    def project(D):
        if cfg.leftQ and has_lockedQ:
            D = prefix_project(Q, Q, D, nlockq)
        if cfg.leftX:
            D = D - X * col_dots(X, D)[None, :]
        return D

    def prec(D):
        return D if K is None else apply_precond(K, D, shift)

    def op(D):
        Z = prec(D)
        return project(scoped_mv(A, Z) - Z * shift[None, :])

    m = cfg.max_inner if cfg.max_inner > 0 else 15
    m = max(1, min(m, 64))

    # the host side: per-column state in double
    hdt = torch.complex128
    valid_h = host_read(valid.cpu)
    itol = torch.clamp(0.1 * host_read(res.detach().to, "cpu", torch.float64),
                       min=0.33 * float(tol))

    V0 = project(-R * vmaskf)
    beta = torch.sqrt(torch.clamp(_dots(V0, V0), min=0.0))
    ok = (beta > tiny) & valid
    V0 = torch.where(ok[None, :], V0 / torch.clamp(beta, min=tiny)[None, :]
                     .to(dtype), 0)
    Vk = torch.zeros((m + 1, n, blk), dtype=dtype, device=dev)
    Vk[0] = V0
    beta_h, ok_h = host_read(beta.cpu).to(torch.float64), host_read(ok.cpu)

    Rm = torch.zeros((m, m, blk), dtype=hdt)
    g = torch.zeros((m + 1, blk), dtype=hdt)
    g[0] = beta_h.to(hdt)
    cs = torch.zeros((m, blk), dtype=torch.float64)
    sn = torch.zeros((m, blk), dtype=hdt)
    alive = ok_h.clone()
    steps = torch.zeros((blk,), dtype=torch.int64)

    for i in range(m):
        if not bool(alive.any()):
            break
        w = op(Vk[i])
        Vi = Vk[:i + 1]
        h = torch.zeros((i + 1, blk), dtype=dtype, device=dev)
        for _ in range(2):
            hp = global_sum(torch.einsum("jnb,nb->jb", Vi.conj(), w))
            w = w - torch.einsum("jnb,jb->nb", Vi, hp)
            h = h + hp
        hnorm = torch.sqrt(torch.clamp(_dots(w, w), min=0.0))
        # one transfer a step: the Hessenberg column and its norm
        hh = host_read(torch.Tensor.cpu,
                       torch.cat([h, hnorm[None, :].to(dtype)])).to(hdt)
        h_h, hn_h = hh[:i + 1], hh[i + 1].real
        good = (hn_h > tiny) & alive
        wn = torch.where((hnorm > tiny)[None, :],
                         w / torch.clamp(hnorm, min=tiny)[None, :].to(dtype),
                         0)

        # apply the previous rotations j < i to the new column
        hcol = torch.zeros((m + 1, blk), dtype=hdt)
        hcol[:i + 1] = h_h
        for j in range(i):
            a, b_ = hcol[j].clone(), hcol[j + 1].clone()
            hcol[j] = cs[j] * a + sn[j] * b_
            hcol[j + 1] = -sn[j].conj() * a + cs[j] * b_

        # the rotation zeroing the subdiagonal hnorm against a = h[i]:
        # c = |a|/r (real), s = (a/|a|) b/r, rotated diagonal c a + s b
        a = hcol[i]
        bb = hn_h
        absa = torch.abs(a)
        r_ = torch.sqrt(absa ** 2 + bb ** 2)
        nz = r_ > tiny
        rsafe = torch.where(nz, r_, 1.0)
        aun = torch.where(absa > tiny, a / torch.where(absa > tiny, absa,
                                                         1.0), 1.0)
        ci = torch.where(nz, absa / rsafe, 1.0)
        si = torch.where(nz, aun * (bb / rsafe), 0.0)
        gi = g[i].clone()
        g[i + 1] = torch.where(alive, -si.conj() * gi, g[i + 1])
        g[i] = torch.where(alive, ci * gi, gi)
        Rm[:, i, :] = torch.where(alive[None, :], hcol[:m], Rm[:, i, :])
        Rm[i, i, :] = torch.where(alive, ci * a + si * bb, Rm[i, i, :])
        cs[i] = torch.where(alive, ci, cs[i])
        sn[i] = torch.where(alive, si, sn[i])
        Vk[i + 1] = torch.where(host_read(alive.to, dev)[None, :], wn,
                                Vk[i + 1])
        steps = steps + alive.to(torch.int64)
        alive = alive & good & (torch.abs(g[i + 1]) > itol)

    # y per column: backsolve the triangular system over the steps it
    # took; unused (or numerically dead) positions get a unit diagonal
    # and y = 0 there
    used = torch.arange(m)[:, None] < steps[None, :]
    diagmag = torch.abs(torch.diagonal(Rm, dim1=0, dim2=1)).T     # [m, blk]
    fix = (~used) | (diagmag < tiny)
    Rsolve = Rm + torch.eye(m, dtype=hdt)[:, :, None] * fix.to(hdt)[None]
    gm = torch.where(used, g[:m], 0)
    y = torch.linalg.solve_triangular(Rsolve.permute(2, 0, 1),
                                      gm.T[:, :, None], upper=True)
    y = torch.where(used, y[:, :, 0].T, 0)
    sol = torch.einsum("jnb,jb->nb", Vk[:m],
                       host_read(y.to, device=dev, dtype=dtype))
    sol = prec(sol) * vmaskf
    solnorm = torch.sqrt(_dots(sol, sol))
    sol = torch.where((solnorm < tiny)[None, :] & (vmaskf != 0), R, sol)
    nmv = int(steps.sum())
    nprec = nmv + int(valid_h.sum()) if K is not None else 0
    return sol, int(steps.max()), nmv, nprec, None
