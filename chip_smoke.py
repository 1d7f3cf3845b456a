#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primme_tpu_torch``) on one card.

Drives the port's paths once at full size. The sparse paths: ``eigsh`` on
the 64^3 27-point Laplacian (n = 262,144, 6.86M nonzeros) in random node
order, k=10 smallest, JDQMR_ETol with block 2, basis 24, restart 14, with
the spectrum-verification probe on; first in f32 at tol 1e-5, then on the
same matrix in f64 at tol 1e-10. The format chooser packs the matrix into
the windowed-slot ELL layout and every product goes through the
hand-written kernel of ``primme_tpu_torch/csrc/windowed_ell.cu`` on the
operator's compact warp-sliced layout (no padding slots): its f32 entry
point for the f32 solve, its native FP64 one for the f64 solve. Then
``bench.py``'s headline: the 7-point Laplacian ``Stencil3DOperator`` on
the 64^3 grid with the shift-aware ``JacobiPrecond``, the same settings in
f32 at tol 1e-5, through ``solve_eigs``; every product runs
``csrc/stencil3d.cu`` and every preconditioner apply ``csrc/jacobi.cu``.
Then ``__graft_entry__.entry``'s GD_Olsen_plusK + Jacobi on the 16^3
stencil, run to convergence. Last, ``eigsh`` through the format chooser's
other branches at n = 262,144 with the sparse paths' settings: the banded
one (``csrc/dia.cu``), the DIA+ELL hybrid (``csrc/dia.cu`` and the
sliced-ELL kernel on a layout built from CSR) and the ELL one
(``aslinearoperator``'s ``ELLOperator`` on the same kernel), and a
BlockELL product against scipy. Then the rest of the Hermitian surface:
the north star (the 128^3 stencil's f32 solve polished in native FP64 to
a true residual of 1e-10 with a Chebyshev preconditioner over the f64
stencil kernel), a generalized FEM pencil (``M=``), orthogonality
constraints (``lock=``) and interior targets through the refined and
harmonic projections and JDQR's skew-Q projector. Last, ``svds`` (the
two-stage singular value solver) on the grounded incidence matrix of the
64^3 grid graph (m = 1,036,288 rows, n = 262,144 columns), an
``ELLOperator`` whose ``A`` and ``A^T`` layouts run the sliced-ELL kernel.
Last, complex Hermitian input: ``eigsh`` on the magnetic graph Laplacian
of the 64^3 grid (a tight-binding electron in a uniform field, the
U(1)-covariant Laplacian of lattice gauge theory; 11 diagonals) through
the DIA kernel's complex entry points in complex64 and complex128, on a
complex scatter through the sliced-ELL kernel's complex64 one, and
``svds`` on the magnetic incidence ``[D; 0.1 I]`` (1,044,480 x 262,144)
in complex128 through both stages. Last, ``eigs`` on normal
(non-Hermitian) operators: the periodic convection-diffusion operator of
the 64^3 torus (velocities 0.3, 0.5, 0.7; 7 non-zeros a row), k=7 of
smallest real part, in f64 through the sliced-ELL kernel's f64 entry
point on the complex128 basis' real view, as the linearised complex
Ginzburg-Landau operator in complex64 through its c64 entry point, and
with the reference's default GD_plusK on a ``BandedOperator`` at 24^3
through ``dia_f32`` on the complex64 basis' real view.

Phases, each printing its own lines; any failed check raises:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles ``windowed_ell.cu``, ``stencil3d.cu``, ``jacobi.cu``
   and ``dia.cu`` from the checkout's sources, and phase 48's
   ``tools/half_packed_check.cu``, one ``nvcc`` each, all started
   together;
3. f32 layout and kernel: ``pack`` and ``compact`` of the permuted
   matrix timed apart and equal to the operator's arrays; the entry count
   E <= 1.1 nnz and the operator's device bytes <= 1.1 nnz (4 + 4) + 8n.
   The kernel against its plain PyTorch version at k in {1, 2, 4, 8}: max
   |diff| <= 1e-5 * max|y|; the median time of the kernel, the plain
   version and the library call that computes the same product (the
   fastest of ``A_csr @ X``, ``torch.sparse.mm(A_csr, X)`` and
   ``A_csr @ X`` on a column-major copy of X, with ``A_csr`` a
   ``torch.sparse_csr_tensor``: cuSPARSE; the port never calls it),
   each over TIMING_REPS (7) samples of 10 back-to-back calls between
   CUDA events,
   queued behind a spin kernel so that host time does not count (the
   kernel also without the spin; the plain version, which reads its
   longest row to the host each call, only without it); and the bound, the bytes the product
   needs (each non-zero's value and column, X and Y, once) over
   3.35 TB/s. The kernel runs on the path the wrapper's rule gives the
   layout (the ring, or the direct path where the mean slice width is at
   most ``NARROW_WIDTH``), printed with that width; the other path is
   timed beside it and must equal it bit for bit (as in every phase that
   compares the sliced-ELL kernel: 5, 12, 13, 19 and 23);
4. f32 solve: the kernel's launch count during the solve (at least one
   per two matvecs, no other kernel), eigenvalues within 1e-4 of the
   closed-form spectrum, every true residual (A in f64 on the host) <=
   1.5e-5 * ||A||, probe verified and not exhausted, matvec count within
   2x of the JAX reference's 1385;
5. f64 layout and kernel: the chooser packs the f64 matrix into an f64
   windowed operator; the layout checks of phase 3 with 8-byte values;
   the FP64 kernel against the f64 plain version at k in {1, 2, 4, 8}:
   max |diff| <= 1e-13 * max|y|, and the times and bound of phase 3;
6. f64 solve: only FP64 launches, at least one per two matvecs;
   eigenvalues within 1e-8 of the closed form, every true residual (on
   the host) <= 1.5e-10 * ||A||, probe verified and not exhausted, matvec
   count within 2x of the JAX reference's 1876;
7. stencil kernel against its plain version, f32 and f64, at every shape
   of ``KERNEL_SHAPES``: the 64^3 grid at k in {1, 2, 4, 8}, 128^3 and
   256^3 at k in {2, 8}, and at 64^3 a k=2 column slice of a [n, 24]
   block at column offset 1 (rows 24 apart, 4 bytes off 8: the kernel's
   scalar path, as the solve's basis slices may be): bit for bit (NaN for
   NaN); the launch plan (columns a point, load width, the stencil's
   tile and grid); the kernel's time with the spin and without, the plain
   version's, the bound (X read and Y written once over 3.35 TB/s) and
   the share; ``library_ms``, a depthwise ``conv3d`` over the same memory
   (cuDNN, TF32 off; timed only, its max |diff| printed); ``copy_ms``,
   torch's copy of X into a preallocated Y (the same bytes in one launch:
   the launch-and-bytes floor; a yardstick the port never calls); and a
   70000 x 1 x 32 grid at k=1, past CUDA's 65535 planes: two launches
   counted as one call, bit for bit;
8. Jacobi kernel against its plain version at the same shapes and types,
   the shifted entry (one shift equal to a diagonal entry, so the eps
   clamp fires) and the unshifted one: bit for bit; the times of phase 7
   with ``copy_ms``; the unshifted apply's ``library_ms`` is
   ``torch.div(X, d[:, None])`` (d lies far from 0, so the eps guard does
   not act), the shifted one has none (no single PyTorch call computes
   ``X[:, j] / guard(d - sigma_j)``);
9. the headline: ``bench.py``'s configuration through ``solve_eigs``, one
   untimed solve and then the minimum of HEADLINE_TIMED (1) timed ones,
   each printed;
   ``bench.py``'s ``ok`` (max resnorm <= 1.5e-5 * anorm_estimate,
   eigenvalues within 1e-4 of the closed form), every true residual (the
   stencil's plain version) <= 1.5e-5 * ||A||, probe verified and not
   exhausted, matvecs within 2x of the JAX reference's 1710, stencil
   launches >= matvecs / 2, Jacobi launches > 0, no windowed-ELL launch;
   the share of each kernel's launches that took the vector path; the
   peak device memory and the share of the solve time the two kernels
   account for (launches x their k=2 time);
10. GD_Olsen_plusK + Jacobi on the 16^3 stencil, k=4, tol 1e-4:
    eigenvalues within 1e-4 of the closed form, probe verified, matvecs
    within 2x of the JAX reference's 494, Jacobi launches > 0 (the Olsen
    correction of ``gd_correction``);
11. banded: the 64^3 27-point Laplacian in grid order; the chooser must
    return a 27-diagonal ``BandedOperator`` with no permutation (its
    seconds and peak host memory printed); the DIA kernel against its
    plain version, matmat and rmatmat, f32 and f64, at k in {1, 2, 4, 8}
    and on the k=2 slice at column offset 1: bit for bit, timed as in
    phase 7 (the plain version without the spin: ten of its calls
    overflow the launch queue) with ``library_ms`` cuSPARSE's CSR product
    of the same matrix; then the solve at tol 1e-5: eigenvalues within
    1e-4 of the closed form, true residuals <= 1.5e-5 ||A||, probe
    verified and not exhausted, matvecs within 2x of the JAX reference's
    1405, DIA launches >= matvecs / 2, no windowed-ELL launch;
12. DIA+ELL: the 7-point Laplacian plus a long-range scatter
    (``hybrid_matrix``); the chooser must return ``SumOperator([
    BandedOperator(7 offsets), ELLOperator])``; the sliced-ELL kernel
    against its plain version on the remainder's layout at k in {1, 2, 8}
    (as phase 3); the solve: eigenvalues within 1e-4 of the JAX
    reference's, true residuals <= 1.5e-5 times the Gershgorin bound of
    ||A||, probe, matvecs within 2x of 1438, DIA and sliced-ELL launches
    each >= matvecs / 2;
13. ELL: a random symmetric matrix with about 10 entries a row
    (``scattered_matrix``); ``rcm_banded`` must return None (it tries the
    windowed pack, whose count array takes about 2 GB here) and
    ``aslinearoperator`` an ``ELLOperator``; the kernel against its plain
    version at k in {1, 2, 8}; the solve gated as in phase 12 against the
    JAX reference's f64 solve of the matrix (533 matvecs; its f32 solve
    stagnates);
14. BlockELL: a ``BlockELLOperator`` (plain PyTorch) of ``fem_like`` at
    n = 262,144 against scipy at k in {2, 8}, timed beside its bytes bound
    and cuSPARSE's CSR product;
15. the north star, ``benches/northstar.py``'s configuration at full size
    through ``tools/torch_northstar.py``'s stages: the 128^3 7-point
    Laplacian (n = 2,097,152), k=10; the f32 JDQMR_ETol + Jacobi solve
    (basis 24, block 2, restart 14, locking off, ``v0`` from
    ``default_rng(0)``), then ``refine_eigsh`` in native FP64 on the f64
    stencil with ``ChebyshevPrecond.from_operator(A64, degree=8)`` to tol
    1e-10: every eigenvalue within 1e-10 of the closed form, the largest
    true residual (recomputed in f64 with the stencil's plain version)
    <= 1e-10 * 12 (the closed form's bound of ||A||), the f32 matvecs and
    the polish iterations each within 2x of the JAX package's (3112 and 77,
    ``tools/torch_smoke_refs.py --phase northstar``), the stencil and
    Jacobi kernels >= matvecs / block and > 0 in the f32 stage, the f64
    stencil >= iterations x (degree + 2) in the polish and no other
    kernel there; the stages' seconds, the peak device memory and one
    polish iteration's device time split into the f64 stencil, the dense
    work (GEMMs and cuSOLVER) and the rest (``torch.profiler``); then the
    same two stages and gates at k=100 (BASELINE config 4: hard locking,
    basis 64, block 4 in the f32 stage), the counts held to the
    reference's recorded 21,005 matvecs and 72 iterations;
16. the generalized pencil: ``eigsh(K, k=10, M=M, which="SA", tol=1e-5)``
    with the sparse phases' settings on the Q1 finite-element Laplacian of
    the 64^3 grid (``fem_q1``: K with 5.3M non-zeros, 21 a row, its face
    terms cancelling, and M with 6.9M, 27 a row; each an
    ``ELLOperator``): eigenvalues within 1e-4 of the closed form,
    true residuals ``||K x - lambda M x||`` (f64 on the host) <= 1.5 tol
    ``||M^-1 K||``, ``X^T M X = I`` to 1e-4, probe verified, matvecs
    within 2x of the JAX package's 1005, and the sliced-ELL kernel
    launched for every product of K and of M, each >= matvecs / 2;
17. orthogonality constraints: ``eigsh`` on the headline's 64^3 stencil
    (with Jacobi) with ``lock=`` the closed-form eigenvectors of
    lambda_1-4, k=6: the closed form's lambda_5-10 within 1e-4, vectors
    orthogonal to the constraints to 1e-5, true residuals, probe, stencil
    launches >= matvecs / 2;
18. interior targets: the k=5 eigenvalues closest to 50 of
    ``tests/test_eigsh.py``'s fixture (``interior_matrix``; the banded
    branch) by GD_plusK with the refined and with the harmonic projection
    at n = 512 and by JDQR with Jacobi (the skew-Q projector) at n = 2048:
    each within 1e-4 ||A|| of scipy's shift-invert ``eigsh`` (f64, host),
    true residuals, matvecs within 2x of the JAX package's (1629, 2226,
    990), DIA launches >= matvecs / 2;
19. the sliced-ELL kernel on rectangular layouts: ``grounded_incidence(64)``
    (``A = [D; 0.1 I]``, D the grid graph's edge-node incidence) as the
    ``ELLOperator`` ``svds`` builds, its ``A`` layout (m rows, X of n
    rows) and ``A^T`` layout (n rows, X of m rows), f32 and f64, at k in
    {1, 2, 4, 8}: against the plain version (1e-5 and 1e-13 of max|y|),
    timed as phase 3 with ``copy_ms``, the bound counting values, columns,
    X and Y once, each layout's path printed and the other path timed;
    the svds solves (20-22, 27) launch each path that the rule gives one
    of their two layouts, and no other;
20. ``svds(A, k=10, which="LM", tol=1e-10)`` (hybrid) on the f64 matrix:
    singular values within 1e-8 sigma_max of the closed form ``sqrt(mu_a
    + mu_b + mu_c + 0.01)``, the host's f64 triplet residual <= 10 tol
    ||A||, ``U^T U`` and ``V^T V`` = I to 1e-8, each stage's matvecs
    within 2x of the JAX package's, the probe verified in each stage it
    covers, ``windowed_ell_spmm_f64`` launches >= matvecs and no other
    kernel;
21. ``method="augmented"``, k=4, LM, tol 1e-5 on the f32 matrix: values
    within 1e-4 sigma_max, the residual, orthonormality to 1e-4, matvecs,
    probe, ``windowed_ell_spmm_f32`` launches >= matvecs;
22. ``svds(A, k=4, which="SM", tol=1e-8)`` (hybrid, f64): delta and the
    three-fold ``sqrt(mu_1 + delta^2)`` within 1e-7 sigma_max, residual and
    orthonormality as phase 20, stage 1 within 2x of the JAX package's
    matvecs, stage 2 run (> 0 matvecs), the total within 2x, launches.
    The JAX package's counts (``REF_SVDS``) come from
    ``python3 tools/torch_smoke_refs.py --phase svds`` on the CPU;
23. the complex entry points against their plain versions at k in {1, 2,
    4, 8}: ``dia_c64``/``dia_c128`` on the magnetic Laplacian
    (``magnetic_laplacian(64)``, the chooser's complex64
    ``BandedOperator``, no permutation), matmat and its adjoint ``A^H``
    bit for bit, with the odd-offset slice; ``windowed_ell_spmm_c64`` on
    phase 26's layout and ``_c128`` on phase 27's ``A`` and ``A^H``
    layouts (1e-5 and 1e-13 of max|y|); each timed as phase 3 with
    ``copy_ms`` and torch's complex CSR product (cuSPARSE) as
    ``library_ms``, beside its bound;
24. ``eigsh`` on the magnetic Laplacian in complex64 at tol 1e-5, gated as
    phase 11: ``dia_c64`` launches >= matvecs / 2 and no other kernel,
    eigenvalues within 1e-4 of the closed form (``magnetic_eigenvalues``:
    the four-fold 0.06665188894193 the last), residuals in complex128 <=
    1.5 tol ||A|| (Gershgorin 12), probe, matvecs within 2x of the JAX
    package's (``REF_MAG_MATVECS``);
25. the same in complex128 at tol 1e-10 (``dia_c128``; within 1e-8);
26. ``complex_scattered_matrix`` (phase 13's scatter with seeded phases,
    n = 262,144) in complex64: ``rcm_banded`` None, ``aslinearoperator``
    a complex64 ``ELLOperator``, ``windowed_ell_spmm_c64`` launches >=
    matvecs / 2, eigenvalues within 1e-4 of the JAX package's complex128
    run (``REF_CELL_EVALS``), matvecs within 2x of its complex64 run's;
27. ``svds(A, k=6, which="SM", tol=1e-8)`` on ``magnetic_svd_matrix(64)``
    in complex128, both stages: values within 1e-8 sigma_max of
    ``sqrt(lambda(L) + 0.01)``, triplet residuals in complex128 <= 1.5 tol
    ||A||, ``U^H U`` and ``V^H V`` = I to 1e-8, stage 1 and the total
    within 2x of the JAX package's (``REF_CSVDS``; the total at most 2x,
    stage 2's count a threshold effect), stage 2 > 0 matvecs,
    ``windowed_ell_spmm_c128`` launches >= matvecs / 2 (stage 1
    multiplies blocks of up to four columns, one launch a side), no other
    kernel. The
    JAX package's counts come from ``python3 tools/torch_smoke_refs.py
    --phase complex``.

28. ``eigs(A, k=7, which="SR", tol=1e-8, method="JDQMR")`` on
    ``convection_diffusion(64)`` in f64 (n = 262,144, 1,835,008
    non-zeros), the scipy matrix as a user passes it
    (``aslinearoperator``'s ``ELLOperator``): the values set-matched to
    the closed form's seven smallest by real part (lambda = 0 and the
    cluster at 2 - 2 cos(2 pi / 64)), each within 1.5 tol ||A||; true
    residuals in complex128 <= 1.5 tol ||A||; matvecs within 2x of the JAX
    package's (``REF_NORMAL``); ``windowed_ell_spmm_f64`` launched at
    least matvecs / block times (the complex128 basis' real view) and no
    other kernel: no complex entry point;
29. the same on the complex Ginzburg-Landau operator (coef 1 - 0.5i) in
    complex64 at tol 1e-5: ``windowed_ell_spmm_c64``;
30. GD_plusK (``eigs``' default method, one matvec an outer iteration)
    at tol 1e-5 on the port's ``BandedOperator.from_scipy`` of the f32
    matrix at 24^3 (13 diagonals with the periodic wraps): ``dia_f32`` on
    the complex64 basis' real view, no other kernel. Cut from 64^3 to
    24^3: the JAX package's GD_plusK takes 4091 matvecs at 32^3 and 2427
    at 24^3 (``tools/torch_smoke_refs.py --phase normal``).
    The JAX package's counts come from ``python3 tools/torch_smoke_refs.py
    --phase normal``.

31. ``eigsh(method="DYNAMIC")`` (the reference's default method: measured
    GD+k/JDQMR switching in segments of 10 outer iterations) on
    ``bench.py``'s headline (phase 9's operator, preconditioner and
    settings, ``v0`` from ``default_rng(seed)``), one untimed solve and one
    timed: values within 1e-4 of the closed form, true residual <= 1.5 tol
    ||A||, probe verified and not exhausted, matvecs at most 2x the larger
    of the JAX package's JDQMR_ETol (1710) and GD_Olsen_plusK (2275)
    counts, both methods in the trace, stencil launches >= matvecs / 2,
    shifted Jacobi launches >= the matvecs outside the probe / 2, no other
    kernel; the method trace, each method's segments, seconds and mean
    digits a second printed (the JAX package's own DYNAMIC trace,
    clock-dependent, printed beside it);
32. the headline through ``solve_eigs`` twice, then with
    ``segment_outer=10``: when the two unsegmented runs agree bit for bit,
    the segmented one must too (values, residuals, vectors, matvecs, inner
    iterations); otherwise the non-determinism is printed and the gate is
    equal matvecs and values within 1e-6;
33. the headline through ``eigsh`` with ``return_history=True`` (one record
    an outer iteration, every key of equal length, ``sum(num_inner)`` the
    stat) and with ``monitor_inner=True`` and a counting monitor; the
    solve time with no monitor, with the history, with the inner replay
    and with the profiler scopes forced open as under a profiler (min of
    EVENT_ROUNDS (1) each, interleaved), and one scope's host cost, opened
    and gated off, times the scopes a solve enters;
34. the config-file driver (``primme_tpu_torch.driver.main``) on a config
    with no method line (DEFAULT_METHOD, so DYNAMIC), the Jacobi
    PrecChoice, eps 1e-10 and 6 smallest values of the 7-point Laplacian
    at 32^3 in random order, written with its ``.mtx`` to a temporary
    directory: the ``--save-x`` run and a ``checkXFile`` run against the
    saved file each exit 0 with "solution check: OK", values within 1e-8
    of the closed form, ``windowed_ell_spmm_f64`` launches >= matvecs / 2;
    then an svds config (``primme_svds_hybrid``) on a 40 x 25 matrix;
35. ``eigsh(profile="pt_", time_breakdown=True)`` on phase 10's solve:
    ``time_source`` "measured", the four phase scopes each > 0 and with
    ``time_other`` within 10% of the traced device busy time, the stencil
    kernels' device time inside ``pt_matvec`` and the Jacobi kernels'
    inside ``pt_precond``, a profile event delivered for every key of
    ``stats["profile"]``; the split, the largest device items and the
    profiler's post-processing seconds printed;
36. the C ABI in-process (``capi_inprocess_phase``): the port's
    ``capi_support`` driven with numpy buffer addresses on the 7-point
    Laplacian of the 64^3 grid in random order (n = 262,144, f64):
    ``eigsh_csr`` (k=6 smallest, tol 1e-10) and a parameter handle
    (numEvals, eps, jacobi 1, PRIMME_DEFAULT_METHOD) through
    ``eigsh_run``; values within 1e-8 of the closed form, the written
    residual norms and the host's f64 residuals of the written vectors
    <= 1.5 tol ||A||, ``windowed_ell_spmm_f64`` in each call,
    ``jacobi_shifted_f64`` in the second, no other kernel;
37. the C ABI from C (``capi_c_phase``): the port's C library built from
    ``primme_tpu_torch/native/capi.cpp``, ``capi_smoke.c`` built against
    it and run in a subprocess on the card (PYTHONPATH the repository and
    site-packages): ``ptpu_eigsh_csr`` and ``ptpu_eigsh_csr_`` on phase
    36's matrix, ``ptpu_eigsh_matvec`` with the program's own CSR product
    on the 32^3 Laplacian, ``ptpu_params_*`` + ``ptpu_eigsh_run``,
    ``ptpu_svds_csr`` and ``ptpu_svds_params_*`` + ``ptpu_svds_run`` on
    ``grounded_incidence(32)``, each result against the closed form as in
    phases 36 and 20; the child seen among ``nvidia-smi``'s compute apps;
    then the JAX package's ``native/test_capi.c``, compiled unchanged
    against the same library: "CAPI OK";
38. the complex Jacobi entry points (``jacobi_shifted_c64``/``_c128``,
    ``jacobi_c64``/``_c128``) against their plain versions, bit for bit,
    at 64^3 (k in {1, 2, 4, 8}), 256^3 k=2 and the odd-offset slice, with
    denominators real in value and truly complex and one shift equal to a
    diagonal entry; the launch plan printed (row group, load width,
    columns a thread); timed as phase 8 times, ``torch.div`` the unshifted
    apply's ``library_ms``; and the real ``jacobi_f64`` at 32^3 k=1
    against ``torch.div``;
39. solves through them: ``eigsh(jacobi=True)`` on phase 24's magnetic
    Laplacian (complex64), the same with a fixed
    ``JacobiPrecond(use_shifts=False)`` at 32^3, ``eigs`` with a complex
    and with a real ``JacobiPrecond`` (phases 29 and 28's operators at
    32^3, cut from 64^3 for time), the config-file driver on the 32^3
    magnetic Laplacian in complex128 with the Jacobi PrecChoice; each
    gated on the closed form, residuals, launches and matvecs within 2x
    of the JAX package's (``tools/torch_smoke_refs.py --phase jacobi``);
40. the half-precision basis: ``eigsh(k=4)`` of phase 4's matrix with
    ``dtype`` bf16 and f16 at tol 4 eps(half): values and vectors f32,
    true residuals < 16 eps(half) ||A||, each value within its residual of
    the closed form, the basis stored in the half type,
    ``windowed_ell_spmm_f32`` >= matvecs / 2, matvecs within 2x of the JAX
    package's (``--phase half``); peak device memory beside phase 4's.

Phases 41-45, the row-partitioned solve (``mesh=``, over
``torch.distributed``). The card is one: P ranks share it over a gloo
group (NCCL refuses two ranks on one device), so no time here is a
scaling number. The extensions are built (phase 2) before any rank is
spawned; the ranks load them. Each world of ranks is spawned once (the
``spawn`` start method); an exception in a rank fails the run.

41. the halo product at P = 2 and 4: ``HaloELLOperator.from_scipy`` of
    phase 3's permuted 64^3 27-point Laplacian (RCM kept where it shrinks
    the halo) and of a banded scatter of ``tests/test_distributed.py``'s
    kind at n = 262,144 (``band_scatter``), k = 2: ``h`` and ``hrows``;
    the elements each rank sends a product (``h k`` a neighbour, ``2 h
    k`` on an inner rank) and no all-gather; the gathered product within
    1e-5 max|y| of the port's unsharded product and of scipy's f64 one;
    the sliced-ELL launches a product on each rank, each layout's launch
    into its row slice (``out=``) equal bit for bit to its launch into a
    block of its own; the median host time of a sharded product beside
    the unsharded kernel's device time (P ranks on one card: not a
    scaling number);
42. the headline (phase 9's settings, probe on) through
    ``eigsh(mesh=)`` on 2 ranks: values within 1e-4 of the closed form,
    true residuals <= 1.5 tol ||A||, probe verified, matvecs within 2x of
    1710, ``stencil3d_f32`` and ``jacobi_shifted_f32`` launches >=
    matvecs / 2 on every rank, both ranks' values equal bit for bit; then
    ``distributed.dryrun_multichip`` inside the 2-rank and the 4-rank
    worlds with its asserts;
43. the sparse chooser under a mesh on 2 ranks: phase 4's call must take
    ``HaloELLOperator`` in the RCM order, every product the sliced-ELL
    kernel (its launches the layouts' count times the exchanges), gated
    as phase 4 (matvecs within 2x of 1385); phase 11's grid-order matrix
    must keep ``BandedOperator`` (``dia_f32`` on the window), gated as
    phase 11;
44. ``svds(mesh=)`` on 2 ranks: phases 20 and 22's calls on
    ``grounded_incidence(32)``, their closed-form gates, each stage's
    matvecs within 2x of the unsharded port's same call;
45. NCCL on the card: a one-rank NCCL group (``init_device_mesh("cuda",
    (1,))``, which takes the unsharded path) runs one all-reduce and
    phase 42's call at 32^3; the backend printed, the values against the
    unsharded run's. NCCL with several ranks needs several cards.

Phase 46, the last surface, at small sizes: ``to_dense()`` of the 8^3
stencil (f32, f64), a ``BandedOperator`` (f32, f64, complex64),
``ELLOperator.from_coo`` (f32, square and 300 x 170), a
``WindowedELLOperator`` and a ``JacobiPrecond`` on the card, each within
1e-6 (single) or 1e-14 (double) of scipy's ``toarray()`` or the closed
form, relative to its largest entry, and its kernel launched;
``solve_eigs`` on ``ELLOperator.from_scipy(A).to("cuda")`` (the 16^3
7-point Laplacian in random order, k=4) with no ``device=``: state on the
card, ``windowed_ell_spmm_f32`` >= matvecs / 2, values within 1e-4 of the
closed form, probe verified; the same call on the CPU operator refused,
naming ``.to(device)`` and ``device="cpu"``; ``io.load_operator`` on the
card; ``debug=True``: a line with the reference's fields a monitor event,
values and matvecs those of the solve without it; ``PTPU_PROBE_DEBUG=1``
in a child process: a line a probe round.

Phase 47, half operators (the JAX package's f16 and bf16 operators, the
reference's half kind): each f16 and bf16 entry point of the stencil,
Jacobi (shifted and unshifted), DIA and sliced-ELL kernels on its phase's
64^3 operator at k=2 against its plain version (bit for bit; the sliced
ELL within one unit in the half's last place, its two paths bit for bit),
timed as phase 3 times with ``copy_ms``, the bound (2 bytes a value, i32
indices, X and Y once) and ``library_ms`` where torch computes the same
function in the half type on the card (``conv3d``, ``torch.div``, a half
CSR product; none printed where it refuses the type); the mixed entry
points (half values or diagonal, an f32 or f64 block: what a half basis
hands a half operator) against their plain versions and the f32 (f64)
kernels on the widened values, the f32 ones timed
(:func:`mixed_kernel_rows`); the redesigned Jacobi (half, f32 and f64
blocks over a half diagonal) and mixed DIA instances held bit for bit at
n = 64^3 - 1, k in 1, 2, 3, 4, 8 and a k=2 slice at column offset 1, both
forms (:func:`new_kernel_checks`); then the solves of ``HALFOP_SOLVES`` at tol
4 eps(half): ``bench.py``'s 64^3 stencil with its Jacobi in f16 and bf16
under an f32 solve and in bf16 with ``dtype=None`` (a half basis), phase
4's matrix as an ``ELLOperator`` and phase 11's as the chooser's
``BandedOperator``, each in both half types under an f32 solve and, at
phase 40's k, in f16 (ELL) and bf16 (DIA) over a half basis: true
residuals (f64) below 16 eps(half) ||A||, each value within its residual
of the closed form, the probe verified for the f32 solves, the half (over
a half basis: mixed) kernels launched at least matvecs / 2 times and
every other entry point (their f32 counterparts too) not at all, each
launch of the shifted half or mixed Jacobi and of the mixed DIA through
the redesigned kernel (``RUN_LAUNCHES``, ``MIXED_LAUNCHES``), matvecs
within 2x of the JAX package's (``tools/torch_smoke_refs.py --phase
halfop``); each solve's time and peak device memory beside its f32
counterpart's.

Phase 48, the packed half arithmetic: every pair of 16-bit patterns
(2^32 pairs) through the packed mul, add and sub of the half kernels
(``primme_tpu_torch/csrc/half2.cuh``) and through f32 on the exact
operands rounded once, in f16 and bf16 (``tools/half_packed_check.cu``,
built here): 0 mismatches for each of the six pairs (two NaN results
match; all else by bits). Then the half rows at 256^3 and k=2: each f16
and bf16 entry point of the stencil, Jacobi and DIA and the mixed Jacobi
and DIA entry points with an f32 block, bit for bit against the plain
versions and timed as phase 47 (7 samples of 5 calls), the 27-point DIA
built on the card from its closed form; then the redesigned instances
held as in phase 47 at n = 256^3 - 1.

The kernel tables' shapes at k in ``UNTIMED_K`` (1, 4 and 8) are held
against the plain versions and not timed, to keep the run within its
time limit.

The run prints the seconds of phases 1-2 (the build), 3-8, 9-10, 11-14,
15, 16-18, 1-18, 46, 47, 48 and the whole run (``seconds`` in the record).
Each solve also prints its peak device memory. The second-to-last line is
a JSON record of the kernels and the solves (each kernel record also
lists its launches on every path, ``path_launches``); the last is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``.
"""

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

GRID = 64            # the problem is the 64^3 grid: n = 262,144
REF_MATVECS = 1385   # the JAX reference's matvecs at GRID (CPU run)
# the JAX reference's matvecs for the f64 solve at GRID, seed 0: its
# eigsh on the f64 matrix (its f64 windowed operator) on the CPU
REF_MATVECS_F64 = 1876
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
L2_BYTES = 50e6             # H100 SXM L2 (the same data sheet)
# the JAX reference's counts for bench.py's configuration (64^3 stencil +
# Jacobi, JDQMR_ETol; solve_eigs on the CPU, x64 off as bench.py runs)
REF_HEADLINE_MATVECS = 1710
REF_HEADLINE_PROBE = (440, 3)        # num_probe_matvecs, num_probe_rounds
# timed repeats of phase 9's headline (2) and rounds of phase 33's variants
# (1), so that phases 36-47 fit the run's time limit beside them
HEADLINE_TIMED = 1
EVENT_ROUNDS = 1
TIMING_REPS = 7      # samples of a median time
GD_GRID = 16
REF_GD_MATVECS = 494   # the JAX reference, GD_Olsen_plusK + Jacobi at 16^3
KERNEL_SOURCES = ("windowed_ell", "stencil3d", "jacobi", "dia")
# phases 11-13: the JAX reference's counts for the same eigsh call on the
# CPU (tools/torch_smoke_refs.py: seed 0, x64 on, the f32 matrices below)
REF_BANDED_MATVECS = 1405
REF_HYBRID_MATVECS = 1438
REF_HYBRID_EVALS = (0.01283545047044754, 0.013797947205603123,
                    0.013878232799470425, 0.013991146348416805,
                    0.02051515132188797, 0.02086835727095604,
                    0.02094254083931446, 0.02531163953244686,
                    0.0254620723426342, 0.027725255116820335)
# phase 13: the JAX reference's f64 solve of the same matrix (its f32 solve
# stagnates there: 2000 matvecs, and eigenvalues up to 1.4e-4 from its own
# vectors' Rayleigh quotients; ROADMAP.md, Queue C's verdicts)
REF_ELL_MATVECS = 533
REF_ELL_EVALS = (-0.02710828066429022, 0.9702542814823517, 1.991720077512685,
                 2.9502063129247187, 3.9763373437232934, 4.977048162137013,
                 5.9808882058165, 6.959294202733723, 7.910877819518647,
                 8.980020506181951)
# phase 11: DIA kernel shapes (k, column offset in a SLICE_WIDTH-wide block
# or None)
DIA_SHAPES = [(k, None) for k in (1, 2, 4, 8)] + [(2, 1)]
# the k of the kernel tables (DIA_SHAPES, KERNEL_SHAPES,
# JACOBI_COMPLEX_SHAPES, compare_kernel's ks) held against the plain
# version but not timed, so that the run keeps within its time limit:
# timing depth only, every check kept
UNTIMED_K = (1, 4, 8)
# phase 7: a grid past CUDA's 65535 planes, run as two launches
SPLIT_SHAPES = [((70000, 1, 32), 1)]
# phases 7-8: (grid side, k, column offset in a SLICE_WIDTH-wide block or
# None for a contiguous [n, k] block)
KERNEL_SHAPES = ([(GRID, k, None) for k in (1, 2, 4, 8)]
                 + [(side, k, None) for side in (128, 256) for k in (2, 8)]
                 + [(GRID, 2, 1)])
SLICE_WIDTH = 24
HYBRID_DENSITY = 5e-7       # phase 12's scatter
SCATTER_PER_ROW = 4.5       # phase 13's S: ~ 2 x 4.5 + 1 entries a row
# the eigsh call of the sparse phases (4, 6, 11-13), at tol 1e-5 unless
# a phase says otherwise
SOLVE_KWARGS = dict(k=10, which="SA", method="PRIMME_JDQMR_ETol",
                    maxBlockSize=2, ncv=24, minRestartSize=14,
                    return_stats=True)
HEADLINE_SHAPE = f"{GRID}^3 k=2"    # the shape the record's top level reads
# phase 15: benches/northstar.py's configuration, the 128^3 7-point
# Laplacian, k=10 smallest to a true residual <= 1e-10 ||A|| (||A|| <= 12,
# the closed form's bound): an f32 JDQMR_ETol + Jacobi solve, then the f64
# LOBPCG polish with Chebyshev(8); the JAX package's counts on the CPU
# (tools/torch_smoke_refs.py --phase northstar)
NS_GRID = 128
NS_K = 10
NS_TOL = 1e-10
NS_DEGREE = 8
NS_ANORM = 12.0
REF_NS_MATVECS = 3112
REF_NS_ITERS = 77
# and at k=100 (BASELINE config 4, hard locking, basis 64, block 4): the
# reference's counts as BASELINE.md:192-209 records them (21,005 f32
# matvecs, 72 polish iterations; a CPU run of the JAX package's host
# polish at this size takes hours)
NS_K_LARGE = 100
REF_NS_LARGE = (21005, 72)
# phase 16: the Q1 FEM pencil on the 64^3 grid (fem_q1); the JAX package's
# matvecs for the same eigsh call (--phase generalized)
FEM_GRID = 64
REF_FEM_MATVECS = 1005
# phase 17: orthogonality constraints on the headline's 64^3 stencil: the
# closed-form ground state and the three-fold lambda_2-4 as lock=, then
# the next LOCK_K (the three-fold clusters lambda_5-7 and lambda_8-10)
LOCK_MODES = ((1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2))
LOCK_K = 6
# phase 18: interior targets on tests/test_eigsh.py's fixture (the
# chooser's banded branch), k=5 closest to sigma=50, each solve at its own
# INTERIOR_N rows; the JAX package's matvecs for each (--phase interior).
# The eigenvalues are 99/n apart, so the counts grow with n: refined
# GD_plusK takes 1629, 3346 and 11,520 matvecs at n = 512, 1024 and 4096;
# JDQR + Jacobi 251, 407, 990, 28,558 and 44,509 at n = 512, 1024, 2048,
# 3072 and 4096 (the JAX package on the CPU, tools/torch_smoke_refs.py
# --phase interior --interior-n); an outer step of the refined solve
# takes ~12.6 ms on the card, so it stays at 512
INTERIOR_N = {"refined": 512, "harmonic": 512, "jdqr": 2048}
INTERIOR_SIGMA = 50.0
INTERIOR_KWARGS = dict(k=5, which="SM", sigma=INTERIOR_SIGMA,
                       maxMatvecs=60000, return_stats=True)
INTERIOR_SOLVES = {
    "refined": dict(method="PRIMME_GD_plusK", projection="refined"),
    "harmonic": dict(method="PRIMME_GD_plusK", projection="harmonic"),
    "jdqr": dict(method="PRIMME_JDQR", jacobi=True)}
REF_INTERIOR_MATVECS = {"refined": 1629, "harmonic": 2226, "jdqr": 990}
# phases 19-22: svds on the grounded incidence matrix of the SVD_GRID^3
# grid graph, A = [D; SVD_DELTA I] (grounded_incidence), m = 1,036,288
# rows, n = 262,144 columns at 64
SVD_GRID = 64
SVD_DELTA = 0.1
# (name, svds arguments, the matrix's type): phase 20 the hybrid LM in
# f64, 21 the augmented stage alone in f32, 22 the hybrid SM in f64
SVDS_SOLVES = {
    "lm": (dict(k=10, which="LM", tol=1e-10), "float64"),
    "augmented": (dict(k=4, which="LM", tol=1e-5, method="augmented"),
                  "float32"),
    "sm": (dict(k=4, which="SM", tol=1e-8), "float64"),
}
# each solve's singular values against the closed form, in sigma_max
SVDS_VALUE_BAR = {"lm": 1e-8, "augmented": 1e-4, "sm": 1e-7}
# the JAX package's counts for the same svds calls on the CPU, seed 0
# (python3 tools/torch_smoke_refs.py --phase svds, x64 on; 274 s, 542 s
# and 124 s): each stage's matvecs (probe included) and its probe's
# matvecs, rounds and exhaustion; its values were within 1.4e-14, 7.4e-6
# and 3.5e-15 of the closed form. Stage 2 of SM targets closest_geq,
# which the probe does not cover.
REF_SVDS = {
    "lm": {"stage1": (2732, 286, 2, 0)},
    "augmented": {"stage2": (3096, 408, 2, 0)},
    "sm": {"stage1": (1834, 410, 2, 0), "stage2": (691, 0, 0, 0)},
}
# phases 23-27: complex Hermitian input. The magnetic graph Laplacian of
# the MAG_GRID^3 grid (magnetic_laplacian: flux MAG_PHI a plaquette of the
# x-y planes, Landau gauge) carries the DIA phases 24-25 and, as A =
# [D; SVD_DELTA I] (magnetic_incidence), the svds phase 27; phase 26 is
# phase 13's scatter with seeded phases (complex_scattered_matrix).
MAG_GRID = 64
MAG_PHI = 1.0 / 64
COMPLEX_SVDS_KWARGS = dict(k=6, which="SM", tol=1e-8)
# the JAX package's counts for phases 24-27's calls on the CPU, seed 0
# (python3 tools/torch_smoke_refs.py --phase complex, x64 on; 40 s, 99 s,
# 47 s, 59 s and 588 s): phase 24's complex64 and phase 25's complex128
# eigsh of the magnetic Laplacian (within 1.5e-6 and 5.0e-16 of the closed
# form), phase 26's complex64 eigsh of the complex scatter and the
# eigenvalues of its complex128 run (532 matvecs), which phase 26 is held
# to; phase 27's svds (values within 3.1e-13 of the closed form): each
# stage's matvecs, probe matvecs, rounds and exhaustion
REF_MAG_MATVECS = {"complex64": 2150, "complex128": 3579}
REF_CELL_MATVECS = 631
REF_CELL_EVALS = (-0.02710830291021553, 0.9702542813544441,
                  1.9917200733942693, 2.9502063023412237, 3.9763373454490853,
                  4.977048168280783, 5.980888221117151, 6.959294212297952,
                  7.910877823851053, 8.980020531189863)
REF_CSVDS = {"stage1": (1900, 386, 2, 0), "stage2": (5299, 0, 0, 0)}
# phases 28-30: eigs on the periodic convection-diffusion operator
# (convection_diffusion), k=7 of smallest real part: lambda = 0 and the
# six-member cluster at real part 2 - 2 cos(2 pi / N)
NORMAL_VELOCITIES = (0.3, 0.5, 0.7)
NORMAL_GRID = 64
# phase 30: GD_plusK takes one matvec an outer iteration; the JAX
# package's count passes 4000 at 32^3 (4091), so the phase runs at 24^3
NORMAL_GD_GRID = 24
NORMAL_KWARGS = dict(k=7, which="SR")
GL_COEF = 1 - 0.5j           # phase 29: the complex Ginzburg-Landau operator
# (name, grid, coef, the matrix's type, tol, method, the operator)
NORMAL_SOLVES = {
    "ell_f64": (NORMAL_GRID, 1.0, "float64", 1e-8, "JDQMR", "ell"),
    "ell_c64": (NORMAL_GRID, GL_COEF, "complex64", 1e-5, "JDQMR", "ell"),
    "dia_f32": (NORMAL_GD_GRID, 1.0, "float32", 1e-5, "GD_plusK", "banded"),
}
# the JAX package's matvecs for the same eigs calls on the CPU, seed 0
# (python3 tools/torch_smoke_refs.py --phase normal, x64 on; 1245 s, 359 s
# and 37 s). Its ell_f64 and ell_c64 values lie within 8.3e-15 and 1.7e-6
# of the closed form; its dia_f32 run returns one member of the second
# cluster in place of one of the first (ROADMAP.md Queue C)
REF_NORMAL = {"ell_f64": 11773, "ell_c64": 4997, "dia_f32": 2427}
# phase 31: the JAX package's GD_Olsen_plusK on the headline's
# configuration at GRID (x64 off, as bench.py runs; the matvec gate is 2x
# the larger of it and REF_HEADLINE_MATVECS), and its own DYNAMIC solve's
# matvecs and method trace (clock-dependent, printed, not held):
# tools/torch_smoke_refs.py --phase dynamic
REF_DYNAMIC_GD_MATVECS = 2275
REF_DYNAMIC = (1773, "GJGGJJGJJGJGJ")
# phases 36-37: the C ABI. Phase 36 drives primme_tpu_torch.capi_support
# in-process with numpy buffers on the 7-point Laplacian of the CAPI_GRID^3
# grid in random order (n = 262,144, f64): eigsh_csr (k = CAPI_K smallest,
# tol CAPI_TOL) and a parameter handle (numEvals CAPI_K, eps CAPI_TOL,
# jacobi 1, the default method) through eigsh_run. Phase 37 runs the same
# calls from the C program primme_tpu_torch/native/capi_smoke.c, with the
# F77 twin, a host CSR matvec on the CAPI_MATVEC_GRID^3 Laplacian and the
# svds entry points (CAPI_SVDS_K largest, tol CAPI_TOL) on
# grounded_incidence(CAPI_SVD_GRID)
CAPI_GRID = 64
CAPI_MATVEC_GRID = 32
CAPI_SVD_GRID = 32
CAPI_K = 6
CAPI_TOL = 1e-10
CAPI_SVDS_K = 4
# the JAX package's counts for phase 36's two calls, the same solves that
# its capi_support runs (eigsh, and solve_eigs_dynamic with the Jacobi
# preconditioner), on the CPU, seed 0 (python3 tools/torch_smoke_refs.py
# --phase capi, x64 on; 220 s and 76 s, values within 4.8e-15 and
# 1.2e-15 of the closed form): printed beside the port's, not held
# (DYNAMIC's switch follows the host's clock)
REF_CAPI = {"csr": 2142, "run": 2158}
# phase 39: solves with the complex Jacobi kernel. "magnetic": phase 24's
# call with jacobi=True; "magnetic_fixed": the same call on the magnetic
# Laplacian of the JACOBI_NORMAL_GRID^3 grid with OPinv a fixed
# JacobiPrecond(diag, use_shifts=False) (the unshifted entry point); "gl":
# eigs on phase 29's Ginzburg-Landau operator
# at JACOBI_NORMAL_GRID^3 with OPinv=JacobiPrecond(its complex diagonal);
# "cd": eigs on phase 28's f64 convection-diffusion operator at that grid
# with a real JacobiPrecond (complex Ritz shifts on a real diagonal);
# "harness": the config-file driver in complex128 on the magnetic
# Laplacian of the JACOBI_HARNESS_GRID^3 grid with the Jacobi PrecChoice
JACOBI_NORMAL_GRID = 32
JACOBI_HARNESS_GRID = 32
# the JAX package's matvecs for the same calls on the CPU, seed 0
# (python3 tools/torch_smoke_refs.py --phase jacobi, x64 on; 51 s, 15 s,
# 31 s, 79 s and 37 s; values within 1.7e-7, 1.1e-7, 3.4e-7, 1.2e-14 and
# 3.7e-15 of the closed forms)
REF_JACOBI = {"magnetic": 2149, "magnetic_fixed": 1630, "gl": 1638,
              "cd": 3540, "harness": 1597}
# phase 40: the half-precision basis: eigsh(k=HALF_K) of phase 4's matrix
# with dtype bf16 and f16, tol 4 eps(half); the JAX package's matvecs for
# the same calls on the CPU, seed 0 (python3 tools/torch_smoke_refs.py
# --phase half, x64 on; the chooser's RCM order of the matrix as the JAX
# package's ELLOperator, 17 s and 34 s; its bf16 values lie 0.40 from the
# closed form at a true residual of 0.40, its f16 values 1.7e-3 at 0.040)
HALF_K = 4
REF_HALF = {"bfloat16": 252, "float16": 457}
# phases 41-45: the row-partitioned solve on P ranks sharing the card
# phase 47: half operators at n = 262,144, each solve name -> (operator,
# its half type, the working type: None for a half basis over it); each
# of the four kernels gets a solve in both half types, and the mixed entry
# points (half values, f32 blocks) the three half-basis solves
HALFOP_SOLVES = {
    "stencil_f16": ("stencil", "float16", "float32"),
    "stencil_bf16_half_basis": ("stencil", "bfloat16", None),
    "stencil_bf16": ("stencil", "bfloat16", "float32"),
    "ell_f16": ("ell", "float16", "float32"),
    "ell_bf16": ("ell", "bfloat16", "float32"),
    "dia_bf16": ("dia", "bfloat16", "float32"),
    "dia_f16": ("dia", "float16", "float32"),
    "ell_f16_half_basis": ("ell", "float16", None),
    "dia_bf16_half_basis": ("dia", "bfloat16", None),
}
# the sparse half-basis solves at phase 40's k: at SOLVE_KWARGS' k the JAX
# package's own half basis over a half sparse operator fails (a restart's
# projection mixes half and f32 branches; ROADMAP C12)
HALFOP_K = {"ell_f16_half_basis": HALF_K, "dia_bf16_half_basis": HALF_K}
# the JAX package's matvecs for the same calls on the CPU
# (tools/torch_smoke_refs.py --phase halfop, seed 0)
REF_HALFOP = {"stencil_f16": 656, "stencil_bf16_half_basis": 352,
              "stencil_bf16": 352, "ell_f16": 549, "ell_bf16": 352,
              "dia_bf16": 389, "dia_f16": 620, "ell_f16_half_basis": 457,
              "dia_bf16_half_basis": 258}
SHARD_RANKS = (2, 4)
SHARD_K = 2                   # the product's columns (the headline's block)
BAND_SCATTER = (GRID ** 3, 150, 3)    # n, half band, entries a row
SHARD_SVD_GRID = 32
SHARD_NCCL_GRID = 32
SURFACE_GRID = 8              # phase 46's to_dense: the 8^3 grid
SURFACE_SOLVE_GRID = 16       # phase 46's solves: n = 4096
SURFACE_DEBUG_FIELDS = ("it", "b", "lock", "nconv", "nunc", "res0", "hv0",
                        "mincol", "VtQ", "minQ", "minconvX")


def laplacian27_grid(m):
    """27-point Laplacian 27 I - E(x)E(x)E (E = tridiag(1, 1, 1)) on an m^3
    grid in grid order, f32; returns (A, analytic eigenvalues ascending)."""
    import numpy as np
    import scipy.sparse as sp

    E = sp.diags([np.ones(m - 1), np.ones(m), np.ones(m - 1)], [-1, 0, 1])
    A = (27.0 * sp.identity(m ** 3) - sp.kron(sp.kron(E, E), E)).tocsr()
    lam1 = 1.0 + 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    ev = np.sort((27.0 - np.einsum("i,j,k->ijk", lam1, lam1, lam1)).ravel())
    return A.astype(np.float32), ev


def laplacian27(m, seed):
    """:func:`laplacian27_grid` with rows and columns in a random order from
    ``seed``; returns (A, analytic eigenvalues ascending)."""
    import numpy as np

    A, ev = laplacian27_grid(m)
    p = np.random.default_rng(seed).permutation(m ** 3)
    return A[p][:, p].tocsr(), ev


def random_sparse(n, count, seed):
    """``count`` entries at uniform random positions of an n x n matrix
    with values uniform in [0, 1), from ``seed`` (a repeated position sums):
    ``sp.random``'s distribution, drawn without its n^2 index space."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rc = rng.integers(0, n, size=(2, count))
    return sp.coo_matrix((rng.random(count), (rc[0], rc[1])), shape=(n, n))


def hybrid_matrix(m, seed):
    """The 7-point Laplacian of an m^3 grid in grid order plus a seeded,
    symmetric, long-range scatter: ``L7 + 0.1 (S + S^T)`` with ``S`` of
    density ``HYBRID_DENSITY`` (:func:`random_sparse`; about 69k scattered
    entries at 64^3), f32: the input of the chooser's DIA+ELL branch."""
    import numpy as np
    import scipy.sparse as sp

    T = sp.diags([-np.ones(m - 1), 2.0 * np.ones(m), -np.ones(m - 1)],
                 [-1, 0, 1])
    Im = sp.identity(m)
    L = (sp.kron(sp.kron(T, Im), Im) + sp.kron(sp.kron(Im, T), Im)
         + sp.kron(sp.kron(Im, Im), T))
    n = m ** 3
    S = random_sparse(n, round(HYBRID_DENSITY * n * n), seed)
    return (L + 0.1 * (S + S.T)).tocsr().astype(np.float32)


def scattered_matrix(n, seed):
    """A seeded random symmetric matrix no earlier branch of the chooser
    takes: ``diag(min(i, 100)) + S + S^T`` with ``SCATTER_PER_ROW`` entries
    of ``S`` a row (:func:`random_sparse`; about 10 entries a row in all),
    f32. Its smallest eigenvalues lie near 0, 1, ..., 9; the rest near
    100."""
    import numpy as np
    import scipy.sparse as sp

    S = random_sparse(n, round(SCATTER_PER_ROW * n), seed)
    D = sp.diags(np.minimum(np.arange(n, dtype=np.float64), 100.0))
    return (D + S + S.T).tocsr().astype(np.float32)


def fem_like(n, seed, b=8):
    """Block-clustered sparsity at scale, the pattern of
    ``tests/test_operators.py``'s ``_fem_like`` with its own random tiles:
    dense b x b tiles in block columns i, 7i + 3 and 13i + 11 (mod n / b)
    of block row i (a repeated one sums), plus the transpose; f32."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    nb = n // b
    i = np.arange(nb)
    bj = np.stack([i, (i * 7 + 3) % nb, (i * 13 + 11) % nb], axis=1)
    r, c = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    rows = (i[:, None, None, None] * b + r).repeat(3, axis=1)
    cols = bj[:, :, None, None] * b + c
    vals = rng.normal(size=(nb, 3, b, b))
    A = sp.coo_matrix((vals.ravel(), (rows.ravel(), cols.ravel())),
                      shape=(n, n)).tocsr()
    return (A + A.T).tocsr().astype(np.float32)


def fem_q1(m):
    """The Q1 finite-element Laplacian pencil on an m^3 grid (Dirichlet
    edges, unit spacing): ``K = K1 x M1 x M1 + M1 x K1 x M1 + M1 x M1 x
    K1`` and ``M = M1 x M1 x M1`` with ``K1 = tridiag(-1, 2, -1)`` and
    ``M1 = tridiag(1, 4, 1) / 6``, both f32 CSR (27 points a row). Returns
    ``(K, M, eigenvalues of the pencil ascending, Gershgorin bound of
    ||K||)``: ``lambda = mu_i + mu_j + mu_k`` with ``mu = 6 (1 - cos t) /
    (2 + cos t)``, ``t = i pi / (m + 1)``."""
    import numpy as np
    import scipy.sparse as sp

    K1 = sp.diags([-np.ones(m - 1), 2.0 * np.ones(m), -np.ones(m - 1)],
                  [-1, 0, 1])
    M1 = sp.diags([np.ones(m - 1), 4.0 * np.ones(m), np.ones(m - 1)],
                  [-1, 0, 1]) / 6.0
    K = (sp.kron(sp.kron(K1, M1), M1) + sp.kron(sp.kron(M1, K1), M1)
         + sp.kron(sp.kron(M1, M1), K1)).tocsr()
    M = sp.kron(sp.kron(M1, M1), M1).tocsr()
    c = np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    mu = 6.0 * (1.0 - c) / (2.0 + c)
    ev = np.sort((mu[:, None, None] + mu[None, :, None]
                  + mu[None, None, :]).ravel())
    return K.astype(np.float32), M.astype(np.float32), ev, gershgorin(K)


def interior_matrix(n):
    """``tests/test_eigsh.py``'s fixture at size n: diag(linspace(1, 100,
    n)) + 0.3 (sub + super), f32 CSR (the chooser's banded branch)."""
    import numpy as np
    import scipy.sparse as sp

    d = np.linspace(1, 100, n)
    return sp.diags([d, 0.3 * np.ones(n - 1), 0.3 * np.ones(n - 1)],
                    [0, 1, -1]).tocsr().astype(np.float32)


def grounded_incidence(N, delta=SVD_DELTA, dtype="float64"):
    """The grounded incidence matrix of the N x N x N grid graph, ``A =
    [D; delta I]``: ``D`` the edge-node incidence (discrete gradient), one
    row per edge (3 N^2 (N - 1) of them, the edges along each axis in turn)
    with -1 at its tail node and +1 at its head, nodes in grid order. So
    ``A^T A = L + delta^2 I`` with ``L`` the grid's Neumann Laplacian, and
    the singular values are ``sqrt(mu_a + mu_b + mu_c + delta^2)``,
    ``mu_j = 2 - 2 cos(pi j / N)``, ``j = 0..N-1``. Returns ``(A as CSR of
    ``dtype``, the N^3 singular values ascending in f64)``."""
    import numpy as np
    import scipy.sparse as sp

    idx = np.arange(N ** 3).reshape(N, N, N)
    tails, heads = [], []
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(0, N - 1), slice(1, N)
        tails.append(idx[tuple(lo)].ravel())
        heads.append(idx[tuple(hi)].ravel())
    tail, head = np.concatenate(tails), np.concatenate(heads)
    ne = len(tail)
    rows = np.concatenate([np.arange(ne), np.arange(ne)])
    D = sp.csr_matrix((np.concatenate([-np.ones(ne), np.ones(ne)]),
                       (rows, np.concatenate([tail, head]))),
                      shape=(ne, N ** 3))
    A = sp.vstack([D, delta * sp.identity(N ** 3)]).tocsr()
    mu = 2.0 - 2.0 * np.cos(np.pi * np.arange(N) / N)
    sv = np.sqrt(np.sort((mu[:, None, None] + mu[None, :, None]
                          + mu[None, None, :]).ravel()) + delta ** 2)
    return A.astype(dtype), sv


def magnetic_incidence(N, phi=MAG_PHI):
    """The magnetic incidence matrix of the N x N x N grid, complex128 CSR:
    node ``x + N y + N^2 z``, open in x and periodic in y and z; one row
    per edge, ``(x -> x+1)`` with phase 1, ``(y -> y+1 mod N)`` with phase
    ``exp(2 pi i phi x)`` (a uniform field in the Landau gauge) and ``(z ->
    z+1 mod N)`` with phase 1, each row -1 at its tail and its phase at its
    head. ``D^H D`` is the magnetic graph Laplacian (a tight-binding
    electron in the field, the U(1)-covariant Laplacian of lattice gauge
    theory): 3 N^3 - N^2 edges, 2 non-zeros each."""
    import numpy as np
    import scipy.sparse as sp

    idx = np.arange(N ** 3).reshape(N, N, N)        # idx[z, y, x]
    x = np.broadcast_to(np.arange(N), (N, N, N))
    tail = np.concatenate([idx[:, :, :-1].ravel(), idx.ravel(), idx.ravel()])
    head = np.concatenate([idx[:, :, 1:].ravel(),
                           np.roll(idx, -1, axis=1).ravel(),
                           np.roll(idx, -1, axis=0).ravel()])
    phase = np.concatenate([np.ones(N * N * (N - 1)),
                            np.exp(2j * np.pi * phi * x.ravel()),
                            np.ones(N ** 3)])
    ne = len(tail)
    rows = np.concatenate([np.arange(ne), np.arange(ne)])
    return sp.csr_matrix(
        (np.concatenate([-np.ones(ne, complex), phase]),
         (rows, np.concatenate([tail, head]))), shape=(ne, N ** 3))


def magnetic_eigenvalues(N, phi=MAG_PHI):
    """The spectrum of the magnetic Laplacian ``D^H D`` in closed form,
    ascending f64: a Fourier transform in y (mode m) and z (mode l) leaves
    N^2 tridiagonal N x N matrices in x, off-diagonal -1 and diagonal
    ``deg_x(x) + 2 - 2 cos(2 pi m / N + 2 pi phi x) + 2 - 2 cos(2 pi l /
    N)`` (``deg_x`` 1 at the two x ends, 2 elsewhere); the l term only
    shifts, so N tridiagonal solves give all N^3 values."""
    import numpy as np
    from scipy.linalg import eigvalsh_tridiagonal

    x = np.arange(N)
    degx = np.where((x == 0) | (x == N - 1), 1.0, 2.0)
    t = 2.0 * np.pi * np.arange(N) / N
    diag = degx + 2.0 - 2.0 * np.cos(t[:, None] + 2 * np.pi * phi * x)
    lam = np.concatenate([eigvalsh_tridiagonal(d, -np.ones(N - 1))
                          for d in diag])
    return np.sort((lam[:, None] + (2.0 - 2.0 * np.cos(t))[None, :]).ravel())


def magnetic_laplacian(N, phi=MAG_PHI, dtype="complex128"):
    """``L = D^H D`` (:func:`magnetic_incidence`) as CSR of ``dtype`` in
    grid order, complex Hermitian, on 11 diagonals (offsets 0, +-1, +-N,
    +-(N-1)N, +-N^2 and +-(N-1)N^2); returns (L, its eigenvalues ascending
    in f64, the Gershgorin bound 12 of ||L||)."""
    D = magnetic_incidence(N, phi)
    L = (D.conj().T @ D).tocsr()
    L.sum_duplicates()
    return L.astype(dtype), magnetic_eigenvalues(N, phi), 12.0


def magnetic_svd_matrix(N, phi=MAG_PHI, delta=SVD_DELTA, dtype="complex128"):
    """``A = [D; delta I]`` (:func:`magnetic_incidence`), CSR of ``dtype``:
    ``A^H A = L + delta^2 I``, so the singular values are ``sqrt(lambda(L)
    + delta^2)``. Returns (A, the N^3 singular values ascending in f64)."""
    import numpy as np
    import scipy.sparse as sp

    D = magnetic_incidence(N, phi)
    A = sp.vstack([D, delta * sp.identity(N ** 3)]).tocsr()
    return A.astype(dtype), np.sqrt(magnetic_eigenvalues(N, phi) + delta ** 2)


def complex_scattered_matrix(n, seed, dtype="complex64"):
    """Phase 13's matrix with complex phases: ``diag(min(i, 100)) + S_t +
    S_t^H``, ``S_t`` the entries of :func:`scattered_matrix`'s ``S`` each
    times ``exp(i theta)``, theta uniform in [0, 2 pi) from ``seed + 1``;
    complex Hermitian, CSR of ``dtype``."""
    import numpy as np
    import scipy.sparse as sp

    S = random_sparse(n, round(SCATTER_PER_ROW * n), seed)
    theta = np.random.default_rng(seed + 1).uniform(0.0, 2 * np.pi, S.nnz)
    St = sp.coo_matrix((S.data * np.exp(1j * theta), (S.row, S.col)),
                       shape=S.shape)
    D = sp.diags(np.minimum(np.arange(n, dtype=np.float64), 100.0))
    return (D + St + St.conj().T).tocsr().astype(dtype)


def convection_diffusion(N, coef=1.0, velocities=NORMAL_VELOCITIES,
                         dtype="float64"):
    """The periodic convection-diffusion operator on the N^3 torus,
    ``A = sum_d I x .. x (coef (2I - S - S^T) + c_d/2 (S - S^T)) x .. x
    I`` with ``S`` the periodic shift (``(S x)_i = x_{i+1 mod N}``) and
    ``c`` the velocities: 7 non-zeros a row, normal (every term is
    circulant, so they commute) and not Hermitian. A complex ``coef``
    (``1 - 0.5i``) makes it the linearised complex Ginzburg-Landau
    operator. CSR of ``dtype`` in grid order, row ``(i N + j) N + l``.
    Returns (A, its N^3 eigenvalues from the closed form ``coef sum_d (2 -
    2 cos t_d) + i sum_d c_d sin t_d``, ``t_d = 2 pi j_d / N``, in
    complex128 sorted by real part, ``||A||`` = their largest modulus)."""
    import numpy as np
    import scipy.sparse as sp

    S = sp.diags([np.ones(N - 1), np.ones(1)], [1, -(N - 1)], shape=(N, N))
    eye = sp.identity(N, format="csr")
    A = None
    for d, c in enumerate(velocities):
        T = coef * (2.0 * eye - S - S.T) + 0.5 * c * (S - S.T)
        parts = [eye] * 3
        parts[d] = T
        term = sp.kron(sp.kron(parts[0], parts[1]), parts[2])
        A = term if A is None else A + term
    A = A.tocsr().astype(dtype)
    A.sum_duplicates()
    t = 2.0 * np.pi * np.arange(N) / N
    re = 2.0 - 2.0 * np.cos(t)
    lam = sum(coef * re[idx] + 1j * c * np.sin(t)[idx]
              for c, idx in zip(velocities, np.ix_(*[np.arange(N)] * 3)))
    lam = np.asarray(lam, np.complex128).ravel()
    lam = lam[np.argsort(lam.real, kind="stable")]
    return A, lam, float(np.abs(lam).max())


def match_values(vals, exp):
    """Set-wise match of complex values: each of ``exp`` takes its nearest
    remaining value of ``vals``; returns the largest distance (inf when
    ``vals`` has fewer)."""
    import numpy as np

    vals = list(np.asarray(vals))
    err = 0.0
    for e in np.asarray(exp):
        if not vals:
            return float("inf")
        i = int(np.argmin([abs(v - e) for v in vals]))
        err = max(err, float(abs(vals[i] - e)))
        vals.pop(i)
    return err


def stencil_modes(m, modes):
    """Closed-form eigenvectors of the 7-point Laplacian on an m^3 grid,
    one column per ``(a, b, c)``: ``sin(a pi i / (m+1)) sin(b pi j / (m+1))
    sin(c pi l / (m+1))`` at row ``(i ny + j) nz + l`` (1-based i, j, l),
    unit norm, f64."""
    import numpy as np

    t = np.pi * np.arange(1, m + 1) / (m + 1)
    cols = []
    for a, b, c in modes:
        v = np.einsum("i,j,k->ijk", np.sin(a * t), np.sin(b * t),
                      np.sin(c * t)).ravel()
        cols.append(v / np.linalg.norm(v))
    return np.stack(cols, axis=1)


_SPIN_CYCLES_PER_MS = None


def spin_cycles_per_ms():
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin, measured on the
    card (the spin counts SM clock cycles, whose rate varies by card and
    clock state); the second of two readings, after the clocks have risen."""
    global _SPIN_CYCLES_PER_MS
    import torch

    if _SPIN_CYCLES_PER_MS is None:
        cycles = 10_000_000
        for _ in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(cycles)
            b.record()
            b.synchronize()
            _SPIN_CYCLES_PER_MS = cycles / a.elapsed_time(b)
    return _SPIN_CYCLES_PER_MS


_LAST_TIMED = 0.0    # when median_ms last finished (host clock)


def median_ms(fn, reps=TIMING_REPS, per=10, spin=True):
    """Median over ``reps`` samples of the device time of one call. Each
    sample times ``per`` back-to-back calls between two CUDA events. Calls
    run for 0.2 s first, so that the card's clocks have risen, or for 0.02 s
    (the spin's measure of a batch) where another timing ended less than a
    second before and the clocks are still up. With
    ``spin``, each sample is queued behind a spin kernel
    (``torch.cuda._sleep``) that lasts twice the host time of a warm batch,
    so that the card runs the calls without gaps and neither launch latency
    nor the host's time per call counts; a sample whose queueing took more
    than 0.8 of the spin is late, and a late sample doubles the spin and
    starts the samples over (a fourth late round raises). Without
    ``spin`` the host's pace counts wherever it is slower than the card."""
    import torch

    global _LAST_TIMED
    t0 = time.perf_counter()
    warm = 0.02 if t0 - _LAST_TIMED < 1.0 else 0.2
    batches = 0
    while True:
        for _ in range(per):
            fn()
        torch.cuda.synchronize()
        batches += 1
        if time.perf_counter() - t0 >= warm and batches >= 2:
            break
    spin_ms = 2e3 * (time.perf_counter() - t0) / batches
    for _ in range(4):
        times, late = [], 0
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            q0 = time.perf_counter()
            a.record()
            for _ in range(per):
                fn()
            b.record()
            late += 1e3 * (time.perf_counter() - q0) > 0.8 * spin_ms
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        if not spin or not late:
            _LAST_TIMED = time.perf_counter()
            return statistics.median(times)
        spin_ms *= 2
    raise RuntimeError(f"chip_smoke: {late} of {reps} samples queued "
                       "slower than the spin, four times over")


def solve(ptt, A, seed, tol=1e-5, kwargs=None, M=None):
    return ptt.eigsh(A, tol=tol, seed=seed, device="cuda", M=M,
                     **(kwargs or SOLVE_KWARGS))


def reset_counts(*mods):
    for mod in mods:
        mod.LAUNCHES = 0
        for counts in (mod.KERNEL_LAUNCHES,
                       getattr(mod, "VECTOR_LAUNCHES", {}),
                       getattr(mod, "DIRECT_LAUNCHES", {}),
                       getattr(mod, "RUN_LAUNCHES", {}),
                       getattr(mod, "MIXED_LAUNCHES", {})):
            for name in counts:
                counts[name] = 0


def read_counts(mods, counts="KERNEL_LAUNCHES"):
    """Every entry point's launches since ``reset_counts`` (with
    ``counts="DIRECT_LAUNCHES"``, those that took the sliced ELL's direct
    path; ``"RUN_LAUNCHES"``, Jacobi's run kernel; ``"MIXED_LAUNCHES"``,
    the mixed DIA kernel)."""
    launches = {}
    for mod in mods:
        launches.update(getattr(mod, counts, {}))
    return launches


def layout_phase(WE, op, Ap, dtype, tag):
    """Rebuild ``op``'s layout from the permuted matrix ``Ap``, timing
    ``pack`` and ``compact`` apart; it must be ``op``'s, hold E <= 1.1 nnz
    entries and take <= 1.1 nnz (sizeof T + 4) + 8n bytes on the card."""
    import numpy as np

    t0 = time.perf_counter()
    p = WE.pack(Ap, dtype=dtype)
    t1 = time.perf_counter()
    lay = WE.compact(p.scal, p.offs, p.vals,
                     (p.nrb, p.S, p.npad, p.n, p.pad, p.WB))
    t2 = time.perf_counter()
    for name in lay._fields:
        check(np.array_equal(getattr(op, name).cpu().numpy(),
                             getattr(lay, name)),
              f"{tag}: the operator's {name} is not compact()'s")
    n, nnz, size = Ap.shape[0], Ap.nnz, np.dtype(dtype).itemsize
    E = len(lay.cols)
    nbytes = sum(b.numel() * b.element_size() for b in op.buffers())
    limit = 1.1 * nnz * (size + 4) + 8 * n
    print(f"[{tag}] pack {t1 - t0:.3f} s  compact {t2 - t1:.3f} s  "
          f"entries E={E} ({E / nnz:.4f} nnz; packed slots "
          f"{p.nrb * p.S * WE.RB})  max row {int(lay.rowlen.max())}  "
          f"operator {nbytes} B on the card (limit {limit:.0f})", flush=True)
    check(E <= 1.1 * nnz, f"{tag}: {E} entries for {nnz} non-zeros")
    check(nbytes <= limit, f"{tag}: operator takes {nbytes} B > {limit:.0f}")
    return {"pack_s": t1 - t0, "compact_s": t2 - t1, "entries": E,
            "entries_per_nnz": E / nnz, "operator_bytes": nbytes}


def direct_need(WE, op, suffix):
    """``(entry,)`` where the wrapper's rule puts ``op``'s sliced-ELL
    layout on the direct path (``format_solve``'s ``need_direct``), else
    ``()``."""
    if WE.choose_path(op.slice_ptr, op.cols) != "direct":
        return ()
    return ("windowed_ell_spmm_" + suffix,)


def csr_on_card(Ap, dtype, dev):
    """``Ap`` as a ``torch.sparse_csr_tensor`` on the card, i32 indices:
    the library call's operand, never the port's."""
    import numpy as np
    import torch

    C = Ap.tocsr()
    with warnings.catch_warnings():     # "beta state", invariant checks
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(C.indptr.astype(np.int32)),
            torch.as_tensor(C.indices.astype(np.int32)),
            torch.as_tensor(C.data.astype(dtype)), size=C.shape).to(dev)


def compare_kernel(WE, op, A_csr, gen, rel, tag, ks=(1, 2, 4, 8), suffix="",
                   copy=False):
    """The kernel against its plain version on ``op``'s layout (with
    ``suffix="_t"`` an ``ELLOperator``'s ``A^T`` layout) at each k of
    ``ks``: max |diff| <= rel * max|y|; the median time of the kernel
    (with and without the spin), the plain version (without) and the
    fastest of three library calls on ``A_csr``, the same matrix (with
    ``copy``, also torch's copy of X, ``copy_ms``); the bound from the
    bytes the product needs: each value and column once, X (the matrix's
    columns x k) and Y (its rows x k). A k of ``UNTIMED_K`` is held to
    both bars (the plain version's and the two paths') but not timed."""
    import numpy as np
    import torch

    arrays = tuple(getattr(op, name + suffix)
                   for name in ("slice_ptr", "rowlen", "cols", "vals"))
    rows, nnz = arrays[1].shape[0], A_csr._nnz()
    ncols = A_csr.shape[1]
    size = arrays[3].element_size()
    width = WE.mean_width(arrays[0], arrays[2])
    path = WE.choose_path(arrays[0], arrays[2])
    other = next(p for p in WE.PATHS if p != path)
    per_k = {}
    for k in ks:
        X = torch.randn((ncols, k), generator=gen, dtype=op.dtype).to(op.device)
        y = WE.matmat(*arrays, X, ncols)
        yref = WE.matmat_reference(*arrays, X, ncols)
        Xcm = X.t().contiguous().t()        # the same X, column-major
        libs = {"A_csr @ X": lambda: A_csr @ X,
                "torch.sparse.mm(A_csr, X)": lambda: torch.sparse.mm(A_csr, X),
                "A_csr @ X, X column-major": lambda: A_csr @ Xcm}
        y_other = WE.matmat(*arrays, X, ncols, path=other)
        torch.cuda.synchronize()
        err = float((y - yref).abs().max())
        ymax = float(yref.abs().max())
        as_real = torch.view_as_real if y.is_complex() else (lambda t: t)
        paths_bit = _bitwise(as_real(y), as_real(y_other))
        bound_ms = 1e3 * (nnz * (size + 4) + (rows + ncols) * k * size) \
            / HBM_BYTES_PER_S
        if k in UNTIMED_K:
            per_k[k] = {"max_abs_err": err, "ymax": ymax, "ms": None,
                        "nospin_ms": None, "plain_ms": None,
                        "library_ms": None, "library_call": None,
                        "library": {}, "bound_ms": bound_ms,
                        "bound_share": None, "path": path,
                        "mean_width": width, "other_path": other,
                        "other_path_ms": None, "paths_bitwise": paths_bit,
                        "copy_ms": None, "timed": False}
            print(f"[{tag}] k={k} max|y-yref|={err:.3e} (limit "
                  f"{rel * ymax:.3e}) on the {path} path, bit for bit with "
                  f"the {other} path {paths_bit}; held, not timed",
                  flush=True)
            check(np.isfinite(err) and err <= rel * ymax,
                  f"{tag}: kernel disagrees with matmat_reference at k={k}")
            check(paths_bit,
                  f"{tag}: the ring and direct paths differ at k={k}")
            continue
        ms = median_ms(lambda: WE.matmat(*arrays, X, ncols))
        nospin_ms = median_ms(lambda: WE.matmat(*arrays, X, ncols),
                              spin=False)
        other_ms = median_ms(lambda: WE.matmat(*arrays, X, ncols,
                                               path=other))
        # the plain version reads its longest row to the host once per
        # call: no spin can queue it ahead, and its host pace is its cost
        plain_ms = median_ms(lambda: WE.matmat_reference(*arrays, X, ncols),
                             spin=False)
        lib = {}
        for call, f in libs.items():
            try:
                diff = float((f() - yref).abs().max())
            except RuntimeError as e:       # no such call for the type
                print(f"[{tag}] library call {call}: {e}", flush=True)
                continue
            lib[call] = {"ms": median_ms(f), "max_abs_err": diff}
        library_call = min(lib, key=lambda c: lib[c]["ms"]) if lib else None
        library_ms = lib[library_call]["ms"] if lib else None
        per_k[k] = {"max_abs_err": err, "ymax": ymax, "ms": ms,
                    "nospin_ms": nospin_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_call": library_call,
                    "library": lib, "bound_ms": bound_ms,
                    "bound_share": bound_ms / ms, "path": path,
                    "mean_width": width, "other_path": other,
                    "other_path_ms": other_ms, "paths_bitwise": paths_bit}
        extra = ""
        if copy:
            Xc = torch.empty_like(X)
            per_k[k]["copy_ms"] = median_ms(lambda: Xc.copy_(X))
            extra = f"  copy {per_k[k]['copy_ms']:.4f} ms"
        print(f"[{tag}] k={k} max|y-yref|={err:.3e} (limit "
              f"{rel * ymax:.3e}) kernel {ms:.4f} ms on the {path} path "
              f"(mean slice width {width:.2f}; without the spin "
              f"{nospin_ms:.4f})  {other} path {other_ms:.4f} ms (bit for "
              f"bit with it {paths_bit})  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms (bytes; share {bound_ms / ms:.3f})" + extra,
              flush=True)
        print(f"[{tag}] k={k} library: " + "; ".join(
            f"{c} {v['ms']:.4f} ms (max|diff| {v['max_abs_err']:.3e})"
            for c, v in lib.items()) + f" -> library_ms {library_ms}",
            flush=True)
        check(np.isfinite(err) and err <= rel * ymax,
              f"{tag}: kernel disagrees with matmat_reference at k={k}")
        check(paths_bit, f"{tag}: the ring and direct paths differ at k={k}")
    return per_k


def stencil_eigenvalues(m, k):
    """The k smallest eigenvalues of the 7-point Dirichlet Laplacian on an
    m^3 grid in closed form (``bench.py``'s), and its norm (the largest)."""
    import numpy as np

    ax = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    lam = np.sort((ax[:, None, None] + ax[None, :, None]
                   + ax[None, None, :]).ravel())
    return lam[:k], float(3 * ax.max())


def _bitwise(a, b):
    """a and b equal element for element, NaN for NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _times(kernel, plain, nbytes, copy, library=None, plain_spin=True):
    """The kernel's median time with and without the spin, the plain
    version's (with the spin where ``plain_spin``: it reads nothing back to
    the host; without it where ten calls of it overflow the launch queue,
    which no spin can hold), torch's copy of the same bytes and the library
    call's, beside the bound: the
    ``nbytes`` the function moves over the device memory's rate. Where they
    fit in L2, the repeated calls of ``median_ms`` find them there, so the
    share is not one of a device-memory bound (``l2_resident``)."""
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    out = {"ms": median_ms(kernel), "nospin_ms": median_ms(kernel, spin=False),
           "plain_ms": median_ms(plain, spin=plain_spin),
           "copy_ms": median_ms(copy),
           "bound_ms": bound_ms, "l2_resident": nbytes <= L2_BYTES,
           "library_ms": median_ms(library) if library is not None else None}
    out["bound_share"] = bound_ms / out["ms"]
    return out


def _untimed(nbytes):
    """The record of a shape held against its plain version but not timed
    (``k`` in ``UNTIMED_K``): its bound, and None for each time."""
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"ms": None, "nospin_ms": None, "plain_ms": None, "copy_ms": None,
            "library_ms": None, "bound_ms": bound_ms, "bound_share": None,
            "l2_resident": nbytes <= L2_BYTES, "timed": False}


def _times_at(k, *args, **kwargs):
    """:func:`_times`, or :func:`_untimed` at a ``k`` of ``UNTIMED_K``."""
    if k in UNTIMED_K:
        return _untimed(args[2])
    return _times(*args, **kwargs)


def _print_times(tag, shape, err, bit, t, plan, extra=""):
    if t.get("timed") is False:
        print(f"[{tag}] {shape} max|y-yref|={err:.3e} bit for bit {bit}; "
              f"plan kc={plan.kc} vw={plan.vw}; held, not timed", flush=True)
        return
    print(f"[{tag}] {shape} max|y-yref|={err:.3e} bit for bit {bit}; plan "
          f"kc={plan.kc} vw={plan.vw} ({'vector' if plan.vw > 1 else 'scalar'}"
          f" path)" + (f" kernel {plan.kernel}" if hasattr(plan, "kernel")
                       else "")
          + (f" tile {plan.tl}x{plan.tj}, grid {plan.grid}, "
                       f"{len(plan.launches)} launch(es)"
                       if hasattr(plan, "tl") else f" grid {plan.grid}"
                       if hasattr(plan, "grid") else f" blocks {plan.blocks}")
          + f"; kernel {t['ms']:.5f} ms (without the "
          f"spin {t['nospin_ms']:.5f})  plain {t['plain_ms']:.5f} ms  copy "
          f"{t['copy_ms']:.5f} ms  bound {t['bound_ms']:.5f} ms (bytes; share "
          f"{t['bound_share']:.3f}"
          + (", L2-resident" if t["l2_resident"] else "") + ")" + extra,
          flush=True)


def shape_label(side, k, off):
    return f"{side}^3 k={k}" + (f" slice+{off} of {SLICE_WIDTH}"
                                if off is not None else "")


def kernel_block(side, k, off, dtype, dev, gen):
    """A random [side^3, k] block on the card: contiguous, or columns
    [off, off + k) of a SLICE_WIDTH-wide one."""
    return block_n(side ** 3, k, off, dtype, dev, gen)


def block_n(n, k, off, dtype, dev, gen):
    """A random [n, k] block on the card: contiguous, or columns
    [off, off + k) of a SLICE_WIDTH-wide one."""
    import torch

    if off is None:
        return torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
    W = torch.randn((n, SLICE_WIDTH), generator=gen, dtype=dtype, device=dev)
    return W[:, off:off + k]


def stencil_phase(ST, dev, gen, scale=1.0):
    """The stencil kernel against its plain version at every shape of
    ``KERNEL_SHAPES``, f32 and f64, bit for bit; timed beside its bound,
    torch's copy of X and a depthwise ``conv3d`` over the same memory
    (``library_ms``; cuDNN with TF32 off, as the package sets it)."""
    import torch
    import torch.nn.functional as F

    check(not torch.backends.cudnn.allow_tf32,
          "cuDNN would run the conv3d yardstick in TF32")
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = "stencil3d_f32" if dtype == torch.float32 else "stencil3d_f64"
        size = torch.finfo(dtype).bits // 8
        w = torch.zeros((3, 3, 3), dtype=dtype)
        w[1, 1, 1] = 6.0
        for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[c] = -1.0
        per_shape = {}
        for side, k, off in KERNEL_SHAPES:
            n, label = side ** 3, shape_label(side, k, off)
            X = kernel_block(side, k, off, dtype, dev, gen)
            grid = (side, side, side)
            y = ST.matmat(X, *grid, scale)
            yref = ST.matmat_reference(X, *grid, scale)
            # the same memory as a (1, k, nx, ny, nz) channels-last-3d input
            Xc = X.view(1, side, side, side, k).permute(0, 4, 1, 2, 3)
            wk = (scale * w).expand(k, 1, 3, 3, 3).contiguous().to(dev)

            def conv():
                return F.conv3d(Xc, wk, padding=1, groups=k)

            ylib = conv().permute(0, 2, 3, 4, 1).reshape(n, k)
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            torch.cuda.synchronize()
            err = float((y - yref).abs().max())
            bit = _bitwise(y, yref)
            lib_err = float((ylib - yref).abs().max())
            plan = ST.card_plan(X, *grid)
            t = _times_at(k, lambda: ST.matmat(X, *grid, scale),
                          lambda: ST.matmat_reference(X, *grid, scale),
                          2 * n * k * size, lambda: Yc.copy_(X), conv)
            per_shape[label] = {"max_abs_err": err, "bitwise": bit,
                                "vector_path": plan.vw > 1,
                                "plan": plan._asdict(),
                                "library_call": "conv3d depthwise (cuDNN)",
                                "library_max_abs_err": lib_err, **t}
            _print_times(name, label, err, bit, t, plan,
                         f"  library (depthwise conv3d) {t['library_ms']}"
                         f" ms (max|diff| {lib_err:.3e})")
            check(bit, f"{name}: kernel differs from its plain version at "
                  f"{label}")
            del X, y, yref, ylib, Xc, Yc
        # a grid past CUDA's 65535 (plane, column group) pairs: several
        # launches from plane offsets, one count
        for grid, k in SPLIT_SHAPES:
            n = grid[0] * grid[1] * grid[2]
            label = "x".join(map(str, grid)) + f" k={k}"
            X = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
            before = ST.LAUNCHES
            y = ST.matmat(X, *grid, scale)
            counted = ST.LAUNCHES - before
            yref = ST.matmat_reference(X, *grid, scale)
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            torch.cuda.synchronize()
            err, bit = float((y - yref).abs().max()), _bitwise(y, yref)
            plan = ST.card_plan(X, *grid)
            t = _times(lambda: ST.matmat(X, *grid, scale),
                       lambda: ST.matmat_reference(X, *grid, scale),
                       2 * n * k * size, lambda: Yc.copy_(X))
            per_shape[label] = {"max_abs_err": err, "bitwise": bit,
                                "vector_path": plan.vw > 1,
                                "plan": plan._asdict(), **t}
            _print_times(name, label, err, bit, t, plan)
            check(bit and len(plan.launches) > 1 and counted == 1,
                  f"{name}: the split grid {label} is not bit for bit in "
                  f"{len(plan.launches)} launches counted {counted}")
            del X, y, yref, Yc
        out[name] = per_shape
    return out


def jacobi_phase(JK, dev, gen):
    """Both Jacobi entry points against their plain versions at every shape
    of ``KERNEL_SHAPES``, f32 and f64, bit for bit: ``d`` spans [1, 11],
    the first shift equals ``d`` of the middle row (the eps clamp fires
    there), the others lie in [0, 1] (the smallest Ritz values of the
    headline)."""
    import torch

    out = {}
    for dtype in (torch.float32, torch.float64):
        suffix = "f32" if dtype == torch.float32 else "f64"
        size = torch.finfo(dtype).bits // 8
        res = {"jacobi_shifted_" + suffix: {}, "jacobi_" + suffix: {}}
        for side, k, off in KERNEL_SHAPES:
            n, label = side ** 3, shape_label(side, k, off)
            d = 1.0 + 10.0 * torch.rand(n, generator=gen, dtype=dtype,
                                        device=dev)
            X = kernel_block(side, k, off, dtype, dev, gen)
            s = torch.rand(k, generator=gen, dtype=dtype, device=dev)
            s[0] = d[n // 2]
            eps = 1e-10
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            # the library call: torch.div for the unshifted apply (d is
            # far from 0 here, so the eps guard does not act); no one call
            # computes the shifted apply's X[:, j] / guard(d - s_j)
            pairs = (
                ("jacobi_shifted_" + suffix,
                 lambda: JK.shifted(X, d, s, eps),
                 lambda: JK.shifted_reference(X, d, s, eps), k, None),
                ("jacobi_" + suffix, lambda: JK.unshifted(X, d, eps),
                 lambda: JK.unshifted_reference(X, d, eps), 0,
                 lambda: torch.div(X, d[:, None])))
            for name, kern, plain, nsig, library in pairs:
                y, yref = kern(), plain()
                torch.cuda.synchronize()
                err = float((y - yref).abs().max())
                bit = _bitwise(y, yref)
                plan = JK.card_plan(X)
                t = _times_at(k, kern, plain, (2 * n * k + n + nsig) * size,
                              lambda: Yc.copy_(X), library)
                res[name][label] = {"max_abs_err": err, "bitwise": bit,
                                    "vector_path": plan.vw > 1,
                                    "plan": plan._asdict(), **t}
                _print_times(name, label, err, bit, t, plan,
                             "" if library is None else
                             f"  library (torch.div) {t['library_ms']} ms")
                check(bit, f"{name}: kernel differs from its plain version "
                      f"at {label}")
                check(bool(torch.isfinite(y).all()),
                      f"{name}: non-finite output at {label}")
            del X, d, y, yref, Yc
        out.update(res)
    return out


def headline_phase(ptt, dev, grid=GRID, ref_mv=REF_HEADLINE_MATVECS,
                   timed=HEADLINE_TIMED):
    """``bench.py``'s solve through the port's ``solve_eigs``: one untimed
    solve, then ``timed`` timed ones (each ends in a device sync); every
    solve gated. Returns the record and the launches of the first timed
    solve."""
    import numpy as np
    import torch
    from primme_tpu_torch.core.inner import jdqmr_inner_solve
    from primme_tpu_torch.core.solver import solve_eigs
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    n = grid ** 3
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                         max_block_size=2, min_restart_size=14,
                         max_matvecs=16000, locking=0)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 2)),
                         dtype=torch.float32).to(dev)
    lam, anorm = stencil_eigenvalues(grid, 10)
    runs = []
    for i in range(1 + timed):
        tag = "headline" + (" untimed" if i == 0 else f" timed {i}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            before_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(WE, ST, JK)
        t0 = time.perf_counter()
        res = solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                         inner_solve=jdqmr_inner_solve)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**ST.KERNEL_LAUNCHES, **JK.KERNEL_LAUNCHES,
                    **WE.KERNEL_LAUNCHES}
        vector = {**ST.VECTOR_LAUNCHES, **JK.VECTOR_LAUNCHES}
        st = res.stats
        evals = res.evals.cpu().numpy()
        err = float(np.abs(np.sort(evals) - lam).max())
        max_res = float(res.resnorms.max())
        ok = max_res <= 1.5e-5 * st.anorm_estimate and err <= 1e-4
        X = res.evecs.to(torch.float64)
        R = (ST.matmat_reference(X, grid, grid, grid)
             - X * res.evals.to(torch.float64)[None, :])
        true_res = float(torch.linalg.vector_norm(R, dim=0).max())
        run = {"wall_s": wall, "num_matvecs": st.num_matvecs,
               "num_probe_matvecs": st.num_probe_matvecs,
               "num_probe_rounds": st.num_probe_rounds,
               "num_preconds": st.num_preconds,
               "num_outer_iterations": st.num_outer_iterations,
               "num_inner_iterations": st.num_inner_iterations,
               "eval_err": err, "max_resnorm": max_res,
               "resnorm_tol": 1.5e-5 * st.anorm_estimate,
               "anorm_estimate": st.anorm_estimate,
               "max_true_residual": true_res, "ok": ok,
               "probe_verified": st.probe_verified,
               "probe_exhausted": st.probe_exhausted,
               "launches": launches, "vector_launches": vector}
        if dev.type == "cuda":
            run["peak_bytes"] = torch.cuda.max_memory_allocated()
            run["bytes_before"] = before_bytes
        runs.append(run)
        print(f"[{tag}] solve {wall:.4f} s  num_matvecs {st.num_matvecs} "
              f"(reference {ref_mv})  num_probe_matvecs "
              f"{st.num_probe_matvecs}  num_probe_rounds "
              f"{st.num_probe_rounds} (reference {REF_HEADLINE_PROBE})  "
              f"outer {st.num_outer_iterations}  inner "
              f"{st.num_inner_iterations}  preconds {st.num_preconds}",
              flush=True)
        print(f"[{tag}] ok {ok}: max resnorm {max_res:.3e} (limit "
              f"{1.5e-5 * st.anorm_estimate:.3e}, anorm_estimate "
              f"{st.anorm_estimate:.4f})  max|eval-analytic| {err:.3e}  "
              f"max true residual {true_res:.3e} (limit "
              f"{1.5e-5 * anorm:.3e})  probe verified {st.probe_verified} "
              f"exhausted {st.probe_exhausted}  launches {launches}"
              + (f"  peak device memory {run['peak_bytes']} B "
                 f"({before_bytes} B before)" if dev.type == "cuda" else ""),
              flush=True)
        print(f"[{tag}] vector-path launches: " + "; ".join(
            f"{e} {vector[e]} of {launches[e]} "
            f"({vector[e] / max(launches[e], 1):.3f})"
            for e in ("stencil3d_f32", "jacobi_shifted_f32")), flush=True)
        mv = st.num_matvecs
        check(ok, f"{tag}: bench.py's correctness gate failed")
        check(true_res <= 1.5e-5 * anorm,
              f"{tag}: true residual {true_res:.3e} > 1.5e-5*||A||")
        check(st.probe_verified == 1 and st.probe_exhausted == 0,
              f"{tag}: spectrum verification did not complete")
        check(ref_mv / 2 <= mv <= 2 * ref_mv,
              f"{tag}: {mv} matvecs, not within 2x of the reference's "
              f"{ref_mv}")
        if dev.type == "cuda":
            check(launches["stencil3d_f32"] >= mv / 2,
                  f"{tag}: only {launches['stencil3d_f32']} stencil launches "
                  f"for {mv} matvecs")
            check(launches["jacobi_shifted_f32"] > 0,
                  f"{tag}: no shifted Jacobi launch")
            check(not any(WE.KERNEL_LAUNCHES.values()),
                  f"{tag}: a windowed-ELL kernel served the stencil")
    timed_walls = [r["wall_s"] for r in runs[1:]]
    print(f"[headline] timed solves {timed_walls} s: min "
          f"{min(timed_walls):.4f} s", flush=True)
    return {"solves": runs, "timed_s": timed_walls,
            "wall_s": min(timed_walls), "n": n}, runs[1]


def gdk_phase(ptt, dev, grid=GD_GRID, ref_mv=REF_GD_MATVECS):
    """``__graft_entry__.entry``'s method, GD_Olsen_plusK with Jacobi on the
    ``grid``^3 stencil (k=4, tol 1e-4), run to convergence."""
    import numpy as np
    import torch
    from primme_tpu_torch.core.solver import solve_eigs
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    n = grid ** 3
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.set_method(ptt.Method.GD_Olsen_plusK,
                       ptt.PrimmeParams(n=n, num_evals=4, eps=1e-4),
                       has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 1)),
                         dtype=torch.float32).to(dev)
    reset_counts(WE, ST, JK)
    t0 = time.perf_counter()
    res = solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ST.KERNEL_LAUNCHES, **JK.KERNEL_LAUNCHES}
    st = res.stats
    lam, _ = stencil_eigenvalues(grid, 4)
    err = float(np.abs(np.sort(res.evals.cpu().numpy()) - lam).max())
    mv = st.num_matvecs
    print(f"[gdk] GD_Olsen_plusK + Jacobi {grid}^3: solve {wall:.4f} s  "
          f"num_matvecs {mv} (reference {ref_mv})  num_probe_matvecs "
          f"{st.num_probe_matvecs}  num_probe_rounds {st.num_probe_rounds}  "
          f"preconds {st.num_preconds}  max|eval-analytic| {err:.3e}  probe "
          f"verified {st.probe_verified}  launches {launches}", flush=True)
    check(err <= 1e-4, f"gdk: eigenvalue error {err:.3e} > 1e-4")
    check(st.probe_verified == 1 and st.probe_exhausted == 0,
          "gdk: spectrum verification did not complete")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"gdk: {mv} matvecs, not within 2x of the reference's {ref_mv}")
    if dev.type == "cuda":
        check(launches["stencil3d_f32"] >= mv / 2 and
              launches["jacobi_shifted_f32"] > 0,
              f"gdk: the kernels did not serve the solve: {launches}")
    return {"wall_s": wall, "num_matvecs": mv, "eval_err": err,
            "num_probe_matvecs": st.num_probe_matvecs,
            "num_probe_rounds": st.num_probe_rounds,
            "num_preconds": st.num_preconds, "launches": launches}


def choose(ptt, A, tag):
    """The port's chooser on ``A``, timed, its peak host memory traced
    (numpy's allocations included); returns (rcm_banded's result, record)."""
    import tracemalloc

    tracemalloc.start()
    t0 = time.perf_counter()
    rb = ptt.rcm_banded(A)
    secs = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    op = None if rb is None else rb[0]
    print(f"[{tag}] n={A.shape[0]} nnz={A.nnz}: rcm_banded -> "
          f"{type(op).__name__ if op is not None else None} in {secs:.3f} s, "
          f"peak host memory {peak} B (tracemalloc)", flush=True)
    return rb, {"chooser_s": secs, "chooser_peak_host_bytes": peak,
                "operator": type(op).__name__ if op is not None else None}


def gershgorin(A):
    """max_i sum_j |a_ij| >= ||A||: the norm the residual gates of the
    matrices without a closed form use."""
    import numpy as np

    return float(np.abs(A).sum(axis=1).max())


def format_solve(ptt, mods, A, seed, tag, ev_ref, ev_tol, anorm, ref_mv,
                 need, forbid=(), tol=1e-5, kwargs=None, M=None,
                 need_direct=()):
    """One gated eigsh of ``A`` (with the mass matrix ``M``, if any) at
    ``tol`` with ``kwargs`` (``SOLVE_KWARGS`` by default). ``A`` and
    ``M`` are scipy matrices (the chooser inside) or operators that carry
    theirs as ``.matrix``. Gates: eigenvalues within ``ev_tol`` of
    ``ev_ref``; true residuals (``A x - lambda M x``, the matrices in f64
    on the host, complex128 for a complex solve) <= 1.5 tol ``anorm``;
    with ``M``, ``X^T M X = I`` to
    1e-4; probe verified and not exhausted where the probe covers the
    target; matvecs within 2x of ``ref_mv``; each entry point of ``need``
    at least matvecs / 2 launches, none of ``forbid``; each of
    ``need_direct`` as many on the sliced ELL's direct path. The counts
    are set to 0 just before the call and read just after it."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*mods)
    t0 = time.perf_counter()
    w, V, st = solve(ptt, A, seed, tol, kwargs, M)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, vector = read_counts(mods), read_counts(mods, "VECTOR_LAUNCHES")
    direct = read_counts(mods, "DIRECT_LAUNCHES")
    peak = torch.cuda.max_memory_allocated()
    mv = st["num_matvecs"]
    err_ev = float(np.abs(np.sort(w) - np.asarray(ev_ref)[:len(w)]).max())
    wide = np.complex128 if np.iscomplexobj(V) else np.float64
    V64 = V.astype(wide)
    host = [getattr(X, "matrix", X) for X in (A, M)]
    BV = V64 if M is None else host[1].astype(wide) @ V64
    R = host[0].astype(wide) @ V64 - BV * w[None, :]
    res = float(np.linalg.norm(R, axis=0).max())
    mtm = (None if M is None else
           float(np.abs(V64.T @ BV - np.eye(V64.shape[1])).max()))
    verify = not st["probe_unsupported"]
    print(f"[{tag}] eigsh wall {wall:.3f} s (solve {st['elapsed_time']:.3f}"
          f" s; the rest is format choice, packing, transfer)  num_matvecs "
          f"{mv} (reference {ref_mv})  num_probe_matvecs "
          f"{st['num_probe_matvecs']}  num_probe_rounds "
          f"{st['num_probe_rounds']}  outer {st['num_outer_iterations']}  "
          f"inner {st['num_inner_iterations']}  restarts "
          f"{st['num_restarts']}  resets {st['num_resets']}", flush=True)
    print(f"[{tag}] launches {launches}  max|eval-ref| {err_ev:.3e} (limit "
          f"{ev_tol})  max residual {res:.3e} (limit {1.5 * tol * anorm:.3e})  "
          f"probe verified {st['probe_verified']} exhausted "
          f"{st['probe_exhausted']}"
          + ("" if verify else " (the probe does not cover this target)")
          + ("" if M is None else f"  max|X^T M X - I| {mtm:.3e} (limit "
             "1e-4)")
          + f"  peak device memory {peak} B ({before_bytes} B before)",
          flush=True)
    if any(direct.values()):
        print(f"[{tag}] on the sliced ELL's direct path: "
              f"{ {e: c for e, c in direct.items() if c} }", flush=True)
    for entry in need:
        check(launches[entry] >= mv / 2, f"{tag}: only {launches[entry]} "
              f"{entry} launches for {mv} matvecs")
    for entry in need_direct:
        check(direct[entry] >= mv / 2, f"{tag}: only {direct[entry]} "
              f"{entry} launches on the direct path for {mv} matvecs")
    for entry in forbid:
        check(launches[entry] == 0,
              f"{tag}: {entry} served this solve: {launches}")
    check(err_ev <= ev_tol, f"{tag}: eigenvalue error {err_ev:.3e} > {ev_tol}")
    check(res <= 1.5 * tol * anorm,
          f"{tag}: residual {res:.3e} > {1.5 * tol}*||A||")
    check(M is None or mtm <= 1e-4, f"{tag}: X^T M X - I reads {mtm}")
    check(not verify or (st["probe_verified"] == 1
                         and st["probe_exhausted"] == 0),
          f"{tag}: spectrum verification did not complete")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"{tag}: {mv} matvecs, not within 2x of the reference's {ref_mv}")
    return {"wall_s": wall, "solve_s": st["elapsed_time"],
            "evals": [float(x) for x in np.sort(w)],
            "num_matvecs": mv, "num_probe_matvecs": st["num_probe_matvecs"],
            "num_probe_rounds": st["num_probe_rounds"], "eval_err": err_ev,
            "max_residual": res, "anorm": anorm, "launches": launches,
            "vector_launches": vector, "direct_launches": direct,
            "peak_bytes": peak, "bytes_before": before_bytes,
            **({} if M is None else {"mtm_err": mtm})}


DIA_REAL = (("dia_f32", "float32"), ("dia_f64", "float64"))
DIA_COMPLEX = (("dia_c64", "complex64"), ("dia_c128", "complex128"))


def dia_phase(DK, op, A, dev, gen, entries=DIA_REAL):
    """The DIA kernel against its plain version on ``op``'s diagonals, in
    the type of each entry point of ``entries`` (f32 and f64, or complex64
    and complex128), matmat and rmatmat, bit for bit at every shape of
    ``DIA_SHAPES``; the matmat timed beside its bound (vals, X and Y once
    over 3.35 TB/s), torch's copy of X and the library call (cuSPARSE CSR
    of the same matrix, ``A_csr @ X``; none where torch has no such call
    for the type)."""
    import numpy as np
    import torch

    n, B = op.shape[0], len(op.offsets)
    out = {}
    for name, tname in entries:
        dtype, ndt = getattr(torch, tname), np.dtype(tname)
        size = torch.empty((), dtype=dtype).element_size()
        vals = op.vals.to(dtype).contiguous()
        offs, offsets = op.offs, op.offsets
        A_csr = csr_on_card(A, ndt, dev)
        per_shape = {}
        for k, off in DIA_SHAPES:
            label = shape_label(GRID, k, off)
            X = block_n(n, k, off, dtype, dev, gen)
            Xc = X.contiguous()
            y = DK.matmat(vals, offs, X)
            yref = DK.matmat_reference(vals, offsets, X)
            yt = DK.matmat(vals, offs, X, adjoint=True)
            ytref = DK.rmatmat_reference(vals, offsets, X)
            library = lambda: A_csr @ Xc    # noqa: E731
            try:
                ylib = library()
                torch.cuda.synchronize()
            except RuntimeError as e:       # no such call for the type
                print(f"[{name}] library call A_csr @ X: {e}", flush=True)
                library = ylib = None
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            torch.cuda.synchronize()
            err = max(float((y - yref).abs().max()),
                      float((yt - ytref).abs().max()))
            bit = _bitwise(y, yref) and _bitwise(yt, ytref)
            lib_err = (None if ylib is None
                       else float((ylib - yref).abs().max()))
            plan = DK.card_plan(X)
            t = _times_at(k, lambda: DK.matmat(vals, offs, X),
                          lambda: DK.matmat_reference(vals, offsets, X),
                          (B * n + 2 * n * k) * size, lambda: Yc.copy_(X),
                          library, plain_spin=False)
            per_shape[label] = {"max_abs_err": err, "bitwise": bit,
                                "vector_path": plan.vw > 1,
                                "plan": plan._asdict(),
                                "library_call": "A_csr @ X (cuSPARSE CSR)",
                                "library_max_abs_err": lib_err, **t}
            _print_times(name, label, err, bit, t, plan,
                         "  library (A_csr @ X) none" if ylib is None else
                         f"  library (A_csr @ X) {t['library_ms']} ms "
                         f"(max|diff| {lib_err:.3e})")
            check(bit, f"{name}: kernel differs from its plain version at "
                  f"{label} (matmat or rmatmat)")
            del X, Xc, y, yref, yt, ytref, ylib, Yc
        out[name] = per_shape
    return out


def banded_phase(ptt, mods, DK, WE, dev, gen, seed):
    """Phase 11: the 64^3 27-point Laplacian in grid order through the
    chooser's banded branch, the DIA kernel against its plain version, and
    the gated solve (DIA launches >= matvecs / 2, no windowed launch)."""
    import numpy as np

    A, ev = laplacian27_grid(GRID)
    rb, chooser = choose(ptt, A, "banded")
    check(rb is not None and isinstance(rb[0], ptt.BandedOperator)
          and rb[1] is None and len(rb[0].offsets) == 27,
          f"banded: the chooser returned {rb and type(rb[0]).__name__}, "
          f"perm {rb and rb[1] is not None}")
    op = rb[0].to(dev)
    kern = dia_phase(DK, op, A, dev, gen)
    run = format_solve(ptt, mods, A, seed, "banded", ev, 1e-4,
                       float(np.abs(ev).max()), REF_BANDED_MATVECS,
                       need=("dia_f32",), forbid=tuple(WE.KERNEL_LAUNCHES))
    return {"chooser": chooser, "offsets": list(op.offsets), "solve": run,
            "kernel": kern}


def hybrid_remainder(A, offsets):
    """The entries of ``A`` off the banded part's diagonals (the hybrid's
    ELL part), as CSR."""
    import numpy as np
    import scipy.sparse as sp

    C = A.tocoo()
    off = np.isin(C.col - C.row, np.asarray(offsets))
    return sp.csr_matrix((C.data[~off], (C.row[~off], C.col[~off])),
                         shape=A.shape)


def hybrid_phase(ptt, mods, DK, WE, dev, gen, seed):
    """Phase 12: the 7-point Laplacian plus a long-range scatter through
    the DIA+ELL branch; the sliced-ELL kernel against its plain version on
    the remainder's layout; the gated solve (DIA and sliced-ELL launches
    each >= matvecs / 2)."""
    import numpy as np

    A = hybrid_matrix(GRID, seed)
    rb, chooser = choose(ptt, A, "hybrid")
    ok = (rb is not None and rb[1] is None
          and isinstance(rb[0], ptt.SumOperator)
          and [type(o) for o in rb[0].ops]
          == [ptt.BandedOperator, ptt.ELLOperator]
          and len(rb[0].ops[0].offsets) == 7)
    check(ok, f"hybrid: the chooser returned {rb and type(rb[0]).__name__}")
    op = rb[0].to(dev)
    ell = op.ops[1]
    rem = hybrid_remainder(A, op.ops[0].offsets)
    check(rem.nnz == int(ell.rowlen.sum()),
          f"hybrid: remainder {rem.nnz} entries, layout {int(ell.rowlen.sum())}")
    print(f"[hybrid] banded offsets {op.ops[0].offsets}; remainder "
          f"{rem.nnz} entries, {len(ell.cols)} layout entries, max row "
          f"{int(ell.rowlen.max())}, empty slices "
          f"{int(((ell.slice_ptr[1:] - ell.slice_ptr[:-1]) == 0).sum())} of "
          f"{len(ell.slice_ptr) - 1}", flush=True)
    kern = compare_kernel(WE, ell, csr_on_card(rem, np.float32, dev), gen,
                          1e-5, "hybrid ell", ks=(1, 2, 8))
    run = format_solve(ptt, mods, A, seed, "hybrid", REF_HYBRID_EVALS, 1e-4,
                       gershgorin(A), REF_HYBRID_MATVECS,
                       need=("dia_f32", "windowed_ell_spmm_f32"),
                       need_direct=direct_need(WE, ell, "f32"))
    return {"chooser": chooser, "remainder_nnz": rem.nnz,
            "layout_entries": len(ell.cols), "solve": run, "ell_kernel": kern}


def ell_phase(ptt, mods, WE, dev, gen, seed):
    """Phase 13: a random symmetric matrix that no branch of the chooser
    takes, through ``aslinearoperator``'s ELLOperator; the sliced-ELL
    kernel against its plain version on its layout; the gated solve."""
    import numpy as np

    A = scattered_matrix(GRID ** 3, seed)
    rb, chooser = choose(ptt, A, "ell")
    check(rb is None, f"ell: the chooser returned {rb and type(rb[0])}")
    t0 = time.perf_counter()
    op = ptt.aslinearoperator(A)
    chooser["aslinearoperator_s"] = time.perf_counter() - t0
    check(isinstance(op, ptt.ELLOperator),
          f"ell: aslinearoperator built {type(op).__name__}")
    op = op.to(dev)
    print(f"[ell] ELLOperator in {chooser['aslinearoperator_s']:.3f} s: "
          f"{len(op.cols)} layout entries for {A.nnz} non-zeros, max row "
          f"{int(op.rowlen.max())}", flush=True)
    kern = compare_kernel(WE, op, csr_on_card(A, np.float32, dev), gen, 1e-5,
                          "ell", ks=(1, 2, 8))
    run = format_solve(ptt, mods, A, seed, "ell", REF_ELL_EVALS, 1e-4,
                       gershgorin(A), REF_ELL_MATVECS,
                       need=("windowed_ell_spmm_f32",),
                       need_direct=direct_need(WE, op, "f32"))
    return {"chooser": chooser, "solve": run, "ell_kernel": kern}


def block_ell_phase(ptt, dev, gen, seed):
    """Phase 14: a BlockELLOperator (plain PyTorch: a panel gather and one
    batched product) built from the FEM-like pattern at n = 64^3, against
    scipy's product at k in {2, 8}; its time beside the bytes it needs and
    the library call (cuSPARSE CSR of the same matrix)."""
    import numpy as np
    import torch

    F = fem_like(GRID ** 3, seed)
    t0 = time.perf_counter()
    op = ptt.BlockELLOperator.from_scipy(F, block_size=8)
    build_s = time.perf_counter() - t0
    op = op.to(dev)
    A_csr = csr_on_card(F, np.float32, dev)
    nb, w, b, _ = op.bvals.shape
    out = {"build_s": build_s, "blocks": [nb, w, b], "nnz": F.nnz}
    for k in (2, 8):
        X = torch.randn((F.shape[0], k), generator=gen).to(dev)
        y = op.matmat(X).cpu().double().numpy()
        yref = F.astype(np.float64) @ X.cpu().double().numpy()
        err = float(np.abs(y - yref).max())
        ymax = float(np.abs(yref).max())
        nbytes = (op.bvals.numel() * 4 + op.bcols.numel() * 8
                  + 2 * F.shape[0] * k * 4)
        t = {"ms": median_ms(lambda: op.matmat(X)),
             "library_ms": median_ms(lambda: A_csr @ X),
             "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "max_abs_err": err, "ymax": ymax}
        t["bound_share"] = t["bound_ms"] / t["ms"]
        out[f"k={k}"] = t
        print(f"[block_ell] n={F.shape[0]} nnz={F.nnz} blocks {nb}x{w} of "
              f"{b}x{b} (built in {build_s:.3f} s) k={k}: max|y-scipy| "
              f"{err:.3e} (limit {1e-5 * ymax:.3e})  {t['ms']:.5f} ms  bound "
              f"{t['bound_ms']:.5f} ms (bytes; share {t['bound_share']:.3f})  "
              f"library (A_csr @ X) {t['library_ms']:.5f} ms", flush=True)
        check(err <= 1e-5 * ymax, f"block_ell: k={k} differs from scipy")
    return out


def polish_split(ptt, A64, K, X, dev):
    """Device time of one polish iteration (``refine_step`` on the
    polished block, the P block zero: the same products and small dense
    work as any iteration) from a ``torch.profiler`` trace, split into the
    f64 stencil kernel, the dense work (cuBLAS GEMMs, the Grams, and
    cuSOLVER's Cholesky, triangular solves and ``eigh``) and the rest
    (torch's elementwise kernels and reductions: the Chebyshev recurrence's
    updates among them); plus the iteration's time between CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from primme_tpu_torch.refine import refine_step

    dense = ("gemm", "gemv", "syevd", "syev", "potrf", "potrs", "trsm",
             "trsv", "getrf", "geqrf", "orgqr", "ormqr", "larf", "sytrd",
             "steqr", "stedc", "cusolver", "magma", "Magma", "syrk",
             "splitKreduce", "cutlass", "sm90_xmma", "xmma")
    Xt = torch.as_tensor(X, dtype=torch.float64, device=dev)
    P = torch.zeros_like(Xt)
    refine_step(A64, K, Xt, P, 1.0)              # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    refine_step(A64, K, Xt, P, 1.0)
    b.record()
    b.synchronize()
    iter_ms, host_ms = a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        refine_step(A64, K, Xt, P, 1.0)
        torch.cuda.synchronize()
    split = {"stencil3d_f64": 0.0, "dense": 0.0, "rest": 0.0}
    items = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us <= 0:
            continue
        key = ("stencil3d_f64" if "stencil3d" in e.key else "dense"
               if any(t in e.key for t in dense) else "rest")
        split[key] += us / 1e3
        items.append([e.key[:70], us / 1e3, e.count, key])
    total = sum(split.values())
    items.sort(key=lambda x: -x[1])
    return {"iteration_ms": iter_ms, "iteration_host_ms": host_ms,
            "device_ms": total, "split_ms": split,
            "split_share": {k: v / max(total, 1e-12)
                            for k, v in split.items()},
            "top": items[:10]}


def northstar_phase(ptt, mods, dev, k=NS_K, refs=(REF_NS_MATVECS,
                                                  REF_NS_ITERS),
                    split=True):
    """Phase 15: ``benches/northstar.py``'s configuration at full size
    through ``tools/torch_northstar.py``'s two stages, k pairs, gated
    against the reference's counts ``refs`` (f32 matvecs, polish
    iterations); the counts are set to 0 before each stage and read after
    it. ``split`` traces one polish iteration."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_northstar as NS

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref_mv, ref_its = refs
    tag = f"northstar k={k}"
    reset_counts(*mods)
    res, t32 = NS.f32_stage(ptt, NS_GRID, k, dev)
    l32 = read_counts(mods)
    st = res.stats
    mv = st.num_matvecs
    reset_counts(*mods)
    ev, X, rst, A64, K64, t64 = NS.polish(ptt, NS_GRID, res.evecs, NS_TOL,
                                          dev, degree=NS_DEGREE)
    l64 = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    err, true_res = NS.check(NS_GRID, k, ev, X, dev)
    its = rst["num_refine_iters"]
    print(f"[{tag}] f32 stage {t32:.3f} s: num_matvecs {mv} (reference "
          f"{ref_mv})  probe {st.num_probe_matvecs} matvecs, "
          f"{st.num_probe_rounds} rounds, verified {st.probe_verified}  "
          f"launches {l32}", flush=True)
    print(f"[{tag}] f64 polish {t64:.3f} s: {its} iterations "
          f"(reference {ref_its})  Chebyshev({NS_DEGREE}) interval "
          f"[{float(K64.a):.6g}, {float(K64.b):.6g}]  launches {l64}",
          flush=True)
    print(f"[{tag}] max|eval-analytic| {err:.3e} (limit 1e-10)  max "
          f"true residual {true_res:.3e} (limit {NS_TOL * NS_ANORM:.3e}; "
          f"the polish's own {float(rst['resnorms'].max()):.3e} with ||A|| "
          f"{rst['anorm_estimate']:.6f})  peak device memory {peak} B "
          f"({before} B before)", flush=True)
    out = {}
    if split:
        out["polish_iteration"] = sp = polish_split(ptt, A64, K64, X, dev)
        print(f"[{tag}] one polish iteration: {sp['iteration_ms']:.3f} ms "
              f"between events ({sp['iteration_host_ms']:.3f} ms on the "
              f"host), traced device time {sp['device_ms']:.3f} ms: " +
              "; ".join(f"{c} {v:.3f} ms ({sp['split_share'][c]:.3f})"
                        for c, v in sp["split_ms"].items()), flush=True)
        print(f"[{tag}] largest device items of the iteration: " + "; ".join(
            f"{name} {ms:.3f} ms x{cnt} ({cat})"
            for name, ms, cnt, cat in sp["top"]), flush=True)
    check(err < 1e-10, f"{tag}: eigenvalue error {err:.3e} >= 1e-10")
    check(true_res <= NS_TOL * NS_ANORM,
          f"{tag}: true residual {true_res:.3e} > {NS_TOL}*||A||")
    check(st.probe_verified == 1 and st.probe_exhausted == 0,
          f"{tag}: the f32 stage's verification did not complete")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"{tag}: {mv} f32 matvecs, not within 2x of the reference's "
          f"{ref_mv}")
    check(ref_its / 2 <= its <= 2 * ref_its,
          f"{tag}: {its} polish iterations, not within 2x of the "
          f"reference's {ref_its}")
    # a launch applies at most a block's columns
    blk = NS.block_size(k)
    check(l32["stencil3d_f32"] >= mv / blk and l32["jacobi_shifted_f32"] > 0,
          f"{tag}: the f32 kernels did not serve the solve ({mv} matvecs "
          f"in blocks of {blk}): {l32}")
    check(l64["stencil3d_f64"] >= its * (NS_DEGREE + 2),
          f"{tag}: {l64['stencil3d_f64']} f64 stencil launches for "
          f"{its} iterations of {NS_DEGREE + 2} products")
    check(not any(v for e, v in l64.items() if e != "stencil3d_f64"),
          f"{tag}: another kernel served the polish: {l64}")
    interval = [float(K64.a), float(K64.b)]
    del res, X, A64, K64
    return {"k": k, "f32_s": t32, "f32_num_matvecs": mv,
            "f32_num_probe_matvecs": st.num_probe_matvecs,
            "f32_num_probe_rounds": st.num_probe_rounds,
            "f32_launches": l32, "polish_s": t64, "num_refine_iters": its,
            "polish_launches": l64,
            "chebyshev_interval": interval,
            "anorm_estimate": rst["anorm_estimate"], "eval_err": err,
            "max_true_residual": true_res, "peak_bytes": peak,
            "bytes_before": before, **out}


def generalized_phase(ptt, mods, seed):
    """Phase 16: ``eigsh(K, M=M)`` on the Q1 FEM pencil (``fem_q1``): both
    matrices become ``ELLOperator``s, as ``eigsh`` builds them with a mass
    matrix (``aslinearoperator``), here wrapped to count each one's
    products; gated as ``format_solve`` (``X^T M X = I`` among its gates)
    with the sliced-ELL kernel's launches: at least matvecs / 2 for each
    of K and M, and one for every product of either. The residual gate's
    norm is the pencil's, ``||M^-1 K||`` (its largest eigenvalue, closed
    form): the norm the solver's criterion is relative to, as in the
    reference (problemNorm, the largest |Ritz value| seen); ``||K||``
    itself is about 4, a ninth of it."""

    class Counted(ptt.LinearOperator):
        def __init__(self, op, matrix):
            super().__init__()
            self.op, self.matrix, self.shape, self.calls = (
                op, matrix, op.shape, 0)

        @property
        def dtype(self):
            return self.op.dtype

        def matmat(self, X):
            self.calls += 1
            return self.op.matmat(X)

    K, M, ev, kn = fem_q1(FEM_GRID)
    t0 = time.perf_counter()
    Kop, Mop = (ptt.aslinearoperator(X) for X in (K, M))
    build_s = time.perf_counter() - t0
    check(isinstance(Kop, ptt.ELLOperator) and isinstance(Mop, ptt.ELLOperator),
          f"generalized: aslinearoperator built {type(Kop).__name__}, "
          f"{type(Mop).__name__}")
    pnorm = float(ev.max())
    print(f"[generalized] Q1 FEM pencil {FEM_GRID}^3: K {K.nnz} and M "
          f"{M.nnz} non-zeros, two ELLOperators in {build_s:.3f} s; "
          f"||M^-1 K|| {pnorm:.6f}, ||K|| <= {kn} (Gershgorin)", flush=True)
    Kc, Mc = Counted(Kop, K), Counted(Mop, M)
    run = format_solve(ptt, mods, Kc, seed, "generalized", ev, 1e-4, pnorm,
                       REF_FEM_MATVECS, need=("windowed_ell_spmm_f32",),
                       M=Mc)
    mv = run["num_matvecs"]
    ell = run["launches"]["windowed_ell_spmm_f32"]
    print(f"[generalized] products K {Kc.calls}, M {Mc.calls}; sliced-ELL "
          f"launches {ell}", flush=True)
    check(Kc.calls >= mv / 2 and Mc.calls >= mv / 2,
          f"generalized: {Kc.calls} K and {Mc.calls} M products for {mv} "
          "matvecs")
    check(ell == Kc.calls + Mc.calls,
          f"generalized: {ell} kernel launches for {Kc.calls} + {Mc.calls} "
          "products")
    run.update(build_s=build_s, k_products=Kc.calls, m_products=Mc.calls,
               pencil_norm=pnorm, k_norm_bound=kn)
    return run


def constraints_phase(ptt, mods, ST, dev, seed):
    """Phase 17: ``eigsh`` on the headline's 64^3 stencil with ``lock=``
    the closed-form eigenvectors of lambda_1-4 (whole clusters): the next
    LOCK_K eigenvalues of the closed form, vectors orthogonal to the
    constraints to 1e-5, true residuals (the stencil's plain version in
    f64) <= 1.5e-5 ||A||, probe verified, stencil launches >= matvecs / 2."""
    import numpy as np
    import torch

    L = stencil_modes(GRID, LOCK_MODES)
    lam, anorm = stencil_eigenvalues(GRID, len(LOCK_MODES) + LOCK_K)
    A = ptt.Stencil3DOperator(GRID, GRID, GRID, dtype=torch.float32,
                              device=dev)
    torch.cuda.synchronize()
    reset_counts(*mods)
    t0 = time.perf_counter()
    w, X, st = ptt.eigsh(A, lock=L, tol=1e-5, seed=seed, jacobi=True,
                         device=dev, **{**SOLVE_KWARGS, "k": LOCK_K})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    mv = st["num_matvecs"]
    err = float(np.abs(np.sort(w) - lam[len(LOCK_MODES):]).max())
    orth = float(np.abs(L.T @ X.astype(np.float64)).max())
    Xt = torch.as_tensor(X, dtype=torch.float64, device=dev)
    R = ST.matmat_reference(Xt, GRID, GRID, GRID) - Xt * torch.as_tensor(
        w, dtype=torch.float64, device=dev)
    res = float(torch.linalg.vector_norm(R, dim=0).max())
    print(f"[constraints] lock {len(LOCK_MODES)} closed-form vectors, k="
          f"{LOCK_K}: eigsh {wall:.3f} s  num_matvecs {mv}  probe "
          f"{st['num_probe_matvecs']} matvecs, verified "
          f"{st['probe_verified']}  max|eval-closed form| {err:.3e} (limit "
          f"1e-4)  max|L^T X| {orth:.3e} (limit 1e-5)  max residual "
          f"{res:.3e} (limit {1.5e-5 * anorm:.3e})  launches {launches}",
          flush=True)
    check(err <= 1e-4, f"constraints: eigenvalue error {err:.3e}")
    check(orth <= 1e-5, f"constraints: |L^T X| reads {orth:.3e}")
    check(res <= 1.5e-5 * anorm, f"constraints: residual {res:.3e}")
    check(st["probe_verified"] == 1 and st["probe_exhausted"] == 0,
          "constraints: spectrum verification did not complete")
    check(launches["stencil3d_f32"] >= mv / 2,
          f"constraints: {launches['stencil3d_f32']} stencil launches for "
          f"{mv} matvecs")
    return {"wall_s": wall, "num_matvecs": mv, "eval_err": err,
            "max_abs_LtX": orth, "max_residual": res, "launches": launches,
            "num_probe_matvecs": st["num_probe_matvecs"]}


def interior_phase(ptt, mods, seed):
    """Phase 18: the k=5 eigenvalues closest to sigma=50 of
    ``interior_matrix(INTERIOR_N[name])`` (banded branch, DIA kernel) by
    GD_plusK with the refined and the harmonic projection and by JDQR with
    Jacobi (its locking turns on the skew-Q projector); each gated by
    ``format_solve`` against scipy's shift-invert ``eigsh`` in f64 on the
    host (within 1e-4 ||A||) and the JAX package's matvecs."""
    import numpy as np
    import scipy.sparse.linalg as sla

    out = {}
    for name, kw in INTERIOR_SOLVES.items():
        n = INTERIOR_N[name]
        A = interior_matrix(n)
        rb, chooser = choose(ptt, A, f"interior {name}")
        check(rb is not None and isinstance(rb[0], ptt.BandedOperator),
              f"interior: the chooser returned "
              f"{rb and type(rb[0]).__name__}")
        ref = np.sort(sla.eigsh(A.astype(np.float64),
                                k=INTERIOR_KWARGS["k"], sigma=INTERIOR_SIGMA,
                                return_eigenvectors=False))
        anorm = gershgorin(A)
        out[name] = format_solve(
            ptt, mods, A, seed, f"interior {name}", ref, 1e-4 * anorm, anorm,
            REF_INTERIOR_MATVECS[name], need=("dia_f32",),
            kwargs={**INTERIOR_KWARGS, **kw})
        out[name].update(n=n, chooser=chooser,
                         scipy_evals=[float(x) for x in ref])
    return out


RECT_REAL = (("float32", "windowed_ell_spmm_f32", 1e-5),
             ("float64", "windowed_ell_spmm_f64", 1e-13))


def rect_kernel_phase(ptt, WE, dev, gen, mats, types=RECT_REAL):
    """Phase 19 (and 23's complex128): the sliced-ELL kernel on the
    rectangular layouts of ``mats[dtype][0]``, ``A`` (m rows, X of n rows)
    and ``A^T`` (``A^H`` for a complex matrix; n rows, X of m rows), as
    the ``ELLOperator`` that ``svds`` builds holds them, in each type of
    ``types`` at k in {1, 2, 4, 8}: against its plain version (the type's
    bar of max|y|), timed beside its bound, ``copy_ms`` and cuSPARSE's CSR
    product of the same matrix."""
    import numpy as np
    import torch

    out = {}
    for dt, name, rel in types:
        A = mats[dt][0]
        t0 = time.perf_counter()
        op = ptt.aslinearoperator(A)
        build_s = time.perf_counter() - t0
        check(isinstance(op, ptt.ELLOperator) and op.shape == A.shape
              and op.dtype == getattr(torch, dt),
              f"rect: aslinearoperator built {type(op).__name__} "
              f"{getattr(op, 'shape', None)} {getattr(op, 'dtype', None)} "
              f"for {A.shape} {dt}")
        op = op.to(dev)
        layouts, per = {}, {}
        adj = "A^H" if np.iscomplexobj(A) else "A^T"
        for label, suffix, M in (("A", "", A),
                                 (adj, "_t", A.conj().T.tocsr())):
            sp_ = getattr(op, "slice_ptr" + suffix)
            rl = getattr(op, "rowlen" + suffix)
            layouts[label] = {
                "rows": int(rl.shape[0]), "cols": int(M.shape[1]),
                "nnz": int(M.nnz), "entries": int(sp_[-1]),
                "max_row": int(rl.max()),
                "empty_slices": int(((sp_[1:] - sp_[:-1]) == 0).sum())}
            print(f"[rect {name}] {label}: {layouts[label]}  (ELLOperator "
                  f"built in {build_s:.3f} s)", flush=True)
            per[label] = compare_kernel(
                WE, op, csr_on_card(M, np.dtype(dt), dev), gen, rel,
                f"rect {name} {label}", suffix=suffix, copy=True)
        out[name] = {"build_s": build_s, "layouts": layouts, "per_k": per}
        del op
    return out


def svds_phase(ptt, mods, dev, name, seed, mats, spec=None):
    """Phases 20-22: one ``svds`` call of ``SVDS_SOLVES[name]`` on the
    grounded incidence matrix, on the card, the counts set to 0 just
    before it and read just after. Gates: singular values within
    ``SVDS_VALUE_BAR[name]`` sigma_max of the closed form; the host's f64
    triplet residual ``sqrt(||A v - s u||^2 + ||A^T u - s v||^2)`` <= 10
    tol ||A||; ``U^T U`` and ``V^T V`` equal to I within 1e-8 (f64) or
    1e-4 (f32); every stage the JAX package ran within 2x of its matvecs
    (stage 2 of SM: its count > 0, with the total within 2x); the probe
    verified and not exhausted in each stage it covers; the sliced-ELL
    entry point of the matrix's type launched at least once a matvec,
    every other kernel never, some launches on the direct path if and
    only if the wrapper's rule gives it one of the operator's two layouts
    (``A``, ``A^H``), some on the ring if and only if it gives the ring
    one. ``spec`` gives another solve, a dict of
    ``kw`` (svds arguments), ``dtype`` (the matrix's type), ``refs`` (the
    JAX package's counts as in REF_SVDS), ``value_bar`` (in sigma_max),
    ``res_bar`` (in tol ||A||), ``launch_floor`` (launches a matvec) and
    ``total_floor`` (whether the total must also reach half the JAX
    package's); a complex matrix is held to its residuals and
    orthonormality in complex128."""
    import numpy as np
    import torch
    from primme_tpu_torch.ops import windowed_ell as WE

    if spec is None:
        kw, dt = SVDS_SOLVES[name]
        spec = dict(kw=kw, dtype=dt, refs=REF_SVDS[name],
                    value_bar=SVDS_VALUE_BAR[name], res_bar=10,
                    launch_floor=1, total_floor=True)
    kw, dt, refs = spec["kw"], spec["dtype"], spec["refs"]
    value_bar, res_bar = spec["value_bar"], spec["res_bar"]
    A, sv = mats[dt]
    tol, smax = kw["tol"], float(sv[-1])
    entry = "windowed_ell_spmm_" + {"float32": "f32", "float64": "f64",
                                    "complex64": "c64",
                                    "complex128": "c128"}[dt]
    tag = f"svds {name}"
    # the paths the wrapper's rule gives the operator's A and A^H layouts
    paths = {WE.choose_path(lay.slice_ptr, lay.cols)
             for lay in (WE.from_csr(A, dt),
                         WE.from_csr(A.conj().T.tocsr(), dt))}
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*mods)
    t0 = time.perf_counter()
    U, s, Vt, st = ptt.svds(A, seed=seed, return_stats=True, device=dev,
                            **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    direct = read_counts(mods, "DIRECT_LAUNCHES")
    peak = torch.cuda.max_memory_allocated()
    ref = sv[-len(s):] if kw["which"] == "LM" else sv[:len(s)]
    err = float(np.abs(np.sort(s) - ref).max())
    wide = np.complex128 if np.iscomplexobj(A) else np.float64
    A64 = A.astype(wide)
    U64, V64 = U.astype(wide), Vt.conj().T.astype(wide)
    R1 = A64 @ V64 - U64 * s[None, :]
    R2 = A64.conj().T @ U64 - V64 * s[None, :]
    res = float(np.sqrt((np.abs(R1) ** 2).sum(axis=0)
                        + (np.abs(R2) ** 2).sum(axis=0)).max())
    kk = len(s)
    orth = max(float(np.abs(U64.conj().T @ U64 - np.eye(kk)).max()),
               float(np.abs(V64.conj().T @ V64 - np.eye(kk)).max()))
    orth_bar = 1e-4 if dt in ("float32", "complex64") else 1e-8
    stages = sorted({key.split("_")[0] for key in st if key != "resnorms"})
    mv = sum(int(st[f"{g}_num_matvecs"]) for g in stages)
    ref_mv = sum(r[0] for r in refs.values())
    per_stage = {g: {key: st[f"{g}_{key}"] for key in (
        "num_matvecs", "num_probe_matvecs", "num_probe_rounds",
        "probe_verified", "probe_exhausted", "probe_unsupported",
        "num_outer_iterations", "num_inner_iterations", "num_restarts",
        "num_locked")} for g in stages}
    for g, r in per_stage.items():
        print(f"[{tag}] {g}: {r} (JAX package: matvecs, probe matvecs, "
              f"rounds, exhausted {refs.get(g)})", flush=True)
    print(f"[{tag}] {A.shape[0]}x{A.shape[1]} {dt} {kw}: wall {wall:.3f} s  "
          f"matvecs {mv} (JAX package {ref_mv})  max|s-closed form| "
          f"{err:.3e} (limit {value_bar * smax:.3e})  max "
          f"triplet residual {res:.3e} (limit {res_bar * tol * smax:.3e})  "
          f"orthonormality {orth:.3e} (limit {orth_bar})  launches "
          f"{launches} ({direct[entry]} on the direct path; the layouts' "
          f"paths {sorted(paths)})  peak device memory {peak} B "
          f"({before_bytes} B before)", flush=True)
    check(err <= value_bar * smax,
          f"{tag}: singular values {err:.3e} from the closed form")
    check(res <= res_bar * tol * smax, f"{tag}: triplet residual {res:.3e}")
    check(orth <= orth_bar, f"{tag}: orthonormality {orth:.3e}")
    check(set(refs) <= set(stages),
          f"{tag}: stages {stages}, the JAX package ran {sorted(refs)}")
    for g, r in refs.items():
        got = per_stage[g]["num_matvecs"]
        if kw["which"] == "SM" and g == "stage2":
            check(got > 0, f"{tag}: stage 2 ran no matvec")
        else:
            check(r[0] / 2 <= got <= 2 * r[0], f"{tag}: {g} {got} matvecs, "
                  f"not within 2x of the JAX package's {r[0]}")
        if not per_stage[g]["probe_unsupported"]:
            check(per_stage[g]["probe_verified"] == 1
                  and per_stage[g]["probe_exhausted"] == 0,
                  f"{tag}: {g}'s spectrum verification did not complete")
    check((not spec["total_floor"] or ref_mv / 2 <= mv) and mv <= 2 * ref_mv,
          f"{tag}: {mv} matvecs, not within 2x of the JAX package's {ref_mv}")
    check(launches[entry] >= spec["launch_floor"] * mv,
          f"{tag}: {launches[entry]} {entry} launches for {mv} matvecs")
    check((direct[entry] > 0) == ("direct" in paths)
          and (launches[entry] > direct[entry]) == ("ring" in paths),
          f"{tag}: {direct[entry]} of {launches[entry]} launches on the "
          f"direct path, the layouts' paths {sorted(paths)}")
    for other, count in launches.items():
        check(other == entry or count == 0,
              f"{tag}: {other} served this solve: {launches}")
    return {"wall_s": wall, "shape": list(A.shape), "dtype": dt,
            "kwargs": kw, "svals": [float(x) for x in s], "eval_err": err,
            "max_triplet_residual": res, "anorm": smax,
            "orthonormality": orth, "num_matvecs": mv,
            "ref_num_matvecs": ref_mv, "stages": per_stage,
            "launches": launches, "direct_launches": direct,
            "layout_paths": sorted(paths), "peak_bytes": peak,
            "bytes_before": before_bytes}


def svds_phases(ptt, mods, WE, dev, seed):
    """Phases 19-22 and their records: the rectangular kernel (one record
    per precision, its launches those of the svds path in its type: phase
    20 for f64, 21 for f32) and the three solves; with the phases'
    seconds."""
    import torch

    t0 = time.perf_counter()
    # the matrix in each type, with its singular values
    mats = {dt: grounded_incidence(SVD_GRID, dtype=dt)
            for dt in ("float64", "float32")}
    gen = torch.Generator().manual_seed(seed)
    rect = rect_kernel_phase(ptt, WE, dev, gen, mats)
    t1 = time.perf_counter()
    runs = {name: svds_phase(ptt, mods, dev, name, seed, mats)
            for name in SVDS_SOLVES}
    t2 = time.perf_counter()
    print(f"[svds] phases 19-22 took {t2 - t0:.1f} s (the matrices and "
          f"phase 19 {t1 - t0:.1f} s, the solves {t2 - t1:.1f} s)",
          flush=True)
    kernels = [rect_kernel_record("windowed_ell_spmm_f64",
                                  "primme_tpu/ops/pallas_windowed.py:363",
                                  runs["lm"], rect["windowed_ell_spmm_f64"]),
               rect_kernel_record("windowed_ell_spmm_f32",
                                  "primme_tpu/ops/pallas_windowed.py:228",
                                  runs["augmented"],
                                  rect["windowed_ell_spmm_f32"])]
    return {"kernels": kernels, "svds": runs,
            "seconds": {"total": t2 - t0, "phase19": t1 - t0,
                        "solves": t2 - t1}}


def complex_phases(ptt, mods, DK, WE, dev, gen, cgen, seed):
    """Phases 23-27: complex Hermitian input. Phase 23 holds the four
    complex entry points to their plain versions at k in {1, 2, 4, 8}
    (DIA on the magnetic Laplacian, matmat and A^H, bit for bit, with the
    odd-offset slice; the sliced ELL on phase 26's layout and on phase
    27's ``A`` and ``A^H`` layouts, 1e-5 and 1e-13 of max|y|), each timed
    beside its bound, ``copy_ms`` and torch's complex CSR product. Phases
    24-25: the chooser's banded branch on the magnetic Laplacian in
    complex64 (tol 1e-5) and complex128 (tol 1e-10) through
    ``format_solve``, the closed form the reference. Phase 26: the complex
    scatter through ``aslinearoperator``'s ``ELLOperator``, held to the
    JAX package's complex128 eigenvalues. Phase 27: ``svds`` on the
    magnetic incidence ``[D; 0.1 I]`` in complex128, both stages."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    # --- 23. the complex entry points against their plain versions ------
    L, ev, anorm = magnetic_laplacian(MAG_GRID)
    L64 = L.astype(np.complex64)
    rb, chooser = choose(ptt, L64, "complex dia")
    check(rb is not None and isinstance(rb[0], ptt.BandedOperator)
          and rb[1] is None and rb[0].dtype == torch.complex64
          and len(rb[0].offsets) == 11,
          f"complex dia: the chooser returned "
          f"{rb and (type(rb[0]).__name__, rb[0].dtype, rb[1] is not None)}")
    op128 = ptt.BandedOperator.from_scipy(L).to(dev)
    print(f"[complex dia] magnetic Laplacian {MAG_GRID}^3, phi {MAG_PHI}: "
          f"n={L.shape[0]} nnz={L.nnz} offsets {list(op128.offsets)}",
          flush=True)
    dia = dia_phase(DK, op128, L, dev, cgen, entries=DIA_COMPLEX)
    del op128
    S = complex_scattered_matrix(GRID ** 3, seed)
    rb26, chooser26 = choose(ptt, S, "complex ell")
    check(rb26 is None, f"complex ell: the chooser returned "
          f"{rb26 and type(rb26[0]).__name__}")
    t1 = time.perf_counter()
    op = ptt.aslinearoperator(S)
    chooser26["aslinearoperator_s"] = time.perf_counter() - t1
    check(isinstance(op, ptt.ELLOperator) and op.dtype == torch.complex64,
          f"complex ell: aslinearoperator built {type(op).__name__} "
          f"{getattr(op, 'dtype', None)}")
    op = op.to(dev)
    ell_layout = {"rows": int(op.rowlen.shape[0]), "nnz": int(S.nnz),
                  "entries": int(op.slice_ptr[-1]),
                  "max_row": int(op.rowlen.max())}
    print(f"[complex ell] ELLOperator in {chooser26['aslinearoperator_s']:.3f}"
          f" s: {ell_layout}", flush=True)
    ell = compare_kernel(WE, op, csr_on_card(S, np.complex64, dev), gen,
                         1e-5, "complex ell", copy=True)
    need26 = direct_need(WE, op, "c64")
    del op
    A27, sv = magnetic_svd_matrix(MAG_GRID)
    mats27 = {"complex128": (A27, sv)}
    rect = rect_kernel_phase(
        ptt, WE, dev, gen, mats27,
        types=(("complex128", "windowed_ell_spmm_c128", 1e-13),))
    t23 = time.perf_counter()
    # --- 24-25. eigsh on the magnetic Laplacian, complex64 and 128 -------
    runs = {}
    for tname, tol, bar in (("complex64", 1e-5, 1e-4),
                            ("complex128", 1e-10, 1e-8)):
        entry = "dia_" + tname.replace("complex", "c")
        runs[tname] = format_solve(
            ptt, mods, L.astype(tname), seed, f"{tname} dia", ev, bar, anorm,
            REF_MAG_MATVECS[tname], need=(entry,),
            forbid=[e for e in others if e != entry], tol=tol)
    t25 = time.perf_counter()
    # --- 26. eigsh through the ELL branch, complex64 --------------------
    runs["ell"] = format_solve(
        ptt, mods, S, seed, "complex64 ell", REF_CELL_EVALS, 1e-4,
        gershgorin(S), REF_CELL_MATVECS, need=("windowed_ell_spmm_c64",),
        forbid=[e for e in others if e != "windowed_ell_spmm_c64"],
        need_direct=need26)
    t26 = time.perf_counter()
    # --- 27. svds on the magnetic incidence, complex128, both stages ----
    # launches: stage 1 multiplies blocks of up to four columns, two
    # launches (A and A^H) a block, so at least one launch per two
    # matvecs. The total is held to at most 2x the JAX package's: stage
    # 2 refines the triplets whose stage-1 residual missed tol, at 1e-8
    # a threshold that rounding decides (the JAX package and the port on
    # the CPU: 5299 and 5630 matvecs, 28 outer iterations, five pairs
    # locked; the port on the card: 451, 6), so stage 2's count is gated
    # > 0 only and the total not from below (ROADMAP.md Queue C)
    runs["svds"] = svds_phase(
        ptt, mods, dev, "complex sm", seed, mats27,
        spec=dict(kw=COMPLEX_SVDS_KWARGS, dtype="complex128",
                  refs=REF_CSVDS, value_bar=1e-8, res_bar=1.5,
                  launch_floor=0.5, total_floor=False))
    t27 = time.perf_counter()
    seconds = {"phase23": t23 - t0, "phases24_25": t25 - t23,
               "phase26": t26 - t25, "phase27": t27 - t26,
               "total": t27 - t0}
    print(f"[complex] phases 23-27 took {seconds['total']:.1f} s (23 "
          f"{seconds['phase23']:.1f}, 24-25 {seconds['phases24_25']:.1f}, "
          f"26 {seconds['phase26']:.1f}, 27 {seconds['phase27']:.1f})",
          flush=True)
    src_dia = "primme_tpu_torch/csrc/dia.cu"
    kernels = [
        main_path_record(name, src_dia, "primme_tpu/operators.py:671",
                         runs[tname], dia, {})
        for name, tname in DIA_COMPLEX]
    kernels.append(dict(
        kernel_record("windowed_ell_spmm_c64", "primme_tpu/operators.py:198",
                      runs["ell"], ell, ell_layout),
        copy_ms=ell[2]["copy_ms"],
        shape=f"complex_scattered_matrix({GRID ** 3}), k=2"))
    kernels.append(rect_kernel_record(
        "windowed_ell_spmm_c128", "primme_tpu/operators.py:198",
        runs["svds"], rect["windowed_ell_spmm_c128"],
        shape=f"magnetic_svd_matrix({MAG_GRID}) A layout, k=2"))
    return {"kernels": kernels, "solves": runs,
            "chooser": {"dia": chooser, "ell": chooser26},
            "seconds": seconds}


NORMAL_ENTRY = {"ell_f64": "windowed_ell_spmm_f64",
                "ell_c64": "windowed_ell_spmm_c64", "dia_f32": "dia_f32"}


def normal_phase(ptt, mods, name, seed, grid=None, jacobi=None, ref_mv=None,
                 tag=None):
    """Phases 28-30: one ``eigs`` call of ``NORMAL_SOLVES[name]`` on the
    card, k=7 of smallest real part on ``convection_diffusion``: the
    scipy matrix as a user passes it (``aslinearoperator``'s
    ``ELLOperator``), or for ``dia_f32`` the port's
    ``BandedOperator.from_scipy`` of it (13 diagonals with the periodic
    wraps). The counts are set to 0 just before the call and read just
    after. Gates: the values set-matched to the closed form's seven
    smallest by real part, each within 1.5 tol ||A|| of its match
    (Bauer-Fike: a normal matrix's Ritz value lies within its residual of
    an eigenvalue); the true residuals ``||A x - lambda x||`` on the host
    in complex128 <= 1.5 tol ||A||; matvecs within 2x of the JAX
    package's (``REF_NORMAL``); the path's entry point launched at least
    matvecs / block times and no other kernel, so no complex entry point
    serves a real matrix. Prints the seconds and the peak device
    memory. Phase 39 runs the call at ``grid`` with OPinv a
    ``JacobiPrecond`` of the matrix's diagonal, whose entry point
    ``jacobi`` must launch, and its own ``ref_mv``."""
    import numpy as np
    import torch

    N, coef, dt, tol, method, fmt = NORMAL_SOLVES[name]
    N = grid or N
    entry = NORMAL_ENTRY[name]
    ref_mv = ref_mv or REF_NORMAL[name]
    tag = tag or f"normal {name}"
    t0 = time.perf_counter()
    A, lam, anorm = convection_diffusion(N, coef, dtype=dt)
    op = A
    if fmt == "banded":
        op = ptt.BandedOperator.from_scipy(A)
        check(len(op.offsets) == 13, f"{tag}: {len(op.offsets)} diagonals")
    blk = ptt.set_method(ptt.Method[method], ptt.PrimmeParams(
        n=A.shape[0], num_evals=NORMAL_KWARGS["k"], hermitian=False,
        target=ptt.Target.smallest)).max_block_size
    build_s = time.perf_counter() - t0
    print(f"[{tag}] convection_diffusion({N}, coef={coef}) {dt}: n="
          f"{A.shape[0]} nnz={A.nnz} ||A||={anorm:.6f}; {method}, tol "
          f"{tol}, block {blk}, "
          f"{'BandedOperator' if fmt == 'banded' else 'scipy CSR'}; built "
          f"in {build_s:.2f} s", flush=True)
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES
              if e not in (entry, jacobi)]
    extra = ({} if jacobi is None else
             {"OPinv": ptt.JacobiPrecond(A.diagonal())})
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*mods)
    t0 = time.perf_counter()
    w, V, st = ptt.eigs(op, tol=tol, method=method, seed=seed,
                        return_stats=True, **NORMAL_KWARGS, **extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    mv = st["num_matvecs"]
    bar = 1.5 * tol * anorm
    err = match_values(w, lam[:len(w)])
    V64 = V.astype(np.complex128)
    R = A.astype(np.complex128) @ V64 - V64 * w[None, :]
    res = float(np.linalg.norm(R, axis=0).max())
    print(f"[{tag}] eigs wall {wall:.3f} s (solve {st['elapsed_time']:.3f} "
          f"s)  num_matvecs {mv} (reference {ref_mv})  outer "
          f"{st['num_outer_iterations']}  inner "
          f"{st['num_inner_iterations']}  restarts {st['num_restarts']}  "
          f"resets {st['num_resets']}", flush=True)
    print(f"[{tag}] launches {launches}  max|eval-closed form| {err:.3e}  "
          f"max residual {res:.3e} (limit for both {bar:.3e})  peak device "
          f"memory {peak} B ({before_bytes} B before)", flush=True)
    print(f"[{tag}] values " + ", ".join(
        f"{x.real:.9f}{x.imag:+.9f}i" for x in w), flush=True)
    check(w.dtype == V.dtype == np.dtype(
        "complex64" if dt in ("float32", "complex64") else "complex128"),
        f"{tag}: values {w.dtype}, vectors {V.dtype}")
    check(launches[entry] >= mv / blk,
          f"{tag}: only {launches[entry]} {entry} launches for {mv} "
          f"matvecs")
    check(jacobi is None or launches[jacobi] > 0,
          f"{tag}: no {jacobi} launch")
    for other in others:
        check(launches[other] == 0,
              f"{tag}: {other} served this solve: {launches}")
    check(err <= bar, f"{tag}: eigenvalue error {err:.3e} > {bar:.3e}")
    check(res <= bar, f"{tag}: residual {res:.3e} > {bar:.3e}")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"{tag}: {mv} matvecs, not within 2x of the reference's {ref_mv}")
    return {"wall_s": wall, "solve_s": st["elapsed_time"], "grid": N,
            "dtype": dt, "method": method, "tol": tol, "block": blk,
            "evals": [[float(x.real), float(x.imag)] for x in w],
            "num_matvecs": mv,
            "num_outer_iterations": st["num_outer_iterations"],
            "num_inner_iterations": st["num_inner_iterations"],
            "eval_err": err, "max_residual": res, "anorm": anorm,
            "launches": launches, "peak_bytes": peak,
            "bytes_before": before_bytes}


def normal_phases(ptt, mods, seed):
    """Phases 28-30: ``eigs`` on normal operators, each solve gated by
    ``normal_phase``; with the phases' seconds."""
    t0 = time.perf_counter()
    runs = {name: normal_phase(ptt, mods, name, seed)
            for name in NORMAL_SOLVES}
    secs = time.perf_counter() - t0
    each = ", ".join(f"{name} {r['wall_s']:.1f}" for name, r in runs.items())
    print(f"[normal] phases 28-30 took {secs:.1f} s (solves {each})",
          flush=True)
    return {"solves": runs, "seconds": secs}


def _headline_eigsh_kwargs(dev, seed, grid):
    """``bench.py``'s headline as an ``eigsh`` call on the stencil: k=10
    smallest, tol 1e-5, block 2, basis 24, restart 14, locking off, the
    shift-aware Jacobi, ``v0`` from ``default_rng(seed)``."""
    import numpy as np

    v0 = np.random.default_rng(seed).normal(size=(grid ** 3, 2))
    return dict(k=10, which="SA", tol=1e-5, ncv=24, maxBlockSize=2,
                minRestartSize=14, locking=False, jacobi=True,
                maxMatvecs=16000, v0=v0.astype(np.float32),
                return_stats=True, device=dev)


def _true_stencil_residual(grid, w, X, dev):
    """The largest ||A x - lambda x|| of the returned pairs, in f64 with
    the stencil's plain version."""
    import torch
    from primme_tpu_torch.ops import stencil3d as ST

    Xt = torch.as_tensor(X, device=dev).to(torch.float64)
    wt = torch.as_tensor(w, device=dev).to(torch.float64)
    R = ST.matmat_reference(Xt, grid, grid, grid) - Xt * wt[None, :]
    return float(torch.linalg.vector_norm(R, dim=0).max())


def dynamic_phase(ptt, mods, dev, seed):
    """31: ``eigsh(method="DYNAMIC")`` on the headline (one untimed solve,
    then one timed), gated; the method trace and each method's segments
    and mean digits a second printed."""
    import numpy as np
    import torch

    grid = GRID
    lam, anorm = stencil_eigenvalues(grid, 10)
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    kw = _headline_eigsh_kwargs(dev, seed, grid)
    ref = 2 * max(REF_HEADLINE_MATVECS, REF_DYNAMIC_GD_MATVECS)
    runs = []
    for tag in ("untimed", "timed"):
        torch.cuda.synchronize()
        reset_counts(*mods)
        t0 = time.perf_counter()
        w, X, st = ptt.eigsh(A, method="DYNAMIC", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(mods)
        mv = st["num_matvecs"]
        err = float(np.abs(np.sort(w) - lam).max())
        true_res = _true_stencil_residual(grid, w, X, dev)
        trace = st["method_trace"]
        per = {}
        for m in ("gd", "jd"):
            segs = [r for r in st["dynamic_segments"] if r["method"] == m]
            per[m] = {"segments": len(segs),
                      "seconds": sum(r["seconds"] for r in segs),
                      "digits": sum(r["digits"] for r in segs),
                      "matvecs": sum(r["matvecs"] for r in segs),
                      "outer": sum(r["outer"] for r in segs),
                      "mean_digits_per_s": (float(np.mean(
                          [r["digits"] / r["seconds"] for r in segs]))
                          if segs else 0.0)}
        run = {"wall_s": wall, "num_matvecs": mv,
               "num_outer_iterations": st["num_outer_iterations"],
               "num_inner_iterations": st["num_inner_iterations"],
               "num_probe_matvecs": st["num_probe_matvecs"],
               "eval_err": err, "max_true_residual": true_res,
               "probe_verified": st["probe_verified"],
               "probe_exhausted": st["probe_exhausted"],
               "method_trace": "".join("G" if t == "gd" else "J"
                                       for t in trace),
               "per_method": per, "launches": launches}
        runs.append(run)
        print(f"[dynamic {tag}] DYNAMIC headline {grid}^3: solve "
              f"{wall:.4f} s  num_matvecs {mv} (limit {ref})  outer "
              f"{st['num_outer_iterations']}  inner "
              f"{st['num_inner_iterations']}  probe "
              f"{st['num_probe_matvecs']} matvecs  max|eval-analytic| "
              f"{err:.3e}  max true residual {true_res:.3e} (limit "
              f"{1.5e-5 * anorm:.3e})  probe verified "
              f"{st['probe_verified']} exhausted {st['probe_exhausted']}",
              flush=True)
        print(f"[dynamic {tag}] method trace {run['method_trace']} "
              f"(G = GD_Olsen_plusK, J = JDQMR_ETol, 10 outer "
              f"iterations a segment; the JAX package's on the CPU "
              f"{REF_DYNAMIC[1]}, {REF_DYNAMIC[0]} matvecs); " + "; ".join(
                  f"{m}: {v['segments']} segments, {v['outer']} outer, "
                  f"{v['matvecs']} matvecs, {v['seconds']:.4f} s, "
                  f"{v['digits']:.3f} digits, mean "
                  f"{v['mean_digits_per_s']:.3f} digits/s"
                  for m, v in per.items()) + f"; launches "
              f"{ {e: c for e, c in launches.items() if c} }", flush=True)
        check(err <= 1e-4, f"dynamic {tag}: eigenvalue error {err:.3e}")
        check(true_res <= 1.5e-5 * anorm,
              f"dynamic {tag}: true residual {true_res:.3e} > 1.5e-5*||A||")
        check(st["probe_verified"] == 1 and st["probe_exhausted"] == 0,
              f"dynamic {tag}: spectrum verification did not complete")
        check(mv <= ref, f"dynamic {tag}: {mv} matvecs > {ref}")
        check("gd" in trace and "jd" in trace,
              f"dynamic {tag}: the trace {trace} misses a method")
        # every QMR step and GD expansion applies the preconditioner; the
        # probe's Chebyshev filter and power steps (one column, no
        # preconditioner) do not
        check(launches["stencil3d_f32"] >= mv / 2
              and launches["jacobi_shifted_f32"]
              >= (mv - st["num_probe_matvecs"]) / 2,
              f"dynamic {tag}: the kernels did not serve the solve: "
              f"{launches}")
        others = {e: c for e, c in launches.items()
                  if e not in ("stencil3d_f32", "jacobi_shifted_f32")}
        check(not any(others.values()),
              f"dynamic {tag}: another kernel launched: {others}")
    return {"untimed": runs[0], "timed": runs[1],
            "wall_s": runs[1]["wall_s"], "launches": runs[1]["launches"],
            "ref_limit": ref}


def _headline_solve_eigs(ptt, A, K, v0, **kw):
    """The headline through ``solve_eigs`` (JDQMR_ETol, as phase 9)."""
    import torch
    from primme_tpu_torch.core.inner import jdqmr_inner_solve
    from primme_tpu_torch.core.solver import solve_eigs

    n = A.shape[0]
    p = ptt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                         max_block_size=2, min_restart_size=14,
                         max_matvecs=16000, locking=0)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    return solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                      inner_solve=jdqmr_inner_solve, **kw)


def segmented_phase(ptt, mods, dev, seed):
    """32: the headline twice unsegmented, then with ``segment_outer=10``:
    run to run bit for bit (the card's path is deterministic), then the
    segmented solve bit for bit against the unsegmented one."""
    import numpy as np
    import torch

    grid = GRID
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    K = ptt.JacobiPrecond(A.diagonal())
    v0 = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(grid ** 3, 2)), dtype=torch.float32).to(dev)
    runs = {}
    for tag, kw in (("unsegmented 1", {}), ("unsegmented 2", {}),
                    ("segment_outer=10", {"segment_outer": 10})):
        torch.cuda.synchronize()
        reset_counts(*mods)
        t0 = time.perf_counter()
        r = _headline_solve_eigs(ptt, A, K, v0, **kw)
        torch.cuda.synchronize()
        runs[tag] = (r, time.perf_counter() - t0, read_counts(mods))
        print(f"[segmented] {tag}: {runs[tag][1]:.4f} s  num_matvecs "
              f"{r.stats.num_matvecs}  outer {r.stats.num_outer_iterations}"
              f"  inner {r.stats.num_inner_iterations}", flush=True)
    (r1, _, _), (r2, _, _), (rs, _, ls) = runs.values()

    def same(a, b):
        return (_bitwise(a.evals, b.evals) and _bitwise(a.resnorms,
                                                        b.resnorms)
                and _bitwise(a.evecs, b.evecs)
                and a.stats.num_matvecs == b.stats.num_matvecs
                and a.stats.num_inner_iterations
                == b.stats.num_inner_iterations)

    deterministic = same(r1, r2)
    seg_same = same(r1, rs)
    print(f"[segmented] run to run bit for bit: {deterministic}; segmented "
          f"against unsegmented bit for bit: {seg_same}", flush=True)
    if deterministic:
        check(seg_same, "segmented: the segmented headline differs from "
              "the unsegmented one")
    else:
        dv = float(torch.abs(rs.evals - r1.evals).max())
        print(f"[segmented] the card's path is not deterministic run to "
              f"run; segmented values within {dv:.3e}", flush=True)
        check(rs.stats.num_matvecs == r1.stats.num_matvecs and dv <= 1e-6,
              "segmented: matvecs or values differ")
    return {"deterministic": deterministic, "bitwise": seg_same,
            "num_matvecs": rs.stats.num_matvecs, "launches": ls,
            "seconds": {tag: v[1] for tag, v in runs.items()}}


def events_phase(ptt, mods, dev, seed):
    """33: the headline through ``eigsh`` with ``return_history=True``,
    then with ``monitor_inner=True`` and a counting monitor, each gated on
    the event count; then the solve time with no monitor, with the
    history, with the inner replay and with the profiler scopes forced
    open (min of EVENT_ROUNDS (1) each, interleaved)."""
    import numpy as np
    import torch
    from primme_tpu_torch.core import linalg

    grid = GRID
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    kw = dict(_headline_eigsh_kwargs(dev, seed, grid), method="JDQMR_ETol")
    _, _, st = ptt.eigsh(A, return_history=True, **kw)
    h = st["hist"]
    nev = len(h["event"])
    lens = {key: len(v) for key, v in h.items() if key != "inner"}
    outer = sorted(set(int(x) for x in h["num_outer"]))
    ninner = int(np.sum(h["num_inner"]))
    print(f"[events] history: {nev} events for {st['num_outer_iterations']}"
          f" outer iterations and {st['num_restarts']} restarts; kinds "
          f"{sorted(set(int(e) for e in h['event']))}; sum(num_inner) "
          f"{ninner} (stat {st['num_inner_iterations']})", flush=True)
    check(set(lens.values()) == {nev}, f"events: history lengths {lens}")
    check(outer == list(range(st["num_outer_iterations"] + 1))
          or outer == list(range(st["num_outer_iterations"])),
          "events: an outer iteration without its event")
    check(ninner == st["num_inner_iterations"],
          f"events: sum(num_inner) {ninner} != "
          f"{st['num_inner_iterations']}")

    count = {"events": 0, "inner": 0, "rows": 0}

    def mon(event, num_outer, num_matvecs, num_locked, num_converged,
            basis_size, num_inner, hvals, resnorms, inner_trace=None):
        count["events"] += 1
        count["inner"] += int(num_inner)
        if inner_trace is not None:
            count["rows"] += min(int(num_inner), inner_trace.shape[0])

    _, _, st2 = ptt.eigsh(A, monitor=mon, monitor_inner=True, **kw)
    print(f"[events] monitor_inner: {count['events']} events, "
          f"sum(num_inner) {count['inner']} (stat "
          f"{st2['num_inner_iterations']}), {count['rows']} replayed rows",
          flush=True)
    check(count["inner"] == st2["num_inner_iterations"],
          "events: the monitor's num_inner does not sum to the stat")
    check(count["events"] >= st2["num_outer_iterations"],
          "events: fewer events than outer iterations")
    check(count["rows"] > 0, "events: no inner rows replayed")

    # the phase scopes open only while a profiler records; "scopes on"
    # forces them open (as if one did), the cost every solve paid when
    # they were unconditional
    enabled = torch.autograd._profiler_enabled
    variants = {"no monitor": {}, "return_history": {"return_history": True},
                "monitor_inner": {"monitor": mon, "monitor_inner": True},
                "scopes on": {}}
    times = {name: [] for name in variants}
    for _ in range(EVENT_ROUNDS):
        for name, extra in variants.items():
            if name == "scopes on":
                torch.autograd._profiler_enabled = lambda: True
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ptt.eigsh(A, **kw, **extra)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
            finally:
                torch.autograd._profiler_enabled = enabled
    best = {name: min(v) for name, v in times.items()}
    print(f"[events] solve seconds, min of {EVENT_ROUNDS} (each run): "
          + "; ".join(
        f"{name} {best[name]:.4f} ({', '.join(f'{t:.4f}' for t in v)})"
        for name, v in times.items()), flush=True)
    paired = [on / off for on, off in zip(times["scopes on"],
                                          times["no monitor"])]
    print("[events] scopes on / no monitor, paired by round: "
          + ", ".join(f"{r:.4f}" for r in paired), flush=True)
    record = linalg.record_function
    n_scope = {"n": 0}

    def counting(name):
        n_scope["n"] += 1
        return record(name)

    linalg.record_function = counting
    torch.autograd._profiler_enabled = lambda: True
    try:
        ptt.eigsh(A, **kw)
    finally:
        linalg.record_function = record
        torch.autograd._profiler_enabled = enabled
    per = {}
    for tag, fn in (("open", record), ("gated", linalg.scope)):
        t0 = time.perf_counter()
        for _ in range(100000):
            with fn("pt_matvec"):
                pass
        per[tag] = (time.perf_counter() - t0) / 100000
    print(f"[events] one scope costs {per['open'] * 1e6:.3f} us of host "
          f"time opened and {per['gated'] * 1e6:.3f} us gated off (no "
          f"profiler running); the headline enters {n_scope['n']} scopes: "
          f"{n_scope['n'] * per['open']:.4f} s opened, "
          f"{n_scope['n'] * per['gated']:.4f} s gated, a solve", flush=True)
    return {"num_events": nev, "history_lengths": lens,
            "num_outer_iterations": st["num_outer_iterations"],
            "monitor_inner_events": count["events"],
            "monitor_inner_rows": count["rows"],
            "times_s": times, "min_s": best, "scopes_on_ratio": paired,
            "scopes_per_solve": n_scope["n"], "scope_cost_s": per}


HARNESS_GRID = 32


def _laplacian7(m, seed):
    """The 7-point Dirichlet Laplacian of the m^3 grid in a random node
    order from ``seed`` (scipy CSR, f64); in grid order, the stencil's,
    when ``seed`` is None."""
    import numpy as np
    import scipy.sparse as sp

    T = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                 [-1, 0, 1])
    I = sp.identity(m)
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T)).tocsr()
    if seed is None:
        return A
    perm = np.random.default_rng(seed).permutation(m ** 3)
    return A[perm][:, perm].tocsr()


def magnetic_config(tmp, N=JACOBI_HARNESS_GRID):
    """Phase 39's config in ``tmp``: the complex128 magnetic Laplacian of
    the N^3 grid (``mag.mtx``), the Jacobi PrecChoice, numEvals 6, eps
    1e-10, smallest, the default method. Returns (its path, the closed-form
    eigenvalues, the norm bound 12)."""
    import scipy.io as sio

    L, ev, anorm = magnetic_laplacian(N)
    sio.mmwrite(os.path.join(tmp, "mag.mtx"), L)
    cfg = os.path.join(tmp, "test_mag")
    with open(cfg, "w") as f:
        f.write("\n".join(["driver.matrixFile    = mag.mtx",
                           "driver.PrecChoice    = jacobi",
                           "primme.numEvals = 6", "primme.eps = 1e-10",
                           "primme.target = primme_smallest"]) + "\n")
    return cfg, ev, anorm


def harness_phase(ptt, mods, dev, seed):
    """34: the config-file driver on the card: a config with no method
    line (DEFAULT_METHOD, so DYNAMIC) and the Jacobi PrecChoice on the
    7-point Laplacian at ``HARNESS_GRID``^3 in random order, saved with
    ``--save-x`` and checked against the saved file; then an svds config
    (``primme_svds_hybrid``) on a small rectangular matrix."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    import numpy as np
    import scipy.io as sio
    import scipy.sparse as sp
    from primme_tpu_torch import driver

    m = HARNESS_GRID
    lam, _ = stencil_eigenvalues(m, 6)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    out = {}
    try:
        sio.mmwrite(os.path.join(tmp, "lap7.mtx"), _laplacian7(m, seed))
        base = ["driver.matrixFile    = lap7.mtx",
                "driver.PrecChoice    = jacobi",
                "primme.numEvals = 6", "primme.eps = 1e-10",
                "primme.target = primme_smallest"]
        cfg = os.path.join(tmp, "test_lap7")
        with open(cfg, "w") as f:
            f.write("\n".join(base) + "\n")
        save = os.path.join(tmp, "sol_lap7")
        where = ["--base-dir", tmp, "--device", dev.type]
        for tag, args in (("save", [cfg, "--save-x", save] + where),
                          ("check", None)):
            if tag == "check":
                shutil.copy(save, save + "_double")
                cfg2 = os.path.join(tmp, "test_lap7_check")
                with open(cfg2, "w") as f:
                    f.write("\n".join(base + [
                        "driver.checkXFile    = sol_lap7"]) + "\n")
                args = [cfg2] + where
            buf = io.StringIO()
            reset_counts(*mods)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = driver.main(args)
            wall = time.perf_counter() - t0
            launches = read_counts(mods)
            text = buf.getvalue()
            mv = int(re.search(r"Matvecs: (\d+)", text).group(1))
            evals = np.sort([float(x) for x in re.findall(
                r"Eval\[\d+\]:\s+(\S+)", text)])
            err = float(np.abs(evals - lam).max())
            print(f"[harness {tag}] driver rc {rc} in {wall:.3f} s: "
                  f"{mv} matvecs, max|eval-analytic| {err:.3e}, launches "
                  f"{ {e: c for e, c in launches.items() if c} }; its "
                  f"report:", flush=True)
            print(text.rstrip(), flush=True)
            check(rc == 0 and "solution check: OK" in text,
                  f"harness {tag}: the solution check failed")
            check(err <= 1e-8, f"harness {tag}: eigenvalue error {err:.3e}")
            check(launches["windowed_ell_spmm_f64"] >= mv / 2,
                  f"harness {tag}: {launches['windowed_ell_spmm_f64']} "
                  f"sliced-ELL f64 launches for {mv} matvecs")
            out[tag] = {"rc": rc, "wall_s": wall, "num_matvecs": mv,
                        "eval_err": err, "launches": launches}
        B = sp.random(40, 25, density=0.3, random_state=7, format="csr")
        sio.mmwrite(os.path.join(tmp, "rectsmall.mtx"), B)
        cfg3 = os.path.join(tmp, "test_svds")
        with open(cfg3, "w") as f:
            f.write("\n".join([
                "driver.matrixFile    = rectsmall.mtx",
                "driver.PrecChoice    = noprecond",
                "primme_svds.numSvals = 2", "primme_svds.eps = 1e-8",
                "primme_svds.target = primme_svds_largest",
                "method = primme_svds_hybrid"]) + "\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = driver.main([cfg3] + where)
        text = buf.getvalue()
        svals = np.sort([float(x) for x in re.findall(
            r"Sval\[\d+\]:\s+(\S+)", text)])
        ref = np.sort(np.linalg.svd(B.toarray(), compute_uv=False)[:2])
        print(f"[harness svds] driver rc {rc}: values {svals} (numpy "
              f"{ref})", flush=True)
        check(rc == 0 and "solution check: OK" in text
              and np.abs(svals - ref).max() <= 1e-7 * ref[-1],
              "harness svds: the solution check failed")
        out["svds"] = {"rc": rc, "svals": svals.tolist()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def profile_phase(ptt, mods, dev):
    """35: ``eigsh(profile="pt_", time_breakdown=True)`` on phase 10's
    solve (GD_Olsen_plusK + Jacobi, the 16^3 stencil, k=4, tol 1e-4): the
    measured split of the traced solve's device time."""
    import numpy as np
    import torch

    grid = GD_GRID
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    v0 = np.random.default_rng(0).normal(size=(grid ** 3, 1))
    got = []

    def mon(event, *args, msg=None, time=None, **kw):
        if int(event) == 7:
            got.append((msg, time))

    t0 = time.perf_counter()
    w, _, st = ptt.eigsh(A, k=4, which="SA", tol=1e-4, jacobi=True,
                         method="GD_Olsen_plusK", v0=v0.astype(np.float32),
                         return_stats=True, time_breakdown=True,
                         profile="pt_", monitor=mon, device=dev)
    wall = time.perf_counter() - t0
    keys = ("time_matvec", "time_precond", "time_ortho", "time_dense",
            "time_other")
    nan = float("nan")
    parts = sum(st[k] for k in keys)
    busy = st.get("device_busy", 0.0)
    print(f"[profile] eigsh(profile) {wall:.3f} s (the solve, then it "
          f"again untimed and traced); time_source {st['time_source']}; "
          + "; ".join(f"{k} {st[k] * 1e3:.3f} ms" for k in keys)
          + f"; sum {parts * 1e3:.3f} ms against device busy "
          f"{busy * 1e3:.3f} ms; traced wall "
          f"{st.get('profiled_wall', nan):.3f} s, device idle "
          f"{st.get('device_idle', nan):.3f} s; post-processing "
          f"{st.get('profile_post_seconds', nan):.3f} s; events delivered "
          f"{got}", flush=True)
    check(st["time_source"] == "measured",
          f"profile: time_source {st['time_source']}")
    check(all(st[k] > 0 for k in keys[:4]),
          "profile: a phase scope measured no device time")
    check(abs(parts - busy) <= 0.1 * busy and st["time_other"] >= 0,
          f"profile: the split {parts:.6f} s against busy {busy:.6f} s")
    kern = st["device_kernels"]
    sten = sum(v for k, v in kern.items() if "stencil3d_kernel" in k)
    jac = sum(v for k, v in kern.items() if "jacobi_kernel" in k)
    print(f"[profile] the stencil kernels {sten * 1e3:.3f} ms, the Jacobi "
          f"kernels {jac * 1e3:.3f} ms; the largest device items: "
          + "; ".join(f"{k[:60]} {v * 1e3:.3f} ms"
                      for k, v in list(kern.items())[:8]), flush=True)
    check(sten > 0 and st["time_matvec"] >= 0.99 * sten,
          f"profile: pt_matvec {st['time_matvec']:.6f} s does not hold the "
          f"stencil kernels' {sten:.6f} s")
    check(jac > 0 and st["time_precond"] >= 0.99 * jac,
          f"profile: pt_precond {st['time_precond']:.6f} s does not hold "
          f"the Jacobi kernels' {jac:.6f} s")
    check(sorted(m for m, _ in got) == sorted(st["profile"]),
          f"profile: events {got} against stats {st['profile']}")
    return {"wall_s": wall, "split_s": {k: st[k] for k in keys},
            "device_busy_s": busy, "device_idle_s": st.get("device_idle"),
            "profiled_wall_s": st.get("profiled_wall"),
            "post_processing_s": st.get("profile_post_seconds"),
            "profile": st["profile"], "num_matvecs": st["num_matvecs"],
            "stencil_s": sten, "jacobi_s": jac}


# --- phases 36-40 -----------------------------------------------------------

def write_csr_bin(path, A):
    """``A`` as ``capi_smoke.c`` reads a CSR: int64 rows, cols, nnz, then
    int64 indptr and indices and f64 data."""
    import numpy as np

    A = A.tocsr()
    with open(path, "wb") as f:
        np.array([A.shape[0], A.shape[1], A.nnz], np.int64).tofile(f)
        A.indptr.astype(np.int64).tofile(f)
        A.indices.astype(np.int64).tofile(f)
        A.data.astype(np.float64).tofile(f)


def build_c_program(src, out):
    """Compile the C program ``src`` into ``out``, linked against the
    port's C ABI library (built at first use); returns ``out``."""
    import shutil

    from primme_tpu_torch import native

    lib = native.capi_library()
    libdir, libfile = os.path.split(lib)
    cc = os.environ.get("CC") or shutil.which("gcc") or shutil.which("cc")
    check(cc is not None, "no C compiler (gcc, cc or $CC)")
    proc = subprocess.run([cc, "-O2", "-o", out, src, f"-L{libdir}",
                           f"-l:{libfile}", f"-Wl,-rpath,{libdir}", "-lm"],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"cc {os.path.basename(src)} failed:\n"
          f"{proc.stdout}{proc.stderr}")
    return out


def capi_env(platform=None):
    """The environment of a C program that embeds the port: PYTHONPATH the
    repository and the interpreter's site-packages (the embedded
    interpreter does not see a virtualenv's otherwise), PTPU_PLATFORM
    unset (the card) or ``platform``."""
    import sysconfig

    env = dict(os.environ)
    parts = [os.path.dirname(os.path.abspath(__file__)),
             sysconfig.get_paths()["purelib"], env.get("PYTHONPATH", "")]
    env["PYTHONPATH"] = os.pathsep.join(p for p in parts if p)
    env.pop("PTPU_PLATFORM", None)
    if platform:
        env["PTPU_PLATFORM"] = platform
    return env


def check_eig_output(tag, A, evals, resnorms, X, lam, anorm, tol):
    """One eigsh result of the C ABI against the closed form: values
    within 1e-8, the written residual norms and the host's f64 residuals
    of the written vectors <= 1.5 tol ||A||."""
    import numpy as np

    err = float(np.abs(np.sort(evals) - lam).max())
    res = float(np.linalg.norm(A @ X - X * evals[None, :], axis=0).max())
    bar = 1.5 * tol * anorm
    print(f"[{tag}] values {np.sort(evals).tolist()}  max|eval-closed form| "
          f"{err:.3e} (limit 1e-8)  written resnorms max "
          f"{float(resnorms.max()):.3e}, host residual {res:.3e} (limit "
          f"{bar:.3e})", flush=True)
    check(err <= 1e-8, f"{tag}: eigenvalue error {err:.3e}")
    check(float(resnorms.max()) <= bar and res <= bar,
          f"{tag}: residuals {float(resnorms.max()):.3e} / {res:.3e}")
    return {"evals": np.sort(evals).tolist(), "eval_err": err,
            "max_resnorm": float(resnorms.max()), "max_residual": res}


def capi_inprocess_phase(ptt, mods, seed):
    """36: the C ABI in-process: ``primme_tpu_torch.capi_support`` driven
    with numpy buffer addresses, as a C caller drives it, on the 7-point
    Laplacian of the CAPI_GRID^3 grid in random order (f64):
    ``eigsh_csr`` (k = CAPI_K smallest, tol CAPI_TOL), then a parameter
    handle (numEvals, eps, jacobi 1, PRIMME_DEFAULT_METHOD) through
    ``eigsh_run``. Gates: ``check_eig_output``; the sliced-ELL f64 entry
    point launched in each call, the shifted f64 Jacobi in the second, no
    other kernel. The counts are set to 0 just before each call and read
    just after."""
    import numpy as np
    import torch
    from primme_tpu_torch import capi_support as cs

    A = _laplacian7(CAPI_GRID, seed)
    n, k = A.shape[0], CAPI_K
    lam, anorm = stencil_eigenvalues(CAPI_GRID, k)
    ip = A.indptr.astype(np.int64)
    ix = A.indices.astype(np.int64)
    dv = A.data.astype(np.float64)
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    out = {}
    for tag in ("csr", "run"):
        ev, X, rn = np.zeros(k), np.zeros(n * k), np.zeros(k)
        torch.cuda.synchronize()
        reset_counts(*mods)
        t0 = time.perf_counter()
        if tag == "csr":
            rc = cs.eigsh_csr(n, A.nnz, ip.ctypes.data, ix.ctypes.data,
                              dv.ctypes.data, k, "SA", CAPI_TOL, "", 0.0,
                              ev.ctypes.data, X.ctypes.data, rn.ctypes.data)
        else:
            h = cs.params_create()
            rc = cs.params_set(h, "numEvals", str(k)) \
                | cs.params_set(h, "eps", repr(CAPI_TOL)) \
                | cs.params_set(h, "jacobi", "1") \
                | cs.params_set_method(h, "PRIMME_DEFAULT_METHOD")
            check(rc == 0, f"capi {tag}: params: {cs.last_error()}")
            rc = cs.eigsh_run(h, n, A.nnz, ip.ctypes.data, ix.ctypes.data,
                              dv.ctypes.data, ev.ctypes.data, X.ctypes.data,
                              rn.ctypes.data)
            check(cs.params_free(h) == 0, f"capi {tag}: params_free")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(mods)
        check(rc == 0, f"capi {tag}: rc {rc}: {cs.last_error()}")
        print(f"[capi {tag}] rc {rc} in {wall:.3f} s; launches "
              f"{ {e: c for e, c in launches.items() if c} } (the JAX "
              f"package's matvecs for the same solve: {REF_CAPI[tag]})",
              flush=True)
        rec = check_eig_output(f"capi {tag}", A, ev, rn,
                               X.reshape(n, k, order="F"), lam, anorm,
                               CAPI_TOL)
        need = ["windowed_ell_spmm_f64"] + (["jacobi_shifted_f64"]
                                            if tag == "run" else [])
        for entry in need:
            check(launches[entry] > 0, f"capi {tag}: no {entry} launch")
        for entry in others:
            check(entry in need or launches[entry] == 0,
                  f"capi {tag}: {entry} served this call: {launches}")
        out[tag] = {"wall_s": wall, "launches": launches, **rec}
    return out


def compute_apps():
    """``nvidia-smi --query-compute-apps``' rows now, as (pid, used
    memory) pairs."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    rows = []
    for line in r.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1]))
    return rows


def _sample_compute_apps(proc, samples):
    """Append :func:`compute_apps` to ``samples`` every 0.5 s until
    ``proc`` exits."""
    while proc.poll() is None:
        samples.append(compute_apps())
        time.sleep(0.5)


def capi_c_phase(seed):
    """37: the C ABI from C on the card: ``native.capi_library()``, then
    ``primme_tpu_torch/native/capi_smoke.c`` built against it and run in a
    subprocess (PYTHONPATH the repository and site-packages, PTPU_PLATFORM
    unset) on phase 36's matrix, the CAPI_MATVEC_GRID^3 Laplacian (the C
    program's own CSR product as the matvec callback) and
    grounded_incidence(CAPI_SVD_GRID); ``nvidia-smi``'s compute apps
    sampled while it runs. Gates: exit 0; each eigsh result as phase 36's
    (``check_eig_output``), each svds result as phase 20's (values within
    1e-8 sigma_max of the closed form, triplet residuals <= 10 tol
    sigma_max); the child among the card's compute apps: by its pid, or,
    where ``nvidia-smi`` sees another pid namespace (a container where
    every row reads pid 1), as a compute app beside this
    process's own while it runs and gone after it exits. Then the
    JAX package's own ``native/test_capi.c``, compiled unchanged against
    the port's library: "CAPI OK" (N = 120, a dense operator, no kernel:
    it holds the ABI, not the card)."""
    import shutil
    import tempfile

    import numpy as np
    from primme_tpu_torch import native

    missing = native.missing_build_prerequisites()
    print(f"[capi c] Python.h and libpython: "
          f"{'present' if not missing else 'missing ' + str(missing)}",
          flush=True)
    check(not missing, f"capi c: the C ABI cannot build here: {missing}")
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capi_")
    try:
        t0 = time.perf_counter()
        prog = build_c_program(os.path.join(
            root, "primme_tpu_torch", "native", "capi_smoke.c"),
            os.path.join(tmp, "capi_smoke"))
        ref_prog = build_c_program(os.path.join(root, "native", "test_capi.c"),
                                   os.path.join(tmp, "test_capi"))
        build_s = time.perf_counter() - t0
        A = _laplacian7(CAPI_GRID, seed)
        Amv = _laplacian7(CAPI_MATVEC_GRID, seed)
        B, sv = grounded_incidence(CAPI_SVD_GRID)
        for name, M in (("lap.bin", A), ("mv.bin", Amv), ("inc.bin", B)):
            write_csr_bin(os.path.join(tmp, name), M)
        print(f"[capi c] library {native.capi_library()}, capi_smoke and "
              f"test_capi built in {build_s:.2f} s", flush=True)
        log = os.path.join(tmp, "capi_smoke.log")
        before, samples = compute_apps(), []
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [prog, tmp, str(CAPI_K), repr(CAPI_TOL), str(CAPI_SVDS_K)],
                env=capi_env(), stdout=f, stderr=subprocess.STDOUT)
            _sample_compute_apps(proc, samples)
        wall = time.perf_counter() - t0
        after = compute_apps()
        with open(log) as f:
            text = f.read()
        print(f"[capi c] capi_smoke pid {proc.pid} exit {proc.returncode} in "
              f"{wall:.1f} s; its output:\n{text.rstrip()}", flush=True)
        # the child is seen on the card by its pid, or, where nvidia-smi
        # cannot see this process's pid namespace (it then reports another
        # pid for every process, this one included), as the compute app
        # that is there beside this process's own only while it runs
        mine = [r for smp in samples for r in smp if r[0] == proc.pid]
        most = max(samples, key=len, default=[])
        extra = len(most) - len(before)
        print(f"[capi c] nvidia-smi compute apps before {before}, with the "
              f"most rows while it ran {most} ({len(samples)} samples), "
              f"after {after}; rows with the child's pid {sorted(set(mine))}",
              flush=True)
        check(proc.returncode == 0 and "capi_smoke OK" in text,
              f"capi c: capi_smoke exited {proc.returncode}")
        check(bool(mine) or (extra > 0 and len(after) == len(before)),
              f"capi c: the child (pid {proc.pid}) was not seen on the card")
        k, ks = CAPI_K, CAPI_SVDS_K
        out = {"wall_s": wall, "build_s": build_s, "pid": proc.pid,
               "smi_before": before, "smi_most": most, "smi_after": after,
               "smi_pid_rows": sorted(set(mine))}
        for name, M, grid in (("csr", A, CAPI_GRID), ("f77", A, CAPI_GRID),
                              ("matvec", Amv, CAPI_MATVEC_GRID),
                              ("run", A, CAPI_GRID)):
            raw = np.fromfile(os.path.join(tmp, f"out_{name}.bin"))
            n = M.shape[0]
            lam, anorm = stencil_eigenvalues(grid, k)
            out[name] = check_eig_output(
                f"capi c {name}", M, raw[:k], raw[k:2 * k],
                raw[2 * k:].reshape(n, k, order="F"), lam, anorm, CAPI_TOL)
        m, n = B.shape
        smax = float(sv[-1])
        for name in ("svds", "svds_run"):
            raw = np.fromfile(os.path.join(tmp, f"out_{name}.bin"))
            s = raw[:ks]
            off = 2 * ks if name == "svds_run" else ks
            U = raw[off:off + m * ks].reshape(m, ks, order="F")
            V = raw[off + m * ks:].reshape(n, ks, order="F")
            err = float(np.abs(np.sort(s) - sv[-ks:]).max())
            res = float(np.sqrt(
                np.linalg.norm(B @ V - U * s[None, :], axis=0) ** 2
                + np.linalg.norm(B.T @ U - V * s[None, :], axis=0) ** 2
            ).max())
            print(f"[capi c {name}] values {np.sort(s).tolist()}  max|sval-"
                  f"closed form| {err:.3e} (limit {1e-8 * smax:.3e})  max "
                  f"triplet residual {res:.3e} (limit "
                  f"{10 * CAPI_TOL * smax:.3e})", flush=True)
            check(err <= 1e-8 * smax, f"capi c {name}: value error {err:.3e}")
            check(res <= 10 * CAPI_TOL * smax,
                  f"capi c {name}: triplet residual {res:.3e}")
            out[name] = {"svals": np.sort(s).tolist(), "sval_err": err,
                         "max_triplet_residual": res}
        t0 = time.perf_counter()
        r = subprocess.run([ref_prog], env=capi_env(), capture_output=True,
                           text=True, timeout=600)
        print(f"[capi c] native/test_capi.c (unchanged) against the port's "
              f"library: exit {r.returncode} in {time.perf_counter() - t0:.1f}"
              f" s:\n{r.stdout.rstrip()}", flush=True)
        check(r.returncode == 0 and "CAPI OK" in r.stdout,
              f"capi c: test_capi failed: {r.stdout}{r.stderr}")
        out["test_capi"] = "CAPI OK"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


JACOBI_COMPLEX = (("c64", "complex64"), ("c128", "complex128"))
JACOBI_COMPLEX_SHAPES = ([(GRID, k, None) for k in (1, 2, 4, 8)]
                         + [(256, 2, None), (GRID, 2, 1)])


def complex_jacobi_phase(JK, dev, gen):
    """38: the complex Jacobi entry points against their plain versions at
    ``JACOBI_COMPLEX_SHAPES`` (phase 8's 64^3 shapes, 256^3 at k=2 and the
    odd-offset slice), complex64 and complex128, shifted and unshifted, in
    two cases: ``d - sigma`` real in value (a complex Hermitian matrix's
    diagonal and real shifts) and truly complex (``d`` and ``sigma`` with
    imaginary parts, ``eigs``' Ritz shifts); the first shift equals ``d``
    of the middle row, so the eps guard fires there. Gate: bit for bit
    (the kernel and the plain version both divide as ``c10::complex``,
    each operation rounded once). Timed in the complex case as phase 8
    times: with and without the spin, the plain version, ``copy_ms``, the
    bound ((4 n k + 2 n + 2 k) reals shifted, 4 n k + 2 n unshifted, over
    3.35 TB/s) and, for the unshifted apply, ``torch.div(X, d[:, None])``
    as ``library_ms`` (the shifted one has no single call). Last, the real
    unshifted f64 apply at phase 34's k=1 shape against ``torch.div``."""
    import torch

    out = {}
    for suffix, tname in JACOBI_COMPLEX:
        dtype = getattr(torch, tname)
        rdt = torch.float32 if suffix == "c64" else torch.float64
        size = torch.finfo(rdt).bits // 8
        res = {"jacobi_shifted_" + suffix: {}, "jacobi_" + suffix: {}}
        for side, k, off in JACOBI_COMPLEX_SHAPES:
            n, label = side ** 3, shape_label(side, k, off)
            X = kernel_block(side, k, off, dtype, dev, gen)
            dre = 1.0 + 10.0 * torch.rand(n, generator=gen, dtype=rdt,
                                          device=dev)
            sre = torch.rand(k, generator=gen, dtype=rdt, device=dev)
            cases = {
                "real": (torch.complex(dre, torch.zeros_like(dre)),
                         torch.complex(sre, torch.zeros_like(sre))),
                "complex": (torch.complex(dre, torch.randn(
                    n, generator=gen, dtype=rdt, device=dev)),
                    torch.complex(sre, torch.randn(k, generator=gen,
                                                   dtype=rdt, device=dev)))}
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            eps = 1e-10
            for case, (d, s) in cases.items():
                s[0] = d[n // 2]
                pairs = (
                    ("jacobi_shifted_" + suffix,
                     lambda: JK.shifted(X, d, s, eps),
                     lambda: JK.shifted_reference(X, d, s, eps), 2 * k, None),
                    ("jacobi_" + suffix, lambda: JK.unshifted(X, d, eps),
                     lambda: JK.unshifted_reference(X, d, eps), 0,
                     lambda: torch.div(X, d[:, None])))
                for name, kern, plain, nsig, library in pairs:
                    y, yref = kern(), plain()
                    torch.cuda.synchronize()
                    err = float((y - yref).abs().max())
                    bit = _bitwise(torch.view_as_real(y),
                                   torch.view_as_real(yref))
                    p = JK.card_plan(X)
                    rec = {"max_abs_err": err, "bitwise": bit,
                           "plan": p._asdict(), "vector_path": p.vw > 1}
                    if case == "complex" and k not in UNTIMED_K:
                        t = _times(kern, plain,
                                   (4 * n * k + 2 * n + nsig) * size,
                                   lambda: Yc.copy_(X), library)
                        rec.update(t)
                        print(f"[{name}] {label} {case} max|y-yref|={err:.3e}"
                              f" bit for bit {bit}; plan kc={p.kc} vw={p.vw}"
                              f" cols={p.cols} blocks {p.blocks} ("
                              f"{'vector' if p.vw > 1 else 'scalar'} path); "
                              f"kernel {t['ms']:.5f} ms "
                              f"(without the spin {t['nospin_ms']:.5f})  "
                              f"plain {t['plain_ms']:.5f} ms  copy "
                              f"{t['copy_ms']:.5f} ms  bound "
                              f"{t['bound_ms']:.5f} ms (bytes; share "
                              f"{t['bound_share']:.3f}"
                              + (", L2-resident" if t["l2_resident"] else "")
                              + ")" + ("" if library is None else
                                       f"  library (torch.div) "
                                       f"{t['library_ms']:.5f} ms"),
                              flush=True)
                    else:
                        print(f"[{name}] {label} {case} max|y-yref|={err:.3e}"
                              f" bit for bit {bit}", flush=True)
                    check(bit, f"{name}: kernel differs from its plain "
                          f"version at {label}, {case} denominators")
                    check(bool(torch.isfinite(y).all()),
                          f"{name}: non-finite output at {label}")
                    res[name].setdefault(label, {})[case] = rec
            del X, Yc, cases
        out.update(res)
    # the real unshifted f64 apply at phase 34's shape (the harness's fixed
    # Jacobi, k=1 on the 32^3 Laplacian, n = 32,768) against torch.div
    # (ROADMAP.md Queue B5)
    n = HARNESS_GRID ** 3
    X = torch.randn((n, 1), generator=gen, dtype=torch.float64, device=dev)
    d = 1.0 + 10.0 * torch.rand(n, generator=gen, dtype=torch.float64,
                                device=dev)
    Yc = torch.empty_like(X)
    y, yref = JK.unshifted(X, d, 1e-10), JK.unshifted_reference(X, d, 1e-10)
    torch.cuda.synchronize()
    bit = _bitwise(y, yref)
    t = _times(lambda: JK.unshifted(X, d, 1e-10),
               lambda: JK.unshifted_reference(X, d, 1e-10), 3 * n * 8,
               lambda: Yc.copy_(X), lambda: torch.div(X, d[:, None]))
    label = f"{HARNESS_GRID}^3 k=1"
    _print_times("jacobi_f64", label, float((y - yref).abs().max()), bit, t,
                 JK.card_plan(X), f"  library (torch.div) "
                 f"{t['library_ms']:.5f} ms")
    check(bit, f"jacobi_f64: kernel differs from its plain version at {label}")
    out["jacobi_f64 " + label] = {"bitwise": bit, **t}
    return out


def jacobi_solves_phase(ptt, mods, dev, seed):
    """39: solves with the complex Jacobi kernel (``REF_JACOBI``'s names):
    ``magnetic`` phase 24's call with ``jacobi=True`` under phase 24's
    gates (``format_solve``) and ``jacobi_shifted_c64`` launched;
    ``magnetic_fixed`` the same call at JACOBI_NORMAL_GRID^3 with OPinv a
    fixed ``JacobiPrecond(diag, use_shifts=False)`` (``jacobi_c64``);
    ``gl`` and ``cd`` phase 29's and phase 28's ``eigs`` at
    JACOBI_NORMAL_GRID^3 with OPinv a ``JacobiPrecond`` of the operator's
    diagonal (``normal_phase``'s gates; the complex shifted entry point
    launched: complex64 for the complex diagonal, complex128 for the real
    f64 one given complex Ritz shifts); ``harness`` the config-file driver
    in complex128 on ``magnetic_config`` (DYNAMIC, the Jacobi PrecChoice:
    ``jacobi_c128``): rc 0, "solution check: OK", values within 1.5 tol
    ||A|| of the closed form, its recomputed residual norms as well, the
    sliced-ELL complex128 launches >= matvecs / 2. Every solve's matvecs
    within 2x of the JAX package's."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch
    from primme_tpu_torch import driver

    t0 = time.perf_counter()
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    runs = {}
    L, ev, anorm = magnetic_laplacian(MAG_GRID, dtype="complex64")
    runs["magnetic"] = format_solve(
        ptt, mods, L, seed, "jacobi magnetic", ev, 1e-4, anorm,
        REF_JACOBI["magnetic"], need=("dia_c64",),
        forbid=[e for e in others if e not in ("dia_c64",
                                               "jacobi_shifted_c64")],
        kwargs=dict(SOLVE_KWARGS, jacobi=True))
    L32, ev32, _ = magnetic_laplacian(JACOBI_NORMAL_GRID, dtype="complex64")
    runs["magnetic_fixed"] = format_solve(
        ptt, mods, L32, seed, "jacobi magnetic fixed", ev32, 1e-4, anorm,
        REF_JACOBI["magnetic_fixed"], need=("dia_c64",),
        forbid=[e for e in others if e not in ("dia_c64", "jacobi_c64")],
        kwargs=dict(SOLVE_KWARGS, OPinv=ptt.JacobiPrecond(
            L32.diagonal(), use_shifts=False)))
    for name, entry in (("magnetic", "jacobi_shifted_c64"),
                        ("magnetic_fixed", "jacobi_c64")):
        check(runs[name]["launches"][entry] > 0,
              f"jacobi {name}: no {entry} launch")
    for name, base, entry in (("gl", "ell_c64", "jacobi_shifted_c64"),
                              ("cd", "ell_f64", "jacobi_shifted_c128")):
        runs[name] = normal_phase(ptt, mods, base, seed,
                                  grid=JACOBI_NORMAL_GRID, jacobi=entry,
                                  ref_mv=REF_JACOBI[name],
                                  tag=f"jacobi {name}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jacobi_")
    try:
        cfg, evh, anh = magnetic_config(tmp)
        buf = io.StringIO()
        reset_counts(*mods)
        th = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = driver.main([cfg, "--base-dir", tmp, "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - th
        launches = read_counts(mods)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = buf.getvalue()
    print(f"[jacobi harness] driver rc {rc} in {wall:.3f} s; launches "
          f"{ {e: c for e, c in launches.items() if c} }; its report:\n"
          f"{text.rstrip()}", flush=True)
    check(rc == 0 and "solution check: OK" in text,
          "jacobi harness: the solution check failed")
    mv = int(re.search(r"Matvecs: (\d+)", text).group(1))
    found = re.findall(r"Eval\[\d+\]:\s+(\S+)\s+rnorm:\s+(\S+)", text)
    w = np.sort([float(x) for x, _ in found])
    rn = max(float(r) for _, r in found)
    bar = 1.5 * 1e-10 * anh
    err = float(np.abs(w - evh[:len(w)]).max())
    ref_mv = REF_JACOBI["harness"]
    print(f"[jacobi harness] {mv} matvecs (reference {ref_mv})  "
          f"max|eval-closed form| {err:.3e}  max rnorm {rn:.3e} (limit for "
          f"both {bar:.3e})", flush=True)
    check(err <= bar and rn <= bar,
          f"jacobi harness: value error {err:.3e}, rnorm {rn:.3e}")
    check(launches["jacobi_c128"] > 0, "jacobi harness: no jacobi_c128")
    check(launches["windowed_ell_spmm_c128"] >= mv / 2,
          f"jacobi harness: {launches['windowed_ell_spmm_c128']} sliced-ELL"
          f" complex128 launches for {mv} matvecs")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"jacobi harness: {mv} matvecs, not within 2x of {ref_mv}")
    runs["harness"] = {"rc": rc, "wall_s": wall, "num_matvecs": mv,
                       "eval_err": err, "max_rnorm": rn,
                       "launches": launches}
    secs = time.perf_counter() - t0
    print(f"[jacobi] phase 39 took {secs:.1f} s", flush=True)
    return {"solves": runs, "seconds": secs}


def half_phase(ptt, mods, dev, seed, solve32):
    """40: the half-precision basis: ``eigsh(k=HALF_K)`` of phase 4's
    permuted 27-point Laplacian in f32 with ``dtype`` bf16 and f16, tol 4
    eps(half), the chooser's windowed operator passed in (the true
    residuals on the host with the matrix in its order). Gates, those of
    ``tests/test_eigsh.py``'s half-precision test: values and vectors f32,
    every true residual < 16 eps(half) ||A||, each value within its own
    true residual of the closed form (the Hermitian residual bound); the
    basis stored in the half type (read from the solver state as it is
    built); ``windowed_ell_spmm_f32`` launches >= matvecs / 2 and no other
    kernel; matvecs within 2x of the JAX package's. Prints the peak device
    memory beside phase 4's f32 solve's."""
    import numpy as np
    import torch
    from primme_tpu_torch.core import solver

    A, ev = laplacian27(GRID, seed)
    op, perm = ptt.rcm_banded(A)
    op = op.to(dev)
    Ap = A[perm][:, perm].astype(np.float64)
    anorm = float(np.abs(ev).max())
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    kw = {key: v for key, v in SOLVE_KWARGS.items() if key != "k"}
    build = solver._build_state
    out = {}
    for half in (torch.bfloat16, torch.float16):
        name = str(half).replace("torch.", "")
        heps = float(torch.finfo(half).eps)
        tol = 4 * heps
        basis = []

        def recording(*a, **k):
            s = build(*a, **k)
            basis.append(s.V.dtype)
            return s

        solver._build_state = recording
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(*mods)
            t0 = time.perf_counter()
            w, X, st = ptt.eigsh(op, k=HALF_K, tol=tol, seed=seed,
                                 dtype=half, device=dev,
                                 raise_for_unconverged=False, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            solver._build_state = build
        launches = read_counts(mods)
        peak = torch.cuda.max_memory_allocated()
        mv = st["num_matvecs"]
        X64 = X.astype(np.float64)
        xn = np.linalg.norm(X64, axis=0)
        R = Ap @ X64 - X64 * w[None, :].astype(np.float64)
        rn = np.linalg.norm(R, axis=0)
        dist = np.abs(ev[None, :] - w[:, None].astype(np.float64)).min(axis=1)
        floor = 16 * heps * anorm
        ref_mv = REF_HALF[name]
        print(f"[half {name}] eigsh wall {wall:.3f} s  basis {basis}  values "
              f"{w.dtype}, vectors {X.dtype}: {np.sort(w).tolist()}  "
              f"num_matvecs {mv} (reference {ref_mv})  launches "
              f"{ {e: c for e, c in launches.items() if c} }  max true "
              f"residual {float(rn.max()):.3e} (limit {floor:.3e})  "
              f"distance to the spectrum / residual "
              f"{(dist * xn / rn).tolist()}  peak device memory {peak} B "
              f"(phase 4's f32 solve {solve32['peak_bytes']} B)", flush=True)
        check(w.dtype == X.dtype == np.float32,
              f"half {name}: values {w.dtype}, vectors {X.dtype}")
        check(basis == [half], f"half {name}: the basis was {basis}")
        check(float(rn.max()) < floor,
              f"half {name}: residual {float(rn.max()):.3e} >= {floor:.3e}")
        check(bool(np.all(dist <= rn / xn)),
              f"half {name}: a value lies farther from the spectrum than "
              "its residual")
        check(launches["windowed_ell_spmm_f32"] >= mv / 2,
              f"half {name}: {launches['windowed_ell_spmm_f32']} launches "
              f"for {mv} matvecs")
        for entry in others:
            check(entry == "windowed_ell_spmm_f32" or launches[entry] == 0,
                  f"half {name}: {entry} served this solve: {launches}")
        check(ref_mv / 2 <= mv <= 2 * ref_mv,
              f"half {name}: {mv} matvecs, not within 2x of {ref_mv}")
        out[name] = {"wall_s": wall, "solve_s": st["elapsed_time"],
                     "tol": tol, "num_matvecs": mv,
                     "evals": np.sort(w).tolist(),
                     "max_residual": float(rn.max()), "floor": floor,
                     "launches": launches, "peak_bytes": peak,
                     "f32_peak_bytes": solve32["peak_bytes"]}
    return out


# ---------------------------------------------------------------------------
# Phases 41-45: the row-partitioned solve (mesh=) over torch.distributed
# ---------------------------------------------------------------------------

def band_scatter(n, halfband, per_row, seed=0):
    """``tests/test_distributed.py``'s ``_band_matrix`` at size ``n``: a
    symmetric matrix with ``per_row`` scattered entries a row (and their
    transposes) inside ``|i - j| <= halfband`` and a diagonal ramp, f32;
    too many distinct offsets for the DIA path, a small halo for the row
    partition."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rows + rng.integers(-halfband, halfband + 1, size=rows.size)
    keep = (cols >= 0) & (cols < n)
    A = sp.coo_matrix((rng.normal(size=keep.sum()),
                       (rows[keep], cols[keep])), shape=(n, n))
    A = A + A.T + sp.diags(np.linspace(1, 50, n) + 2 * per_row)
    return A.tocsr().astype(np.float32)


def _world_rank(rank, P, store, fn, args, out):
    """One spawned rank: join the gloo group, make the 1-D ``"cuda"`` mesh,
    run ``fn(mesh, *args)`` and write its record for the parent."""
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from primme_tpu_torch.distributed import TIMEOUT

    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cuda", (P,))
        res = globals()[fn](mesh, *args)
        torch.cuda.synchronize()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_world(P, fn, *args):
    """``fn(mesh, *args)`` on ``P`` ranks sharing the card over gloo
    (``torch.multiprocessing.spawn``; what a rank raises, this raises);
    the ranks' records in rank order."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_world_rank, args=(P, os.path.join(out, "store"), fn, args,
                                    out), nprocs=P, join=True)
        recs = []
        for r in range(P):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    return recs


def _rank_tag(mesh, phase):
    import torch.distributed as dist
    return f"{phase} P={mesh.size()} rank {dist.get_rank()}"


def halo_product(mesh, A, name, seed):
    """Phase 41 on this rank for the matrix ``A`` (``name``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from primme_tpu_torch import distributed as D
    from primme_tpu_torch.core import comm as cm
    from primme_tpu_torch.ops import windowed_ell as WE

    tag = _rank_tag(mesh, f"41 {name}")
    dev = D.mesh_device(mesh)
    t0 = time.perf_counter()
    op, perm = D.HaloELLOperator.from_scipy(A, mesh)
    pack_s = time.perf_counter() - t0
    comm = op.comm
    Ap = A if perm is None else A[perm][:, perm].tocsr()
    X = np.random.default_rng(seed).normal(
        size=(A.shape[0], SHARD_K)).astype(np.float32)
    x = torch.as_tensor(comm.rows(X)).to(dev)
    op(x[:, :1])                      # the first call pays the set-up
    torch.cuda.synchronize()
    sent0, l0 = cm.SENT_ELEMENTS, dict(WE.KERNEL_LAUNCHES)
    gathers = []
    orig = dist.all_gather
    dist.all_gather = lambda *a, **k: gathers.append(1) or orig(*a, **k)
    try:
        y = op.matmat(x)
        torch.cuda.synchronize()
    finally:
        dist.all_gather = orig
    sent = cm.SENT_ELEMENTS - sent0
    launches = {e: WE.KERNEL_LAUNCHES[e] - l0[e] for e in l0}
    n_nb = (comm.rank > 0) + (comm.rank < comm.size - 1)
    check(sent == n_nb * op.halo * SHARD_K and not gathers,
          f"{tag}: {sent} elements sent ({n_nb} neighbours, h={op.halo}, "
          f"k={SHARD_K}), {len(gathers)} all-gathers")
    per_product = launches["windowed_ell_spmm_f32"]
    check(per_product == (3 if op.split else 1)
          and sum(launches.values()) == per_product,
          f"{tag}: launches {launches} for one product")
    # each layout's launch into its row slice against its own block
    bitwise = True
    if op.split:
        hr, nl = op.hrows, op.nl
        Ys = torch.full_like(y, float("nan"))
        op.interior(x, Ys)
        own = op._run("int", x, None)
        bitwise = bool(torch.equal(Ys[hr:nl - hr], own)
                       and torch.equal(Ys[hr:nl - hr], y[hr:nl - hr]))
        check(bitwise, f"{tag}: the interior launch into its row slice "
              "differs from its launch into its own block")
    Yg = comm.all_gather_rows(y).cpu().numpy().astype(np.float64)
    ref = Ap.astype(np.float64) @ X.astype(np.float64)
    ymax = float(np.abs(ref).max())
    err_sp = float(np.abs(Yg - ref).max())
    # the port's unsharded product of the same matrix, on this card
    op1, _ = D.HaloELLOperator.from_scipy(Ap, None, try_rcm=False,
                                          device=dev)
    Xd = torch.as_tensor(X).to(dev)
    Y1 = op1.matmat(Xd)
    err_un = float(np.abs(Yg - Y1.cpu().numpy()).max())
    check(err_sp <= 1e-5 * ymax and err_un <= 1e-5 * ymax,
          f"{tag}: max|y - scipy| {err_sp:.3e}, max|y - unsharded| "
          f"{err_un:.3e} (limit {1e-5 * ymax:.3e})")
    # the sharded product's host time, every rank together; then the
    # unsharded kernel's device time on rank 0 alone
    dist.barrier()
    walls = []
    for _ in range(21):
        t0 = time.perf_counter()
        op.matmat(x)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    dist.barrier()
    un_ms = median_ms(lambda: op1.matmat(Xd)) if comm.rank == 0 else None
    dist.barrier()
    rec = {"n": A.shape[0], "nnz": int(A.nnz), "halo": op.halo,
           "hrows": op.hrows, "split": op.split, "rcm": perm is not None,
           "rows": [comm.lo, comm.hi], "sent_elements": sent,
           "neighbours": int(n_nb), "all_gathers": len(gathers),
           "launches": launches, "out_slice_bitwise": bitwise,
           "max_err_scipy": err_sp, "max_err_unsharded": err_un,
           "max_abs_y": ymax, "sharded_host_ms": statistics.median(walls),
           "unsharded_kernel_ms": un_ms, "pack_s": pack_s}
    print(f"[{tag}] n={A.shape[0]} h={op.halo} hrows={op.hrows} rcm="
          f"{perm is not None} rows [{comm.lo}, {comm.hi}) sent {sent} "
          f"elements ({n_nb} x h x k) launches {launches} max|y-scipy| "
          f"{err_sp:.3e} max|y-unsharded| {err_un:.3e} (max|y| {ymax:.3e}) "
          f"sharded product {rec['sharded_host_ms']:.4f} ms host"
          + (f", unsharded kernel {un_ms:.5f} ms device" if un_ms else "")
          + f" (P ranks on one card: not a scaling number); pack "
          f"{pack_s:.2f} s", flush=True)
    return rec


def world_products(mesh, seed):
    """Phase 41 on this rank, both matrices; then, in the world of the
    same size, ``dryrun_multichip`` (phase 42's second half)."""
    from primme_tpu_torch import distributed as D

    A, _ = laplacian27(GRID, seed)
    out = {"laplacian27": halo_product(mesh, A, "laplacian27", seed),
           "band_scatter": halo_product(mesh, band_scatter(*BAND_SCATTER),
                                        "band_scatter", seed)}
    t0 = time.perf_counter()
    dry = D.dryrun_multichip(mesh.size(), device="cuda")
    out["dryrun"] = {"evals": [float(v) for v in dry["evals"]],
                     "max_resnorm": float(dry["resnorms"].max()),
                     "matvecs": int(dry["matvecs"]),
                     "seconds": time.perf_counter() - t0}
    return out


def world_solves(mesh, seed, svd_refs):
    """Phases 42-44 on this rank (2 ranks)."""
    import numpy as np
    import torch
    import primme_tpu_torch as ptt
    from primme_tpu_torch.core import comm as cm
    from primme_tpu_torch.ops import dia as DK
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    import primme_tpu_torch.distributed as D
    mods = (DK, WE, ST, JK)
    dev = D.mesh_device(mesh)
    out = {}

    # --- 42. the headline under eigsh(mesh=) ---
    tag = _rank_tag(mesh, "42 headline")
    lam, anorm = stencil_eigenvalues(GRID, 10)
    A = ptt.Stencil3DOperator(GRID, GRID, GRID, dtype=torch.float32,
                              device=dev)
    kw = _headline_eigsh_kwargs(dev, seed, GRID)
    torch.cuda.synchronize()
    reset_counts(*mods)
    t0 = time.perf_counter()
    w, V, st = ptt.eigsh(A, mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    mv = st["num_matvecs"]
    err = float(np.abs(np.sort(w) - lam).max())
    res = _true_stencil_residual(GRID, w, V, dev)
    print(f"[{tag}] wall {wall:.3f} s matvecs {mv} (reference "
          f"{REF_HEADLINE_MATVECS}) max|eval-analytic| {err:.3e} true "
          f"residual {res:.3e} (limit {1.5e-5 * anorm:.3e}) probe verified "
          f"{st['probe_verified']} exhausted {st['probe_exhausted']} "
          f"global sums {st['num_global_sum']} launches {launches}",
          flush=True)
    check(err <= 1e-4, f"{tag}: eigenvalue error {err:.3e}")
    check(res <= 1.5e-5 * anorm, f"{tag}: true residual {res:.3e}")
    check(st["probe_verified"] == 1 and st["probe_exhausted"] == 0,
          f"{tag}: spectrum verification did not complete")
    check(REF_HEADLINE_MATVECS / 2 <= mv <= 2 * REF_HEADLINE_MATVECS,
          f"{tag}: {mv} matvecs")
    for e in ("stencil3d_f32", "jacobi_shifted_f32"):
        check(launches[e] >= mv / 2, f"{tag}: {launches[e]} {e} launches")
    check(not any(v for e, v in launches.items()
                  if e not in ("stencil3d_f32", "jacobi_shifted_f32")),
          f"{tag}: another kernel served the headline: {launches}")
    out["headline"] = {"wall_s": wall, "num_matvecs": mv, "eval_err": err,
                       "max_true_residual": res, "evals": w,
                       "num_global_sum": st["num_global_sum"],
                       "volume_global_sum": st["volume_global_sum"],
                       "probe_verified": st["probe_verified"],
                       "launches": launches}

    # --- 43. the sparse chooser under the mesh ---
    forbid = [e for m in mods for e in m.KERNEL_LAUNCHES]
    A27, ev = laplacian27(GRID, seed)
    ex0 = cm.EXCHANGES
    run = format_solve(ptt, mods, A27, seed, _rank_tag(mesh, "43 sparse"),
                       ev, 1e-4, float(np.abs(ev).max()), REF_MATVECS,
                       need=("windowed_ell_spmm_f32",),
                       forbid=[e for e in forbid
                               if e != "windowed_ell_spmm_f32"],
                       kwargs={**SOLVE_KWARGS, "mesh": mesh})
    pk = D.pack(A27, mesh.size())
    nl = A27.shape[0] // mesh.size()
    split = pk.halo > 0 and 0 < pk.hrows and 2 * pk.hrows < nl
    exchanges = cm.EXCHANGES - ex0
    check(pk.perm is not None and exchanges > 0
          and run["launches"]["windowed_ell_spmm_f32"]
          == (3 if split else 1) * exchanges,
          f"43: the halo operator in the RCM order did not serve every "
          f"product: perm {pk.perm is not None}, {exchanges} exchanges, "
          f"{run['launches']}")
    run["exchanges"], run["halo"], run["hrows"] = exchanges, pk.halo, \
        pk.hrows
    out["sparse"] = run
    Ag, evg = laplacian27_grid(GRID)
    ex0 = cm.EXCHANGES
    run = format_solve(ptt, mods, Ag, seed, _rank_tag(mesh, "43 banded"),
                       evg, 1e-4, float(np.abs(evg).max()),
                       REF_BANDED_MATVECS, need=("dia_f32",),
                       forbid=[e for e in forbid if e != "dia_f32"],
                       kwargs={**SOLVE_KWARGS, "mesh": mesh})
    run["exchanges"] = cm.EXCHANGES - ex0
    check(run["exchanges"] > 0, "43 banded: no halo exchange")
    out["banded"] = run

    # --- 44. svds under the mesh ---
    mats = {"float64": grounded_incidence(SHARD_SVD_GRID)}
    out["svds"] = {}
    for name in ("lm", "sm"):
        kw, dt = SVDS_SOLVES[name]
        refs = svd_refs[name]
        spec = dict(kw={**kw, "mesh": mesh}, dtype=dt, refs=refs,
                    value_bar=SVDS_VALUE_BAR[name], res_bar=10,
                    launch_floor=1, total_floor=True)
        r = svds_phase(ptt, mods, dev, name, seed, mats, spec)
        for g, ref in refs.items():
            got = r["stages"][g]["num_matvecs"]
            if name == "sm" and g == "stage2":
                # phase 22's rule for this stage (svds_phase holds it: a
                # count > 0, the total within 2x): the SM stage 2 refines a
                # triple-degenerate cluster, and its count moves with the
                # rounding of its start
                continue
            check(ref[0] / 2 <= got <= 2 * ref[0],
                  f"44 svds {name}: {g} {got} matvecs against the unsharded "
                  f"port's {ref[0]}")
        out["svds"][name] = {key: r[key] for key in (
            "wall_s", "svals", "eval_err", "max_triplet_residual",
            "num_matvecs", "ref_num_matvecs", "stages", "launches")}
    return out


def nccl_phase(ptt, mods, dev, seed):
    """Phase 45: a one-rank NCCL group on the card."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from primme_tpu_torch.distributed import TIMEOUT

    grid = SHARD_NCCL_GRID
    kw = _headline_eigsh_kwargs(dev, seed, grid)
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    w0, _, st0 = ptt.eigsh(A, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            timeout=TIMEOUT)
        try:
            mesh = init_device_mesh("cuda", (1,))
            backend = str(dist.get_backend(mesh.get_group()))
            t = torch.arange(4, dtype=torch.float32, device=dev)
            dist.all_reduce(t, group=mesh.get_group())
            torch.cuda.synchronize()
            reduced = t.cpu().tolist()
            reset_counts(*mods)
            w, _, st = ptt.eigsh(A, mesh=mesh, **kw)
            launches = read_counts(mods)
        finally:
            dist.destroy_process_group()
    diff = float(np.abs(np.sort(w) - np.sort(w0)).max())
    print(f"[45 nccl] backend {backend}; all_reduce on the card -> "
          f"{reduced}; eigsh(mesh=1-rank NCCL mesh) at {grid}^3: matvecs "
          f"{st['num_matvecs']} (unsharded {st0['num_matvecs']}), max|w - "
          f"unsharded w| {diff:.3e}, bitwise {bool(np.array_equal(w, w0))}; "
          "NCCL with several ranks needs several cards (it refuses two "
          "ranks on one device), not verified here", flush=True)
    check(backend == "nccl", f"45: backend {backend}")
    check(reduced == [0.0, 1.0, 2.0, 3.0], f"45: all_reduce gave {reduced}")
    check(diff <= 1e-6 * float(np.abs(w0).max()),
          f"45: values {diff:.3e} from the unsharded run's")
    return {"backend": backend, "all_reduce": reduced, "grid": grid,
            "num_matvecs": st["num_matvecs"],
            "unsharded_num_matvecs": st0["num_matvecs"], "max_diff": diff,
            "bitwise": bool(np.array_equal(w, w0)), "launches": launches}


def sharded_phases(ptt, mods, dev, seed):
    """Phases 41-45 and their seconds."""
    import numpy as np

    t0 = time.perf_counter()
    # the unsharded port's svds counts at phase 44's size, for its gates
    A32, _ = grounded_incidence(SHARD_SVD_GRID)
    svd_refs = {}
    for name in ("lm", "sm"):
        kw, _ = SVDS_SOLVES[name]
        _, _, _, st = ptt.svds(A32, seed=seed, return_stats=True,
                               device=dev, **kw)
        svd_refs[name] = {g: (int(st[f"{g}_num_matvecs"]), 0, 0, 0)
                          for g in ("stage1", "stage2")
                          if f"{g}_num_matvecs" in st}
        print(f"[44 unsharded] svds {name} at {SHARD_SVD_GRID}^3: "
              f"{svd_refs[name]}", flush=True)
    t1 = time.perf_counter()
    worlds = {}
    for P in SHARD_RANKS:
        worlds[P] = run_world(P, "world_products", seed)
    t2 = time.perf_counter()
    solves = run_world(2, "world_solves", seed, svd_refs)
    t3 = time.perf_counter()
    h = [r["headline"] for r in solves]
    check(all(np.array_equal(r["evals"], h[0]["evals"]) for r in h[1:]),
          "42: the ranks' headline values differ")
    for r in h:
        r["evals"] = [float(v) for v in r["evals"]]
    nccl = nccl_phase(ptt, mods, dev, seed)
    t4 = time.perf_counter()
    secs = {"svds_refs": t1 - t0, "products_and_dryruns": t2 - t1,
            "solves": t3 - t2, "nccl": t4 - t3, "total": t4 - t0}
    for P, recs in worlds.items():
        for name in ("laplacian27", "band_scatter"):
            r = [rec[name] for rec in recs]
            print(f"[41 P={P} {name}] h={r[0]['halo']} hrows="
                  f"{r[0]['hrows']} sent a product by rank "
                  f"{[x['sent_elements'] for x in r]} (2 h k = "
                  f"{2 * r[0]['halo'] * SHARD_K}); sharded product "
                  f"{r[0]['sharded_host_ms']:.4f} ms host against the "
                  f"unsharded kernel's {r[0]['unsharded_kernel_ms']:.5f} ms "
                  f"device (P ranks on one card over gloo: not a scaling "
                  f"number)", flush=True)
        print(f"[42 dryrun_multichip({P})] {recs[0]['dryrun']}", flush=True)
    print("[phases 41-45] " + ", ".join(f"{key} {v:.1f} s"
                                         for key, v in secs.items()),
          flush=True)
    return {"products": {P: [{k: v for k, v in rec.items()}
                             for rec in recs]
                         for P, recs in worlds.items()},
            "solves": solves, "nccl": nccl, "seconds": secs,
            "svds_unsharded": svd_refs}


_PROBE_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu_torch.core.inner import jdqmr_inner_solve
A = CS._laplacian7(CS.SURFACE_SOLVE_GRID, int(sys.argv[2]))
op = ptt.ELLOperator.from_scipy(A.astype("float32")).to("cuda")
r = ptt.solve_eigs(op, CS.surface_params(ptt, A.shape[0]),
                   inner_solve=jdqmr_inner_solve)
print("PROBE_ROUNDS", r.stats.num_probe_rounds, flush=True)
"""


def surface_params(ptt, n):
    """Phase 46's solves: k=4 smallest, JDQMR_ETol, block 2, basis 24,
    restart 14, tol 1e-5, the probe on."""
    return ptt.set_method(ptt.Method.JDQMR_ETol, ptt.PrimmeParams(
        n=n, num_evals=4, eps=1e-5, max_basis_size=24, max_block_size=2,
        min_restart_size=14, max_matvecs=16000))


def surface_phase(ptt, mods, dev, seed):
    """46: the port's last surface on the card, at small sizes. ``to_dense``
    of the stencil (8^3, f32 and f64), a ``BandedOperator`` (f32, f64,
    c64), ``ELLOperator.from_coo`` (f32, square and rectangular), a
    ``WindowedELLOperator`` and a ``JacobiPrecond``, each against scipy's
    ``toarray()`` or the closed form, its kernel launched; ``solve_eigs``
    on ``ELLOperator.from_scipy(A).to("cuda")`` with no ``device=`` (state
    on the card, the sliced-ELL kernel >= matvecs / 2), the same call on
    the CPU operator refused, ``io.load_operator`` on the card,
    ``debug=True`` (one line a monitor event, the values bit for bit those
    of the solve without it) and ``PTPU_PROBE_DEBUG=1`` in a child
    process (a line a probe round)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import scipy.io as sio
    import scipy.sparse as sp
    import torch
    from primme_tpu_torch.core.inner import jdqmr_inner_solve

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    m = SURFACE_GRID
    L = _laplacian7(m, None)
    Lc = L.tocoo()
    R = sp.random(300, 170, density=0.02, random_state=seed, format="coo")
    nb = 512
    offs = (-9, -1, 0, 2, 30)
    band = sp.diags([rng.normal(size=nb - abs(o)) for o in offs], offs,
                    format="csr")
    band_c = (band + 1j * sp.diags([rng.normal(size=nb - abs(o))
                                    for o in offs], offs)).tocsr()
    wide = sp.diags([2 * np.ones(256), -np.ones(255), -np.ones(255),
                     0.5 * np.ones(249), 0.5 * np.ones(249)],
                    [0, 1, -1, 7, -7], format="csr").astype(np.float32)
    d = rng.uniform(0.5, 2.0, size=300).astype(np.float32)
    d[::2] *= -1
    cases = {
        "stencil f32": (lambda: ptt.Stencil3DOperator(
            m, m, m, dtype=torch.float32, device=dev), L, "stencil3d_f32"),
        "stencil f64": (lambda: ptt.Stencil3DOperator(
            m, m, m, dtype=torch.float64, device=dev), L, "stencil3d_f64"),
        "banded f32": (lambda: ptt.BandedOperator.from_scipy(
            band.astype(np.float32)).to(dev), band, "dia_f32"),
        "banded f64": (lambda: ptt.BandedOperator.from_scipy(band).to(dev),
                       band, "dia_f64"),
        "banded c64": (lambda: ptt.BandedOperator.from_scipy(
            band_c.astype(np.complex64)).to(dev), band_c, "dia_c64"),
        "from_coo f32": (lambda: ptt.ELLOperator.from_coo(
            Lc.row, Lc.col, Lc.data.astype(np.float32), L.shape).to(dev),
            L, "windowed_ell_spmm_f32"),
        "from_coo f32 300x170": (lambda: ptt.ELLOperator.from_coo(
            R.row, R.col, R.data.astype(np.float32), R.shape).to(dev),
            R, "windowed_ell_spmm_f32"),
        "windowed f32": (lambda: ptt.WindowedELLOperator.from_scipy(
            wide).to(dev), wide, "windowed_ell_spmm_f32"),
        "jacobi f32": (lambda: ptt.JacobiPrecond(d).to(dev),
                       sp.diags(1.0 / d), "jacobi_f32"),
    }
    dense = {}
    for tag, (build, truth, entry) in cases.items():
        op = build()
        check(op.device.type == "cuda", f"46 {tag}: operator on {op.device}")
        reset_counts(*mods)
        D = op.to_dense()
        torch.cuda.synchronize()
        launches = read_counts(mods)[entry]
        T = truth.toarray()
        single = D.dtype in (torch.float32, torch.complex64)
        tol = 1e-6 if single else 1e-14
        err = float(np.abs(D.cpu().numpy() - T).max() / np.abs(T).max())
        print(f"[46 to_dense] {tag}: {tuple(D.shape)} {D.dtype} on "
              f"{D.device}, max rel err {err:.3e} (tol {tol:g}), {entry} "
              f"{launches} launches", flush=True)
        check(D.device.type == "cuda" and tuple(D.shape) == T.shape,
              f"46 {tag}: to_dense {tuple(D.shape)} on {D.device}")
        check(err <= tol, f"46 {tag}: to_dense off by {err:.3e}")
        check(launches > 0, f"46 {tag}: {entry} not launched")
        dense[tag] = {"entry": entry, "launches": launches,
                      "max_rel_err": err, "shape": list(T.shape)}
    to_dense_launches = {}
    for r in dense.values():
        to_dense_launches[r["entry"]] = (to_dense_launches.get(r["entry"], 0)
                                         + r["launches"])
    t1 = time.perf_counter()

    # solve_eigs with no device=: the card
    g = SURFACE_SOLVE_GRID
    A = _laplacian7(g, seed).astype(np.float32)
    n = A.shape[0]
    lam, anorm = stencil_eigenvalues(g, 4)
    p = surface_params(ptt, n)
    op = ptt.ELLOperator.from_scipy(A).to("cuda")
    reset_counts(*mods)
    res = ptt.solve_eigs(op, p, inner_solve=jdqmr_inner_solve)
    torch.cuda.synchronize()
    launches = dict(read_counts(mods))
    mv = res.stats.num_matvecs
    w = res.evals.cpu().numpy()
    err = float(np.abs(np.sort(w) - lam).max())
    need = launches["windowed_ell_spmm_f32"]
    print(f"[46 solve] solve_eigs(ELLOperator.from_scipy(A).to('cuda')) "
          f"n={n}: state on {res.evecs.device}, {mv} matvecs, "
          f"windowed_ell_spmm_f32 {need} launches, probe verified "
          f"{res.stats.probe_verified}, eval err {err:.2e}", flush=True)
    check(res.evecs.device.type == "cuda" and res.evals.device.type == "cuda",
          f"46: solve_eigs returned on {res.evecs.device}")
    check(need >= mv / 2, f"46: {need} sliced-ELL launches for {mv} matvecs")
    check(err <= 1e-4, f"46: eigenvalues off by {err:.2e}")
    check(res.stats.probe_verified == 1, "46: the probe did not verify")
    try:
        ptt.solve_eigs(ptt.ELLOperator.from_scipy(A), p,
                       inner_solve=jdqmr_inner_solve)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"[46 solve] the CPU operator without device=: {refused!r}",
          flush=True)
    check(".to(device)" in refused and 'device="cpu"' in refused,
          "46: solve_eigs took an operator on the CPU without a word")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lap.mtx")
        sio.mmwrite(path, A)
        lop = ptt.io.load_operator(path)
    print(f"[46 io] load_operator -> {type(lop).__name__} on {lop.device}",
          flush=True)
    check(lop.device.type == "cuda", f"46: load_operator on {lop.device}")

    # debug=True: a line an outer iteration, nothing else changed
    events = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rd = ptt.solve_eigs(op, p, inner_solve=jdqmr_inner_solve, debug=True,
                            monitor=lambda **kw: events.append(kw["event"]))
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("it=")]
    fields_ok = all(tuple(k for k, _ in (f.split("=", 1)
                                         for f in ln.split()))
                    == SURFACE_DEBUG_FIELDS for ln in lines)
    same = (torch.equal(rd.evals, res.evals)
            and rd.stats.num_matvecs == mv)
    print(f"[46 debug] {len(lines)} lines for {len(events)} monitor events "
          f"({rd.stats.num_outer_iterations} outer iterations); first "
          f"{lines[0] if lines else None!r}; values and matvecs as without "
          f"debug: {same}", flush=True)
    check(len(lines) == len(events) > 0 and fields_ok,
          f"46: debug printed {len(lines)} lines for {len(events)} events")
    check(same, "46: debug=True changed the solve")

    # PTPU_PROBE_DEBUG=1 in a child process
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE_CHILD, here, str(seed)],
        env=dict(os.environ, PTPU_PROBE_DEBUG="1"), capture_output=True,
        text=True, timeout=300)
    check(proc.returncode == 0,
          f"46: the probe-debug child failed:\n{proc.stderr[-2000:]}")
    out = proc.stdout.splitlines()
    rounds = [ln for ln in out if ln.startswith("probe round ")]
    nr = int(next(ln for ln in out if ln.startswith("PROBE_ROUNDS")).split()[1])
    print(f"[46 probe debug] child: {len(rounds)} probe-round lines for "
          f"{nr} rounds; first {rounds[0] if rounds else None!r}",
          flush=True)
    check(len(rounds) == nr > 0, "46: PTPU_PROBE_DEBUG printed "
          f"{len(rounds)} lines for {nr} probe rounds")
    secs = time.perf_counter() - t0
    print(f"[phase 46] {secs:.1f} s (to_dense {t1 - t0:.1f} s)", flush=True)
    return {"to_dense": dense, "to_dense_launches": to_dense_launches,
            "solve": {"n": n, "matvecs": mv, "launches": launches,
                      "eval_err": err, "device": str(res.evecs.device),
                      "refused": refused},
            "debug": {"lines": len(lines), "events": len(events),
                      "unchanged": same},
            "probe_debug": {"lines": len(rounds), "rounds": nr},
            "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 47: half operators (f16, bf16) on the card
# ---------------------------------------------------------------------------

HALF_SUFFIX = {"float16": "f16", "bfloat16": "bf16"}


def _within_ulp(y, yref):
    """|y - yref| at most one unit in the last place of the half yref."""
    import torch

    fi = torch.finfo(yref.dtype)
    mag = yref.float().abs().clamp_min(fi.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * fi.eps
    return bool(((y.float() - yref.float()).abs() <= ulp).all())


def _half_library(call, fn):
    """``fn`` if torch computes it in the half type on the card, else None
    (printed): a yardstick the port never calls."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except RuntimeError as e:
        print(f"[halfop] library call {call}: none in this type "
              f"({str(e).splitlines()[0]})", flush=True)
        return None


def half_kernel_rows(ST, JK, DK, WE, dev, gen, dia_op, ell_op, A_ell,
                     A_dia):
    """47, the kernel rows: each f16 and bf16 entry point on its phase's
    64^3 operator at k=2 against its plain version (bit for bit for the
    stencil, Jacobi and DIA; within one unit in the half's last place for
    the sliced ELL, whose two paths agree bit for bit), timed as phase 3
    times, with ``copy_ms``, the bound (2 bytes a value, i32 indices, X and
    Y once, over 3.35 TB/s) and ``library_ms`` where one PyTorch call
    computes the same function in the half type on the card: a depthwise
    ``conv3d`` for the stencil, ``torch.div`` for the unshifted Jacobi,
    ``A_csr @ X`` on a half CSR tensor for DIA and the sliced ELL (none
    for the shifted Jacobi, nor where torch refuses the type)."""
    import torch
    import torch.nn.functional as F

    n, k = GRID ** 3, 2
    grid = (GRID,) * 3
    out = {}
    for half, sfx in HALF_SUFFIX.items():
        dtype = getattr(torch, half)
        X = torch.randn((n, k), generator=gen, device=dev).to(dtype)
        Yc = torch.empty_like(X)

        def copy():
            return Yc.copy_(X)

        def row(entry, y, yref, bit, t, plan, call, extra=None):
            err = float((y.float() - yref.float()).abs().nan_to_num().max())
            out[entry] = {"max_abs_err": err, "bitwise": bit,
                          "vector_path": plan.vw > 1 if plan else None,
                          "plan_kernel": getattr(plan, "kernel", None),
                          "library_call": call if t["library_ms"] is not None
                          else None, **t, **(extra or {})}
            if plan is not None:
                _print_times(entry, HEADLINE_SHAPE, err, bit, t, plan,
                             f"  library ({call}) " + (
                                 "none" if t["library_ms"] is None
                                 else f"{t['library_ms']:.5f} ms"))
        # stencil
        w = torch.zeros((3, 3, 3), dtype=dtype)
        w[1, 1, 1] = 6.0
        for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[c] = -1.0
        Xc = X.view(1, GRID, GRID, GRID, k).permute(0, 4, 1, 2, 3)
        wk = w.expand(k, 1, 3, 3, 3).contiguous().to(dev)
        conv = _half_library("conv3d", lambda: F.conv3d(
            Xc, wk, padding=1, groups=k))
        entry = "stencil3d_" + sfx
        y, yref = ST.matmat(X, *grid), ST.matmat_reference(X, *grid)
        bit = _bitwise(y, yref)
        t = _times(lambda: ST.matmat(X, *grid),
                   lambda: ST.matmat_reference(X, *grid), 2 * n * k * 2,
                   copy, conv)
        row(entry, y, yref, bit, t, ST.card_plan(X, *grid),
            "conv3d depthwise (cuDNN)")
        check(bit, f"{entry}: kernel differs from its plain version")
        # Jacobi: one shift equal to a diagonal entry (f16: eps is 0, the
        # column infinite there; bf16: the guard's 1e-10)
        d = (torch.rand(n, generator=gen, device=dev) * 3 + 0.5).to(dtype)
        s = torch.stack([d[5], torch.tensor(0.7, device=dev).to(dtype)])
        for form in ("shifted", "unshifted"):
            entry = ("jacobi_shifted_" if form == "shifted" else "jacobi_") \
                + sfx
            if form == "shifted":
                def kern():
                    return JK.shifted(X, d, s, 1e-10)

                def plain():
                    return JK.shifted_reference(X, d, s, 1e-10)
                lib, nbytes = None, (2 * n * k + n + k) * 2
            else:
                def kern():
                    return JK.unshifted(X, d, 1e-10)

                def plain():
                    return JK.unshifted_reference(X, d, 1e-10)
                lib = _half_library("torch.div", lambda: torch.div(
                    X, d[:, None]))
                nbytes = (2 * n * k + n) * 2
            y, yref = kern(), plain()
            bit = _bitwise(y, yref)
            t = _times(kern, plain, nbytes, copy, lib)
            row(entry, y, yref, bit, t, JK.card_plan(X),
                "torch.div(X, d[:, None])" if lib else
                "none: no single call computes X / guard(d - sigma_j)")
            check(bit, f"{entry}: kernel differs from its plain version")
        # DIA: phase 11's 27 diagonals, matmat and rmatmat
        entry = "dia_" + sfx
        vals, offs, offsets = dia_op.vals.to(dtype), dia_op.offs, \
            dia_op.offsets
        csr = csr_on_card(A_dia, "float32", dev)
        lib = _half_library("A_csr @ X", lambda: csr.to(dtype) @ X)
        csr_h = csr.to(dtype) if lib else None
        y, yref = DK.matmat(vals, offs, X), DK.matmat_reference(vals,
                                                                offsets, X)
        yt = DK.matmat(vals, offs, X, adjoint=True)
        ytref = DK.rmatmat_reference(vals, offsets, X)
        bit = _bitwise(y, yref) and _bitwise(yt, ytref)
        t = _times(lambda: DK.matmat(vals, offs, X),
                   lambda: DK.matmat_reference(vals, offsets, X),
                   (len(offsets) * n + 2 * n * k) * 2, copy,
                   (lambda: csr_h @ X) if lib else None, plain_spin=False)
        row(entry, y, yref, bit, t, DK.card_plan(X), "A_csr @ X (cuSPARSE)")
        check(bit, f"{entry}: kernel differs from its plain version "
              "(matmat or rmatmat)")
        del csr, csr_h
        # the sliced ELL: phase 4's matrix in the chooser's RCM order
        entry = "windowed_ell_spmm_" + sfx
        lay = [ell_op.slice_ptr, ell_op.rowlen, ell_op.cols,
               ell_op.vals.to(dtype)]
        path = WE.choose_path(lay[0], lay[2])
        other = "ring" if path == "direct" else "direct"
        csr = csr_on_card(A_ell, "float32", dev)
        lib = _half_library("A_csr @ X", lambda: csr.to(dtype) @ X)
        csr_h = csr.to(dtype) if lib else None
        y = WE.matmat(*lay, X)
        yref = WE.matmat_reference(*lay, X)
        y_other = WE.matmat(*lay, X, path=other)
        ok = _within_ulp(y, yref)
        paths_bit = _bitwise(y, y_other)
        t = _times(lambda: WE.matmat(*lay, X),
                   lambda: WE.matmat_reference(*lay, X),
                   A_ell.nnz * (2 + 4) + 2 * n * k * 2, copy,
                   (lambda: csr_h @ X) if lib else None, plain_spin=False)
        other_ms = median_ms(lambda: WE.matmat(*lay, X, path=other))
        row(entry, y, yref, _bitwise(y, yref), t, None,
            "A_csr @ X (cuSPARSE)",
            {"within_one_ulp": ok, "path": path, "other_path": other,
             "other_path_ms": other_ms, "paths_bitwise": paths_bit,
             "mean_width": WE.mean_width(lay[0], lay[2])})
        r = out[entry]
        print(f"[{entry}] {HEADLINE_SHAPE} max|y-yref|={r['max_abs_err']:.3e}"
              f" within one ulp {ok}, bit for bit {r['bitwise']}; path "
              f"{path} (mean width {r['mean_width']:.1f}), {other} "
              f"{other_ms:.5f} ms, the paths bit for bit {paths_bit}; "
              f"kernel {t['ms']:.5f} ms (without the spin "
              f"{t['nospin_ms']:.5f})  plain {t['plain_ms']:.5f} ms  copy "
              f"{t['copy_ms']:.5f} ms  bound {t['bound_ms']:.5f} ms (bytes; "
              f"share {t['bound_share']:.3f})  library (A_csr @ X) "
              + ("none" if t["library_ms"] is None
                 else f"{t['library_ms']:.5f} ms"), flush=True)
        check(ok and paths_bit, f"{entry}: kernel not within one ulp of its "
              f"plain version ({ok}) or its paths differ ({paths_bit})")
        del X, Yc, csr, csr_h
    return out


def mixed_kernel_rows(JK, DK, WE, dev, gen, dia_op, ell_op, A_ell, A_dia):
    """47, the mixed rows: the entry points that take half values (or a
    half diagonal) with a wider real block, as a half basis hands a half
    operator f32 blocks, on the same 64^3 operators at k=2. With an f32
    block: Jacobi (shifted, one shift equal to a diagonal entry, and
    unshifted) and DIA (matmat and rmatmat) bit for bit against their
    plain versions; the sliced ELL within 1e-5 max|y| of its plain version
    and, with DIA, bit for bit against the f32 kernel on the widened
    values (its two paths bit for bit); each timed as the half rows, with
    ``library_ms`` the f32 call of the same function (``torch.div``, the
    f32 CSR product: the widened values are exact). With an f64 block, the
    same checks (1e-13 for the sliced ELL), held and not timed."""
    import torch

    n, k = GRID ** 3, 2
    out = {}
    csr = csr_on_card(A_dia, "float32", dev)
    csr_ell = csr_on_card(A_ell, "float32", dev)
    for half, sfx in HALF_SUFFIX.items():
        hdt = getattr(torch, half)
        d = (torch.rand(n, generator=gen, device=dev) * 3 + 0.5).to(hdt)
        vals = dia_op.vals.to(hdt)
        offs, offsets = dia_op.offs, dia_op.offsets
        lay = [ell_op.slice_ptr, ell_op.rowlen, ell_op.cols,
               ell_op.vals.to(hdt)]
        path = WE.choose_path(lay[0], lay[2])
        other = "ring" if path == "direct" else "direct"
        for bdt, bsfx, rel in ((torch.float32, "f32", 1e-5),
                               (torch.float64, "f64", 1e-13)):
            timed = bdt == torch.float32
            size = torch.empty((), dtype=bdt).element_size()
            X = torch.randn((n, k), generator=gen, device=dev).to(bdt)
            s = torch.stack([d[5].to(bdt),
                             torch.tensor(0.7, dtype=bdt, device=dev)])
            Yc = torch.empty_like(X)

            def copy():
                return Yc.copy_(X)

            def times(kern, plain, nbytes, lib, plain_spin=True):
                if not timed:
                    return _untimed(nbytes)
                return _times(kern, plain, nbytes, copy, lib,
                              plain_spin=plain_spin)

            def row(entry, err, bit, t, plan, call, extra=None):
                out[entry] = {"max_abs_err": err, "bitwise": bit,
                              "vector_path": plan.vw > 1 if plan else None,
                              "plan_kernel": getattr(plan, "kernel", None),
                              "library_call": call if t["library_ms"]
                              is not None else None, **t, **(extra or {})}
                if plan is not None:
                    _print_times(entry, HEADLINE_SHAPE, err, bit, t, plan,
                                 "" if t["library_ms"] is None else
                                 f"  library ({call}) "
                                 f"{t['library_ms']:.5f} ms")

            # Jacobi, shifted and unshifted, half d
            for form in ("shifted", "unshifted"):
                entry = (f"jacobi_shifted_{sfx}_{bsfx}" if form == "shifted"
                         else f"jacobi_{sfx}_{bsfx}")
                if form == "shifted":
                    def kern():
                        return JK.shifted(X, d, s, 1e-10)

                    def plain():
                        return JK.shifted_reference(X, d, s, 1e-10)
                    lib, call = None, None
                    nbytes = 2 * n * k * size + 2 * n + k * size
                else:
                    def kern():
                        return JK.unshifted(X, d, 1e-10)

                    def plain():
                        return JK.unshifted_reference(X, d, 1e-10)
                    dw = d.to(bdt)[:, None]

                    def lib():
                        return torch.div(X, dw)
                    call = "torch.div(X, d[:, None])"
                    nbytes = 2 * n * k * size + 2 * n
                y, yref = kern(), plain()
                bit = _bitwise(y, yref) and y.dtype == bdt
                t = times(kern, plain, nbytes, lib)
                err = float((y - yref).abs().nan_to_num().max())
                row(entry, err, bit, t, JK.card_plan(X, d), call)
                check(bit, f"{entry}: kernel differs from its plain version")
            # DIA, matmat and rmatmat, half values
            entry = f"dia_{sfx}_{bsfx}"
            y = DK.matmat(vals, offs, X)
            yt = DK.matmat(vals, offs, X, adjoint=True)
            bit = (_bitwise(y, DK.matmat_reference(vals, offsets, X))
                   and _bitwise(yt, DK.rmatmat_reference(vals, offsets, X)))
            wide = vals.to(bdt)
            same = (_bitwise(y, DK.matmat(wide, offs, X))
                    and _bitwise(yt, DK.matmat(wide, offs, X, adjoint=True)))
            err = float((y - DK.matmat_reference(vals, offsets, X))
                        .abs().max())
            t = times(lambda: DK.matmat(vals, offs, X),
                      lambda: DK.matmat_reference(vals, offsets, X),
                      len(offsets) * n * 2 + 2 * n * k * size,
                      (lambda: csr @ X) if timed else None, plain_spin=False)
            row(entry, err, bit, t, DK.card_plan(X, vals),
                "A_csr @ X (cuSPARSE, f32 values)",
                {f"bitwise_with_dia_{bsfx}": same})
            check(bit and same, f"{entry}: kernel differs from its plain "
                  f"version ({bit}) or from dia_{bsfx} on the widened "
                  f"values ({same})")
            # the sliced ELL, half values
            entry = f"windowed_ell_spmm_{sfx}_{bsfx}"
            y = WE.matmat(*lay, X)
            yref = WE.matmat_reference(*lay, X)
            y_other = WE.matmat(*lay, X, path=other)
            y_wide = WE.matmat(*lay[:3], lay[3].to(bdt), X)
            err = float((y - yref).abs().max())
            ymax = float(yref.abs().max())
            ok = err <= rel * ymax and y.dtype == bdt
            paths_bit, same = _bitwise(y, y_other), _bitwise(y, y_wide)
            t = times(lambda: WE.matmat(*lay, X),
                      lambda: WE.matmat_reference(*lay, X),
                      A_ell.nnz * (2 + 4) + 2 * n * k * size,
                      (lambda: csr_ell @ X) if timed else None,
                      plain_spin=False)
            other_ms = (median_ms(lambda: WE.matmat(*lay, X, path=other))
                        if timed else None)
            row(entry, err, _bitwise(y, yref), t, None,
                "A_csr @ X (cuSPARSE, f32 values)",
                {"path": path, "other_path": other, "other_path_ms": other_ms,
                 "paths_bitwise": paths_bit,
                 f"bitwise_with_windowed_ell_spmm_{bsfx}": same,
                 "mean_width": WE.mean_width(lay[0], lay[2])})
            print(f"[{entry}] {HEADLINE_SHAPE} max|y-yref|={err:.3e} (limit "
                  f"{rel * ymax:.3e}); bit for bit with the {bsfx} kernel on "
                  f"the widened values {same}, with the {other} path "
                  f"{paths_bit}; path {path}" + (
                      "; held, not timed" if not timed else
                      f"; kernel {t['ms']:.5f} ms (without the spin "
                      f"{t['nospin_ms']:.5f}), {other} {other_ms:.5f} ms  "
                      f"plain {t['plain_ms']:.5f} ms  copy "
                      f"{t['copy_ms']:.5f} ms  bound {t['bound_ms']:.5f} ms "
                      f"(bytes; share {t['bound_share']:.3f})  library "
                      f"(A_csr @ X, f32) {t['library_ms']:.5f} ms"),
                  flush=True)
            check(ok and paths_bit and same, f"{entry}: not within "
                  f"{rel} max|y| of its plain version ({err:.3e}), or its "
                  f"paths differ ({paths_bit}), or it differs from the "
                  f"{bsfx} kernel on the widened values ({same})")
            del X, Yc
    del csr, csr_ell
    return out


# the widths phases 47 and 48 hold the redesigned Jacobi and mixed DIA
# instances at, on contiguous blocks (k = 1, 2, 4 take the new kernels)
# and a k=2 slice at an odd column offset, n odd
NEW_KERNEL_K = (1, 2, 3, 4, 8)


def new_kernel_checks(JK, DK, dev, gen, vals32, offs, offsets, tag):
    """The half Jacobi (half, f32 and f64 blocks: shifted with one shift
    equal to a diagonal entry, and unshifted) and the mixed DIA (f32 and
    f64 blocks, matmat and rmatmat) in f16 and bf16 against their plain
    versions bit for bit, at the n = ``vals32.shape[1]`` rows of the DIA
    values ``vals32`` (f32, ``offsets`` in stored order), on contiguous
    blocks of each k of ``NEW_KERNEL_K`` and a k=2 slice at column offset
    1 of a 24-wide block; held, not timed. Returns, by entry point, the
    cases, how many of them the plan gave the new kernel (Jacobi's run
    kernel, the mixed DIA kernel) and whether every case matched."""
    import torch

    n = vals32.shape[1]
    out = {}

    def note(entry, bit, new):
        r = out.setdefault(entry, {"cases": 0, "new_kernel": 0,
                                   "bitwise": True})
        r["cases"] += 1
        r["new_kernel"] += new
        r["bitwise"] &= bit
        check(bit, f"{tag} {entry}: kernel differs from its plain version")

    for half, sfx in HALF_SUFFIX.items():
        hdt = getattr(torch, half)
        d = (torch.rand(n, generator=gen, device=dev) * 3 + 0.5).to(hdt)
        vals = vals32.to(hdt)
        for bdt, bsfx in ((hdt, ""), (torch.float32, "_f32"),
                          (torch.float64, "_f64")):
            W = torch.randn((n, SLICE_WIDTH), generator=gen,
                            device=dev).to(bdt)
            blocks = [torch.randn((n, k), generator=gen, device=dev).to(bdt)
                      for k in NEW_KERNEL_K] + [W[:, 1:3]]
            for X in blocks:
                k = X.shape[1]
                s = (torch.rand(k, generator=gen, device=dev) * 3
                     + 0.5).to(bdt)
                s[0] = d[5]
                run = JK.card_plan(X, d).kernel == JK.RUN_KERNEL
                note(f"jacobi_shifted_{sfx}{bsfx}", _bitwise(
                    JK.shifted(X, d, s, 1e-10),
                    JK.shifted_reference(X, d, s, 1e-10)), run)
                note(f"jacobi_{sfx}{bsfx}", _bitwise(
                    JK.unshifted(X, d, 1e-10),
                    JK.unshifted_reference(X, d, 1e-10)), run)
                if bdt == hdt:
                    continue
                mixed = DK.card_plan(X, vals).kernel == DK.MIXED_KERNEL
                note(f"dia_{sfx}{bsfx}", _bitwise(
                    DK.matmat(vals, offs, X),
                    DK.matmat_reference(vals, offsets, X)) and _bitwise(
                    DK.matmat(vals, offs, X, adjoint=True),
                    DK.rmatmat_reference(vals, offsets, X)), mixed)
            del W, blocks
        del d, vals
    print(f"[{tag}] the redesigned instances at n = {n}, k in "
          f"{list(NEW_KERNEL_K)} and a k=2 slice at column offset 1, bit "
          "for bit (cases / on the new kernel): "
          + ", ".join(f"{e} {r['cases']}/{r['new_kernel']}"
                      for e, r in out.items()), flush=True)
    return out


def half_operator_phase(ptt, mods, dev, gen, seed, f32_runs):
    """47: half operators. The kernel rows (:func:`half_kernel_rows`), then
    the solves of ``HALFOP_SOLVES`` at n = 262,144, each at ``tol = 4
    eps(half)``: ``bench.py``'s 64^3 stencil with its shift-aware Jacobi
    (``jacobi=True``: the diagonal in the half type) under an f32 solve in
    f16 and bf16 and, in bf16, with ``dtype=None`` (a half basis over the
    half operator); phase 4's permuted 27-point Laplacian (the chooser's
    RCM order) as an ``ELLOperator`` and phase 11's grid-order one as the
    chooser's ``BandedOperator``, each in both half types under an f32
    solve with ``SOLVE_KWARGS``, and over a half basis (f16 ELL, bf16 DIA,
    ``k`` of ``HALFOP_K``). Gates: every true residual (f64, the exact
    matrix) below ``16 eps(half) ||A||``; each value within its own true
    residual of the closed form; the probe verified and not exhausted for
    an f32 solve (printed, not held, for the half basis, as phase 40);
    the half kernels of the solve launched at least matvecs / 2 times (the
    shifted Jacobi: half the matvecs the probe does not make), every other
    entry point not at all (over a half basis, given f32 blocks and
    shifts, the operator computes in f32 as the JAX package's promotes:
    the mixed entry points, ``*_f16_f32``/``*_bf16_f32``, there); matvecs
    within 2x of the JAX package's. Each solve's
    time and peak device memory beside its f32 counterpart's
    (``f32_runs``: phases 9, 4 and 11; None where not run)."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from primme_tpu_torch.ops import dia as DK
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    t0 = time.perf_counter()
    A27, ev27 = laplacian27(GRID, seed)
    perm = np.asarray(reverse_cuthill_mckee(A27, symmetric_mode=True))
    A_ell = A27[perm][:, perm].tocsr()
    ell32 = ptt.ELLOperator.from_scipy(A_ell).to(dev)
    A_dia, ev_dia = laplacian27_grid(GRID)
    rb = ptt.rcm_banded(A_dia)
    check(rb is not None and isinstance(rb[0], ptt.BandedOperator)
          and rb[1] is None, "halfop: the chooser did not take phase 11's "
          "matrix banded")
    dia32 = rb[0].to(dev)
    print(f"[halfop] operators built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rows = half_kernel_rows(ST, JK, DK, WE, dev, gen, dia32, ell32, A_ell,
                            A_dia)
    rows.update(mixed_kernel_rows(JK, DK, WE, dev, gen, dia32, ell32, A_ell,
                                  A_dia))
    # n odd: the 27-point operator's first n - 1 rows
    held = new_kernel_checks(JK, DK, dev, gen,
                             dia32.vals[:, :-1].contiguous(), dia32.offs,
                             dia32.offsets, "halfop")
    lam_st, anorm_st = stencil_eigenvalues(GRID, GRID ** 3)
    host = {"stencil": (_laplacian7(GRID, None), lam_st, anorm_st),
            "ell": (A_ell, ev27, float(np.abs(ev27).max())),
            "dia": (A_dia, ev_dia, float(np.abs(ev_dia).max()))}
    f32_of = {"stencil": "headline", "ell": "solve f32", "dia": "banded"}
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    solves = {}
    for name, (kind, half, working) in HALFOP_SOLVES.items():
        hdt = getattr(torch, half)
        sfx = HALF_SUFFIX[half]
        heps = float(torch.finfo(hdt).eps)
        tol = 4 * heps
        wd = None if working is None else getattr(torch, working)
        if kind == "stencil":
            op = ptt.Stencil3DOperator(GRID, GRID, GRID, dtype=hdt,
                                       device=dev)
            kw = {**_headline_eigsh_kwargs(dev, seed, GRID),
                  "method": "PRIMME_JDQMR_ETol"}
            # over a half basis the shifted Jacobi gets f32 blocks and
            # shifts: its mixed entry point
            need = allowed = ["stencil3d_" + sfx, "jacobi_shifted_" + sfx
                              + ("_f32" if wd is None else "")]
        elif kind == "ell":
            lays = [WE.SlicedELL(*(getattr(ell32, f + t) for f in
                                   WE.SlicedELL._fields[:-1]),
                                 getattr(ell32, "vals" + t).to(hdt))
                    for t in ("", "_t")]
            op = ptt.ELLOperator(lays[0], lays[1], ell32.diag.to(hdt))
            kw = dict(SOLVE_KWARGS, device=dev)
            need = allowed = ["windowed_ell_spmm_" + sfx
                              + ("_f32" if wd is None else "")]
        else:
            op = ptt.BandedOperator(dia32.offsets, dia32.vals.to(hdt))
            kw = dict(SOLVE_KWARGS, device=dev)
            need = allowed = ["dia_" + sfx + ("_f32" if wd is None else "")]
        if name in HALFOP_K:
            kw["k"] = HALFOP_K[name]
        check(op.dtype == hdt, f"halfop {name}: operator {op.dtype}")
        A, lam, anorm = host[kind]
        torch.cuda.synchronize()
        before_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*mods)
        t1 = time.perf_counter()
        w, X, st = ptt.eigsh(op, **{**kw, "tol": tol, "seed": seed,
                                    "dtype": wd,
                                    "raise_for_unconverged": False})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_counts(mods)
        # the launches that ran the redesigned kernels: Jacobi's run
        # kernel, the mixed DIA kernel
        new_kernel = {**read_counts(mods, "RUN_LAUNCHES"),
                      **read_counts(mods, "MIXED_LAUNCHES")}
        peak = torch.cuda.max_memory_allocated()
        mv, pmv = st["num_matvecs"], st["num_probe_matvecs"]
        X64 = X.astype(np.float64)
        w64 = w.astype(np.float64)
        if kind == "stencil":
            Xt = torch.as_tensor(X64, device=dev)
            Rt = ST.matmat_reference(Xt, GRID, GRID, GRID) \
                - Xt * torch.as_tensor(w64, device=dev)[None, :]
            rn = torch.linalg.vector_norm(Rt, dim=0).cpu().numpy()
        else:
            rn = np.linalg.norm(A.astype(np.float64) @ X64
                                - X64 * w64[None, :], axis=0)
        xn = np.linalg.norm(X64, axis=0)
        dist = np.array([np.abs(lam - v).min() for v in w64])
        floor = 16 * heps * anorm
        ref_mv = REF_HALFOP[name]
        ref32 = (f32_runs or {}).get(f32_of[kind])
        verify = wd is not None
        print(f"[halfop {name}] {type(op).__name__} {half}, working "
              f"{working}: eigsh wall {wall:.3f} s (solve "
              f"{st['elapsed_time']:.3f} s)  num_matvecs {mv} (JAX package "
              f"{ref_mv})  num_probe_matvecs {pmv}  probe verified "
              f"{st['probe_verified']} exhausted {st['probe_exhausted']}"
              + ("" if verify else " (printed, not held)")
              + f"  launches { {e: c for e, c in launches.items() if c} }"
              f" (on the redesigned kernels "
              f"{ {e: c for e, c in new_kernel.items() if c} })  "
              f"max true residual {float(rn.max()):.3e} (limit {floor:.3e})"
              f"  distance to the spectrum / residual "
              f"{np.round(dist * xn / rn, 4).tolist()}  values "
              f"{np.sort(w64).tolist()}  peak device memory {peak} B "
              f"({before_bytes} B before: the phase's operators); its "
              f"f32 counterpart ({f32_of[kind]}): "
              + ("not run" if ref32 is None else
                 f"{ref32['wall_s']:.3f} s, {ref32.get('peak_bytes')} B"),
              flush=True)
        check(float(rn.max()) < floor, f"halfop {name}: residual "
              f"{float(rn.max()):.3e} >= {floor:.3e}")
        check(bool(np.all(dist <= rn / xn)), f"halfop {name}: a value lies "
              "farther from the closed form than its residual")
        check(not verify or (st["probe_verified"] == 1
                             and st["probe_exhausted"] == 0),
              f"halfop {name}: spectrum verification did not complete")
        for entry in need:
            least = (mv - pmv) / 2 if entry.startswith("jacobi") else mv / 2
            check(launches[entry] >= least, f"halfop {name}: only "
                  f"{launches[entry]} {entry} launches for {mv} matvecs")
            if entry.startswith("jacobi_shifted_") or (
                    entry.startswith("dia_") and entry.endswith("_f32")):
                check(new_kernel[entry] == launches[entry],
                      f"halfop {name}: {new_kernel[entry]} of the "
                      f"{launches[entry]} {entry} launches ran the "
                      "redesigned kernel")
        for entry in others:
            check(entry in allowed or launches[entry] == 0,
                  f"halfop {name}: {entry} served this solve: {launches}")
        check(ref_mv / 2 <= mv <= 2 * ref_mv, f"halfop {name}: {mv} "
              f"matvecs, not within 2x of the JAX package's {ref_mv}")
        solves[name] = {"operator": type(op).__name__, "half": half,
                        "working": working, "tol": tol, "wall_s": wall,
                        "solve_s": st["elapsed_time"], "num_matvecs": mv,
                        "num_probe_matvecs": pmv,
                        "probe_verified": st["probe_verified"],
                        "probe_exhausted": st["probe_exhausted"],
                        "evals": np.sort(w64).tolist(),
                        "max_residual": float(rn.max()), "floor": floor,
                        "launches": launches,
                        "new_kernel_launches": {
                            e: c for e, c in new_kernel.items() if c},
                        "peak_bytes": peak,
                        "bytes_before": before_bytes, "ref_matvecs": ref_mv,
                        "f32_counterpart": None if ref32 is None else {
                            "phase": f32_of[kind], "wall_s": ref32["wall_s"],
                            "peak_bytes": ref32.get("peak_bytes")}}
    return {"kernels": rows, "solves": solves, "held": held,
            "seconds": time.perf_counter() - t0}


# the entry points phase 47 times, what each replaces, and the solve whose
# launches its record reads (None: no solve runs the unshifted apply)
HALF_RECORDS = {
    **{f"stencil3d_{s}": ("primme_tpu/operators.py:379",
                          "primme_tpu_torch/csrc/stencil3d.cu",
                          f"stencil_{h}")
       for h, s in (("f16", "f16"), ("bf16", "bf16"))},
    **{f"jacobi_shifted_{s}": ("primme_tpu/operators.py:484",
                               "primme_tpu_torch/csrc/jacobi.cu",
                               f"stencil_{s}") for s in ("f16", "bf16")},
    **{f"jacobi_{s}": ("primme_tpu/operators.py:481",
                       "primme_tpu_torch/csrc/jacobi.cu", None)
       for s in ("f16", "bf16")},
    **{f"dia_{s}": ("primme_tpu/operators.py:671",
                    "primme_tpu_torch/csrc/dia.cu", f"dia_{s}")
       for s in ("f16", "bf16")},
    **{f"windowed_ell_spmm_{s}": ("primme_tpu/operators.py:198",
                                  "primme_tpu_torch/csrc/windowed_ell.cu",
                                  f"ell_{s}") for s in ("f16", "bf16")},
    # the mixed entry points (half values, f32 blocks; their f64-block
    # twins under "entries"), each with the half-basis solve that runs it
    **{f"jacobi_shifted_{s}_f32": ("primme_tpu/operators.py:484",
                                   "primme_tpu_torch/csrc/jacobi.cu", path)
       for s, path in (("f16", None), ("bf16", "stencil_bf16_half_basis"))},
    **{f"jacobi_{s}_f32": ("primme_tpu/operators.py:481",
                           "primme_tpu_torch/csrc/jacobi.cu", None)
       for s in ("f16", "bf16")},
    **{f"dia_{s}_f32": ("primme_tpu/operators.py:671",
                        "primme_tpu_torch/csrc/dia.cu", path)
       for s, path in (("f16", None), ("bf16", "dia_bf16_half_basis"))},
    **{f"windowed_ell_spmm_{s}_f32": ("primme_tpu/operators.py:198",
                                      "primme_tpu_torch/csrc/windowed_ell.cu",
                                      path)
       for s, path in (("f16", "ell_f16_half_basis"), ("bf16", None))},
}


# ---------------------------------------------------------------------------
# Phase 48: the packed half operations, exhaustively; the half rows at 256^3
# ---------------------------------------------------------------------------

HALF_CHECK_SOURCE = os.path.join("tools", "half_packed_check.cu")
HALF_CHECK_OPS = ("mul", "add", "sub")
LARGE_GRID = 256              # phase 48's grid: n = 16,777,216
LARGE_REPS, LARGE_PER = 7, 5  # its timings: 7 samples of 5 calls


def half_check_path():
    """Where :func:`half_check_library` builds ``HALF_CHECK_SOURCE``."""
    from primme_tpu_torch.ops import build

    return build.hashed_path(half_check_source(), build.NVCC_FLAGS,
                             "half_packed_check", build.headers())


def half_check_source():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        HALF_CHECK_SOURCE)


def half_check_library():
    """``tools/half_packed_check.cu``, built (once) and loaded."""
    from primme_tpu_torch.ops import build

    return build.load_source(half_check_source(), "half_packed_check")


def half_packed_check(dev):
    """Every pair of 16-bit patterns through the packed half operations of
    the port's kernels (``primme_tpu_torch/csrc/half2.cuh``) and through
    f32 on the exact operands rounded once to the half type, in f16 and
    bf16 (``tools/half_packed_check.cu``, built here). Returns, for each
    "<type> <operation>", the pairs (2^32), the mismatches (a pair of
    results matches when both are NaN, else when their bits are equal),
    the pairs whose results are both NaN and those of them whose NaN bits
    differ, and the first mismatching pair ``[a, b]`` (or None); and the
    seconds of the build and of the run."""
    import ctypes

    import torch

    t0 = time.perf_counter()
    fn = half_check_library().half_packed_check
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    t1 = time.perf_counter()
    counts = torch.zeros(2 * 3 * 3, dtype=torch.int64, device=dev)
    first = torch.full((6,), -1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(counts.data_ptr(), first.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"half_packed_check: launch failed, CUDA error {rc}")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c = counts.view(2, 3, 3).cpu().tolist()
    firsts = [v & 0xFFFFFFFF for v in first.cpu().tolist()]
    out = {}
    for t, half in enumerate(("float16", "bfloat16")):
        for o, op in enumerate(HALF_CHECK_OPS):
            fp = firsts[3 * t + o]
            out[f"{half} {op}"] = {
                "pairs": 2 ** 32, "mismatches": c[t][o][0],
                "both_nan": c[t][o][1], "nan_bits_differ": c[t][o][2],
                "first_mismatch": (None if fp == 0xFFFFFFFF
                                   else [fp >> 16, fp & 0xFFFF])}
    return out, {"build_s": t1 - t0, "run_s": t2 - t1}


def laplacian27_dia(m, dtype, dev):
    """:func:`laplacian27_grid`'s matrix as 27 diagonals on the card, from
    its closed form: offsets ascending, ``vals[b, i] = A[i, i + off_b]``
    (26 on the main diagonal, -1 where the neighbour lies in the grid, 0
    where it does not), in ``dtype``. Returns (vals ``[27, m^3]``, offs as
    an i64 tensor on the card, offsets)."""
    import torch

    n = m ** 3
    i = torch.arange(n, device=dev)
    coords = (i // (m * m), (i // m) % m, i % m)
    vals = torch.empty((27, n), dtype=dtype, device=dev)
    offsets = []
    for b, (di, dj, dl) in enumerate(
            (a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)):
        inside = torch.ones(n, dtype=torch.bool, device=dev)
        for c, d in zip(coords, (di, dj, dl)):
            inside &= (c + d >= 0) & (c + d < m)
        off = (di * m + dj) * m + dl
        vals[b] = torch.where(inside, 26.0 if off == 0 else -1.0, 0.0)
        offsets.append(off)
    return vals, torch.tensor(offsets, device=dev), offsets


def dia_csr(vals, offsets, dtype):
    """The CSR tensor (i32 indices, values in ``dtype``) of the DIA matrix
    ``vals`` (offsets ascending, a zero value off the grid), built on the
    card: the library call's operand, never the port's."""
    import torch

    n = vals.shape[1]
    cols = torch.arange(n, device=vals.device)[:, None] + torch.tensor(
        offsets, device=vals.device)[None, :]
    keep = vals.t() != 0                  # the edges' zeros leave
    crow = torch.zeros(n + 1, dtype=torch.int32, device=vals.device)
    crow[1:] = keep.sum(1).cumsum(0)
    col = cols[keep].to(torch.int32)
    del cols
    with warnings.catch_warnings():     # "beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, vals.t()[keep].to(dtype),
                                       size=(n, n))


def _times_large(kernel, plain, nbytes, copy, library, plain_spin=True):
    """:func:`_times` at ``LARGE_REPS`` samples of ``LARGE_PER`` calls and
    without the no-spin time: the 256^3 rows."""
    def med(fn, spin=True):
        return median_ms(fn, reps=LARGE_REPS, per=LARGE_PER, spin=spin)

    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    out = {"ms": med(kernel), "nospin_ms": None,
           "plain_ms": med(plain, plain_spin), "copy_ms": med(copy),
           "bound_ms": bound_ms, "l2_resident": nbytes <= L2_BYTES,
           "library_ms": med(library) if library is not None else None}
    out["bound_share"] = bound_ms / out["ms"]
    return out


def large_half_rows(ST, JK, DK, dev, gen):
    """48, the 256^3 rows: each half entry point of the stencil, Jacobi
    (shifted, one shift equal to a diagonal entry, and unshifted) and DIA,
    and the mixed Jacobi and DIA entry points with an f32 block, at
    ``LARGE_GRID``^3 and k=2 against its plain version bit for bit (DIA:
    matmat and rmatmat), timed as :func:`_times_large` (with ``copy_ms``
    and the library call of phase 47: ``conv3d``, ``torch.div``, cuSPARSE
    on the same matrix's CSR, half values or f32 for the mixed rows)
    beside the bound, the bytes once over 3.35 TB/s. The 27-point DIA is built on the
    card from its closed form (:func:`laplacian27_dia`: 906 MB of half
    values), and its CSR from it (:func:`dia_csr`)."""
    import torch
    import torch.nn.functional as F

    m, k = LARGE_GRID, 2
    n, grid = m ** 3, (m,) * 3
    out = {}

    def row(entry, y, yref, bit, t, plan, call):
        err = float((y.float() - yref.float()).abs().nan_to_num().max())
        out[entry] = {"shape": f"{m}^3 k={k}", "max_abs_err": err,
                      "bitwise": bit, "plan": {
                          **plan._asdict(),
                          "rows": getattr(plan, "rows", None)},
                      "library_call": call if t["library_ms"] is not None
                      else None, **t}
        print(f"[{entry}] {m}^3 k={k} max|y-yref|={err:.3e} bit for bit "
              f"{bit}; plan {plan._asdict()}; kernel {t['ms']:.5f} ms  "
              f"plain {t['plain_ms']:.5f} ms  copy {t['copy_ms']:.5f} ms  "
              f"bound {t['bound_ms']:.5f} ms (bytes; share "
              f"{t['bound_share']:.3f})  library ({call}) "
              + ("none" if t["library_ms"] is None
                 else f"{t['library_ms']:.5f} ms"), flush=True)
        check(bit, f"{entry} at {m}^3: kernel differs from its plain version")

    for half, sfx in HALF_SUFFIX.items():
        dtype = getattr(torch, half)
        X = torch.randn((n, k), generator=gen, device=dev).to(dtype)
        Yc = torch.empty_like(X)

        def copy():
            return Yc.copy_(X)
        # stencil
        w = torch.zeros((3, 3, 3), dtype=dtype)
        w[1, 1, 1] = 6.0
        for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[c] = -1.0
        Xc = X.view(1, m, m, m, k).permute(0, 4, 1, 2, 3)
        wk = w.expand(k, 1, 3, 3, 3).contiguous().to(dev)
        conv = _half_library("conv3d", lambda: F.conv3d(
            Xc, wk, padding=1, groups=k))
        y, yref = ST.matmat(X, *grid), ST.matmat_reference(X, *grid)
        row("stencil3d_" + sfx, y, yref, _bitwise(y, yref),
            _times_large(lambda: ST.matmat(X, *grid),
                         lambda: ST.matmat_reference(X, *grid),
                         2 * n * k * 2, copy, conv),
            ST.card_plan(X, *grid), "conv3d depthwise (cuDNN)")
        del y, yref
        # Jacobi
        d = (torch.rand(n, generator=gen, device=dev) * 3 + 0.5).to(dtype)
        s = torch.stack([d[5], torch.tensor(0.7, device=dev).to(dtype)])
        for entry, kern, plain, lib, nbytes, call in (
                ("jacobi_shifted_" + sfx,
                 lambda: JK.shifted(X, d, s, 1e-10),
                 lambda: JK.shifted_reference(X, d, s, 1e-10), None,
                 (2 * n * k + n + k) * 2,
                 "none: no single call computes X / guard(d - sigma_j)"),
                ("jacobi_" + sfx, lambda: JK.unshifted(X, d, 1e-10),
                 lambda: JK.unshifted_reference(X, d, 1e-10),
                 _half_library("torch.div", lambda: torch.div(
                     X, d[:, None])), (2 * n * k + n) * 2,
                 "torch.div(X, d[:, None])")):
            y, yref = kern(), plain()
            row(entry, y, yref, _bitwise(y, yref),
                _times_large(kern, plain, nbytes, copy, lib),
                JK.card_plan(X), call)
            del y, yref
        # the mixed Jacobi: the half d, an f32 block and shifts
        Xf = torch.randn((n, k), generator=gen, device=dev)
        sf = torch.stack([d[5].float(), torch.tensor(0.7, device=dev)])
        Yf, dw = torch.empty_like(Xf), d.float()[:, None]

        def copy_f():
            return Yf.copy_(Xf)
        for entry, kern, plain, lib, nbytes, call in (
                (f"jacobi_shifted_{sfx}_f32",
                 lambda: JK.shifted(Xf, d, sf, 1e-10),
                 lambda: JK.shifted_reference(Xf, d, sf, 1e-10), None,
                 2 * n * k * 4 + 2 * n + k * 4,
                 "none: no single call computes X / guard(d - sigma_j)"),
                (f"jacobi_{sfx}_f32", lambda: JK.unshifted(Xf, d, 1e-10),
                 lambda: JK.unshifted_reference(Xf, d, 1e-10),
                 lambda: torch.div(Xf, dw), 2 * n * k * 4 + 2 * n,
                 "torch.div(X, d[:, None])")):
            y, yref = kern(), plain()
            row(entry, y, yref, _bitwise(y, yref) and y.dtype == Xf.dtype,
                _times_large(kern, plain, nbytes, copy_f, lib),
                JK.card_plan(Xf, d), call)
            del y, yref
        del Xf, Yf, dw
        # DIA, half values: a half block, then an f32 one (mixed)
        vals, offs, offsets = laplacian27_dia(m, dtype, dev)
        csr = dia_csr(vals, offsets, dtype)
        for Xb, entry, call, lib_csr in (
                (X, "dia_" + sfx, "A_csr @ X (cuSPARSE)", csr),
                (None, f"dia_{sfx}_f32", "A_csr @ X (cuSPARSE, f32 values)",
                 None)):
            if Xb is None:
                del csr
                Xb = torch.randn((n, k), generator=gen, device=dev)
                lib_csr = dia_csr(vals, offsets, torch.float32)
                Yb = torch.empty_like(Xb)

                def copy_b():
                    return Yb.copy_(Xb)
            else:
                copy_b = copy
            lib = _half_library("A_csr @ X", lambda: lib_csr @ Xb)
            y = DK.matmat(vals, offs, Xb)
            yt = DK.matmat(vals, offs, Xb, adjoint=True)
            yref = DK.matmat_reference(vals, offsets, Xb)
            bit = _bitwise(y, yref) and _bitwise(
                yt, DK.rmatmat_reference(vals, offsets, Xb))
            row(entry, y, yref, bit,
                _times_large(lambda: DK.matmat(vals, offs, Xb),
                             lambda: DK.matmat_reference(vals, offsets, Xb),
                             len(offsets) * n * 2
                             + 2 * n * k * Xb.element_size(), copy_b,
                             (lambda: lib_csr @ Xb) if lib else None,
                             plain_spin=False),
                DK.card_plan(Xb, vals), call)
            del y, yt, yref, lib_csr
        del X, Xb, Yc, vals, d
        torch.cuda.empty_cache()
    return out


def half_check_phase(ST, JK, DK, dev, gen):
    """48: :func:`half_packed_check` (0 mismatches for each of the six
    (type, operation) pairs), then :func:`large_half_rows`, then
    :func:`new_kernel_checks` at n = 256^3 - 1 (the 27-point operator's
    first n rows)."""
    import torch

    t0 = time.perf_counter()
    ops, secs = half_packed_check(dev)
    for name, r in ops.items():
        print(f"[halfcheck] {name}: {r['mismatches']} mismatches in "
              f"{r['pairs']} pairs ({r['both_nan']} both NaN, "
              f"{r['nan_bits_differ']} of them with other NaN bits); first "
              f"mismatch {r['first_mismatch']}", flush=True)
    print(f"[halfcheck] build {secs['build_s']:.2f} s, run "
          f"{secs['run_s']:.3f} s", flush=True)
    check(all(r["mismatches"] == 0 for r in ops.values()),
          "halfcheck: the packed half operations differ from f32 rounded "
          "once")
    rows = large_half_rows(ST, JK, DK, dev, gen)
    vals, offs, offsets = laplacian27_dia(LARGE_GRID, torch.float32, dev)
    held = new_kernel_checks(JK, DK, dev, gen, vals[:, :-1].contiguous(),
                             offs, offsets, "halfcheck")
    del vals
    torch.cuda.empty_cache()
    return {"ops": ops, **secs, "rows": rows, "held": held,
            "seconds": time.perf_counter() - t0}


def half_kernel_record(name, halfop, halfcheck):
    """The record of a half entry point: phase 47's row at 64^3 k=2 (and
    phase 48's at 256^3 k=2 under ``large``, where it has one), its
    launches those of the phase 47 solve that runs it."""
    replaces, source, path = HALF_RECORDS[name]
    r = halfop["kernels"][name]
    keys = ("ms", "nospin_ms", "plain_ms", "copy_ms", "library_ms",
            "library_call", "bound_ms", "bound_share", "max_abs_err",
            "bitwise", "within_one_ulp", "path", "other_path",
            "other_path_ms", "paths_bitwise", "mean_width", "vector_path")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (0 if path is None else
                         halfop["solves"][path]["launches"][name]),
            "launches_path": None if path is None else f"halfop {path}",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "shape": HEADLINE_SHAPE,
            **{key: r.get(key) for key in keys},
            **({"large": halfcheck["rows"][name]}
               if name in halfcheck["rows"] else {}),
            **({"entries": {twin: {"replaces": replaces,
                                   **halfop["kernels"][twin]}}}
               if (twin := name[:-3] + "f64") in halfop["kernels"]
               and name.endswith("_f32") else {})}


def jacobi_complex_record(name, replaces, per_shape, path, launches):
    """The record of a complex Jacobi entry point (phase 38's numbers at
    ``HEADLINE_SHAPE``, complex denominators), its launches those of the
    phase 39 path ``path``."""
    keys = ("ms", "nospin_ms", "plain_ms", "copy_ms", "library_ms",
            "bound_ms", "bound_share", "max_abs_err", "bitwise")
    top = per_shape[HEADLINE_SHAPE]["complex"]
    return {"name": name, "route": "cuda",
            "source": "primme_tpu_torch/csrc/jacobi.cu",
            "replaces": replaces, "launches": launches,
            "launches_path": path,
            "max_abs_err": max(c["max_abs_err"] for v in per_shape.values()
                               for c in v.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "bound_share": top["bound_share"],
            "library_call": ("torch.div(X, d[:, None])"
                             if top["library_ms"] is not None else None),
            "shapes": {label: {case: {key: c.get(key) for key in keys}
                               for case, c in v.items()}
                       for label, v in per_shape.items()}}


def rect_kernel_record(name, replaces, run, per,
                       shape=f"grounded_incidence({SVD_GRID}) A layout, k=2"):
    """The record of a sliced-ELL entry point on the rectangular layouts
    (phase 19, or 23 on the magnetic incidence), its top-level numbers at
    the ``A`` layout's k=2, its launches those of the svds path ``run``."""
    top = per["per_k"]["A"][2]
    keys = ("ms", "nospin_ms", "plain_ms", "copy_ms", "library_ms",
            "library_call", "bound_ms", "bound_share", "max_abs_err",
            *PATH_KEYS)
    return {"name": name, "route": "cuda",
            "source": "primme_tpu_torch/csrc/windowed_ell.cu",
            "replaces": replaces, "launches": run["launches"][name],
            "direct_launches": run["direct_launches"][name],
            "path": top["path"],
            "max_abs_err": max(v["max_abs_err"] for lay in per["per_k"].values()
                               for v in lay.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "bound_share": top["bound_share"],
            "library_call": top["library_call"],
            "shape": shape,
            "layouts": per["layouts"],
            "per_k": {label: {str(k): {key: v[key] for key in keys}
                              for k, v in lay.items()}
                      for label, lay in per["per_k"].items()}}


# a sliced-ELL timing's path, the other path's time and their agreement
PATH_KEYS = ("path", "mean_width", "other_path", "other_path_ms",
             "paths_bitwise")


def kernel_record(name, replaces, run, per_k, layout):
    """The record of a sliced-ELL entry point on one square layout (its
    top-level numbers at k=2), its launches those of the solve ``run``."""
    k2 = per_k[2]
    return {"name": name, "route": "cuda",
            "source": "primme_tpu_torch/csrc/windowed_ell.cu",
            "replaces": replaces, "launches": run["launches"][name],
            "direct_launches": run["direct_launches"][name],
            "path": k2["path"],
            "max_abs_err": max(v["max_abs_err"] for v in per_k.values()),
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"], "bound_by": "bytes",
            "library_ms": k2["library_ms"], "bound_share": k2["bound_share"],
            "library_call": k2["library_call"], "layout": layout,
            "per_k": {str(k): {key: v[key] for key in (
                "ms", "nospin_ms", "plain_ms", "library_ms", "library_call",
                "bound_ms", "bound_share", "max_abs_err", *PATH_KEYS)}
                for k, v in per_k.items()}}


def main_path_record(name, source, replaces, run, per_entry, others):
    """The record of a kernel of the headline's path (its f32 entry point,
    at ``HEADLINE_SHAPE``) with its other entry points' numbers under
    ``entries``; ``run`` is the headline solve whose counts (every entry
    point's launches, and those that took the vector path) it reads."""
    keys = ("ms", "nospin_ms", "plain_ms", "copy_ms", "library_ms",
            "bound_ms", "bound_share", "max_abs_err", "bitwise",
            "vector_path", "plan")

    def by_shape(per_shape):
        return {label: {key: v[key] for key in keys}
                for label, v in per_shape.items()}

    top = per_entry[name][HEADLINE_SHAPE]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name],
            "vector_launches": run["vector_launches"][name],
            "max_abs_err": max(v["max_abs_err"]
                               for v in per_entry[name].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "bound_share": top["bound_share"],
            "library_call": top.get("library_call"),
            "shapes": by_shape(per_entry[name]),
            "entries": {other: {"replaces": rep,
                                "launches": run["launches"][other],
                                "vector_launches":
                                    run["vector_launches"][other],
                                "shapes": by_shape(per_entry[other])}
                        for other, rep in others.items()}}


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_main = time.perf_counter()
    timers = {}

    def lap(key, since):
        """Seconds since ``since`` under ``key``, printed."""
        timers[key] = time.perf_counter() - since
        print(f"[{key}] {timers[key]:.1f} s", flush=True)
        return time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import build
    from primme_tpu_torch.ops import dia as DK
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    # --- 1. device ------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)
    print(f"[device] timing spin: {spin_cycles_per_ms():.0f} cycles per ms",
          flush=True)

    # --- 2. build ---------------------------------------------------------
    # always from the checkout's sources: one nvcc per source, all at once
    for src in KERNEL_SOURCES:
        if os.path.exists(build.library_path(src)):
            os.remove(build.library_path(src))
    if os.path.exists(half_check_path()):
        os.remove(half_check_path())
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) \
            as pool:
        check_lib = pool.submit(half_check_library)    # phase 48's
        handles = dict(zip(KERNEL_SOURCES, pool.map(build.load,
                                                    KERNEL_SOURCES)))
        check_lib.result()
    for src, mod in (("windowed_ell", WE), ("stencil3d", ST),
                     ("jacobi", JK), ("dia", DK)):
        entries = list(mod.KERNEL_LAUNCHES)
        for entry in entries:
            getattr(handles[src], entry)  # AttributeError if it is missing
        print(f"[build] {src}.cu -> "
              f"{os.path.relpath(build.library_path(src))}; entry points "
              f"{entries}", flush=True)
    print(f"[build] {len(KERNEL_SOURCES)} sources and "
          f"{HALF_CHECK_SOURCE} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    mods = (DK, WE, ST, JK)
    t_phase = lap("phases 1-2", t_main)

    # --- 3. f32 layout and kernel against its plain version -------------
    A, ev = laplacian27(GRID, args.seed)
    n = A.shape[0]
    t0 = time.perf_counter()
    op, perm = ptt.rcm_banded(A)
    check(isinstance(op, ptt.WindowedELLOperator),
          f"format chooser picked {type(op).__name__}")
    op = op.to(dev)
    print(f"[kernel] n={n} nnz={A.nnz} meta(nrb,S,npad,n,pad,WB)={op.meta} "
          f"chooser {time.perf_counter() - t0:.2f} s", flush=True)
    Ap = A[perm][:, perm]
    layout32 = layout_phase(WE, op, Ap, np.float32, "kernel")
    gen = torch.Generator().manual_seed(args.seed)
    per_k = compare_kernel(WE, op, csr_on_card(Ap, np.float32, dev), gen,
                           1e-5, "kernel")

    # --- 4. f32 solve -------------------------------------------------------
    others = [e for mod in mods for e in mod.KERNEL_LAUNCHES]
    anorm = float(np.abs(ev).max())
    solve32 = format_solve(
        ptt, mods, A, args.seed, "solve", ev, 1e-4, anorm, REF_MATVECS,
        need=("windowed_ell_spmm_f32",),
        forbid=[e for e in others if e != "windowed_ell_spmm_f32"])

    # --- 5. f64 layout and kernel against its plain version -------------
    A64 = A.astype(np.float64)      # entries 26 and -1: exact in f32
    t0 = time.perf_counter()
    op64, perm64 = ptt.rcm_banded(A64)
    check(isinstance(op64, ptt.WindowedELLOperator)
          and op64.dtype == torch.float64,
          f"format chooser picked {type(op64).__name__} "
          f"({getattr(op64, 'dtype', None)}) for the f64 matrix")
    op64 = op64.to(dev)
    print(f"[kernel64] meta(nrb,S,npad,n,pad,WB)={op64.meta} dtype "
          f"{op64.dtype} chooser {time.perf_counter() - t0:.2f} s",
          flush=True)
    Ap64 = A64[perm64][:, perm64]
    layout64 = layout_phase(WE, op64, Ap64, np.float64, "kernel64")
    per_k64 = compare_kernel(WE, op64, csr_on_card(Ap64, np.float64, dev),
                             gen, 1e-13, "kernel64")

    # --- 6. f64 solve -------------------------------------------------------
    solve64 = format_solve(
        ptt, mods, A64, args.seed, "solve64", ev, 1e-8, anorm,
        REF_MATVECS_F64, need=("windowed_ell_spmm_f64",),
        forbid=[e for e in others if e != "windowed_ell_spmm_f64"],
        tol=1e-10)

    # --- 7. stencil kernel against its plain version --------------------
    # inputs made on the card (256^3 at k=8 in f64 is 1 GB a block)
    cgen = torch.Generator(device=dev).manual_seed(args.seed)
    sten = stencil_phase(ST, dev, cgen)

    # --- 8. Jacobi kernels against their plain versions -------------------
    jac = jacobi_phase(JK, dev, cgen)
    t_phase = lap("phases 3-8", t_phase)

    # --- 9. the headline: bench.py's configuration ----------------------
    headline, hl_run = headline_phase(ptt, dev)
    hl_launches = hl_run["launches"]
    first = headline["solves"][1]["wall_s"]       # the first timed solve
    kernel_ms = {entry: hl_launches[entry] * per[HEADLINE_SHAPE]["ms"]
                 for entry, per in
                 (("stencil3d_f32", sten["stencil3d_f32"]),
                  ("jacobi_shifted_f32", jac["jacobi_shifted_f32"]))}
    headline["kernel_share"] = {entry: ms / (1e3 * first)
                                for entry, ms in kernel_ms.items()}
    print(f"[headline] first timed solve {first:.4f} s; launches x "
          f"{HEADLINE_SHAPE} time: " + "; ".join(
              f"{entry} {hl_launches[entry]} x -> {ms:.2f} ms "
              f"({headline['kernel_share'][entry]:.4f} of the solve)"
              for entry, ms in kernel_ms.items()), flush=True)

    # --- 10. GD_Olsen_plusK + Jacobi (__graft_entry__.entry's method) ----
    gdk = gdk_phase(ptt, dev)
    t_phase = lap("phases 9-10", t_phase)

    # --- 11-13. the chooser's banded, DIA+ELL and ELL branches ----------
    banded = banded_phase(ptt, mods, DK, WE, dev, cgen, args.seed)
    hybrid = hybrid_phase(ptt, mods, DK, WE, dev, gen, args.seed)
    ell = ell_phase(ptt, mods, WE, dev, gen, args.seed)

    # --- 14. BlockELL (plain PyTorch) against scipy ----------------------
    block_ell = block_ell_phase(ptt, dev, gen, args.seed)
    t_phase = lap("phases 11-14", t_phase)

    # --- 15. the north star: f32 solve + native FP64 polish --------------
    northstar = northstar_phase(ptt, mods, dev)
    northstar100 = northstar_phase(ptt, mods, dev, k=NS_K_LARGE,
                                   refs=REF_NS_LARGE, split=False)
    t_phase = lap("phase 15", t_phase)

    # --- 16-18. generalized pencil, constraints, interior targets --------
    generalized = generalized_phase(ptt, mods, args.seed)
    constraints = constraints_phase(ptt, mods, ST, dev, args.seed)
    interior = interior_phase(ptt, mods, args.seed)
    t_phase = lap("phases 16-18", t_phase)
    lap("phases 1-18", t_main)

    # --- 19-22. svds: the kernel on rectangular layouts, three solves ----
    svd = svds_phases(ptt, mods, WE, dev, args.seed)

    # --- 23-27. complex Hermitian eigsh and complex svds ------------------
    cplx = complex_phases(ptt, mods, DK, WE, dev, gen, cgen, args.seed)

    # --- 28-30. eigs on normal operators ----------------------------------
    normal = normal_phases(ptt, mods, args.seed)

    # --- 31. DYNAMIC on the headline (eigsh's default method) -------------
    t0 = time.perf_counter()
    dynamic = dynamic_phase(ptt, mods, dev, args.seed)

    # --- 32. the segmented headline against the unsegmented one -----------
    segmented = segmented_phase(ptt, mods, dev, args.seed)

    # --- 33. the event stream and its cost ---------------------------------
    events = events_phase(ptt, mods, dev, args.seed)

    # --- 34. the config-file harness and driver ----------------------------
    harness = harness_phase(ptt, mods, dev, args.seed)

    # --- 35. the measured profile ------------------------------------------
    profile = profile_phase(ptt, mods, dev)
    print(f"[phases 31-35] {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 36-37. the C ABI: in-process, then from a C program -------------
    t0 = time.perf_counter()
    capi = capi_inprocess_phase(ptt, mods, args.seed)
    t1 = time.perf_counter()
    capi_c = capi_c_phase(args.seed)
    t2 = time.perf_counter()

    # --- 38. the complex Jacobi entry points against their plain versions -
    cjac = complex_jacobi_phase(JK, dev, cgen)
    t3 = time.perf_counter()

    # --- 39. solves with the complex Jacobi --------------------------------
    jsolves = jacobi_solves_phase(ptt, mods, dev, args.seed)
    t4 = time.perf_counter()

    # --- 40. the half-precision basis ---------------------------------------
    half = half_phase(ptt, mods, dev, args.seed, solve32)
    t5 = time.perf_counter()
    seconds36 = {"phase36": t1 - t0, "phase37": t2 - t1, "phase38": t3 - t2,
                 "phase39": t4 - t3, "phase40": t5 - t4, "total": t5 - t0}
    print("[phases 36-40] " + ", ".join(f"{key} {v:.1f} s"
                                         for key, v in seconds36.items()),
          flush=True)
    jl = {name: r["launches"] for name, r in jsolves["solves"].items()}

    # --- 41-45. the row-partitioned solve on ranks sharing the card -------
    sharded = sharded_phases(ptt, mods, dev, args.seed)

    # --- 46. the last surface: to_dense, from_coo, the device rule, debug -
    t_phase = time.perf_counter()
    surface = surface_phase(ptt, mods, dev, args.seed)
    t_phase = lap("phase 46", t_phase)

    # --- 47. half operators: the f16 and bf16 entry points and solves -----
    halfop = half_operator_phase(
        ptt, mods, dev, cgen, args.seed,
        {"headline": {**headline,
                      "peak_bytes": headline["solves"][1].get("peak_bytes")},
         "solve f32": solve32, "banded": banded["solve"]})
    t_phase = lap("phase 47", t_phase)

    # --- 48. the packed half operations, exhaustively; the 256^3 rows -----
    halfcheck = half_check_phase(ST, JK, DK, dev, cgen)
    lap("phase 48", t_phase)

    rec = {"kernels": [
        kernel_record("windowed_ell_spmm_f32",
                      "primme_tpu/ops/pallas_windowed.py:228", solve32,
                      per_k, layout32),
        kernel_record("windowed_ell_spmm_f64",
                      "primme_tpu/ops/pallas_windowed.py:363", solve64,
                      per_k64, layout64),
        main_path_record("stencil3d_f32", "primme_tpu_torch/csrc/stencil3d.cu",
                         "primme_tpu/operators.py:379", hl_run, sten,
                         {"stencil3d_f64": "primme_tpu/operators.py:379"}),
        main_path_record("jacobi_shifted_f32",
                         "primme_tpu_torch/csrc/jacobi.cu",
                         "primme_tpu/operators.py:484", hl_run, jac,
                         {"jacobi_shifted_f64": "primme_tpu/operators.py:484",
                          "jacobi_f32": "primme_tpu/operators.py:481",
                          "jacobi_f64": "primme_tpu/operators.py:481"}),
        main_path_record("dia_f32", "primme_tpu_torch/csrc/dia.cu",
                         "primme_tpu/operators.py:671", banded["solve"],
                         banded["kernel"],
                         {"dia_f64": "primme_tpu/operators.py:671"}),
        *svd["kernels"], *cplx["kernels"],
        jacobi_complex_record(
            "jacobi_shifted_c64", "primme_tpu/operators.py:484",
            cjac["jacobi_shifted_c64"], "jacobi magnetic",
            jl["magnetic"]["jacobi_shifted_c64"]),
        jacobi_complex_record(
            "jacobi_c64", "primme_tpu/operators.py:481", cjac["jacobi_c64"],
            "jacobi magnetic fixed", jl["magnetic_fixed"]["jacobi_c64"]),
        jacobi_complex_record(
            "jacobi_shifted_c128", "primme_tpu/operators.py:484",
            cjac["jacobi_shifted_c128"], "jacobi cd",
            jl["cd"]["jacobi_shifted_c128"]),
        jacobi_complex_record(
            "jacobi_c128", "primme_tpu/operators.py:481",
            cjac["jacobi_c128"], "jacobi harness",
            jl["harness"]["jacobi_c128"]),
        *[half_kernel_record(name, halfop, halfcheck)
          for name in HALF_RECORDS]],
        "solve": {**solve32, "f64": solve64},
        "headline": headline, "gdk": gdk,
        "banded": {k: v for k, v in banded.items() if k != "kernel"},
        "hybrid": hybrid, "ell": ell, "block_ell": block_ell,
        "northstar": northstar, "northstar_k100": northstar100,
        "generalized": generalized,
        "constraints": constraints, "interior": interior,
        "svds": svd["svds"], "svds_seconds": svd["seconds"],
        "complex": {"solves": cplx["solves"], "chooser": cplx["chooser"],
                    "seconds": cplx["seconds"]},
        "normal": normal, "dynamic": dynamic, "segmented": segmented,
        "events": events, "harness": harness, "profile": profile,
        "capi": capi, "capi_c": capi_c, "jacobi_solves": jsolves,
        "half": half, "seconds_36_40": seconds36, "sharded": sharded,
        "surface": surface, "halfop": halfop, "halfcheck": halfcheck,
        "spin_cycles_per_ms": spin_cycles_per_ms()}
    # every path's launches, each counted from 0 just before it ran
    paths = {"solve f32": solve32["launches"],
             "solve f64": solve64["launches"],
             "headline": hl_launches, "gdk": gdk["launches"],
             "banded": banded["solve"]["launches"],
             "hybrid": hybrid["solve"]["launches"],
             "ell": ell["solve"]["launches"],
             "northstar f32": northstar["f32_launches"],
             "northstar polish": northstar["polish_launches"],
             "northstar k=100 f32": northstar100["f32_launches"],
             "northstar k=100 polish": northstar100["polish_launches"],
             "generalized": generalized["launches"],
             "constraints": constraints["launches"],
             **{f"interior {name}": interior[name]["launches"]
                for name in INTERIOR_SOLVES},
             **{f"svds {name}": svd["svds"][name]["launches"]
                for name in SVDS_SOLVES},
             **{f"complex {name}": cplx["solves"][name]["launches"]
                for name in ("complex64", "complex128", "ell", "svds")},
             **{f"normal {name}": normal["solves"][name]["launches"]
                for name in NORMAL_SOLVES},
             "dynamic": dynamic["launches"],
             "segmented": segmented["launches"],
             "harness save": harness["save"]["launches"],
             "harness check": harness["check"]["launches"],
             "capi csr": capi["csr"]["launches"],
             "capi run": capi["run"]["launches"],
             **{"jacobi " + name.replace("_", " "): counts
                for name, counts in jl.items()},
             **{f"half {name}": r["launches"] for name, r in half.items()},
             **{f"halo product P={P} {name} rank {r}": rec[name]["launches"]
                for P, recs in sharded["products"].items()
                for r, rec in enumerate(recs)
                for name in ("laplacian27", "band_scatter")},
             **{f"sharded {name} rank {r}": rec[name]["launches"]
                for r, rec in enumerate(sharded["solves"])
                for name in ("headline", "sparse", "banded")},
             **{f"sharded svds {name} rank {r}":
                rec["svds"][name]["launches"]
                for r, rec in enumerate(sharded["solves"])
                for name in ("lm", "sm")},
             "nccl headline": sharded["nccl"]["launches"],
             "surface to_dense": surface["to_dense_launches"],
             "surface solve": surface["solve"]["launches"],
             **{f"halfop {name}": r["launches"]
                for name, r in halfop["solves"].items()}}
    for kern in rec["kernels"]:
        for entry, r in [(kern["name"], kern),
                         *kern.get("entries", {}).items()]:
            r["path_launches"] = {path: counts.get(entry, 0)
                                  for path, counts in paths.items()}
    lap("total", t_main)
    rec["seconds"] = dict(timers)
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
