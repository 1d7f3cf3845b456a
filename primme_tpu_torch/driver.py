"""Config-file driver CLI: run a reference-format test config end to end.

PyTorch port of ``primme_tpu/driver.py``, the analogue of the reference's
test drivers (``tests/driver.c``
for eigenproblems and ``tests/driversvds.c`` for singular values): parse
one of its config files (``tests/tests/test_???``), build the operator
from the named MatrixMarket file, solve, print the solution in the
reference driver's report style, verify against the stored golden
solution (``driver.checkXFile`` + ``check_solution``,
``tests/COMMON/ioandtest.c:70``), and optionally save the computed
vectors in the reference's binary golden format (``driver.saveXFile``,
``tests/driver.c:280``) so the golden corpus can be regenerated or
extended from this framework.

Usage::

    python -m primme_tpu_torch.driver CONFIG [--base-dir DIR] [--complex]
                                             [--save-x FILE]
                                             [--mv-slack F] [--eps-slack F]
                                             [--device cpu]

The solve runs on the card unless ``--device`` names another device; the
configs' double-precision solves run in f64 working types, whatever the
device.

Exit status 0 when all solution checks pass, 1 otherwise — so the module
can stand in for the reference's ``make test`` runner in scripts.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m primme_tpu_torch.driver",
        description="Run a reference-format test config (tests/driver.c "
                    "analogue).")
    ap.add_argument("config", help="path to a test_??? config file")
    ap.add_argument("--base-dir", default=None,
                    help="directory the config's matrixFile/checkXFile "
                         "paths are relative to (default: CONFIG/..)")
    ap.add_argument("--complex", action="store_true", dest="as_complex",
                    help="run the doublecomplex variant (the reference "
                         "runs every test_0?? both ways, tests/Makefile:98)")
    ap.add_argument("--save-x", default=None,
                    help="write the computed vectors in the reference's "
                         "binary golden format (overrides driver.saveXFile)")
    ap.add_argument("--mv-slack", type=float, default=2.0)
    ap.add_argument("--eps-slack", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="where the solve runs (default: the card, "
                         "failing when there is none; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from .testharness import run_config, run_svds_config, parse_config

    try:
        cfg = parse_config(args.config)
    except OSError as e:
        print(f"driver error: {e}", file=sys.stderr)
        return 1
    print(f"driver.matrixFile  = {cfg.matrix_file}")
    print(f"driver.checkXFile  = {cfg.check_x_file}")
    print(f"driver.PrecChoice  = {cfg.prec_choice}")
    dtype = complex if args.as_complex else None

    t0 = time.time()
    # errors (missing matrix file, bad config key, solver failure) exit
    # with status 1 and a message, like the reference driver — scripted
    # make-test-style use must see a clean failure, not a traceback
    try:
        # cfg.is_svds: the config sets primme_svds.* fields or an
        # primme_svds_* method (tests/driversvds.c reads the same
        # key=value format with the svds prefix)
        if cfg.is_svds:
            r = run_svds_config(args.config, base_dir=args.base_dir,
                                eps_slack=args.eps_slack, dtype=dtype,
                                save_x_file=args.save_x, device=args.device)
            label = "Sval"
        else:
            r = run_config(args.config, base_dir=args.base_dir,
                           mv_slack=args.mv_slack, eps_slack=args.eps_slack,
                           dtype=dtype, save_x_file=args.save_x,
                           device=args.device)
            label = "Eval"
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"driver error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    wall = time.time() - t0

    # reference driver report style (driver.c primme display + ioandtest)
    if r.evals is not None:
        for i, (ev, rn) in enumerate(zip(r.evals, r.rnorms)):
            print(f"{label}[{i + 1}]: {ev:-22.15E} rnorm: {rn:-22.15E}")
    # eigs configs carry a Stats namedtuple; svds configs carry the flat
    # per-stage dict (stage1_num_matvecs/stage2_num_matvecs) — sum the
    # stages so the matvec aggregate (the reference suite's parity
    # metric, tests/Makefile:119) is real for both
    nmv = 0
    if r.stats is not None:
        mv = getattr(r.stats, "num_matvecs", None)
        if mv is not None:
            nmv = int(mv)
        elif isinstance(r.stats, dict):
            # stage keys are "stageN_num_matvecs" (probe matvecs are a
            # separate "stageN_num_probe_matvecs" subset counter and do
            # not match this suffix)
            nmv = int(sum(v for kk, v in r.stats.items()
                          if kk.endswith("_num_matvecs")))
    print(f"Tests: 1 Matvecs: {nmv} Time: {wall:.3f} s")
    if r.ok:
        print("solution check: OK")
        return 0
    print(f"solution check FAILED: {r!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
