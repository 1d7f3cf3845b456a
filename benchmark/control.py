"""The control of the comparison: the plain reference polish put in the
program's place, in the precision below the configuration's.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--dtype float32] [--maxiter 100]

For each seed the cell's own input to the polish is made as a run makes
it (the job's ``polish_input``: in ``northstar`` the program's f32
``eigsh`` from call 0's start block, in ``polish`` the block made from
the exact vectors), then ``reference.polish`` polishes it in ``--dtype``
(the configuration states float64, so the control is float32; float64
shows that the reference itself meets the limits) and the job's
comparison judges the result against the configuration's limits. Prints
one JSON line a seed. Needs the card (``--device cpu`` runs it on the
CPU); the benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import run as R  # noqa: E402


def control(res: dict, seeds, dtype, maxiter: int, device, log=sys.stdout):
    """One record a seed: the compared numbers, whether they pass, the
    reference's steps and seconds."""
    import importlib

    import torch

    from reference import polish

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, wl = res["config"], res["workload"]
    ref, check = res["reference"], res["check"]
    ptt = importlib.import_module(R.PROGRAM)
    prob = res["operators"].build(ptt, cfg, device)
    out = []
    for seed in seeds:
        job = res["job"].Job(ptt, prob, ref, cfg, wl, seed, device)
        X = torch.as_tensor(job.polish_input()).to(device)
        t0 = time.perf_counter()
        lam, V, steps = polish.polish(ref, cfg, X, tol=cfg["polish"]["tol"],
                                      dtype=dtype,
                                      degree=cfg["polish"]["degree"],
                                      maxiter=maxiter)
        secs = time.perf_counter() - t0
        got = check.measure(ref, cfg, lam.cpu().numpy(), V.cpu().numpy(),
                            cfg["k"], device)
        rec = {"cell": res["cell"]["name"], "seed": seed,
               "dtype": str(dtype).replace("torch.", ""), "steps": steps,
               "seconds": secs, "numbers": got,
               "passes": check.passes(got, cfg["limits"]),
               "limits": cfg["limits"]}
        if log is not None:
            print(json.dumps(rec), file=log, flush=True)
        out.append(rec)
        del X, V, job
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    res = R.resolve(R.load_json(R.ROOT, "BENCHMARK.json"), args.workload)
    control(res, args.seeds, getattr(torch, args.dtype), args.maxiter,
            torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
