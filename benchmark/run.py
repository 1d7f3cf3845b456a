"""Benchmark of primme_tpu_torch, the PyTorch and CUDA eigensolver, on a card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; the harness finds everything that belongs to it by
name, and nothing here names a cell, a kind of call, an operator or a
metric:

* ``benchmark/configs/<config>.json``: the problem, its accuracy and the
  limits of the comparison; its ``operator`` names
  ``benchmark/operators/<operator>.py`` (the program's operators, made in
  set-up) and ``benchmark/reference/<operator>.py`` (their plain
  reference);
* ``benchmark/workloads/<cell>.json``: the traffic's parameters; its
  ``job`` names ``benchmark/jobs/<job>.py``, the calls, whose ``CHECK``
  names the comparison in ``benchmark/reference/``;
* ``benchmark/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer.

A run builds the operators, lets the job warm the cell's entries at its
shapes (set-up), then makes calls back to back, a closed loop of one
caller: a call starts while the time since the first call's start plus
the longest call so far fits in ``--seconds``. The window runs from the
first call's start to the last call's end. With ``--trace 0`` the result
line holds the cell's end-to-end metrics; with ``--trace 1`` the calls
(at most the workload's ``trace_calls``) run under ``torch.profiler``,
and the line holds the per-layer metrics, the device's busy and traced
seconds and a breakdown. After the window every answer is judged by the
plain reference; the numbers compared and their limits are the last lines
on standard error and the last key of the result.

Exits 2 without a result where there is no card or fewer than the cell
asks for, and 3 where JAX or the JAX package is loaded once the window
has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "_bench_cache")
PROGRAM = "primme_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "primme_tpu")

if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

from lib import find  # noqa: E402


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def resolve(spec: dict, cell_name: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, workload file, job, operators,
    reference and comparison, and the readers of its metrics, each found
    by name under ``root``; raises KeyError or FileNotFoundError when one
    is missing."""
    import reference

    bench = os.path.join(root, "benchmark")
    cell = {c["name"]: c for c in spec["workloads"]}[cell_name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(root, cfgs[cell["config"]]["file"])
    wl = load_json(bench, "workloads", cell_name + ".json")
    wl["traffic"] = cell["traffic"]
    job = find.module("jobs", wl["job"], bench)
    refs = os.path.join(bench, "reference")

    def mine(metrics):
        return [m for m in metrics
                if cell_name in m.get("workloads", [cell_name])]

    per_layer, end_to_end = mine(spec["per_layer"]), mine(spec["end_to_end"])
    return {"cell": cell, "config": cfg, "workload": wl, "job": job,
            "operators": find.module("operators", cfg["operator"], bench),
            "reference": reference.load(cfg["operator"], refs),
            "check": reference.load(job.CHECK, refs),
            "per_layer": per_layer, "end_to_end": end_to_end,
            "readers": {m["name"]: metric_reader(m["name"], root)
                        for m in per_layer + end_to_end}}


def metric_reader(name: str, root: str = ROOT):
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    return find.module("metrics", name, os.path.join(root, "benchmark")).read


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def drive(job, seconds: float, max_calls=None):
    """The window: ``job``'s calls back to back, each started while the
    time since the first call's start plus the longest call so far fits
    in ``seconds`` (and, where given, fewer than ``max_calls`` have run).
    A call that raises ends the window. Returns ``(answers, counters,
    times, errors, window_s)``, the window from the first call's start to
    the last call's end."""
    answers, counters, times, errors = [], [], [], []
    t_first = t_end = time.monotonic()
    longest, i = 0.0, 0
    while not (i and time.monotonic() - t_first + longest > seconds) \
            and not (max_calls and i >= max_calls):
        t0 = time.monotonic()
        try:
            ans, cnt = job.call(i)
        except Exception:   # a job that raises is a failed call
            errors.append(f"call {i}: {traceback.format_exc()}")
            break
        t_end = time.monotonic()
        answers.append(ans)
        counters.append(cnt)
        times.append(t_end - t0)
        longest = max(longest, t_end - t0)
        i += 1
        job.next_input(i)
    return answers, counters, times, errors, t_end - t_first


def run_cell(res: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = None, log=sys.stderr) -> dict:
    """One run of a resolved cell on ``device``: set-up, the window, the
    comparison. Returns the result's object (without printing it)."""
    import torch

    from lib import profile as P
    from lib import trace as T

    t_start = T_START if t_start is None else t_start
    cfg, wl = res["config"], res["workload"]
    cuda = torch.device(device).type == "cuda"
    ptt = importlib.import_module(PROGRAM)
    prob = res["operators"].build(ptt, cfg, device)
    job = res["job"].Job(ptt, prob, res["reference"], cfg, wl, seed, device,
                         traced=trace)
    job.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_start

    max_calls = wl.get("trace_calls") if trace else None
    with (P.kernel_entries(PROGRAM) if trace
          else contextlib.nullcontext()) as kernels:
        with (P.recorder() if trace else contextlib.nullcontext()) as prof:
            answers, counters, times, errors, window_s = drive(
                job, seconds, max_calls)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    process_peak = max(peak, setup_peak) if cuda else 0
    t_digest = time.monotonic()
    digest = P.digest(prof) if trace else None
    t_digest = time.monotonic() - t_digest
    del job, prob, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = res["check"].compare(res["reference"], cfg, answers, device)
    failed = judged["failed"] + len(errors)
    correct = not errors and bool(answers) and judged["failed"] == 0

    out = {"correct": correct, "attempted": len(answers) + len(errors),
           "failed": failed, "metrics": {}, "device": {}}
    if cuda:
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": 1, "memory_peak_bytes": process_peak}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    run = {"calls": counters, "times": times, "window_s": window_s,
           "peak_bytes": peak, "setup_s": setup_s,
           "kind": out["device"]["kind"]}
    if trace:
        lo = min((s[1] for s in digest["host_spans"]
                  if s[0] == "bench.call"), default=None)
        hi = max((s[2] for s in digest["host_spans"]
                  if s[0] == "bench.call"), default=None)
        run.update(trace=digest, stencil_calls=kernels, window_us=(lo, hi))
    for m in res["per_layer"] if trace else res["end_to_end"]:
        v = res["readers"][m["name"]](run)
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        if lo is not None:
            out["device"]["busy_s"] = T.busy_us(digest["device"], lo,
                                                hi) * 1e-6
            out["device"]["window_s"] = (hi - lo) * 1e-6
            out["breakdown"] = {
                "device_ops": T.device_ops(digest["device"]),
                "idle_gaps": T.idle_by_host_span(
                    digest["device"], digest["host_spans"], lo, hi)}
        print(f"[trace] events by kind {digest['kinds']}; traced calls "
              f"{len(times)}; read in {t_digest:.3f} s", file=log,
              flush=True)
    if cuda:
        print(f"[run] card {power_limit()}", file=log, flush=True)
    print(f"[run] cell {res['cell']['name']} seed {seed}: setup "
          f"{setup_s:.3f} s, {len(answers)} calls in {window_s:.3f} s "
          f"{[round(t, 4) for t in times]}, counters "
          f"{counters[:3]}{' ...' if len(counters) > 3 else ''}",
          file=log, flush=True)
    for e in errors:
        print(f"[run] {e}", file=log, flush=True)
    out["checks"] = judged["numbers"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernels build into its own folder in the checkout; any
    # other compiler cache a library keeps goes to fixed folders in it too
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"

    spec = load_json(ROOT, "BENCHMARK.json")
    res = resolve(spec, args.workload)
    try:
        import torch
    except ImportError as exc:
        print(f"no torch: {exc}", file=sys.stderr)
        return 2
    chips = res["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} card(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    out = run_cell(res, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    for name, nv in out["checks"].items():
        print(f"check {name} {nv['value']!r} limit {nv['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
