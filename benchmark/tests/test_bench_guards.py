"""Guards: what the benchmark may import, the shape of ``BENCHMARK.json``,
cells found by name (a new cell, a new kind of call, a new operator and a
new metric too, each added as files only), and the exits without a card
or without the program."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import run
from conftest import BENCH, ROOT, shrink

FORBIDDEN = {"jax", "jaxlib", "flax", "primme_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def sources(sub=""):
    top = os.path.join(BENCH, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of the absolute imports of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = imported(path)
        assert not names & (FORBIDDEN | {"primme_tpu_torch", "lib", "jobs",
                                         "operators"}), path
        with open(path) as f:
            assert "primme_tpu" not in f.read(), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("primme_tpu_torch", "primme_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "primme_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_forbidden() == ["jax", "primme_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['benchmark/tests', 'benchmark', '.']\n"
        "import run, control\n"
        "from conftest import shrink\n"
        "res = shrink(run.resolve(run.load_json('.', 'BENCHMARK.json'),"
        " 'lap3d7_128_k10.northstar'), grid=(8, 8, 8))\n"
        "out = run.run_cell(res, 5, 0.2, True, 'cpu')\n"
        "assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "primme_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_benchmark_json_keeps_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"][1] == "benchmark/run.py"
    assert isinstance(spec["run_seconds"], int) and \
        1 <= spec["run_seconds"] <= 51
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"], key
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        res = run.resolve(spec, cell)
        assert {m["name"] for m in res["end_to_end"]} >= {"setup_s"}
        assert len(res["end_to_end"]) >= 2 and res["per_layer"]


def test_every_cell_resolves_by_name(spec):
    for w in spec["workloads"]:
        res = run.resolve(spec, w["name"])
        assert res["config"]["name"] == w["config"]
        assert res["workload"]["traffic"] == w["traffic"]
        assert res["job"].__file__.endswith(
            os.path.join("jobs", res["workload"]["job"] + ".py"))
        assert res["operators"].__file__.endswith(
            os.path.join("operators", res["config"]["operator"] + ".py"))
        assert res["reference"].__file__.endswith(
            os.path.join("reference", res["config"]["operator"] + ".py"))
        assert res["check"].__file__.endswith(
            os.path.join("reference", res["job"].CHECK + ".py"))
        assert set(res["readers"]) == {m["name"] for m in
                                       res["per_layer"] + res["end_to_end"]}


# A later cell of a new kind: a new operator (the Laplacian scaled by 2,
# with its own reference), a new job (the polish from a seeded normal
# block), a new per-layer and a new end-to-end metric, each a new file;
# no file that is there is edited.
NEW_OPERATOR = """
import torch
from types import SimpleNamespace


def build(ptt, cfg, device):
    nx, ny, nz = cfg["grid"]
    A64 = ptt.Stencil3DOperator(nx, ny, nz, dtype=torch.float64,
                                device=device, scale=2.0)
    K64 = ptt.ChebyshevPrecond.from_operator(A64, degree=8)
    return SimpleNamespace(n=nx * ny * nz, k=cfg["k"], A64=A64, K64=K64)
"""
NEW_REFERENCE = """
import os, importlib.util
spec = importlib.util.spec_from_file_location(
    "lap_for_twice", os.path.join(os.path.dirname(__file__),
                                  "laplacian7.py"))
lap = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lap)
size = lap.size


def smallest(cfg, k):
    return 2 * lap.smallest(cfg, k)


def norm(cfg):
    return 2 * lap.norm(cfg)


def matmat(cfg, X):
    return 2 * lap.matmat(cfg, X)
"""
NEW_JOB = """
from lib import draw, stages
from lib.profile import span

CHECK = "eigenpairs"


class Job:
    def __init__(self, ptt, prob, ref, cfg, wl, seed, device, traced=False):
        self.ptt, self.prob, self.cfg, self.device = ptt, prob, cfg, device
        self.X = draw.normal(seed, 0, (prob.n, cfg["k"]), device,
                             dtype=__import__("torch").float64)

    def setup(self):
        pass

    def next_input(self, i):
        pass

    def call(self, i):
        with span("call", False):
            ev, V, st = stages.polish(self.ptt, self.prob, self.cfg, self.X,
                                      self.device)
        return (ev, V), {"twice_iters": st["num_refine_iters"]}
"""
NEW_METRIC = """
def read(run):
    got = [c["twice_iters"] for c in run["calls"]]
    return sum(got) / len(got) if got else None
"""
NEW_E2E = """
def read(run):
    return len(run["times"]) / run["window_s"] if run["times"] else None
"""


def test_a_cell_added_as_files_only_is_found(tmp_path, spec):
    """A checkout with new files only: a configuration of a new operator,
    a workload of a new job, their reference, and two metrics, all found
    by name; the cell runs and is judged correct at a small grid."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs/lap3d7_128_k10.json").read_text())
    cfg.update(name="twice_8", operator="twice", grid=[8, 8, 8], k=4)
    cfg["polish"]["maxiter"] = 400
    files = {"configs/twice_8.json": json.dumps(cfg),
             "workloads/twice_8.normal.json": json.dumps(
                 {"job": "normal_polish", "trace_calls": 1}),
             "operators/twice.py": NEW_OPERATOR,
             "reference/twice.py": NEW_REFERENCE,
             "jobs/normal_polish.py": NEW_JOB,
             "metrics/twice.iterations.py": NEW_METRIC,
             "metrics/calls_per_s.py": NEW_E2E}
    for rel, text in files.items():
        assert not (b / rel).exists(), rel
        (b / rel).write_text(text)
    new = json.loads(json.dumps(spec))
    new["configs"].append(dict(spec["configs"][0], name="twice_8",
                               file="benchmark/configs/twice_8.json"))
    new["workloads"].append(dict(spec["workloads"][-1],
                                 name="twice_8.normal", config="twice_8",
                                 traffic="normal"))
    new["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["twice_8.normal"]})
    new["per_layer"].append({"name": "twice.iterations", "unit": "count",
                             "better": "lower", "source": "program_counter",
                             "layer": "refine", "moves": "calls_per_s",
                             "workloads": ["twice_8.normal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import sys; sys.path[:0] = ['benchmark', %r]\n"
        "import json, run\n"
        "res = run.resolve(run.load_json('.', 'BENCHMARK.json'),"
        " 'twice_8.normal', root='.')\n"
        "import os\n"
        "for part in ('operators', 'reference', 'job'):\n"
        "    assert os.path.abspath(res[part].__file__).startswith("
        "os.getcwd()), res[part].__file__\n"
        "out = run.run_cell(res, 3, 0.3, False, 'cpu', log=sys.stdout)\n"
        "tr = run.run_cell(res, 3, 0.3, True, 'cpu', log=sys.stdout)\n"
        "print(json.dumps([out['correct'], sorted(out['metrics']),"
        " tr['correct'], sorted(tr['metrics'])]))\n") % ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    # on the CPU there is no device peak, so peak_mem_GiB finds nothing
    assert got == [True, ["calls_per_s", "setup_s"], True,
                   ["twice.iterations"]], got


def test_no_card_exits_without_a_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the exit without one")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "lap3d7_128_k10.polish", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, 'benchmark')\n"
            "import run\n"
            "res = run.resolve(run.load_json('.', 'BENCHMARK.json'),"
            " 'lap3d7_128_k10.polish', root='.')\n"
            "print(run.run_cell(res, 1, 1.0, False, 'cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "primme_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""
