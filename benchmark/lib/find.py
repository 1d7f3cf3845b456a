"""Files of the benchmark found by name.

A cell's parts are files named in ``BENCHMARK.json`` or in its own data
files: ``benchmark/jobs/<job>.py`` (the calls a workload file's ``job``
names), ``benchmark/operators/<operator>.py`` (the operators a
configuration's ``operator`` names) and ``benchmark/metrics/<metric>.py``
(one reader a metric, end-to-end or per-layer). A new one is a new file;
nothing here or in ``run.py`` lists them.
"""

from __future__ import annotations

import importlib.util
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def module(folder: str, name: str, bench: str = BENCH):
    """``<bench>/<folder>/<name>.py``, loaded from its path; raises
    FileNotFoundError where there is no such file."""
    path = os.path.join(bench, folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
