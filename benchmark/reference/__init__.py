"""The benchmark's plain reference. Imports nothing of the program under
test and takes nothing it made.

One file an operator, named as a configuration's ``operator`` names it
(:mod:`.laplacian7`): its exact values, its own product and, where known,
its eigenbasis. One file a kind of answer (:mod:`.eigenpairs`): the
comparison that decides ``correct``, named by the job that returns it.
:mod:`.polish` is a plain polish for the control. A new operator or a new
kind of answer is a new file here; :func:`load` finds it by name.
"""

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, folder: str = HERE):
    """The module ``<folder>/<name>.py``, loaded from its path."""
    path = os.path.join(folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reference {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_reference_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
