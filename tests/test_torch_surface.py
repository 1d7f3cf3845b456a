"""The port is complete: every public name of ``primme_tpu`` has its
counterpart in ``primme_tpu_torch``.

The walk takes, on the CPU, from the JAX package:

* each module's public functions and classes (those the module defines);
* the public members of each of those classes (methods, properties,
  fields of a ``NamedTuple`` or a dataclass);
* the parameters of the user entry points (:data:`ENTRY_POINTS`) and of
  the constructors of the classes ``primme_tpu`` exports;
* the ``PTPU_*`` environment switches each module reads.

Each is one case, held against the port's module of the same name (or
the one :data:`MODULES` maps it to). Where the port serves the same thing
under another name, or the thing belongs to JAX alone, :data:`EXCLUDED`
says so with its reason; every entry of that table must name a real item
of the JAX package, and one that has no counterpart must be absent from
the port."""

import dataclasses
import importlib
import inspect
import pkgutil
import re

import pytest

import primme_tpu
import primme_tpu_torch

# a module of the JAX package -> the port's module that serves it
MODULES = {"ops.pallas_windowed": "ops.windowed_ell"}

# (module, function) whose parameters are held one by one
ENTRY_POINTS = (("api", "eigsh"), ("api", "eigs"), ("svds", "svds"),
                ("refine", "refine_eigsh"), ("core.solver", "solve_eigs"),
                ("core.dynamic", "solve_eigs_dynamic"))

_PYTREE = ("JAX pytree plumbing (flatten/unflatten for jit); a port "
           "operator is an nn.Module, whose buffers .to(device) moves")
_KEY = ("the caller's random stream: a JAX PRNG key there, a "
        "torch.Generator here (a CPU one seeded s gives rng_seed=s bit for "
        "bit)")
_SHARD = ("the row partition: a jax.sharding spec there, a RowComm over "
          "torch.distributed here (eigsh/svds take mesh= in both)")

# case id -> (the port's counterpart as a case id, or None; the reason)
EXCLUDED = {
    **{("member", "operators", cls, m): (None, _PYTREE)
       for cls in ("LinearOperator", "CastOperator", "FunctionOperator")
       for m in ("tree_flatten", "tree_unflatten")},
    **{case: (None, "the low f32 half of the f32x2 double-single values "
              "the TPU kernel reads; the port's f64 operator and packed "
              "layout hold native FP64 values, read by the kernel's FP64 "
              "entry point")
       for case in (("param", "operators", "WindowedELLOperator", "vals_lo"),
                    ("member", "ops.pallas_windowed", "WindowedELL",
                     "vals_lo"))},
    ("name", "ops.pallas_windowed", "matmat_ds"): (
        ("name", "ops.windowed_ell", "matmat"),
        "the f32x2 double-single product of the TPU kernel; on the card "
        "matmat's native FP64 entry point (windowed_ell_spmm_f64)"),
    **{("param", "operators", "ELLOperator", a): (
        ("name", "ops.windowed_ell", "SlicedELL"),
        "the padded [n, w] cols/vals arrays (and their transpose) of the "
        "reference; the port's constructor takes the sliced-ELL layouts of "
        "A and A^H and the diagonal, built by from_scipy/from_coo")
       for a in ("cols", "vals", "shape", "colsT", "valsT")},
    **{("param", "core.solver", "solve_eigs", "key"): (
        ("param", "core.solver", "solve_eigs", "generator"), _KEY),
       ("param", "core.dynamic", "solve_eigs_dynamic", "key"): (
        ("param", "core.dynamic", "solve_eigs_dynamic", "generator"), _KEY),
       ("member", "core.solver", "SolverState", "key"): (
        ("member", "core.solver", "SolverState", "gen"), _KEY)},
    **{("param", mod, fn, "shard"): (("param", mod, fn, "comm"), _SHARD)
       for mod, fn in (("core.solver", "solve_eigs"),
                       ("core.dynamic", "solve_eigs_dynamic"))},
    ("param", "core.dynamic", "solve_eigs_dynamic", "method_trace"): (
        ("param", "core.dynamic", "solve_eigs_dynamic", "segment_log"),
        "a list of method names there; the port's segment_log gets a "
        "record a segment, whose 'method' is the same name"),
    ("env", "driver", "PTPU_PLATFORM"): (
        ("option", "driver", "--device"),
        "the JAX driver pins jax_platforms from PTPU_PLATFORM; the port's "
        "driver takes --device (the card unless --device cpu)"),
}


def _modules(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name.split(".", 1)[1]] = importlib.import_module(m.name)
    return out


JAX = _modules(primme_tpu)


def _port(module):
    return importlib.import_module(
        "primme_tpu_torch." + MODULES.get(module, module))


def _own(mod):
    """The public functions and classes a module defines."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


def _members(cls):
    names = {k for k in vars(cls) if not k.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    names |= set(getattr(cls, "_fields", ()))
    return names


def _params(fn):
    return [name for name, q in inspect.signature(fn).parameters.items()
            if name != "self" and q.kind not in (q.VAR_POSITIONAL,
                                                  q.VAR_KEYWORD)]


_ENV = re.compile(r"""environ(?:\.get\(|\[)\s*["'](PTPU_\w+)["']""")


def _source(mod) -> str:
    with open(mod.__file__) as f:
        return f.read()


def _env_reads(mod):
    return set(_ENV.findall(_source(mod)))


def _surface():
    cases = []
    for name, mod in sorted(JAX.items()):
        for k, v in sorted(_own(mod).items()):
            cases.append(("name", name, k))
            if inspect.isclass(v):
                cases += [("member", name, k, m) for m in sorted(_members(v))]
        cases += [("env", name, e) for e in sorted(_env_reads(mod))]
    for name, fn in ENTRY_POINTS:
        cases += [("param", name, fn, a)
                  for a in _params(getattr(JAX[name], fn))]
    for k in primme_tpu.__all__:
        v = getattr(primme_tpu, k)
        if inspect.isclass(v) and not issubclass(v, BaseException):
            mod = v.__module__.split(".", 1)[1]
            cases += [("param", mod, k, a) for a in _params(v)]
    return cases


SURFACE = _surface()


def _present(case) -> bool:
    """Whether the port has the item ``case`` names."""
    kind, module = case[0], case[1]
    port = _port(module)
    if kind == "name":
        return hasattr(port, case[2])
    if kind == "env":
        return case[2] in _env_reads(port)
    if kind == "option":
        return f'"{case[2]}"' in _source(port)
    obj = getattr(port, case[2], None)
    if obj is None:
        return False
    if kind == "member":
        return case[3] in _members(obj) or hasattr(obj, case[3])
    return case[3] in _params(obj)          # "param"


def _id(case):
    return ":".join(case)


@pytest.mark.parametrize("case", SURFACE, ids=_id)
def test_port_has_counterpart(case):
    if case in EXCLUDED:
        other, reason = EXCLUDED[case]
        assert reason
        if other is None:
            assert not _present(case), \
                f"{_id(case)} is in the port now: drop its exclusion"
            return
        assert _present(other), f"{_id(case)}: no {_id(other)} in the port"
        return
    assert _present(case), f"no counterpart of primme_tpu {_id(case)}"


@pytest.mark.parametrize("case", sorted(EXCLUDED), ids=_id)
def test_exclusion_names_jax_surface(case):
    # every exclusion names a real item of the JAX package and says why
    assert case in SURFACE, f"{_id(case)} is not on primme_tpu's surface"
    assert len(EXCLUDED[case][1]) > 20


def test_surface_walk_sees_the_new_names():
    # the items this walk holds the port to include the last ones ported
    want = {("member", "operators", "LinearOperator", "to_dense"),
            ("member", "operators", "DenseOperator", "to_dense"),
            ("member", "operators", "ELLOperator", "from_coo"),
            ("param", "core.solver", "solve_eigs", "debug"),
            ("param", "core.solver", "solve_eigs", "key"),
            ("env", "core.solver", "PTPU_PROBE_ITERS"),
            ("env", "core.solver", "PTPU_PROBE_DEBUG")}
    assert want <= set(SURFACE)
