"""The program's spans and its count of host reads, on the CPU.

``eigsh`` and ``refine_eigsh`` open their layer spans (``pt_eigsh``,
``pt_init``, ``pt_outer``, ``pt_window``, ``pt_inner``, ``pt_probe``,
``pt_restart``, ``pt_refine``, ``pt_anorm``, ``pt_refine_step``,
``pt_to_host``) and a ``pt_read`` at every wait for the card, only while a
profiler records (``core.linalg.scope`` and ``host_read``); the reads are
counted with or without one and returned as ``stats["num_host_reads"]``.
Tracing changes no result: the values, vectors and every other stat are
bit for bit those of the untraced call. The problem is the north star's
two stages at 8^3 (n = 512): the f32 JDQMR_ETol solve with the Jacobi
preconditioner and the spectrum probe, then the f64 LOBPCG polish with
Chebyshev(8). ``test_torch_tracing_cuda.py`` checks on the card that the
count misses no synchronisation."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import primme_tpu_torch as ptt
from primme_tpu_torch import profiling
from primme_tpu_torch.core import linalg as L

SOLVER_SPANS = {"pt_eigsh", "pt_init", "pt_outer", "pt_window", "pt_inner",
                "pt_probe", "pt_restart", "pt_read", "pt_to_host"}
REFINE_SPANS = {"pt_refine", "pt_anorm", "pt_refine_step", "pt_read",
                "pt_to_host", "pt_matvec", "pt_ortho", "pt_precond"}


def _stages():
    """Both stages of the 8^3 north star, each returning its results."""
    A32 = ptt.Stencil3DOperator(8, 8, 8, dtype=torch.float32, device="cpu")
    A64 = ptt.Stencil3DOperator(8, 8, 8, dtype=torch.float64, device="cpu")
    K32 = ptt.JacobiPrecond(A32.diagonal())
    K64 = ptt.ChebyshevPrecond.from_operator(A64, degree=8)
    v0 = np.random.default_rng(0).standard_normal((512, 2)).astype(
        np.float32)

    def f32():
        return ptt.eigsh(A32, k=4, which="SA", v0=v0, tol=1e-5, OPinv=K32,
                         method="JDQMR_ETol", ncv=24, maxBlockSize=2,
                         minRestartSize=8, locking=False, return_stats=True,
                         device="cpu")

    def f64(X):
        return ptt.refine_eigsh(A64, X, tol=1e-10, OPinv=K64, maxiter=200,
                                return_stats=True, device="cpu")
    return f32, f64


def _spans(prof):
    """The profiler's user annotations as ``(name, start_ns, end_ns)``."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


@pytest.fixture(scope="module")
def runs():
    """Each stage traced and untraced, with the untraced calls' opened
    profiler ranges counted: ``{"eigsh"|"refine": (traced, plain,
    spans)}``, a run being the stage's ``(values, vectors, stats)``."""
    f32, f64 = _stages()
    opened = []
    real = L.record_function
    L.record_function = lambda name: opened.append(name) or real(name)
    try:
        plain = f32()
        plain_r = f64(plain[1])
    finally:
        L.record_function = real
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = f32()
    spans = _spans(prof)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced_r = f64(plain[1])
    return {"eigsh": (traced, plain, spans),
            "refine": (traced_r, plain_r, _spans(prof))}


@pytest.mark.parametrize("stage, outer, want", [
    ("eigsh", "pt_eigsh", SOLVER_SPANS), ("refine", "pt_refine",
                                          REFINE_SPANS)])
def test_spans_open_under_a_profiler(runs, stage, outer, want):
    _, _, spans = runs[stage]
    assert want <= {s[0] for s in spans}
    (top,) = [s for s in spans if s[0] == outer]
    reads = [s for s in spans if s[0] == "pt_read"]
    assert reads and all(top[1] <= a and b <= top[2] for _, a, b in reads)


@pytest.mark.parametrize("stage", ["eigsh", "refine"])
def test_span_counts_match_the_stats(runs, stage):
    (_, _, st), _, spans = runs[stage]
    names = [s[0] for s in spans]
    assert names.count("pt_read") == st["num_host_reads"] > 0
    if stage == "refine":
        assert names.count("pt_refine_step") == st["num_refine_iters"]
        assert names.count("pt_anorm") == 1
    else:
        # an outer iteration expands the basis (num_outer_iterations) or
        # restarts it, and the last one finds the set converged
        assert st["num_probe_rounds"] > 0 and st["num_restarts"] > 0
        assert names.count("pt_outer") == (st["num_outer_iterations"]
                                           + st["num_restarts"] + 1)
        assert names.count("pt_probe") == st["num_probe_rounds"]
        assert names.count("pt_restart") == (st["num_restarts"]
                                             + st["num_resets"])
        assert names.count("pt_eigsh") == names.count("pt_init") == 1


@pytest.mark.parametrize("stage", ["eigsh", "refine"])
def test_tracing_changes_no_result(runs, stage):
    traced, plain, _ = runs[stage]
    for a, b in zip(traced[:2], plain[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ts, ps = (dict(r[2]) for r in (traced, plain))
    ts.pop("elapsed_time", None)
    ps.pop("elapsed_time", None)
    assert ts.keys() == ps.keys()
    for key in ts:
        assert np.array_equal(ts[key], ps[key]), key


def test_host_read_counts_and_returns():
    from primme_tpu_torch.core.linalg import host_read, host_reads
    t = torch.arange(5.0)
    n0 = host_reads()
    assert host_read(float, t.sum()) == 10.0
    assert host_read(torch.Tensor.tolist, t[:2]) == [0.0, 1.0]
    assert host_read(t.to, dtype=torch.float64).dtype == torch.float64
    assert host_reads() - n0 == 3


@pytest.mark.parametrize("extra", [[], ["pt_eigsh", "pt_outer", "pt_read"]])
def test_breakdown_buckets_ignore_the_layer_spans(extra):
    """``measure_breakdown``'s four phases keep their meaning with the
    layer spans open around and inside them: a kernel under ``pt_read``
    inside ``pt_ortho`` still counts for ``pt_ortho``."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, a, b, annotation=False):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=a, end=b),
                               is_user_annotation=annotation)
    dev = [ev("stencil3d_kernel", 0.0, 5.0), ev("sgemm", 10.0, 17.0),
           ev("Memcpy DtoH", 17.0, 18.0), ev("add", 19.0, 20.0)]
    phases = [ev("pt_matvec", 0.0, 8.0, True), ev("pt_ortho", 10.0, 18.5,
                                                  True)]
    layer = {"pt_eigsh": (0.0, 30.0), "pt_outer": (9.0, 21.0),
             "pt_read": (16.5, 18.2)}
    spans = [ev(name, *layer[name], True) for name in extra]
    br = profiling.breakdown_from_events(dev + phases + spans)
    assert br["buckets_us"] == {"pt_matvec": 5.0, "pt_precond": 0.0,
                                "pt_ortho": 8.0, "pt_dense": 0.0}
    assert br["other_us"] == 1.0
