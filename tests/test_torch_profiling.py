"""``primme_tpu_torch.profiling`` and ``eigsh(profile=, time_breakdown=)``
on the CPU.

* ``tests/test_eigsh.py::test_profile_event_stream``'s assertions in the
  port: the regex selects phase scopes, each reaches the monitor as a
  profile event (7) with ``msg``/``time`` and ``stats["profile"]`` holds
  the same table; a regex that matches nothing selects nothing.
* On the CPU there is no device trace: ``measure_breakdown`` returns
  ``{}`` and the estimate of ``time_breakdown`` stands in, labelled
  ``"estimated"``, never ``"measured"``; its keys are the JAX package's
  ``time_breakdown``'s on the same matrix and counters.
* The solver's phases are tagged: a CPU trace of a preconditioned JDQMR
  solve holds the four scopes, and the operator's products run inside
  ``pt_matvec``; with no profiler running a scope is a no-op.
* The attribution rule (:func:`breakdown_from_events`) on a synthetic
  event list: a device event counts once, for the innermost scope whose
  device-side span holds it; the spans themselves and host events are
  not counted; device time outside the scopes is ``other``; busy is the
  union of the device intervals.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch import profiling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(n=400):
    # test_profile_event_stream's matrix
    return sp.diags([np.linspace(1, 40, n), 0.4 * np.ones(n - 1),
                     0.4 * np.ones(n - 1)], [0, 1, -1]).tocsr()


def test_profile_event_stream():
    A = _matrix()
    events = []

    def mon(event, *args, msg=None, time=None, **kw):
        if int(event) == 7:
            events.append((msg, time))

    _, _, st = ptt.eigsh(A, k=4, which="SA", tol=1e-8, jacobi=True,
                         return_stats=True, monitor=mon,
                         profile=r"matvec|ortho", device="cpu")
    names = {m for m, _ in events}
    assert names == {"pt_matvec", "pt_ortho"}, names
    assert set(st["profile"]) == {"pt_matvec", "pt_ortho"}
    assert all(t >= 0.0 for _, t in events)
    assert dict(events) == st["profile"]
    # no device trace on the CPU: the estimate, labelled as one
    assert st["time_source"] == "estimated"
    _, _, st2 = ptt.eigsh(A, k=4, which="SA", tol=1e-8, return_stats=True,
                          profile=r"nomatch_xyz", device="cpu")
    assert st2["profile"] == {}


def test_profile_events_reach_only_monitors_that_take_them():
    A = _matrix()
    plain = []

    def mon_plain(event, num_outer, num_matvecs, num_locked, num_converged,
                  basis_size, num_inner, hvals, resnorms):
        plain.append(int(event))

    ptt.eigsh(A, k=2, which="SA", tol=1e-6, monitor=mon_plain,
              profile="pt_", device="cpu")
    assert plain and 7 not in plain

    def mon_raises(event, *a, msg=None, time=None, **kw):
        if int(event) == 7:
            raise KeyError("raised inside the monitor")

    with pytest.raises(KeyError, match="inside the monitor"):
        ptt.eigsh(A, k=2, which="SA", tol=1e-6, monitor=mon_raises,
                  profile="pt_", device="cpu")


def test_time_breakdown_estimate_on_the_cpu():
    A = _matrix()
    _, _, st = ptt.eigsh(A, k=4, which="SA", tol=1e-8, jacobi=True,
                         return_stats=True, time_breakdown=True,
                         device="cpu")
    for key in ("time_matvec", "time_precond", "time_ortho", "time_dense",
                "time_other", "time_global_sum", "time_broadcast"):
        assert st[key] >= 0.0, key
    assert st["time_precond"] > 0.0
    assert st["time_source"] == "estimated"
    # a solve on the CPU is not re-run under the profiler at all
    calls = []
    assert profiling.measure_breakdown(lambda: calls.append(1),
                                       device="cpu") == {}
    assert calls == []


def test_time_breakdown_keys_match_the_reference():
    import jax.numpy as jnp
    from primme_tpu import profiling as jprof
    from primme_tpu.operators import aslinearoperator as jas

    A = _matrix(200)
    stats = {"num_matvecs": 300, "num_preconds": 0,
             "num_outer_iterations": 100, "num_restarts": 5,
             "elapsed_time": 10.0}
    kw = dict(mmax=16, blk=2, cwin=6)
    t = profiling.time_breakdown(ptt.aslinearoperator(A), None, stats,
                                 dtype=torch.float64, **kw)
    j = jprof.time_breakdown(jas(A), None, stats, dtype=jnp.float64, **kw)
    assert set(t) == set(j)
    for out in (t, j):
        assert out["time_precond"] == 0.0
        parts = sum(out[k] for k in ("time_matvec", "time_ortho",
                                     "time_dense"))
        assert out["time_other"] == pytest.approx(max(0.0, 10.0 - parts))


def test_solver_phases_are_tagged():
    A = ptt.aslinearoperator(_matrix(300))
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.set_method(ptt.Method.JDQMR,
                       ptt.PrimmeParams(n=300, num_evals=3, eps=1e-8),
                       has_precond=True)
    from primme_tpu_torch.core.inner import jdqmr_inner_solve
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ptt.solve_eigs(A, p, K=K, inner_solve=jdqmr_inner_solve)
    evs = prof.events()
    names = {e.name for e in evs}
    assert {"pt_matvec", "pt_precond", "pt_ortho", "pt_dense"} <= names
    # every dense product of the operator runs inside pt_matvec (the
    # DenseOperator's matmat is one aten::mm under the scope)
    for e in evs:
        if e.name == "pt_matvec":
            assert any(c.name in ("aten::mm", "aten::matmul")
                       for c in e.cpu_children), e


def test_phase_scopes_open_only_under_a_profiler():
    import contextlib

    from primme_tpu_torch.core.linalg import scope
    # no profiler: the scope is a no-op, so an untraced solve pays nothing
    assert isinstance(scope("pt_matvec"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with scope("pt_matvec"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("pt_matvec") == 1
    assert isinstance(scope("pt_matvec"), contextlib.nullcontext)


def _ev(name, device=False, span=(0.0, 0.0), annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=span[0], end=span[1]),
        is_user_annotation=annotation)


def test_breakdown_from_events_attribution():
    # host events (the scopes' own host spans among them) count for
    # nothing; each device event goes to the innermost device-side span
    # holding it, whatever launched it (the stencil from the extension's
    # own code, the GEMM from torch's)
    host = [_ev("pt_matvec", span=(0.0, 30.0), annotation=True),
            _ev("aten::mm", span=(9.0, 10.0))]
    dev = [_ev("stencil3d_kernel", device=True, span=(0.0, 5.0)),
           _ev("jacobi_kernel", device=True, span=(5.0, 8.0)),
           _ev("sgemm", device=True, span=(10.0, 17.0)),
           _ev("potrf", device=True, span=(17.0, 19.0)),
           _ev("add", device=True, span=(19.0, 20.0)),
           _ev("Memcpy HtoD", device=True, span=(21.0, 23.0)),
           _ev("stencil3d_kernel", device=True, span=(24.0, 26.0)),
           # another user annotation on the device track: not device time
           _ev("ProfilerStep#1", device=True, span=(0.0, 30.0),
               annotation=True)]
    spans = [_ev("pt_matvec", device=True, span=(0.0, 8.0), annotation=True),
             _ev("pt_precond", device=True, span=(5.0, 8.0),
                 annotation=True),
             _ev("pt_dense", device=True, span=(10.0, 17.0),
                 annotation=True),
             _ev("pt_ortho", device=True, span=(17.0, 19.0),
                 annotation=True),
             _ev("pt_matvec", device=True, span=(24.0, 26.0),
                 annotation=True)]
    br = profiling.breakdown_from_events(host + dev + spans)
    assert br["buckets_us"] == {"pt_matvec": 7.0, "pt_precond": 3.0,
                                "pt_ortho": 2.0, "pt_dense": 7.0}
    assert br["other_us"] == 3.0
    assert br["busy_us"] == 22.0 == br["total_us"]
    assert br["kernels_us"]["stencil3d_kernel"] == 7.0
    total = sum(br["buckets_us"].values()) + br["other_us"]
    assert total == br["busy_us"]
    # no device event: no breakdown
    assert profiling.breakdown_from_events(host + spans) == {}
