"""The span arithmetic of ``lib/spans.py`` on synthetic tuples, and the
per-layer readers of the program's spans on a synthetic traced run."""

import pytest

import run
from lib import spans as S


def test_idle_inside_nested_and_overlapping_spans():
    ev = [("k", 0, 2), ("k", 1, 3), ("m", 5, 6), ("k", 9, 12)]
    # nested and overlapping spans count their union once: [0, 8]
    sp = [(0, 8), (1, 2), (4, 7)]
    assert S.idle_inside_us(ev, sp, 0, 100) == pytest.approx(8 - 3 - 1)
    # two disjoint spans: [2, 6] holds busy [2, 3] and [5, 6]
    assert S.idle_inside_us(ev, [(2, 4), (4.5, 6)], 0, 100) == \
        pytest.approx(3.5 - 2)
    assert S.idle_inside_us([], [(1, 4)], 0, 100) == pytest.approx(3)


def test_idle_inside_spans_clipped_to_the_window():
    ev = [("k", 0, 2), ("k", 9, 12)]
    # the span [-5, 20] clipped to [1, 10]: busy [1, 2] and [9, 10]
    assert S.idle_inside_us(ev, [(-5, 20)], 1, 10) == pytest.approx(7)
    assert S.idle_inside_us(ev, [(20, 30)], 1, 10) == 0


def test_overlap_of_interval_lists():
    assert S.overlap_us([(0, 3), (5, 8)], [(2, 6), (7, 9)]) == \
        pytest.approx(1 + 1 + 1)
    assert S.overlap_us([], [(0, 1)]) == 0


def test_counts_inside_an_ancestor_span():
    sp = [("pt_eigsh", 0, 10), ("pt_read", 1, 2), ("pt_read", 9, 10),
          ("pt_read", 9.5, 11), ("pt_refine", 12, 20), ("pt_read", 13, 14),
          ("pt_read", 30, 31)]
    reads = S.of(sp, "pt_read")
    assert S.inside(reads, S.of(sp, "pt_eigsh")) == [(1, 2), (9, 10)]
    assert S.inside(reads, S.of(sp, "pt_refine")) == [(13, 14)]
    assert S.inside(reads, []) == []


def traced_run(host, dev=(), calls=2):
    return {"calls": [{}] * calls,
            "trace": {"device": list(dev), "device_scopes": [],
                      "host_spans": list(host), "kinds": {}},
            "stencil_calls": [], "window_us": (0.0, 100.0),
            "kind": "NVIDIA H100 80GB HBM3"}


HOST = [("bench.call", 0, 100), ("pt_eigsh", 0, 40), ("pt_inner", 10, 20),
        ("pt_read", 5, 6), ("pt_read", 15, 16), ("pt_refine", 40, 90),
        ("pt_read", 50, 51), ("pt_to_host", 80, 90), ("pt_read", 80, 85)]
DEV = [("k", 0, 10), ("k", 12, 14), ("k", 40, 70), ("copy", 85, 86)]


@pytest.mark.parametrize("name, value", [
    ("solver.host_reads", 1.0), ("refine.host_reads", 1.0),
    ("solver.idle_ms", (40 - 12) / 2e3), ("inner.idle_ms", 8 / 2e3),
    ("job.refine.idle_ms", (50 - 31) / 2e3),
    ("refine.idle_ms", (50 - 31) / 2e3), ("refine.to_host_ms", 10 / 2e3)])
def test_span_readers_on_a_synthetic_run(name, value):
    assert run.metric_reader(name)(traced_run(HOST, DEV)) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", [
    "solver.host_reads", "refine.host_reads", "solver.idle_ms",
    "inner.idle_ms", "job.refine.idle_ms", "refine.idle_ms",
    "refine.to_host_ms"])
def test_span_readers_find_nothing_without_the_spans(name):
    """A program without the spans (its harness's own spans only) reads
    as nothing, not as zero."""
    bare = [("bench.call", 0, 100), ("bench.eigsh", 0, 40),
            ("bench.refine_eigsh", 40, 90), ("pt_matvec", 1, 2)]
    assert run.metric_reader(name)(traced_run(bare, DEV)) is None
    assert run.metric_reader(name)(traced_run([], [])) is None
