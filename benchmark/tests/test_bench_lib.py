"""The metric arithmetic on synthetic events and shapes, and the
per-layer readers on a synthetic traced run."""

import pytest

import run
from lib import cost
from lib import trace as T


def test_union_and_merged():
    spans = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 10.5)]
    assert T.merged(spans) == [(0, 3), (5, 7), (10, 10.5)]
    assert T.union_us(spans) == pytest.approx(5.5)
    assert T.union_us([]) == 0


def test_busy_and_gaps_inside_a_window():
    ev = [("k", 0, 2), ("k", 1, 3), ("m", 5, 6), ("k", 9, 12)]
    assert T.busy_us(ev, 1, 10) == pytest.approx(2 + 1 + 1)
    assert T.gaps(ev, 1, 10) == [(3, 5), (6, 9)]
    assert T.gaps(ev, -2, 14) == [(-2, 0), (3, 5), (6, 9), (12, 14)]
    assert T.gaps([], 0, 4) == [(0, 4)]


def test_innermost_scope_takes_nested_kernels():
    ann = [("pt_dense", 0, 100), ("pt_ortho", 10, 40), ("pt_matvec", 20, 30)]
    ev = [("gemm", 11, 15), ("stencil", 21, 25), ("add", 45, 50),
          ("copy", 150, 160)]
    assert T.innermost(ann, [(e[1], e[2]) for e in ev]) == \
        ["pt_ortho", "pt_matvec", "pt_dense", None]
    assert T.scope_us(ev, ann, "pt_ortho") == pytest.approx(4)
    assert T.scope_us(ev, ann, "pt_dense") == pytest.approx(5)
    assert T.scope_us(ev, ann, "pt_precond") == 0


def test_device_ops_and_idle_by_host_span():
    ev = [("a", 0, 10), ("b", 10, 12), ("a", 20, 25), ("c", 30, 31)]
    assert T.device_ops(ev, top=2) == [["a", pytest.approx(15e-6)],
                                       ["b", pytest.approx(2e-6)]]
    host = [("bench.eigsh", 0, 40), ("pt_dense", 12, 19),
            ("bench.refine_eigsh", 40, 60)]
    got = dict(T.idle_by_host_span(ev, host, 0, 50))
    assert got["pt_dense"] == pytest.approx(8e-6)       # gap 12-20
    assert got["bench.eigsh"] == pytest.approx(5e-6)    # gap 25-30
    assert got["bench.refine_eigsh"] == pytest.approx(19e-6)  # 31-50
    assert dict(T.idle_by_host_span(ev, [], 0, 50)) == \
        {"(no span)": pytest.approx(32e-6)}


def test_stencil_bytes_flops_and_bound():
    n = 128 ** 3
    assert cost.stencil7_bytes(n, 10, 8) == 2 * n * 10 * 8
    assert cost.stencil7_flops(n, 10) == 8 * n * 10
    t, by = cost.least_seconds(cost.stencil7_bytes(n, 10, 8),
                               cost.stencil7_flops(n, 10), cost.H100_SXM,
                               "float64")
    assert by == "bytes"
    assert t == pytest.approx(2 * n * 10 * 8 / 3.35e12)
    t, by = cost.least_seconds(1.0, 1e9, cost.H100_SXM, "float64")
    assert by == "flops" and t == pytest.approx(1e9 / 34e12)


def test_stencil_roofline_share():
    n = 128 ** 3
    launches = [(n, 10, 8), (n, 30, 8)]
    least = (2 * n * 40 * 8) / 3.35e12
    share, by = cost.stencil7_roofline(launches, 2 * least, cost.H100_SXM,
                                       "float64")
    assert share == pytest.approx(50.0) and by == "bytes"
    assert cost.stencil7_roofline([], 1.0, cost.H100_SXM, "float64") is None
    assert cost.stencil7_roofline(launches, 0.0, cost.H100_SXM,
                                  "float64") is None
    assert cost.stencil7_roofline(launches, 1.0, None, "float64") is None


def synthetic_run(kind="NVIDIA H100 80GB HBM3"):
    n = 128 ** 3
    k10 = 2 * n * 10 * 8 / 3.35e12 * 1e6       # least us of a k=10 launch
    dev = [("void (anonymous namespace)::stencil3d_kernel<double, 2, 2>"
            "(double const*, ...)", 100, 100 + 4 * k10),
           ("sm90_xmma_gemm_f64", 2000, 2100),
           ("void stencil3d_kernel<float, 2, 2>(float const*)", 3000, 3010)]
    return {"calls": [{"matvecs": 2800, "refine_iters": 80,
                       "polish_s": 2.0},
                      {"matvecs": 2900, "refine_iters": 78,
                       "polish_s": 2.2}],
            "trace": {"device": dev,
                      "device_scopes": [("pt_ortho", 1990, 2200)],
                      "host_spans": [], "kinds": {}},
            "stencil_calls": [("stencil3d_float64", n, 10, 8),
                              ("stencil3d_float32", n, 2, 4)],
            "window_us": (0.0, 10000.0), "kind": kind}


@pytest.mark.parametrize("name, value", [
    ("solver.matvecs", 2850.0), ("refine.iterations", 79.0),
    ("refine.polish_s", 2.1), ("linalg.ortho_ms", 0.05),
    ("stencil3d_f64_roofline", 25.0), ("job.refine.iterations", 79.0),
    ("job.stencil3d_f64_roofline", 25.0)])
def test_readers_on_a_synthetic_run(name, value):
    assert run.metric_reader(name)(synthetic_run()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["device.idle_share",
                                  "job.device.idle_share"])
def test_idle_share_reader(name):
    r = synthetic_run()
    busy = T.busy_us(r["trace"]["device"], 0, 10000)
    assert run.metric_reader(name)(r) == \
        pytest.approx(100 * (1 - busy / 10000))


@pytest.mark.parametrize("name", [
    "solver.matvecs", "refine.iterations", "refine.polish_s",
    "linalg.ortho_ms", "stencil3d_f64_roofline", "device.idle_share",
    "job.refine.iterations", "job.stencil3d_f64_roofline",
    "job.device.idle_share"])
def test_readers_find_nothing_to_read(name):
    empty = {"calls": [], "trace": {"device": [], "device_scopes": [],
                                    "host_spans": [], "kinds": {}},
             "stencil_calls": [], "window_us": (None, None),
             "kind": "NVIDIA H100 80GB HBM3"}
    assert run.metric_reader(name)(empty) is None


def test_roofline_reader_needs_a_known_card():
    assert run.metric_reader("stencil3d_f64_roofline")(
        synthetic_run(kind="some other card")) is None


@pytest.mark.parametrize("k, beyond", [(4, 10), (10, 30)])
def test_polish_block_sits_at_the_stated_residual(k, beyond):
    """The polish job's input: each column's residual is the workload's
    ``residual`` times ||A|| (to float32 rounding), and seeds change the
    columns' signs alone, so the work stays; another error stream changes
    the errors."""
    import torch

    from lib import find
    from reference import eigenpairs, laplacian7

    polish = find.module("jobs", "polish")
    cfg = {"grid": [10, 9, 8], "k": k}
    spec = {"modes_beyond": beyond, "residual": 1e-5, "error_stream": 0}
    lam = torch.as_tensor(laplacian7.smallest(cfg, k))
    anorm = laplacian7.norm(cfg)
    blocks = [polish.block(laplacian7, cfg, spec, s, "cpu")
              for s in (1, 2 ** 33 + 5, -4)]
    for X in blocks:
        assert X.dtype == torch.float64
        assert torch.equal(X, X.to(torch.float32).to(torch.float64))
        Xn = X / torch.linalg.vector_norm(X, dim=0)
        res = eigenpairs.residual_norms(laplacian7, cfg, Xn, lam) / anorm
        assert float(res.max()) < 1.2e-5 and float(res.min()) > 0.8e-5
    signs = [torch.sign((blocks[0] * X).sum(dim=0)) for X in blocks[1:]]
    for X, d in zip(blocks[1:], signs):
        assert torch.equal(X, blocks[0] * d[None, :])
    assert any(bool((d < 0).any()) for d in signs)
    other = polish.block(laplacian7, cfg, dict(spec, error_stream=1), 1,
                         "cpu")
    assert not torch.equal(other.abs(), blocks[0].abs())
