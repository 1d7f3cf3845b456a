"""On the card: a traced run at a small grid finds what the per-layer
readers read (the f64 stencil's kernels and shapes, the ``pt_ortho``
scope on the card's track, device time in the window). Skips where there
is no card."""

import pytest

from conftest import shrink


@pytest.mark.cuda
def test_traced_run_reads_the_card(card, spec):
    import run

    res = shrink(run.resolve(spec, "lap3d7_128_k10.northstar"),
                 grid=(32, 32, 32))
    out = run.run_cell(res, 2 ** 31 + 7, 1.0, True, card)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in ("solver.matvecs", "job.refine.iterations",
                 "refine.polish_s", "linalg.ortho_ms",
                 "job.stencil3d_f64_roofline", "job.device.idle_share"):
        assert name in m and m[name]["value"] > 0, (name, m)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_untraced_run_on_card(card, spec):
    import run

    res = shrink(run.resolve(spec, "lap3d7_128_k10.polish"),
                 grid=(32, 32, 32))
    out = run.run_cell(res, 2 ** 31 + 8, 1.0, False, card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"solve_s", "peak_mem_GiB", "setup_s"}
    assert out["metrics"]["peak_mem_GiB"]["value"] > 0
