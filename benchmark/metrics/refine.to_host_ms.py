"""refine.to_host_ms: host milliseconds a traced call of the program's
pt_to_host span inside pt_refine: the polish's results copied to numpy
(values, the [n, k] f64 vectors, residuals), the wait for the card's last
work included; moves solve_s."""

from lib import spans


def read(run):
    return spans.host_ms_in(run, "pt_to_host", "pt_refine")
