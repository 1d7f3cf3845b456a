"""solve_s: seconds a call, the window (the first call's start to the last
call's end, on the host's clock) over the calls completed in it: all the
work and all the time, so a stall anywhere inside the calls counts."""


def read(run):
    return run["window_s"] / len(run["times"]) if run["times"] else None
