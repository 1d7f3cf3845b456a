"""job_s: seconds a whole job (the f32 stage and the polish), the window
over the calls completed in it, as ``solve_s`` reads it; its own name so
that its bound is its own."""


def read(run):
    return run["window_s"] / len(run["times"]) if run["times"] else None
