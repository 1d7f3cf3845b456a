"""northstar: each call is the whole north-star job of a PRIMME user's
script: ``eigsh`` in float32 (the configuration's ``f32_stage``) from a
start block, then ``refine_eigsh`` in float64 (its ``polish``) of the
returned vectors. The call starts with the start block on the card and
ends with the results on the host as numpy arrays.

Every call starts from one block, drawn from the workload file's fixed
stream ``f32_start``, with each column's sign drawn from ``(seed,
call)``. A sign is exact in floating point and every operation of the
solve rounds alike under it, so every seed and every call does the same
work on other inputs: the answers differ by their vectors' signs. (A
start drawn from the seed changed the f32 stage by up to 17% in matvecs
and the polish by 2x in iterations, which made the work follow the seed.)

Workload keys: ``f32_start``, ``warmup`` (``f32_matvecs``, the warm
f32 call's cap; ``polish_iters``, the warm polish's) and ``trace_calls``.
"""

from __future__ import annotations

import time

from lib import draw, stages
from lib.profile import span

CHECK = "eigenpairs"
WARM_INDEX = 2 ** 32      # the warm call's signs, apart from the calls'


class Job:
    """``setup()`` once, then ``call(i)`` back to back; ``call`` returns
    ``((evals, evecs), counters)``."""

    def __init__(self, ptt, prob, ref, cfg: dict, wl: dict, seed: int,
                 device, traced: bool = False):
        self.ptt, self.prob, self.cfg, self.wl = ptt, prob, cfg, wl
        self.seed, self.device, self.traced = seed, device, traced
        bs = cfg["f32_stage"]["maxBlockSize"]
        self.base = draw.normal(wl["f32_start"], 0, (prob.n, bs), device)
        self.v0 = None

    def start(self, index: int):
        """Call ``index``'s start block, on the device."""
        return self.base * draw.signs(self.seed, index, (self.base.shape[1],),
                                      self.device, self.base.dtype)

    def f32_stage(self, v0, **extra):
        return stages.f32_eigsh(self.ptt, self.prob, self.cfg,
                                v0.cpu().numpy(), self.device, **extra)

    def setup(self):
        """A capped f32 call and a capped polish: the cell's shapes."""
        warm = self.wl["warmup"]
        _, X, _ = self.f32_stage(self.start(WARM_INDEX),
                                 maxMatvecs=warm["f32_matvecs"],
                                 raise_for_unconverged=False)
        stages.polish(self.ptt, self.prob, self.cfg, X, self.device,
                      maxiter=warm["polish_iters"])
        self.next_input(0)

    def next_input(self, i: int):
        """Draw call ``i``'s start block (before the call starts)."""
        self.v0 = self.start(i)

    def polish_input(self):
        """The block call 0's polish starts from: the program's f32 stage
        from call 0's start block (for the control)."""
        return self.f32_stage(self.start(0))[1]

    def call(self, i: int):
        counters = {}
        with span("call", self.traced):
            with span("eigsh", self.traced):
                _, X, st = self.f32_stage(self.v0)
            counters["matvecs"] = st["num_matvecs"]
            t0 = time.perf_counter()
            with span("refine_eigsh", self.traced):
                ev, V, rst = stages.polish(self.ptt, self.prob, self.cfg, X,
                                           self.device)
            counters["polish_s"] = time.perf_counter() - t0
            counters["refine_iters"] = rst["num_refine_iters"]
        return (ev, V), counters
