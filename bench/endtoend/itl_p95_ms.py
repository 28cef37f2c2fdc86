"""The 95th percentile over every gap between consecutive output tokens
of every request, both tokens emitted in the window, on the host clock
after each step's sync."""
import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    w = run.window
    gaps = []
    for r in w.reqs.values():
        t = [x for x in r.times if w.t0 <= x <= w.t_last]
        gaps.extend(b - a for a, b in zip(t, t[1:]))
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
