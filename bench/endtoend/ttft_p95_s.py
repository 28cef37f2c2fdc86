"""The 95th percentile over every request due in the window of the time
from when the open loop had it due (not from its submit) to its first
token; a request that failed, was refused or never got a first token
counts with its wait until it ended or the drain gave up."""
import numpy as np

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    w = run.window
    if run.mix.loop != "open":
        return None
    end = max([s.t_end for s in w.steps] + [w.t_last])
    ttft = []
    for r in w.reqs.values():
        if not w.t0 <= r.due < w.t_close:
            continue
        first = r.times[0] if r.times else (r.finished or end)
        ttft.append(first - r.due)
    return float(np.percentile(ttft, 95)) if ttft else None
