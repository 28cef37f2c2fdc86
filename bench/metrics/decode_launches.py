"""Device operations (kernels, copies, sets) that start inside a traced
decode ``dispatch`` span, per traced decode step: what the whole decode
dispatch asks of the device, one launch at a time (the ``upload`` copies,
the model's kernels, the sampler's and the ``sync`` copy; the card runs
behind the host, so a start time cannot tell the model's share from the
rest). None where the trace holds no device operation (no device ran the
window)."""
import bisect

from bench.lib import program_spans

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "output_tok_s"
UNIT = "launches"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace["kernels"]:
        return None
    w = program_spans.window(run, traced=True)
    if w is None:
        return None
    ds = program_spans.dispatches(w[2], "decode", w[0], w[1])
    if not ds:
        return None
    starts = sorted(a for _, a, _ in run.trace["kernels"])
    return sum(bisect.bisect_right(starts, d.end_ns * 1e-9)
               - bisect.bisect_left(starts, d.start_ns * 1e-9)
               for d in ds) / len(ds)
