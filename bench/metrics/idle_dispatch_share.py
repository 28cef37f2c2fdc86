"""Share of the traced window in which no device operation ran while the
host was in a dispatch's ``upload``, ``model`` or ``choose`` span, in
percent: the device waiting on the host to enqueue its work. None where
the trace holds no device operation."""
from bench.lib import program_spans

LAYER = "device"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace["kernels"]:
        return None
    idle = program_spans.idle_by_span(run)
    if idle is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in program_spans.ENQUEUE) \
        / run.trace["window_s"]
