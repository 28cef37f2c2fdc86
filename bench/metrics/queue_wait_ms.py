"""Mean wait of the requests claimed in the window between their submit
and the claim of a slot: the program's ``queued`` spans that a claim ended
(not a terminal status), in ms."""
from bench.lib import program_spans
from bench.lib.readers import mean

LAYER = "serve/scheduler.py and Engine admission"
MOVES = "ttft_p95_s"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    lo, hi, spans = w
    return mean((s.end_ns - s.start_ns) * 1e-6 for s in spans
                if s.name == "queued" and lo <= s.end_ns <= hi
                and "status" not in (s.attrs or {}))
