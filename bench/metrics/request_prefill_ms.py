"""Mean time from a slot's claim to the first token, over the requests
whose first token falls in the window: the program's ``prefill`` spans
that ended in a first token (the chunked prefill over mixed steps), in
ms."""
from bench.lib import program_spans
from bench.lib.readers import mean

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "ttft_p95_s"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    lo, hi, spans = w
    return mean((s.end_ns - s.start_ns) * 1e-6 for s in spans
                if s.name == "prefill" and lo <= s.end_ns <= hi
                and (s.attrs or {}).get("first") == 1)
