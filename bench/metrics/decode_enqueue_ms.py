"""Mean host time a decode step spends enqueueing its work: the
``upload``, ``model`` and ``choose`` spans inside each of the window's
decode ``dispatch`` spans, summed per step, in ms. The rest of the
dispatch is the host's wait in ``sync``."""
from bench.lib import program_spans
from bench.lib.readers import mean

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "output_tok_s"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    lo, hi, spans = w
    kids = program_spans.children(spans)
    return mean(sum(c.end_ns - c.start_ns for c in kids.get(d.sid, ())
                    if c.name in program_spans.ENQUEUE) * 1e-6
                for d in program_spans.dispatches(spans, "decode", lo, hi))
