"""Mean columns a mixed step's linears ran over: the ``cols`` attribute of
the window's mixed ``dispatch`` spans (the step's fresh tokens where the
engine packs its live columns, ``num_slots x chunk`` where it runs every
one). The M that the DMM/SMM bodies and the GEMMs of a mixed step see.
Left out where the spans carry no ``cols``."""
from bench.lib import program_spans
from bench.lib.readers import mean

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "itl_p95_ms"
UNIT = "columns"
SOURCE = "program_span"


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    lo, hi, spans = w
    cols = [d.attrs.get("cols")
            for d in program_spans.dispatches(spans, "mixed", lo, hi)]
    if None in cols:
        return None
    return mean(cols)
