"""Mean host wall of the window's mixed steps: ``_run_mixed`` to its host
sync (the engine's own ``step_ms["mixed"]``), sum over count."""
from bench.lib.readers import mean, window_steps

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "itl_p95_ms"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    return mean(s.run_ms for s in window_steps(run, "mixed"))
