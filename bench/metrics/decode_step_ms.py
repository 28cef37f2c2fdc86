"""Mean host wall of the window's decode steps: the engine's device call
``_run_decode`` to its host sync (the engine's own ``step_ms["decode"]``),
sum over count."""
from bench.lib.readers import mean, window_steps

LAYER = "serve/engine.py step to models/transformer.py"
MOVES = "output_tok_s"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    return mean(s.run_ms for s in window_steps(run, "decode"))
