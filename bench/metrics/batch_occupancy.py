"""Rows emitting in each decode step of the window over the engine's rows
(``num_slots``), averaged over the steps, in percent: how full the
admission keeps the batch."""
from bench.lib.readers import mean, window_steps

LAYER = "serve/scheduler.py and Engine admission"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "program_counter"


def read(run):
    return mean(100.0 * len(s.n_new) / s.slots
                for s in window_steps(run, "decode"))
