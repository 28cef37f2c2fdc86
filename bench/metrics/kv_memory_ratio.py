"""Pages of the K/V pool in use over the pool's pages, averaged over the
window's steps, in percent (the pool's counters, read before each step's
device call, where the engine counts its own ``kv_memory_ratio``)."""
from bench.lib.readers import mean, window_steps

LAYER = "serve/pages.py PagePool"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "program_counter"


def read(run):
    return mean(100.0 * s.pages_in_use / s.pages_total
                for s in window_steps(run) if s.pages_total)
