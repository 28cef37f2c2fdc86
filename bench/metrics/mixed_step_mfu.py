"""The model FLOPs of the window's mixed steps (their fresh prompt tokens
and decode rows, counted as for ``step_mfu``) over those steps' host time
at the card's bf16 peak, in percent: the whole mixed step's share, which
bounds what a faster mixed kernel can give the time to first token."""
from bench.lib import counts
from bench.lib.readers import step_work, window_steps

LAYER = "models/transformer.py, the whole model step"
MOVES = "ttft_p95_s"
UNIT = "%"
SOURCE = "host_clock"


def read(run):
    steps = window_steps(run, "mixed")
    span = sum(s.t_end - s.t_start for s in steps)
    if not steps or span <= 0:
        return None
    flops = sum(step_work(run, s)["flops"] for s in steps)
    return 100.0 * flops / (span * counts.PEAKS["bf16_flops"])
