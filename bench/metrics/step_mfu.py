"""The model FLOPs of the window's useful work (every emitting row, every
fresh prompt token: linears with a factorized W_D counted by its
non-zeros, attention over the keys each token sees, the head once a row a
step) over the window's host time at the card's bf16 peak, in percent."""
from bench.lib import counts
from bench.lib.readers import step_work, window_steps

LAYER = "models/transformer.py, the whole model step"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "host_clock"


def read(run):
    steps = window_steps(run)
    span = run.window.t_last - run.window.t0
    if not steps or span <= 0:
        return None
    flops = sum(step_work(run, s)["flops"] for s in steps)
    return 100.0 * flops / (span * counts.PEAKS["bf16_flops"])
