"""Every output token emitted by the steps that started in the window,
over the window: its start to the end of the last such step."""
from bench.lib.readers import window_steps

UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    span = run.window.t_last - run.window.t0
    if span <= 0:
        return None
    return sum(s.emitted for s in window_steps(run)) / span
