"""The paged decode attention kernel's share of its roofline over the
traced decode steps: the least time their attention needs (each row's
resident K and V read once, at most a window of it; q read, o written;
QK and PV FLOPs) at the card's peaks, over the device time of the
kernels whose names hold these patterns, in percent."""
from bench.lib.readers import roofline

LAYER = "kernels/tda decode"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "device_trace"
PATTERNS = ("pagedaddr",)


def read(run):
    return roofline(run, "decode", "attn", PATTERNS)
