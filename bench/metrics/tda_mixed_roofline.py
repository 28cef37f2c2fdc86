"""The mixed attention kernel's share of its roofline over the traced
mixed steps: the least time the chunks' attention needs (the larger of the
FLOP bound and the byte bound: resident K and V read once, the chunk's q,
k, v read and o written) over the device time of the kernels whose names
hold these patterns, in percent."""
from bench.lib.readers import roofline

LAYER = "kernels/tda mixed"
MOVES = "ttft_p95_s"
UNIT = "%"
SOURCE = "device_trace"
PATTERNS = ("mixed_kernel", "mixed_tc_kernel")


def read(run):
    return roofline(run, "mixed", "attn", PATTERNS)
