"""Share of the traced window in which no kernel ran on the device, in
percent: one minus the union of kernel intervals over the window."""
LAYER = "device"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
