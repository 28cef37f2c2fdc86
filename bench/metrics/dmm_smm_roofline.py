"""The compressed linears' share of their roofline over the traced steps:
for every linear of every layer, the larger of its FLOP bound (``2 M (K r
+ nnz N)``) and its byte bound (the compressed streams, the activations in
and out), over the device time of the DMM and SMM kernels, in percent."""
from bench.lib.readers import roofline

LAYER = "kernels/dmm and kernels/smm"
MOVES = "output_tok_s"
UNIT = "%"
SOURCE = "device_trace"
PATTERNS = ("dmm_kernel", "dmm_tc_kernel", "dmm_small_kernel", "sum_splits",
            "smm_kernel", "smm_small_kernel", "smm_tc_kernel")


def read(run):
    if not run.spec.factorized:
        return None
    return roofline(run, None, "linear", PATTERNS)
