"""Process start to the first measured step: imports, the CUDA context,
the kernel build (a checkout's first run only), the weights drawn on the
device, the compression, the engine, and the warm-up of this cell's
shapes."""
UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
