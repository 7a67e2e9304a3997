"""Process start to the window's first due arrival: imports, the kernel library, the weights, the cluster (and its fp32 copy) and the warm-up trace."""

LAYER = "service"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(o):
    return o.setup_s
