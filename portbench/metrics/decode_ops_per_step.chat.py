"""Device operations starting between a decode step's launch start and wait end, over the traced span's decode steps."""
from pbcore import progspans

LAYER = "engine"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.decode_ops_per_step(o)
