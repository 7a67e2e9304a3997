"""B1's least time (its live keys' K and V at 3.35 TB/s) over its device time, for the traced span's decode iterations."""
from pbcore import readings

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "atgt_p90_ms"
BETTER = "higher"


def read(o):
    return readings.paged_decode_roofline(o)
