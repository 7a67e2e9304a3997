"""Model FLOPs of the window's decode iterations over their wall time, as a share of 989 TFLOP/s."""
from pbcore import readings

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "higher"


def read(o):
    return readings.mfu(o, ('decode',))
