"""Model FLOPs of the window's prefill iterations over their wall time, as a share of 989 TFLOP/s."""
from pbcore import readings

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "ttft_p50_s"
BETTER = "higher"


def read(o):
    return readings.mfu(o, ('prefill',))
