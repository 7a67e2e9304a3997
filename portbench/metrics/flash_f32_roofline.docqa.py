"""B2 fp32 route's least time from each chunk's rows and context (989 TFLOP/s, 3.35 TB/s) over its device time, in the traced span."""
from pbcore import readings

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p50_s"
BETTER = "higher"


def read(o):
    return readings.flash_f32_roofline(o)
