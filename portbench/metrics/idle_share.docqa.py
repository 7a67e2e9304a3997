"""Share of the traced span in which no operation ran on the device."""
from pbcore import readings

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p50_s"
BETTER = "lower"


def read(o):
    return readings.idle_share(o)
