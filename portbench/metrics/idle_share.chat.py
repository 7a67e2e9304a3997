"""Share of the traced span in which no operation ran on the device."""
from pbcore import readings

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return readings.idle_share(o)
