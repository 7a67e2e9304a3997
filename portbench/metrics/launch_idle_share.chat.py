"""Device-idle time inside the program's engine.decode.launch spans, as a share of the traced span (a part of idle_share.chat)."""
from pbcore import progspans

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.launch_idle_share(o)
