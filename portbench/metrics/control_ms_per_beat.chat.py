"""Mean host ms of a window heartbeat outside its engine steps (placement, re-balance, refits, hand-over), from the harness's spans."""
from pbcore import readings

LAYER = "control plane"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return readings.control_ms_per_beat(o)
