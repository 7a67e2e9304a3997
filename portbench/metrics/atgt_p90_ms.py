"""90th percentile over every request that arrived in the window of its average time between tokens as the client saw them, in ms."""
from pbcore import readings

LAYER = "service"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    p90 = readings.percentile(readings.atgts(o), 90)
    return None if p90 is None else 1e3 * p90
