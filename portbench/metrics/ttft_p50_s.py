"""Median time to first token over every request that arrived in the window, from its due time."""
from pbcore import readings

LAYER = "service"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "ttft_p50_s"
BETTER = "lower"


def read(o):
    return readings.percentile(readings.ttfts(o), 50)
