"""Median host ms from a window request's submission to its placement (the program's request.submit and request.placed instants)."""
from pbcore import progspans

LAYER = "control plane"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_s"
BETTER = "lower"


def read(o):
    return progspans.median_wait_ms(o, 0, 1)
