"""Median host ms from a window request's placement to the start of its prefill (the program's engine.prefill span)."""
from pbcore import progspans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_s"
BETTER = "lower"


def read(o):
    return progspans.median_wait_ms(o, 1, 2)
