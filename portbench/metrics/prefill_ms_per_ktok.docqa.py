"""TraceBuffer prefill time of the window over its prompt tokens, ms a thousand tokens."""
from pbcore import readings

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_s"
BETTER = "lower"


def read(o):
    return readings.prefill_ms_per_ktok(o)
