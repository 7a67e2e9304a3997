"""Mean TraceBuffer time of the window's decode iterations (every worker)."""
from pbcore import readings

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return readings.iter_ms(o, 'decode')
