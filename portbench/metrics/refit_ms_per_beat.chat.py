"""Host ms of the program's cluster.refit spans (Eqs. 1-3 refits, one a worker) over the window's heartbeats."""
from pbcore import progspans

LAYER = "control plane"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.per_beat_ms(o, ('cluster.refit',))
