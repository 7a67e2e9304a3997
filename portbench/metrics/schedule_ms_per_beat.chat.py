"""Host ms of the program's cluster.place (Alg. 1) and cluster.rebalance (Alg. 2) spans over the window's heartbeats."""
from pbcore import progspans

LAYER = "control plane"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.per_beat_ms(o, ('cluster.place', 'cluster.rebalance'))
