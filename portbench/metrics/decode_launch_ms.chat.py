"""Mean host ms of a window decode step's launch: the program's engine.decode.launch span around PagedEngine._decode."""
from pbcore import progspans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.decode_part_ms(o, 0)
