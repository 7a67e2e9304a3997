"""Mean host ms of a window decode step's wait for the device: the program's engine.decode.wait span around the argmax's host read."""
from pbcore import progspans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "lower"


def read(o):
    return progspans.decode_part_ms(o, 1)
