"""Share (%) of the window's decode steps whose engine.decode.launch span holds an engine.decode.replay instant: the steps run by replaying the engine's CUDA graph."""
from pbcore import progspans

LAYER = "engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "atgt_p90_ms"
BETTER = "higher"


def read(o):
    try:
        from repro_torch.serving.engine import PagedEngine
    except ImportError:
        return None
    if not hasattr(PagedEngine, "decode_replays"):
        progspans._log("the program's engine replays no decode graph")
        return None
    spans = progspans.records(o)
    if spans is None:
        return None
    kept = {x.index for x in progspans.in_window(o, spans, "engine.step")}
    launches = [ln.index for step, (ln, _) in
                progspans.decode_steps(spans).items() if step in kept]
    if not launches:
        return None
    replayed = {x.parent for x in spans if x.name == "engine.decode.replay"}
    return 100.0 * sum(i in replayed for i in launches) / len(launches)
