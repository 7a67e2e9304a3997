"""The algorithm's own operations and bytes, and the chip's peaks.

Frozen with the benchmark: later changes to the program cannot move a
roofline or an mfu share by recounting. Every share is stated against the
H100 SXM's top dense rates (989 TFLOP/s, 3.35 TB/s), whatever precision
the work runs in, so that no later kernel that computes the same product
another way can read over 100%. Counts are the algorithm's: each input
byte read once, each output written once, padding to a length bucket and
idle batch slots not counted. Derived from ``chip_smoke.py``'s
``paged_work`` and ``chunk_plan``. A configuration that names a layout
module takes from it how many layers attend and one token's FLOPs
outside attention (``attn_layers``, ``token_flops``); the per-launch
counts of B1 and B2 are the same for any layer that attends.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from pbcore.spec import layout

PEAK_FLOPS = 989e12           # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def heads(cfg: Dict) -> Tuple[int, int, int]:
    """(query heads, KV heads, head size) of the layers that attend."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return hq, cfg["num_key_value_heads"], cfg.get("head_dim") or d // hq


def sizes(cfg: Dict) -> Dict[str, int]:
    """The counted sizes of a dense configuration file."""
    hq, hkv, hd = heads(cfg)
    return {"L": cfg["num_hidden_layers"], "d": cfg["hidden_size"],
            "hq": hq, "hkv": hkv, "hd": hd,
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def layer_params(cfg: Dict) -> int:
    """Parameters of one dense layer: q, k, v, o, the gated MLP, 2 norms."""
    s = sizes(cfg)
    qd, kvd = s["hq"] * s["hd"], s["hkv"] * s["hd"]
    return (s["d"] * qd + 2 * s["d"] * kvd + qd * s["d"]
            + 3 * s["d"] * s["ff"] + 2 * s["d"])


def attn_layers(cfg: Dict) -> int:
    """How many layers attend: how many times B1 (a decode step) and B2
    (a prefill chunk) launch. Every layer, or as the configuration's
    layout module counts them."""
    lay = layout(cfg)
    if lay is not None:
        return lay.attn_layers(cfg)
    return cfg["num_hidden_layers"]


def token_flops(cfg: Dict) -> float:
    """One token's FLOPs outside attention's products and the head: 2 x
    the layers' parameters and the final norm, or as the configuration's
    layout module counts them."""
    lay = layout(cfg)
    if lay is not None:
        return float(lay.token_flops(cfg))
    s = sizes(cfg)
    return 2.0 * (s["L"] * layer_params(cfg) + s["d"])


def head_flops(cfg: Dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def attn_flops(cfg: Dict, keys: float) -> float:
    """QK^T and PV of one query row against ``keys`` keys, in every layer
    that attends."""
    n = attn_layers(cfg)
    if not n:
        return 0.0
    hq, _, hd = heads(cfg)
    return 4.0 * hq * hd * keys * n


def prefill_flops(cfg: Dict, l_in: int) -> float:
    """A prompt of ``l_in`` tokens, causal, logits at its last position
    only (as the engine computes them)."""
    return (token_flops(cfg) * l_in + attn_flops(cfg, l_in * (l_in + 1) / 2)
            + head_flops(cfg))


def decode_flops(cfg: Dict, batch: int, total_keys: int) -> float:
    """One decode iteration of ``batch`` live sequences attending to
    ``total_keys`` keys in all (the TraceBuffer's total context)."""
    return ((token_flops(cfg) + head_flops(cfg)) * batch
            + attn_flops(cfg, total_keys))


def bound_s(flops: float, nbytes: float) -> float:
    """Least time on the chip: the larger of the two roofs."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def paged_decode_work(cfg: Dict, batch: int, total_keys: int,
                      max_pages: int, esz: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one B1 launch (one layer) for ``batch`` live
    sequences and ``total_keys`` live keys: their K and V, q and out once,
    their block-table rows and lengths."""
    hq, hkv, hd = heads(cfg)
    nbytes = ((2 * total_keys * hkv * hd + 2 * batch * hq * hd) * esz
              + batch * max_pages * 4 + batch * 4)
    return 4.0 * total_keys * hq * hd, float(nbytes)


def chunk_plan(l_in: int, chunk: int) -> List[Tuple[int, int]]:
    """(rows, context before them) of each chunk when the engine prefills
    ``l_in`` tokens in chunks of ``chunk``; [] for a one-shot prefill."""
    if not chunk or l_in <= chunk:
        return []
    plan, done = [], 0
    while done < l_in:
        n = min(chunk, l_in - done)
        plan.append((n, done))
        done += n
    return plan


def flash_f32_work(cfg: Dict, rows: int, done: int,
                   esz: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one B2 fp32 launch (one layer) for a chunk of
    ``rows`` real rows after ``done`` context tokens: row i sees done + i +
    1 keys; Q and out, and the done + rows keys' K and V, once."""
    hq, hkv, hd = heads(cfg)
    pairs = rows * done + rows * (rows + 1) / 2
    nbytes = (2 * rows * hq * hd + 2 * (done + rows) * hkv * hd) * esz + 4
    return 4.0 * hq * hd * pairs, float(nbytes)
