"""The algorithm's own operations and bytes, and the chip's peaks.

Frozen with the benchmark: later changes to the program cannot move a
roofline or an mfu share by recounting. Every share is stated against the
H100 SXM's top dense rates (989 TFLOP/s, 3.35 TB/s), whatever precision
the work runs in, so that no later kernel that computes the same product
another way can read over 100%. Counts are the algorithm's: each input
byte read once, each output written once, padding to a length bucket and
idle batch slots not counted. Derived from ``chip_smoke.py``'s
``paged_work`` and ``chunk_plan``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = 989e12           # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def sizes(cfg: Dict) -> Dict[str, int]:
    """The counted sizes of a configuration file."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // hq
    return {"L": cfg["num_hidden_layers"], "d": d, "hq": hq,
            "hkv": cfg["num_key_value_heads"], "hd": hd,
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def layer_params(cfg: Dict) -> int:
    """Parameters of one dense layer: q, k, v, o, the gated MLP, 2 norms."""
    s = sizes(cfg)
    qd, kvd = s["hq"] * s["hd"], s["hkv"] * s["hd"]
    return (s["d"] * qd + 2 * s["d"] * kvd + qd * s["d"]
            + 3 * s["d"] * s["ff"] + 2 * s["d"])


def token_flops(cfg: Dict) -> float:
    """2 x the layers' parameters and the final norm: one token's FLOPs
    outside attention's products and the head."""
    s = sizes(cfg)
    return 2.0 * (s["L"] * layer_params(cfg) + s["d"])


def head_flops(cfg: Dict) -> float:
    s = sizes(cfg)
    return 2.0 * s["d"] * s["V"]


def attn_flops(cfg: Dict, keys: float) -> float:
    """QK^T and PV of one query row against ``keys`` keys, every layer."""
    s = sizes(cfg)
    return 4.0 * s["hq"] * s["hd"] * keys * s["L"]


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
    s = sizes(cfg)
    nbytes = ((2 * total_keys * s["hkv"] * s["hd"]
               + 2 * batch * s["hq"] * s["hd"]) * esz
              + batch * max_pages * 4 + batch * 4)
    return 4.0 * total_keys * s["hq"] * s["hd"], float(nbytes)


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
    s = sizes(cfg)
    pairs = rows * done + rows * (rows + 1) / 2
    nbytes = (2 * rows * s["hq"] * s["hd"]
              + 2 * (done + rows) * s["hkv"] * s["hd"]) * esz + 4
    return 4.0 * s["hq"] * s["hd"] * pairs, float(nbytes)
