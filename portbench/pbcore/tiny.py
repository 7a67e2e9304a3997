"""Throwaway cells for the CPU tests, made of data files only: a reduced
configuration, a traffic mix and a workload, written into a directory
that a ``Bench`` searches before ``portbench/`` itself, with a copy of
``BENCHMARK.json`` that names the cell; and configurations that bring
their own layout module."""
from __future__ import annotations

import copy
import json
import math
from pathlib import Path
from typing import Dict, Optional

from pbcore.spec import HERE, ROOT, Bench

PRECISION = {"weights": "bfloat16", "one_shot_prefill": "bfloat16",
             "chunked_prefill": "float32", "decode": "float32",
             "kv_cache": "float32"}


def config(base: str = "granite-3-8b", layers: int = 2, d: int = 64,
           hq: int = 4, hkv: int = 2, hd: int = 16, ff: int = 128,
           vocab: int = 256, dtype: str = "bfloat16") -> Dict:
    """A reduced configuration in the files' format; ``base`` is the
    port's registry entry whose family it keeps."""
    return {"port_arch": base, "reference": "dense_gqa",
            "num_hidden_layers": layers, "hidden_size": d,
            "num_attention_heads": hq, "num_key_value_heads": hkv,
            "head_dim": hd, "intermediate_size": ff, "vocab_size": vocab,
            "hidden_act": "silu", "attention_bias": False,
            "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "rope_scaling": None, "tie_word_embeddings": True,
            "torch_dtype": dtype, "embedding_multiplier": math.sqrt(d),
            "attention_multiplier": 1.0 / math.sqrt(hd),
            "precision": dict(PRECISION, weights=dtype,
                              one_shot_prefill=dtype)}


TRAFFIC = {"kind": "open_loop", "rate_per_s": 8.0,
           "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.9,
                      "min": 4, "max": 150},
           "output": {"dist": "lognormal", "median": 10, "sigma": 0.7,
                      "min": 2, "max": 30}}


def workload(config_name: str, traffic_name: str, chunk: int = 0,
             served_tokens: int = 64, limit: float = 0.05,
             err_limit: float = 0.05, drain_s: float = 300.0) -> Dict:
    """A reduced cell's deployment. Its SLO is loose: on a shared CPU an
    engine step can take longer than a card's ATGT limit, and once the
    refitted Eq. 3 says a single decode step misses the limit, Algorithm 1
    refuses every request and an idle cluster never refits (PERF.md, Open
    questions)."""
    return {"config": config_name, "traffic": traffic_name,
            "cluster": {"n_workers": 2, "policy": "aladdin",
                        "heartbeat_iters": 1, "enable_rebalance": True,
                        "autoscale": False},
            "engine": {"max_batch": 8, "page_size": 16, "n_pages": 160,
                       "max_pages_per_seq": 16, "prefill_chunk": chunk},
            "slo": {"ttft_s": 30.0, "atgt_s": 5.0}, "drain_s": drain_s,
            "trace_start_frac": 0.25, "trace_s": 1.0,
            "check": {"served_tokens": served_tokens,
                      "max_logit_gap": limit, "max_logit_err": err_limit}}


def bench(root: Path, name: str, cfg: Dict, wl: Dict,
          traffic: Optional[Dict] = None) -> Bench:
    """Write the cell's files under ``root`` and return a Bench that finds
    them first; the cell reports every end-to-end metric."""
    root = Path(root)
    for sub, fname, data in (("configs", wl["config"], cfg),
                             ("traffic", wl["traffic"], traffic or TRAFFIC),
                             ("workloads", name, wl)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / f"{fname}.json").write_text(json.dumps(data))
    b = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    b["workloads"].append({"name": name, "config": wl["config"],
                           "traffic": wl["traffic"], "chips": 1,
                           "why": "a throwaway cell of the tests"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    return Bench(b, [root, HERE])


def layout_config(root: Path, name: str, cfg: Dict, source: str) -> Bench:
    """Write ``configs/<name>.json`` and the layout module it names
    (``cfg["layout"]``, its text ``source``) under ``root``, and return a
    Bench that finds them first: ``Bench.config(name)`` reads them."""
    root = Path(root)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (root / "configs" / f"{cfg['layout']}.py").write_text(source)
    return Bench(json.loads((ROOT / "BENCHMARK.json").read_text()),
                 [root, HERE])
