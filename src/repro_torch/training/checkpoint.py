"""Checkpoints in the reference's on-disk format (``repro.training.
checkpoint``), so each package reads the other's.

Layout: <dir>/step_<N>/
    manifest.json            - step, extra, and per leaf its key, file,
                               shape and dtype
    arrays/<leaf_id>.npy     - one file per leaf; bf16 stored as fp32

Leaves are keyed by their path as JAX names it: dict keys (sorted) joined
by "/", a NamedTuple's fields as ".<name>" (an ``OptState``'s
``opt/.mu/embed``); None is no leaf. Saving
is atomic (a tmp dir, then a rename) and ``latest_step`` scans complete
checkpoints only. ``load`` puts each leaf on the device and in the type
of the matching leaf of ``like``."""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):              # a NamedTuple (OptState)
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in
    ``_flatten``'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    return next(leaves)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None
         ) -> str:
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(flat):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:      # numpy has no bf16: store fp32
            t = t.float()
        arr = t.cpu().numpy()
        np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
        manifest["leaves"].append(
            {"key": key, "file": f"{i}.npy", "shape": list(arr.shape),
             "dtype": str(leaf.dtype).replace("torch.", "")})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d,
                                                "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def load(ckpt_dir: str, step: int, like: Any,
         shardings: Any = None) -> Tuple[Any, Dict]:
    """Load into the structure of ``like`` (a tree of tensors), each leaf
    on its ``like`` leaf's device and in its type -> (tree, extra). The
    reference's ``shardings`` (elastic re-sharding onto another mesh)
    waits for ROADMAP A11 and raises NotImplementedError."""
    if shardings is not None:
        raise NotImplementedError("load(shardings=...): re-sharding onto a "
                                  "device mesh waits for ROADMAP A11")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    leaves = []
    for key, leaf in _flatten(like):
        arr = np.load(os.path.join(path, "arrays", by_key[key]["file"]))
        leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                               dtype=leaf.dtype))
    return _unflatten(like, iter(leaves)), manifest.get("extra", {})
