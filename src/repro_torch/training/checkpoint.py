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
of the matching leaf of ``like`` and, with ``shardings``, lays it out on a
mesh (elastic re-sharding: leaves are stored whole, so a checkpoint
written on one mesh loads onto any other). ``save`` writes DTensor leaves
whole: every rank gathers them, rank 0 writes."""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import PSpec, placements


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
    if any(isinstance(t, DTensor) for _, t in flat):
        # a collective: every rank gathers each leaf, rank 0 writes
        flat = [(k, t.full_tensor() if isinstance(t, DTensor) else t)
                for k, t in flat]
        try:
            if dist.get_rank() == 0:
                _write(final, step, flat, extra)
        finally:
            dist.barrier()
        return final
    return _write(final, step, flat, extra)


def _write(final: str, step: int, flat, extra) -> str:
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


def _layouts(like, shardings) -> List[Any]:
    """``shardings``' leaves in ``_flatten(like)``'s order: each a
    ``(mesh, placements)`` pair, a ``PSpec`` or None (the leaf stays
    whole); ``shardings`` None gives None for every leaf."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _layouts(
            like[k], None if shardings is None else shardings[k])]
    if isinstance(like, tuple):
        return [s for f in like._fields for s in _layouts(
            getattr(like, f),
            None if shardings is None else getattr(shardings, f))]
    return [shardings]


def load(ckpt_dir: str, step: int, like: Any, shardings: Any = None,
         mesh: Any = None) -> Tuple[Any, Dict]:
    """Load into the structure of ``like`` (a tree of tensors), each leaf
    on its ``like`` leaf's device and in its type -> (tree, extra).
    ``shardings`` (a tree shaped as ``like``) lays each leaf out on a mesh
    as a DTensor: a ``(mesh, placements)`` pair, or a ``PSpec`` on
    ``mesh`` (a policy's); a None leaf stays whole. Every rank reads the
    whole leaf and keeps its own shard: nothing is sent."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    leaves = []
    for (key, leaf), lay in zip(_flatten(like), _layouts(like, shardings)):
        arr = np.load(os.path.join(path, "arrays", by_key[key]["file"]))
        t = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        if isinstance(lay, PSpec):
            lay = (mesh, placements(lay, mesh))
        if lay is not None:
            t = distribute_tensor(t, lay[0], lay[1], src_data_rank=None)
        leaves.append(t)
    return _unflatten(like, iter(leaves)), manifest.get("extra", {})
