"""Logical-axis sharding policy, the port of ``repro.distributed.sharding``.

Models annotate activations and params with *logical* axis names ("batch",
"seq_q", "heads", "d_ff", ...). A ``Policy`` maps logical names to mesh
axes; changing the mapping (one dict) re-shards the whole model.

The reference's JAX objects and their counterparts here:

  ``jax.sharding.Mesh``        -> ``torch.distributed.device_mesh.DeviceMesh``
                                  (or any object with ``axis_names`` and a
                                  ``shape`` dict, a stand-in that needs no
                                  devices, as the reference's tests use)
  ``PartitionSpec``            -> ``PSpec``: a tuple with one entry a tensor
                                  dim, each None, an axis name or a tuple of
                                  axis names; it compares equal to a tuple
  ``NamedSharding``            -> ``placements(spec, mesh)``: one DTensor
                                  placement (``Shard(d)`` / ``Replicate()``)
                                  a mesh dimension
  ``with_sharding_constraint`` -> ``DTensor.redistribute`` (``constrain``)

A tensor dim sharded over several mesh axes is laid out in the entry's
order by JAX and in mesh-dimension order by DTensor's ``Shard``. The two
agree when the entry names its axes in mesh order; ``placements`` raises
where they do not, and never reorders. ``make_policy`` builds one such
entry, ``("data", "model", "pod")`` for the batch of a ``fsdp_pure``
training cell on the 2x16x16 mesh. ``spec_for_shape`` drops "pod" from
it wherever the batch does not divide by 512, which holds for every shape
of the configs (the largest global batch is 256); parameters, inputs,
caches and constraints are all laid out shape-aware here, so no cell
reaches the raise.

Default mappings per (arch, shape) are chosen by ``make_policy``, rule for
rule as the reference's:

  * train/prefill attention:  "heads" -> model
  * decode:                   KV cache sequence-sharded ("kv_seq" -> model,
                              + "data" too when batch == 1)
  * params:                   "tp": TP dims over model, replicated over data
                              "fsdp": + the largest non-TP dim over data
  * MoE:                      "experts" -> model (expert parallelism)
  * dense training:           pure FSDP, the batch over every axis
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

AxisMap = dict


class PSpec(tuple):
    """A ``PartitionSpec``: one entry a tensor dim (None, an axis name or
    a tuple of axis names). ``PSpec()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PSpec" + tuple.__repr__(self)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def mesh_axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[name])
    return int(shape[mesh_axis_names(mesh).index(name)])


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement for each mesh dimension: ``Shard(d)`` where
    the spec's entry d names that axis, else ``Replicate()``. Raises
    ``ValueError`` for an entry that names its axes out of mesh order (see
    the module docstring)."""
    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {dim} is sharded over {_entry_axes(entry)}, out of "
                f"the mesh's axis order {names}: DTensor lays a dim out in "
                "mesh order, JAX in the spec's")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass
class Policy:
    mesh: Any = None
    rules: AxisMap = dataclasses.field(default_factory=dict)
    params_mode: str = "tp"          # "tp" | "fsdp"
    attn_mode: str = "heads"         # "heads" | "seq" | "data"
    # local()'s resolved placements by (axes, input shapes)
    _local_placements: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    # -- resolution ---------------------------------------------------------
    def _axes(self, name, used) -> Tuple[str, ...]:
        names = mesh_axis_names(self.mesh)
        axes = self.rules.get(name, ()) if name else ()
        return tuple(a for a in axes if a not in used and a in names)

    def spec(self, logical: Sequence[Optional[str]]) -> PSpec:
        if self.mesh is None:
            return PSpec()
        used: set = set()
        out = []
        for name in logical:
            axes = self._axes(name, used)
            used.update(axes)
            out.append(None if not axes
                       else axes[0] if len(axes) == 1 else axes)
        return PSpec(*out)

    def spec_for_shape(self, logical: Sequence[Optional[str]],
                       shape: Sequence[int]) -> PSpec:
        """Like ``spec``, but drops the axes that do not divide the dim
        size (the longest prefix of the axis tuple that divides it is
        kept: batch 256 over (pod, data, model) = 512 falls back to (pod,
        data) = 32), as parameters and inputs are laid out evenly."""
        if self.mesh is None:
            return PSpec()
        used: set = set()
        out = []
        for name, dim in zip(logical, shape):
            axes = self._axes(name, used)
            while axes:
                size = math.prod(mesh_axis_size(self.mesh, a) for a in axes)
                if size > 0 and dim % size == 0:
                    break
                axes = axes[:-1]
            used.update(axes)
            out.append(None if not axes
                       else axes[0] if len(axes) == 1 else axes)
        return PSpec(*out)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """DTensor placements of ``spec(logical)``, or with ``shape`` of
        ``spec_for_shape(logical, shape)``."""
        spec = self.spec(logical) if shape is None \
            else self.spec_for_shape(logical, shape)
        return placements(spec, self.mesh)

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """A DTensor redistributed to ``spec_for_shape(logical,
        x.shape)``; anything else (a plain tensor, None, a number), or any
        input without a mesh, as it came. The reference's constraint
        shards a dim that its axes do not divide, which GSPMD pads; a
        DTensor so sharded cannot be viewed or flattened across that dim,
        so here the dim keeps the longest prefix of its axes that divides
        it, and a caller that needs GSPMD's layout pads the dim itself
        (attention's query heads, ``models/attention.py``)."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(logical, x.shape))

    def local(self, fn, in_axes: Sequence, out_axes):
        """``fn`` run on each rank's local shards (``local_map``): its
        inputs laid out by ``in_axes`` (a logical spec an argument, None
        for one that is no DTensor) and its outputs by ``out_axes`` (a
        logical spec, or a list of them, one an output). As ``constrain``,
        a logical axis keeps only the prefix of its mesh axes that divides
        every input dim it names, in the outputs too. Inputs laid out
        otherwise are redistributed first. The placements are resolved
        once for each (axes, input shapes). Without a mesh, ``fn``."""
        if self.mesh is None:
            return fn
        outs = tuple(out_axes) if isinstance(out_axes, list) else None
        in_axes = tuple(in_axes)

        def call(*args):
            shapes = tuple(None if ax is None else tuple(a.shape)
                           for a, ax in zip(args, in_axes))
            key = (in_axes, out_axes if outs is None else outs,
                   outs is None, shapes)
            pls = self._local_placements.get(key)
            if pls is None:
                pls = self._local_placements[key] = self._resolve_local(
                    in_axes, out_axes, shapes)
            return local_map(fn, out_placements=pls[1],
                             in_placements=pls[0], device_mesh=self.mesh,
                             redistribute_inputs=True)(*args)
        return call

    def _resolve_local(self, in_axes, out_axes, shapes):
        """``local``'s in and out placements for inputs of ``shapes``."""
        rules = dict(self.rules)
        for axes, shape in zip(in_axes, shapes):
            if axes is None:
                continue
            for name, entry in zip(axes, self.spec_for_shape(axes, shape)):
                kept = _entry_axes(entry)
                if name and len(kept) < len(rules.get(name, ())):
                    rules[name] = kept
        pol = dataclasses.replace(self, rules=rules)

        def pl(axes):
            return None if axes is None else list(pol.placements(axes))
        # local_map reads a tuple as one placement list an output
        out = tuple(pl(a) for a in out_axes) \
            if isinstance(out_axes, list) else pl(out_axes)
        return tuple(pl(a) for a in in_axes), out

    def distribute(self, t: torch.Tensor, logical: Sequence[Optional[str]]):
        """A tensor every rank holds whole, as a DTensor laid out by
        ``spec_for_shape(logical, t.shape)``: each rank keeps its own
        shard and nothing is sent. Without a mesh, ``t``."""
        if self.mesh is None:
            return t
        return distribute_tensor(t, self.mesh,
                                 self.placements(logical, t.shape),
                                 src_data_rank=None)

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        names = mesh_axis_names(self.mesh)
        return math.prod(mesh_axis_size(self.mesh, a)
                         for a in self.rules.get(name, ()) if a in names)

    @property
    def model_size(self) -> int:
        return self.axis_size("heads") or 1


NO_POLICY = Policy()


def make_policy(arch, shape, mesh, *, params_mode: Optional[str] = None,
                attn_mode: Optional[str] = None,
                decode_kv: Optional[str] = None, mlp_mode: str = "tp",
                train_mode: Optional[str] = None) -> Policy:
    """Default sharding policy for an (arch x shape) cell on ``mesh``.

    mesh axes: ("data", "model") or ("pod", "data", "model")."""
    if mesh is None:
        return Policy()
    axis_names = mesh_axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    if shape is not None and shape.global_batch == 1:
        batch_axes = ()            # batch == 1: the data/pod axes go to
                                   # the KV sequence instead
    model_ax = ("model",) if "model" in axis_names else ()
    msize = mesh_axis_size(mesh, "model") if "model" in axis_names else 1
    kind = shape.kind if shape is not None else "train"

    # attention: TP over query heads; KV heads sharded only when they
    # divide the axis, else replicated
    if attn_mode is None:
        attn_mode = "heads" if arch.n_heads else "seq"
    # params: training always wants FSDP (optimizer state); decode of very
    # large models too
    if params_mode is None:
        data = mesh_axis_size(mesh, "data") if "data" in axis_names else 1
        big = arch.param_count() * 2 > 12e9 * data
        params_mode = "fsdp" if (kind == "train" or big) else "tp"
    if decode_kv is None:
        # batch == 1 long-context: spread KV over every axis there is
        decode_kv = "all" if (shape is not None and shape.global_batch == 1) \
            else "model"

    rules: AxisMap = {
        "batch": batch_axes,
        "d_ff": model_ax,
        "d_inner": model_ax,           # mamba heads/channels
        "ssm_heads": model_ax,
        "experts": model_ax,
        "vocab": model_ax,
        "embed": (),                   # activations' d_model unsharded
        "kv_heads": model_ax if (attn_mode == "heads"
                                 and _divides(arch.n_kv_heads, msize)) else (),
        "heads": model_ax if attn_mode == "heads" else (),
        "seq_q": model_ax if attn_mode == "seq" else (),
        "kv_seq": (batch_axes + model_ax) if decode_kv == "all" else model_ax,
        "frontend_seq": model_ax,
        # param-only logical dims
        "p_tp": model_ax,              # tensor-parallel weight dim
        "p_embed_in": (),              # contracting dims of weights
        "p_fsdp": batch_axes if params_mode == "fsdp" else (),
        "p_layers": (),
    }
    if mlp_mode == "sp":
        rules["d_ff"] = ()
    # training of non-MoE archs: pure ZeRO-3/FSDP, the batch over every
    # mesh axis, weights fully sharded, no tensor parallelism; MoE training
    # keeps the model axis for expert parallelism
    if train_mode is None:
        train_mode = "fsdp_pure" if (kind == "train"
                                     and arch.moe is None) else "tp"
    if train_mode == "fsdp_pure" and kind == "train":
        # batch axes ordered so the divisibility prefix fallback lands on
        # 256-way sharding on both meshes
        data_first = tuple(a for a in ("data",) if a in axis_names)
        pod = tuple(a for a in ("pod",) if a in axis_names)
        rules.update({
            "batch": data_first + model_ax + pod,
            "p_fsdp": pod + data_first + model_ax,
            "p_tp": (),
            "d_ff": (), "d_inner": (), "ssm_heads": (),
            "heads": (), "kv_heads": (), "seq_q": (), "vocab": (),
        })
        attn_mode = "data"
    return Policy(mesh=mesh, rules=rules, params_mode=params_mode,
                  attn_mode=attn_mode)
