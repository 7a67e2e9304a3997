"""What one rank's step moves and computes, read from a trace of the ops
it dispatches: the counterpart of ``repro.distributed.hlo_analysis``.

The reference parses the HLO text of the compiled SPMD module, which is
one chip's program. Here nothing is compiled: ``TraceAnalysis``, a
``TorchDispatchMode``, watches the ops that one rank dispatches while a
step runs (on fake tensors under the dry run, ``launch/dryrun.py``). An
op on DTensors it hands back to DTensor (``NotImplemented``, as
``CommDebugMode`` does), so that it then sees what DTensor runs for it:
the local ops on this rank's shards and the collectives of every
redistribution, explicit or implied by an op's sharding (not the ops
that DTensor's sharding propagation runs on fake global shapes to infer
an output's metadata). It counts, for that rank:

- ``collectives``: the bytes of each ``_c10d_functional`` collective's
  result by kind, as the reference counts them: an all-reduce twice (a
  ring's reduce-scatter and all-gather), a reduce-scatter by its input;
  ``collective_op_executions`` how many ran, ``largest_collective_bytes``
  the largest result of one;
- ``dot_flops``: 2 * M * N * K of every local matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``) and 2 * output * window of every
  local convolution (``FlopCounterMode`` around DTensor ops would count
  the global product);
- ``hbm_bytes``: the bytes that each local op reads and writes (its
  tensor inputs and outputs), views excluded;
- ``peak_bytes``: the most bytes of local storage alive at once, from
  the storages of the tensors registered with ``track`` (the step's
  inputs) and of every op's outputs, each counted until it is freed.

``summary()`` returns the reference's keys (``collectives``,
``total_collective_bytes``, ``collective_op_executions``, ``dot_flops``,
``hbm_bytes``) and ``largest_collective_bytes``, ``peak_bytes`` and
``flops`` (dot FLOPs plus one an output element of every other op that
computes)."""
from __future__ import annotations

import math
import sys
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# _c10d_functional op -> the reference's collective kind
_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast",
          "broadcast_": "broadcast"}
_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args) -> float:
    """2 * M * N * K of a matrix product, from its operands' shapes."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
        else (args[0], args[1])
    return 2.0 * math.prod(a.shape) * b.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> float:
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


def _in_sharding_propagation() -> bool:
    """Whether the op now dispatched is DTensor's shape inference."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def storage_bytes(tree) -> int:
    """Bytes of the distinct local storages of ``tree``'s tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


class TraceAnalysis(TorchDispatchMode):
    """Counts what the ops dispatched under it move and compute (see the
    module docstring). Enter it inside ``FakeTensorMode`` for a dry run;
    register the step's inputs with ``track`` first."""

    def __init__(self):
        super().__init__()
        self.collectives: Dict[str, float] = defaultdict(float)
        self.n_collectives = 0
        self.largest = 0
        self.dot_flops = 0.0
        self.other_flops = 0.0
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._storages = weakref.WeakKeyDictionary()

    # -- storage ------------------------------------------------------------
    def track(self, tree) -> int:
        """Count the local storages of ``tree``'s tensors as live from now
        until they are freed; returns their bytes not counted before."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(_local(t))
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # see DTensor's local ops instead
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        pkt = func.overloadpacket
        ns, name = pkt._qualified_op_name.split("::")
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional":
            kind = _KINDS.get(name)
            if kind is not None:
                result = sum(_nbytes(t) for t in outs)
                self.largest = max(self.largest, result)
                nbytes = _nbytes(args[0]) if kind == "reduce-scatter" \
                    else result * (2 if kind == "all-reduce" else 1)
                self.collectives[kind] += nbytes
                self.n_collectives += 1
            for t in outs:
                self._add(t)
            return out
        if func.is_view or not outs or ns == "prim":
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        if name in _PRODUCTS:
            self.dot_flops += _product_flops(name, args)
        elif name == "convolution":
            self.dot_flops += _conv_flops(args, outs[0])
        else:
            self.other_flops += sum(t.numel() for t in outs)
        for t in outs:
            self._add(t)
        return out

    def summary(self) -> Dict:
        coll = {k: float(v) for k, v in self.collectives.items()}
        return {"collectives": coll,
                "total_collective_bytes": float(sum(coll.values())),
                "collective_op_executions": float(self.n_collectives),
                "largest_collective_bytes": int(self.largest),
                "dot_flops": float(self.dot_flops),
                "flops": float(self.dot_flops + self.other_flops),
                "hbm_bytes": float(self.hbm_bytes),
                "peak_bytes": int(self.peak)}
