"""Dry run: every (arch x shape) cell traced on rank 0 of the production
mesh, on fake tensors, without a compiler; the port of
``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape decode_32k [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell with ``jax.jit`` against 256
or 512 host devices and reads the compiled module. Here the step runs
once, eagerly, as rank 0 of a ``"fake"`` process group of 256 (16x16
``("data", "model")``) or 512 (2x16x16 ``("pod", "data", "model")``)
ranks, under ``FakeTensorMode``: every tensor has its shape, type and
layout and no data, every collective returns at once, and the kernels'
plain versions run on rank 0's local shards on the CPU device (the
reference's ``use_pallas=False``). A train cell traces the step with its
backward and AdamW (``remat`` on, as the reference's), a prefill cell
``prefill``, a decode cell ``decode_step`` on a zero cache of the cell's
length. ``distributed/trace_analysis.py`` counts what rank 0 dispatches.

The record keeps the reference's keys and meanings, per device: ``ok``,
``n_devices``, ``params``, ``active_params``, ``attn_mode``,
``params_mode``, ``flops`` (dot FLOPs plus an operation an output element
of every other op), ``peak_bytes_per_device`` (the most local storage
alive during the step, its inputs included), ``resident_bytes_per_device``
(what the step's inputs and outputs hold, the inputs that the reference
donates, train state and decode cache, counted once, as its argument plus
output less alias sizes), ``argument_size_bytes``, ``output_size_bytes``,
``collectives`` (bytes by kind), ``collective_bytes``, ``hlo_dot_flops``
and ``hlo_bytes`` (read from the trace, which stands where the HLO stood:
local dot FLOPs and the bytes the ops read and write). ``build_s`` times
the fake model and inputs, ``trace_s`` the step. Left out, having no
meaning without a compiler: ``lower_s``, ``compile_s``,
``alias_size_bytes``, ``temp_size_bytes``, ``bytes_accessed`` (the
trace's ``hlo_bytes`` stands for it) and the HLO text files. Every number
is a count derived on the host from shapes, not a time or a size measured
on any chip. A failing cell is a data point with ``error``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES_BY_NAME, get_arch,
                                 shape_applicable)
from repro_torch.distributed.sharding import make_policy
from repro_torch.distributed.trace_analysis import (TraceAnalysis,
                                                   storage_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import TrainConfig, make_train_step

# per-cell overrides, the reference's
CELL_OVERRIDES: Dict[str, Dict[str, Any]] = {
    # 90B weights TP-16 alone are 11.25 GiB a chip; serve cells gather
    # the weights layer by layer (FSDP) beside the 32k KV cache
    "llama-3.2-vision-90b/decode_32k": {"policy": {"params_mode": "fsdp"}},
    "llama-3.2-vision-90b/prefill_32k": {"policy": {"params_mode": "fsdp"}},
}


def input_specs(arch, shape):
    """Per input of this cell, its (shape, dtype): whole, as every rank
    holds it; ``LM`` lays each out by its logical axes (the batch)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if arch.family.value == "audio":
            specs["embeds"] = ((b, s, arch.d_model), torch.bfloat16)
        else:
            specs["tokens"] = ((b, s), torch.int64)
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int64)
    else:
        specs["tokens"] = ((b,), torch.int64)
    if arch.family.value == "vlm":
        specs["frontend"] = ((b, arch.n_frontend_tokens, arch.d_model),
                             torch.bfloat16)
    return specs


def _fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def lower_cell(arch, shape, mesh, policy_kw: Optional[dict] = None):
    """Build one cell's fake model, inputs and step on ``mesh`` (call it
    under ``FakeTensorMode``) -> (step: () -> outputs, inputs, donated,
    policy)."""
    policy = make_policy(arch, shape, mesh, **(policy_kw or {}))
    model = LM(arch, policy, device="cpu", remat=shape.kind == "train")
    params = model.init(None)
    specs = input_specs(arch, shape)
    batch = {k: torch.empty(sh, dtype=dt) for k, (sh, dt) in specs.items()}
    if shape.kind == "train":
        step_fn = make_train_step(model, TrainConfig(adamw=AdamWConfig()))
        opt = init_opt_state(params, compression=False)
        inputs, donated = (params, opt, batch), (params, opt)

        def step():
            return step_fn(params, opt, batch)
    elif shape.kind == "prefill":
        inputs, donated = (params, batch), ()

        def step():
            with torch.no_grad():
                return model.prefill(params, tokens=batch.get("tokens"),
                                     embeds=batch.get("embeds"),
                                     frontend=batch.get("frontend"),
                                     s_max=shape.seq_len)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        inputs, donated = (params, cache, batch), (cache,)

        def step():
            with torch.no_grad():
                return model.decode_step(params, cache, batch["tokens"])
    return step, inputs, donated, policy


def trace_cell(arch, shape, mesh, policy_kw: Optional[dict] = None
               ) -> Dict[str, Any]:
    """Build and trace one cell on ``mesh`` (this process its rank 0 of a
    fake process group) -> the record's measured keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, inputs, donated, policy = lower_cell(arch, shape, mesh,
                                                   policy_kw)
        t_build = time.time() - t0
        ta = TraceAnalysis()
        with ta:
            arg_bytes = ta.track(inputs)
            out = step()
        t_trace = time.time() - t0 - t_build
        out_bytes = storage_bytes(out)
        kept = arg_bytes - storage_bytes(donated)
    s = ta.summary()
    return {"attn_mode": policy.attn_mode,
            "params_mode": policy.params_mode,
            "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
            "flops": s["flops"], "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "peak_bytes_per_device": s["peak_bytes"],
            "resident_bytes_per_device": kept + out_bytes,
            "collectives": s["collectives"],
            "collective_bytes": s["total_collective_bytes"],
            "collective_op_executions": s["collective_op_executions"],
            "largest_collective_bytes": s["largest_collective_bytes"],
            "hlo_dot_flops": s["dot_flops"], "hlo_bytes": s["hbm_bytes"]}


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = "reports/dryrun") -> Dict[str, Any]:
    res: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "multi_pod": multi_pod, "ok": False}
    try:
        arch = get_arch(arch_name)
        overrides = dict(CELL_OVERRIDES.get(f"{arch_name}/{shape_name}",
                                            {}))
        pol_kw = overrides.pop("policy", {})
        _fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        res.update({"n_devices": dist.get_world_size(),
                    "params": arch.param_count(),
                    "active_params": arch.param_count(active_only=True),
                    "overrides": overrides})
        res.update(trace_cell(arch, SHAPES_BY_NAME[shape_name], mesh,
                              pol_kw))
        res["ok"] = True
        print(f"[dryrun] {arch_name}/{shape_name} "
              f"{'pod2' if multi_pod else 'pod1'} OK "
              f"build={res['build_s']}s trace={res['trace_s']}s "
              f"mem/dev={res['peak_bytes_per_device'] / 1e9:.2f}GB "
              f"coll={res['collective_bytes'] / 1e9:.3f}GB "
              f"dot={res['hlo_dot_flops']:.3e}", flush=True)
    except Exception as e:   # noqa: BLE001 — a failing cell is a data point
        res["error"] = f"{type(e).__name__}: {e}"[:2000]
        res["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch_name}/{shape_name} "
              f"{'pod2' if multi_pod else 'pod1'} FAILED: "
              f"{res['error'][:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        pod = "pod2" if multi_pod else "pod1"
        fn = os.path.join(out_dir, f"{arch_name}_{shape_name}_{pod}.json")
        with open(fn, "w") as f:
            json.dump({k: v for k, v in res.items() if k != "traceback"},
                      f, indent=1)
    return res


def iter_cells(multi_pod: bool):
    for a in ASSIGNED_ARCHS:
        arch = get_arch(a)
        for sname, shape in SHAPES_BY_NAME.items():
            if shape_applicable(arch, shape):
                yield a, sname


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args()

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    if args.all:
        for mp in meshes:
            for a, s in iter_cells(mp):
                r = run_cell(a, s, multi_pod=mp, out_dir=args.out)
                failures += 0 if r["ok"] else 1
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            r = run_cell(args.arch, args.shape, multi_pod=mp,
                         out_dir=args.out)
            failures += 0 if r["ok"] else 1
    print(f"[dryrun] done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
