"""Distributed helpers of the port's tests, importing neither JAX nor the
JAX package (the card's tests use them too): ``fake_world``, a fake
process group and mesh in this process; ``wrapper_calls``, a small call
of each kernel wrapper; and the jobs that ``tests/test_torch_dist.py``
runs on real ranks: a gloo process group on the CPU, spawned with
``torch.multiprocessing``, a 2x2 ("data", "model") mesh. The parent
writes ``jobs.pt`` (a dict of jobs, each with its inputs as numpy arrays)
into a directory; every rank runs every job in order; rank 0 writes
``out.pt``."""
import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

MESH = (2, 2)
WORLD = 4


@contextlib.contextmanager
def fake_world(n: int, shape=None, names=("data", "model"),
               device_type: str = "cpu"):
    """A fake process group of ``n`` ranks, this process rank 0, and a
    mesh over it (default (1, n)); torn down after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield init_device_mesh(device_type, shape or (1, n),
                               mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def wrapper_calls():
    """A small call of each kernel wrapper (B1-B4), its first tensor made
    by the function each takes."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    z = torch.zeros
    return {
        "rmsnorm": lambda d: rmsnorm(d(z(4, 8)), z(8)),
        "flash_attention": lambda d: flash_attention(
            d(z(1, 4, 2, 8)), z(1, 4, 2, 8), z(1, 4, 2, 8)),
        "paged_decode_attention": lambda d: paged_decode_attention(
            d(z(1, 2, 8)), z(2, 4, 2, 8), z(2, 4, 2, 8),
            z(1, 2, dtype=torch.int32), z(1, dtype=torch.int32)),
        "ssd_scan": lambda d: ssd_scan(
            d(z(1, 8, 2, 4)), z(1, 8, 2), z(2), z(1, 8, 1, 4),
            z(1, 8, 1, 4), z(2), chunk=4),
    }


def _arch(job):
    from repro_torch.configs import get_arch, reduced
    arch = reduced(get_arch(job["arch"]), **job["reduce"])
    if "moe" in job:
        arch = dataclasses.replace(
            arch, moe=dataclasses.replace(arch.moe, **job["moe"]))
    return dataclasses.replace(arch, param_dtype="float32")


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _tree(tree, fn):
    """``fn`` over the tensors of a cache or params tree (dicts, lists,
    tuples, ``MambaCache``s: a list in field order), as nested dicts and
    lists."""
    from repro_torch.models.mamba2 import MambaCache
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, MambaCache):
        return [_tree(t, fn) for t in tree.leaves()]
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _numpy(t):
    t = _whole(t).detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_job(mesh, job, _dir):
    """Prefill, then decode steps with flushes, sharded; every logits and
    the last cache, gathered, and the query heads of each B2 call."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.convert import params_from_jax_numpy
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.models import attention
    from repro_torch.models.model import LM
    arch = _arch(job)
    toks = job["tokens"]
    pol = make_policy(arch, ShapeSpec("t", "decode", job["s_max"],
                                      toks.shape[0]), mesh)
    model = LM(arch, pol, device="cpu", recent_window=job["window"])
    params = model.place_params(params_from_jax_numpy(job["params"]))
    logits, b2_heads = [], []
    flash = attention.flash_attention

    def counted(q, k, v, **kw):
        b2_heads.append(q.shape[2])
        return flash(q, k, v, **kw)
    attention.flash_attention = counted
    try:
        with torch.no_grad():
            lg, cache = model.prefill(params, torch.from_numpy(toks),
                                      s_max=job["s_max"])
            logits.append(_numpy(lg))
            for i, tok in enumerate(job["steps"]):
                lg, cache = model.decode_step(params, cache,
                                              torch.from_numpy(tok))
                logits.append(_numpy(lg))
                if i + 1 in job["flush_after"]:
                    cache = model.maybe_flush(cache)
    finally:
        attention.flash_attention = flash
    return {"logits": logits, "cache": _tree(cache, _numpy),
            "layout": _tree(cache, lambda t: str(tuple(t.placements))),
            "b2_heads": b2_heads}


def train_job(mesh, job, _dir):
    """Train steps of the sharded port from seeded params; the loss and
    every updated param, gathered."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.models.model import LM
    from repro_torch.training import TrainConfig, init_train_state
    from repro_torch.training import make_train_step
    arch = _arch(job)
    b, s = job["tokens"].shape
    pol = make_policy(arch, ShapeSpec("t", "train", s, b), mesh)
    model = LM(arch, pol, device="cpu", loss_chunk=job["loss_chunk"])
    cfg = TrainConfig()
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   cfg)
    step = make_train_step(model, cfg)
    batch = {"tokens": torch.from_numpy(job["tokens"]),
             "labels": torch.from_numpy(job["labels"])}
    losses = []
    for _ in range(job["steps"]):
        params, opt, m = step(params, opt, batch)
        losses.append(float(_whole(m["loss"])))
    return {"losses": losses, "params": _tree(params, _numpy),
            "layout": {k: str(tuple(v.placements)) for k, v in
                       params["seg0"].items()}}


def ckpt_job(mesh, job, job_dir):
    """Rank 0 saves whole params; every rank loads them laid out by the
    policy's specs (one leaf by a (mesh, placements) pair instead) and
    saves the sharded tree again (rank 0 writes it whole); the loaded
    leaves gathered, and the second checkpoint read back whole."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import make_policy, placements
    from repro_torch.models.model import LM
    from repro_torch.training import load, save
    arch = _arch(job)
    pol = make_policy(arch, ShapeSpec("t", "decode", 16, 4), mesh)
    whole = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    path = os.path.join(job_dir, "ckpt")
    if dist.get_rank() == 0:
        save(path, 7, {"params": whole})
    dist.barrier()
    specs = LM(arch, pol, device="cpu").param_specs()
    specs["embed"] = (mesh, placements(specs["embed"], mesh))
    got, _ = load(path, 7, {"params": whole}, shardings={"params": specs},
                  mesh=mesh)
    save(path, 8, {"params": got["params"]})     # sharded: rank 0 writes
    back, _ = load(path, 8, {"params": whole})
    return {"loaded": _tree(got["params"], _numpy),
            "saved": _tree(whole, _numpy),
            "resaved": _tree(back["params"], _numpy),
            "layout": {k: str(tuple(v.placements))
                       for k, v in got["params"]["seg0"].items()}}


def moe_job(mesh, job, _dir):
    """The expert-parallel ``moe_ffn`` (experts over "model", tokens over
    "data"): out gathered, rank 0's aux."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.models import moe
    arch = _arch(job)
    x = torch.from_numpy(job["x"])
    pol = make_policy(arch, ShapeSpec("t", "prefill", x.shape[1],
                                      x.shape[0]), mesh)
    leaf_axes = {"router": (None, None),
                 "w_gate": ("experts", "p_fsdp", None),
                 "w_up": ("experts", "p_fsdp", None),
                 "w_down": ("experts", None, "p_fsdp")}
    p = {k: pol.distribute(torch.from_numpy(job["p"][k]), ax)
         for k, ax in leaf_axes.items()}
    with torch.no_grad():
        out, aux = moe.moe_ffn(pol.distribute(x, ("batch", None, None)), p,
                               arch, pol, job["cf"])
    return {"out": _numpy(out), "aux": aux.to_local().numpy().copy(),
            "ep": pol.axis_size("experts"),
            "w_gate_local": tuple(p["w_gate"].to_local().shape)}


RUNNERS = {"lm": lm_job, "train": train_job, "ckpt": ckpt_job,
           "moe": moe_job}


def worker(rank: int, job_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        job_dir, "store"), rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                             "model"))
        jobs = torch.load(os.path.join(job_dir, "jobs.pt"),
                          weights_only=False)
        out = {name: RUNNERS[job["kind"]](mesh, job, job_dir)
               for name, job in jobs.items()}
        if rank == 0:
            torch.save(out, os.path.join(job_dir, "out.pt"))
    finally:
        dist.destroy_process_group()


def start(job_dir: str, jobs: dict):
    """Spawn the ranks on ``jobs`` and return at once (``finish`` waits)."""
    import torch.multiprocessing as mp
    torch.save(jobs, os.path.join(job_dir, "jobs.pt"))
    return mp.start_processes(worker, args=(job_dir,), nprocs=WORLD,
                              join=False, start_method="spawn")


def finish(job_dir: str, ranks) -> dict:
    """Wait for the ranks (a failed rank raises); rank 0's results."""
    while not ranks.join():
        pass
    return torch.load(os.path.join(job_dir, "out.pt"), weights_only=False)

