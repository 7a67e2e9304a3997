"""The sharded port on real ranks: four gloo ranks on the CPU, spawned with
``torch.multiprocessing`` once for the whole file (``torch_dist_jobs.py``;
a ``file://`` store in the test's temporary directory, so parallel
workers never share a port), a 2x2 ("data", "model") mesh, reduced archs
in fp32.

- ``LM.prefill`` logits and 4 decode steps (flushes after the 2nd and
  4th; prompt 40 padded to 48) of a dense arch, mamba2, zamba2 and a
  dense arch whose 3 query heads the model axis does not divide (padded
  to 4, as GSPMD pads them; B2 on rank 0's 2 heads) under
  ``make_policy``, against the JAX ``LM`` without a mesh on the same
  weights, at 1e-5; and the last cache, gathered (the SSM state at 1e-3
  and the bf16 conv windows at bf16's tolerance, as
  ``tests/test_torch_generation.py`` holds them). A Mamba layer keeps its
  conv windows in bf16 whatever the model's type, and the mesh sums the
  row-parallel products in another order, so a window entry within fp32
  noise of a bf16 rounding boundary can round to the other neighbour (one
  ulp, 2^-8 relative: zamba2's first decode step reads one such entry,
  2.0e-5 off in its logits, where the unsharded port is 2.3e-6 off); the
  decode logits of the two Mamba archs are held at 1e-5 relative plus
  2e-5 of their largest value.
- A train step's loss and updated params (pure FSDP, the batch over both
  axes) against the port's unsharded step, at 1e-5.
- ``load(shardings=...)`` of a checkpoint saved whole by rank 0: each leaf
  laid out by its spec, bit for bit after ``full_tensor()``; and ``save``
  of the sharded tree (gathered, rank 0 writes), read back bit for bit.
- Expert parallelism, ep = 2 (7 experts padded to 8, tokens over "data"),
  with and without drops, against the reference's own sharded
  ``moe_ffn`` (``shard_map`` + ``psum``) run in a subprocess on 4 forced
  host devices: output at 1e-5, rank 0's load-balance loss at 1e-5 and
  its drops exactly (the reference's aux is replicated by declaration:
  device 0's value, data rank 0's). The reference's ``moe.shard_map`` is
  ``jax.experimental.shard_map.shard_map``, which this jax refuses the
  ``check_vma`` keyword the reference passes; the subprocess points it at
  ``jax.shard_map``, which takes it (ROADMAP C13)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_jobs  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.models.model import ExecConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.training import (TrainConfig, init_train_state,  # noqa: E402
                                  make_train_step)
from test_torch_generation import _leaves, _models  # noqa: E402
from test_torch_models import _close_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [("granite-3-8b", 2), ("mamba2-1.3b", 2), ("zamba2-7b", 3)]
KW = dict(d_model=64, vocab=128)
# 3 query heads over the model axis's 2 (padded to 4, 2 a rank: rank 1
# holds one real head), 1 K/V head picked on both; wq's columns split
# mid-head, as phi4-mini's 24 heads over 16 do
UNEVEN = ("phi4-mini-3.8b", dict(n_layers=2, d_model=48, vocab=128,
                                 n_heads=3, n_kv_heads=1))
TRAIN = dict(arch="granite-3-8b", reduce=dict(n_layers=2, **KW),
             loss_chunk=8, steps=2)
MOE = dict(arch="qwen2-moe-a2.7b", reduce=dict(n_layers=2, **KW),
           moe=dict(n_experts=7, top_k=2))
MOE_CASES = {"no_drops": 8.0, "drops": 1.0}
TOL = dict(rtol=1e-5, atol=1e-5)

# the reference's expert-parallel moe_ffn on a 2x2 mesh of forced host
# devices, on the inputs in the .npz named by argv[1]; writes its outputs
# to argv[2]
_REF_MOE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import ShapeSpec, get_arch, reduced
from repro.distributed.sharding import make_policy
from repro.models import moe
# the reference calls jax.experimental.shard_map.shard_map with check_vma,
# which this jax's experimental function does not take (it is check_rep
# there); jax.shard_map takes check_vma, with the same meaning
moe.shard_map = lambda f, mesh, in_specs, out_specs, check_vma: \
    jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_vma=check_vma)
spec = json.loads(sys.argv[3])
arch = reduced(get_arch(spec["arch"]), **spec["reduce"])
arch = dataclasses.replace(arch, param_dtype="float32",
                           moe=dataclasses.replace(arch.moe, **spec["moe"]))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
inp = np.load(sys.argv[1])
x = jnp.asarray(inp["x"])
pol = make_policy(arch, ShapeSpec("t", "prefill", x.shape[1], x.shape[0]),
                  mesh)
p = {k: jnp.asarray(inp["p_" + k]) for k in ("router", "w_gate", "w_up",
                                              "w_down")}
out = {}
for name, cf in spec["cases"].items():
    o, aux = jax.jit(lambda x, p: moe.moe_ffn(x, p, arch, pol, cf))(x, p)
    out["out_" + name], out["aux_" + name] = np.asarray(o), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


class _StandInMesh:
    """2x2 ("data", "model") names and sizes: the reference's padded
    expert count without devices."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


def _moe_inputs():
    """x (4, 8, D) and layer 0's routed-expert leaves of the reference's
    reduced MoE arch, 7 experts padded to 8 for ep = 2."""
    from repro.configs import ShapeSpec as JaxShape
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.distributed.sharding import make_policy as jax_policy
    from repro.models.model import LM as JaxLM
    arch = jax_reduced(jax_get_arch(MOE["arch"]), **MOE["reduce"])
    arch = dataclasses.replace(arch, param_dtype="float32",
                               moe=dataclasses.replace(arch.moe,
                                                       **MOE["moe"]))
    x = np.random.default_rng(5).standard_normal(
        (4, 8, arch.d_model)).astype(np.float32)
    lm = JaxLM(arch, jax_policy(arch, JaxShape("t", "prefill", 8, 4),
                                _StandInMesh()))
    seg = lm.init(jax.random.key(0))[f"seg{len(lm.segments) - 1}"]
    return x, {k: np.asarray(seg[k][0]) for k in ("router", "w_gate",
                                                  "w_up", "w_down")}


def _start_reference_moe(tmp, x, p):
    inp, out = os.path.join(tmp, "moe_in.npz"), os.path.join(tmp,
                                                             "moe_out.npz")
    np.savez(inp, x=x, **{"p_" + k: v for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_MOE, inp, out,
         json.dumps(dict(MOE, cases=MOE_CASES))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    return proc, out


def _lm_case(name, n_layers, reduce=None):
    """The job (the reference's weights and tokens) and, to finish while
    the ranks run, the JAX LM's logits and last cache (op by op, as
    ``tests/test_torch_generation.py`` runs it: under ``jax.jit`` XLA
    sums zamba2's SSD in another order, 2e-5 off). ``reduce`` replaces
    the reduced config's sizes."""
    if reduce is None:
        jm, jp, _, _ = _models(name, n_layers, "float32", window=2)
        reduce = dict(n_layers=n_layers, **KW)
    else:
        jm = JaxLM(dataclasses.replace(jax_reduced(jax_get_arch(name),
                                                   **reduce),
                                       param_dtype="float32"),
                   exec_cfg=ExecConfig(recent_window=2))
        jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jm.arch.vocab, (4, 40))
    steps = list(rng.integers(2, jm.arch.vocab, (4, 4)))
    job = dict(kind="lm", arch=name, reduce=reduce,
               tokens=toks, steps=steps, s_max=48, window=2,
               flush_after=(2, 4), params=jax.tree.map(np.asarray, jp))

    def want():
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), s_max=48)
        logits = [np.asarray(jl)]
        for i, tok in enumerate(steps):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
            logits.append(np.asarray(jl))
            if i + 1 in job["flush_after"]:
                jc = jm.maybe_flush(jc)
        return {"logits": logits, "cache": jc}
    return job, want


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Every job on the four ranks, and what each is held against. The
    ranks, the reference's sharded MoE (a subprocess) and the JAX LM runs
    (here) go on at once."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    jobs, wants = {}, {}
    for name, n in LM_ARCHS:
        jobs[name], wants[name] = _lm_case(name, n)
    jobs["uneven"], wants["uneven"] = _lm_case(UNEVEN[0], 0, UNEVEN[1])
    rng = np.random.default_rng(11)
    toks = rng.integers(0, KW["vocab"], (4, 16))
    jobs["train"] = dict(kind="train", tokens=toks,
                         labels=np.roll(toks, -1, axis=1), **TRAIN)
    jobs["ckpt"] = dict(kind="ckpt", arch="granite-3-8b",
                        reduce=dict(n_layers=2, **KW))
    x, p = _moe_inputs()
    for case, cf in MOE_CASES.items():
        jobs["moe_" + case] = dict(kind="moe", x=x, cf=cf, p=p, **MOE)
    proc, moe_out = _start_reference_moe(tmp, x, p)
    try:
        ranks = torch_dist_jobs.start(tmp, jobs)
        want = {name: w() for name, w in wants.items()}
        got = torch_dist_jobs.finish(tmp, ranks)
        log = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-3000:]
    want["moe"] = dict(np.load(moe_out))
    return got, want


def _np_leaves(tree):
    """Leaves of a gathered tree in ``_leaves``' order (dicts by key;
    a MambaCache is a list in its field order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree]


@pytest.mark.parametrize("name", [n for n, _ in LM_ARCHS] + ["uneven"])
def test_sharded_generation_matches_jax(dist_run, name):
    got, want = dist_run[0][name], dist_run[1][name]
    assert any("Shard(dim=1)" in pl for pl in _np_leaves(got["layout"])
               if isinstance(pl, str))           # batch over "data"
    if name in ("granite-3-8b", "uneven"):      # rank 0's heads, 2 of 4
        assert got["b2_heads"] == [2] * 2        # or of 3 padded to 4
    assert len(got["logits"]) == len(want["logits"]) == 5
    ssm = name in ("mamba2-1.3b", "zamba2-7b")
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        tol = dict(rtol=1e-5, atol=2e-5 * np.abs(w).max()) if ssm and i \
            else TOL
        np.testing.assert_allclose(g, w, err_msg=f"{name} step {i}", **tol)
    jl = list(_leaves(want["cache"]))
    gl = _np_leaves(got["cache"])
    assert len(gl) == len(jl)
    for g, (path, w) in zip(gl, jl):
        if np.asarray(w).dtype == jnp.bfloat16:  # conv windows: bf16 always
            _close_model(torch.from_numpy(g), w, "bfloat16")
            continue
        tol = dict(rtol=1e-3, atol=1e-3) if path.endswith("ssm_state") \
            else TOL
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), err_msg=path,
                                   **tol)


def test_sharded_train_step_matches_unsharded(dist_run):
    got = dist_run[0]["train"]
    job_toks = np.random.default_rng(11).integers(0, KW["vocab"], (4, 16))
    arch = dataclasses.replace(reduced(get_arch("granite-3-8b"),
                                       **TRAIN["reduce"]),
                               param_dtype="float32")
    model = LM(arch, device="cpu", loss_chunk=TRAIN["loss_chunk"])
    cfg = TrainConfig()
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   cfg)
    step = make_train_step(model, cfg)
    batch = {"tokens": torch.from_numpy(job_toks),
             "labels": torch.from_numpy(np.roll(job_toks, -1, axis=1))}
    losses = []
    for _ in range(TRAIN["steps"]):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert any("Shard" in v for v in got["layout"].values())
    want = _np_leaves(torch_dist_jobs._tree(params, lambda t: t.numpy()))
    gl = _np_leaves(got["params"])
    assert len(gl) == len(want)
    for g, w in zip(gl, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_load_with_shardings_round_trips(dist_run):
    got = dist_run[0]["ckpt"]
    assert got["layout"]["wq"] == "(Replicate(), Shard(dim=2))"
    saved = _np_leaves(got["saved"])
    for name in ("loaded", "resaved"):
        leaves = _np_leaves(got[name])
        assert len(leaves) == len(saved) > 0
        for g, w in zip(leaves, saved):
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_expert_parallel_moe_matches_reference(dist_run, case):
    got, ref = dist_run[0]["moe_" + case], dist_run[1]["moe"]
    assert got["ep"] == 2 and got["w_gate_local"][0] == 4
    np.testing.assert_allclose(got["out"], ref["out_" + case], **TOL)
    want_aux = ref["aux_" + case]
    np.testing.assert_allclose(got["aux"][0], want_aux[0], **TOL)
    assert got["aux"][1] == want_aux[1]
    assert (want_aux[1] > 0) == (case == "drops")
