"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``), with no devices:
both run on a stand-in mesh object. Twins of ``tests/test_dryrun.py``'s
fast tests; then, for all 64 cells (10 archs x their applicable shapes x
the 16x16 and 2x16x16 meshes), ``make_policy``'s rules, ``param_specs()``
and ``cache_specs(...)`` equal the reference's entry by entry, and each
device's resident bytes (params, and the cache for a serving cell) from
the port's placements equal those from the reference's specs and template
shapes. Also each kernel wrapper's refusal of a DTensor."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import shape_applicable as jax_applicable  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, LONG_500K,  # noqa: E402
                                 SHAPES_BY_NAME, get_arch,
                                 shape_applicable)
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.sharding import PSpec, Policy  # noqa: E402
from repro_torch.models.mamba2 import MambaCache  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from torch_dist_jobs import fake_world, wrapper_calls  # noqa: E402


class FakeMesh:
    """The reference tests' stand-in mesh: axis names and sizes only."""

    def __init__(self, multi_pod: bool):
        self.axis_names = ("pod", "data", "model") if multi_pod \
            else ("data", "model")
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


CELLS = [(a, s, mp) for mp in (False, True) for a in ASSIGNED_ARCHS
         for s in SHAPES_BY_NAME if shape_applicable(get_arch(a),
                                                     SHAPES_BY_NAME[s])]


def test_cells_are_the_reference_cells():
    want = [(a, s, mp) for mp in (False, True) for a in JAX_ARCHS
            for s in JAX_SHAPES if jax_applicable(jax_get_arch(a),
                                                  JAX_SHAPES[s])]
    assert CELLS == want and len(CELLS) == 64


# ---------------------------------------------------------------------------
# twins of tests/test_dryrun.py's fast tests
# ---------------------------------------------------------------------------
def test_policy_no_mesh_is_noop():
    p = Policy()
    assert p.spec(("batch", None)) == PSpec() == ()
    assert p.constrain(1.5, ("batch",)) == 1.5
    t = torch.ones(3)
    assert p.constrain(t, ("batch",)) is t


def test_spec_for_shape_drops_nondivisible():
    pol = Policy(mesh=FakeMesh(False), rules={"batch": ("data",),
                                              "vocab": ("model",)})
    assert pol.spec_for_shape(("batch", "vocab"), (256, 4096)) == \
        ("data", "model")
    # 49155 % 16 != 0 -> vocab dropped
    assert pol.spec_for_shape(("batch", "vocab"), (256, 49155)) == \
        ("data", None)


def test_long500k_applicability():
    assert shape_applicable(get_arch("mamba2-1.3b"), LONG_500K)
    assert shape_applicable(get_arch("zamba2-7b"), LONG_500K)
    assert not shape_applicable(get_arch("qwen2.5-32b"), LONG_500K)
    assert not shape_applicable(get_arch("llama-3.2-vision-90b"), LONG_500K)


def test_placements_keep_mesh_order_or_raise():
    """A dim over several axes in mesh order becomes one ``Shard`` a mesh
    dim; out of mesh order it raises, never reorders."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(True)
    assert tsh.placements(PSpec(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(PSpec(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(PSpec(("data", "model", "pod")), mesh)


def test_out_of_order_batch_is_never_laid_out():
    """``fsdp_pure`` training on 2x16x16 names the batch ("data", "model",
    "pod"), out of mesh order. Every layout here is shape-aware, and the
    batch (256) does not divide by 512, so "pod" drops: the constraint
    lays the batch out over ("data", "model") and nothing reaches the
    raise, which the spec without a shape would."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    arch = get_arch("granite-3-8b")
    pol = tsh.make_policy(arch, SHAPES_BY_NAME["train_4k"], FakeMesh(True))
    assert pol.rules["batch"] == ("data", "model", "pod")
    assert pol.spec_for_shape(("batch", None), (256, 4096)) == \
        (("data", "model"), None)
    with pytest.raises(ValueError, match="mesh order"):
        pol.placements(("batch", None, None))
    with fake_world(512, (2, 16, 16), ("pod", "data", "model")) as mesh:
        pol = tsh.make_policy(arch, SHAPES_BY_NAME["train_4k"], mesh)
        x = DTensor.from_local(torch.zeros(256, 2, 4), mesh,
                               [Replicate()] * 3)
        y = pol.constrain(x, ("batch", None, None))
        assert tuple(y.placements) == (Replicate(), Shard(0), Shard(0))


def test_production_and_worker_meshes():
    """The reference's mesh shapes and names over the world's ranks, and
    its RuntimeError on a world too small (here no process group)."""
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_worker_mesh)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device_type="cpu")
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        assert (mesh.shape, mesh.mesh_dim_names) == ((16, 16),
                                                     ("data", "model"))
        with pytest.raises(RuntimeError, match="need 512 devices"):
            make_production_mesh(multi_pod=True, device_type="cpu")
        worker = make_worker_mesh(4, device_type="cpu")
        assert (worker.shape, worker.mesh_dim_names) == ((1, 4),
                                                         ("data", "model"))


# ---------------------------------------------------------------------------
# all 64 cells against the reference
# ---------------------------------------------------------------------------
def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_port(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, MambaCache):
        return [x for f, t in zip(("ssm_state", "conv_x", "conv_bc"),
                                  tree.leaves())
                for x in _flat_port(t, f"{path}/{f}")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PSpec):
        return [x for i, t in enumerate(tree)
                for x in _flat_port(t, f"{path}/{i}")]
    return [(path, tree)]


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    def name(p):
        return getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))
    return [("".join(f"/{name(p)}" for p in path), leaf)
            for path, leaf in flat]


def _policies(a, s, mp):
    mesh = FakeMesh(mp)
    return (tsh.make_policy(get_arch(a), SHAPES_BY_NAME[s], mesh),
            jsh.make_policy(jax_get_arch(a), JAX_SHAPES[s], mesh))


@pytest.mark.parametrize("a,s,mp", CELLS, ids=[
    f"{a}-{s}-{'pod2' if mp else 'pod1'}" for a, s, mp in CELLS])
def test_cell_specs_match_reference(a, s, mp):
    tp, jp = _policies(a, s, mp)
    assert tp.rules == jp.rules
    assert (tp.params_mode, tp.attn_mode) == (jp.params_mode, jp.attn_mode)
    assert tp.axis_size("experts") == jp.axis_size("experts")
    shape = SHAPES_BY_NAME[s]
    tm, jm = LM(get_arch(a), tp, device="cpu"), JaxLM(jax_get_arch(a), jp)
    for got, want in ((tm.param_specs(), jm.param_specs()),
                      (tm.cache_specs(shape.global_batch, shape.seq_len),
                       jm.cache_specs(shape.global_batch, shape.seq_len))):
        g, w = _flat_port(got), _flat_ref(want)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, gs), (_, ws) in zip(g, w):
            assert isinstance(gs, PSpec), path
            assert tuple(gs) == tuple(ws), path
            tsh.placements(gs, FakeMesh(mp))      # every spec has one


@pytest.mark.parametrize("a,s,mp", CELLS, ids=[
    f"{a}-{s}-{'pod2' if mp else 'pod1'}" for a, s, mp in CELLS])
def test_cell_resident_bytes_match_reference(a, s, mp):
    """Per device: the port's leaves (fake tensors) divided by the port's
    placements, against the reference's ``eval_shape`` leaves divided by
    its specs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    tp, jp = _policies(a, s, mp)
    mesh = FakeMesh(mp)
    shape = SHAPES_BY_NAME[s]
    serve = shape.kind != "train"
    tm, jm = LM(get_arch(a), tp, device="cpu"), JaxLM(jax_get_arch(a), jp)
    def leaves(node):                 # the port's template, experts padded
        return {k: leaves(v) if isinstance(v, dict) else torch.empty(
            v[0], dtype=torch.float32 if v[2] == -2.0 else tm.dtype)
            for k, v in node.items()}
    with FakeTensorMode():
        tree = {"params": leaves(tm.param_template())}
        if serve:
            tree["cache"] = LM(get_arch(a), device="cpu").init_cache(
                shape.global_batch, shape.seq_len)
    specs = {"params": tm.param_specs()}
    jtree = {"params": jax.eval_shape(lambda: jm.init(jax.random.key(0)))}
    jspecs = {"params": jm.param_specs()}
    if serve:
        specs["cache"] = tm.cache_specs(shape.global_batch, shape.seq_len)
        jtree["cache"] = jax.eval_shape(
            lambda: jm.init_cache(shape.global_batch, shape.seq_len))
        jspecs["cache"] = jm.cache_specs(shape.global_batch, shape.seq_len)

    def port_local(t, spec):
        out = list(t.shape)
        for i, pl in enumerate(tsh.placements(spec, mesh)):
            if isinstance(pl, Shard):
                out[pl.dim] //= mesh.shape[mesh.axis_names[i]]
        return math.prod(out) * t.element_size()
    got = sum(port_local(t, sp) for (_, t), (_, sp) in zip(
        _flat_port(tree), _flat_port(specs)) if isinstance(t, torch.Tensor))

    def ref_local(t, spec):
        out = list(t.shape)
        for d, entry in enumerate(spec):
            for ax in (() if entry is None else (entry,)
                       if isinstance(entry, str) else entry):
                out[d] //= mesh.shape[ax]
        return math.prod(out) * jnp.dtype(t.dtype).itemsize
    jl, jsl = _flat_ref(jtree), _flat_ref(jspecs)
    want = sum(ref_local(t, sp) for (_, t), (_, sp) in zip(jl, jsl)
               if t.shape)
    assert got == want > 0


# ---------------------------------------------------------------------------
# kernel wrappers refuse a DTensor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "paged_decode_attention", "ssd_scan"])
def test_kernel_wrapper_refuses_dtensor(name):
    """A DTensor reaching a kernel wrapper, as it would at a call site
    without its ``local_map``, raises TypeError; the local tensor goes
    through."""
    from torch.distributed.tensor import DTensor, Replicate
    call = wrapper_calls()[name]
    with fake_world(2) as mesh:
        with pytest.raises(TypeError, match="DTensor"):
            call(lambda t: DTensor.from_local(t, mesh,
                                              [Replicate(), Replicate()]))
    out = call(lambda t: t)
    assert np.isfinite(np.asarray((out[0] if isinstance(out, tuple)
                                   else out).float())).all()
