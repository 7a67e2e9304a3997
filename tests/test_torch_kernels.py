"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, over the reference's own sweeps. The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_pallas, paged_decode_ref as jax_paged_ref)
from repro.kernels.flash_attention import (  # noqa: E402
    attention_dense_ref as jax_dense_ref, flash_attention_pallas,
    flash_attention_ref as jax_flash_ref)
from repro.kernels.rmsnorm import (rmsnorm_pallas,  # noqa: E402
                                   rmsnorm_ref as jax_rmsnorm_ref)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_ref, paged_decode_split_ref,
    split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_dense_ref, flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    launch_plan, tile_rows)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_ref  # noqa: E402

_TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor of one dtype."""
    j = jnp.asarray(rng.standard_normal(shape), dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(_TORCH_DT[dtype])
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 64, 64, 8, 2, 32),        # GQA
    (2, 128, 128, 8, 1, 64),      # MQA
    (1, 32, 128, 4, 4, 128),      # rectangular (chunked prefill q block)
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_pallas_sweep(b, sq, skv, hq, hkv, d, dtype, causal):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (b, sq, hq, d), dtype)
    kj, kt = _pair(rng, (b, skv, hkv, d), dtype)
    vj, vt = _pair(rng, (b, skv, hkv, d), dtype)
    off = skv - sq if causal else 0
    got = flash_attention(qt, kt, vt, causal=causal, q_offset=off)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, q_offset=off,
                                    block_q=32, block_k=32, interpret=True)
    _close(got, pallas, dtype)
    _close(got, jax_dense_ref(qj, kj, vj, causal=causal, q_offset=off),
           dtype)
    _close(attention_dense_ref(qt, kt, vt, causal=causal, q_offset=off),
           pallas, dtype)


@pytest.mark.parametrize("kv_chunk", [16, 64, 256])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_offset_and_kv_len(kv_chunk, dtype):
    """The runtime q_offset / kv_len mode the engine's chunked prefill uses
    (no Pallas counterpart): held against the reference's jnp oracles."""
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, 64, 4, 32), dtype)
    kj, kt = _pair(rng, (2, 256, 2, 32), dtype)
    vj, vt = _pair(rng, (2, 256, 2, 32), dtype)
    kvlen = np.array([100, 256], np.int32)
    kl_j, kl_t = jnp.asarray(kvlen), torch.from_numpy(kvlen)
    got = flash_attention(qt, kt, vt, causal=True, q_offset=192,
                          kv_len=kl_t, kv_chunk=kv_chunk)
    _close(got, jax_flash_ref(qj, kj, vj, causal=True, q_offset=192,
                              kv_len=kl_j, kv_chunk=kv_chunk), dtype)
    _close(got, jax_dense_ref(qj, kj, vj, causal=True, q_offset=192,
                              kv_len=kl_j), dtype)


@pytest.mark.parametrize("ctx,c", [(0, 8), (8, 8), (16, 32), (40, 16)])
def test_flash_chunked_prefill_shapes(ctx, c):
    """Exactly the engine's chunk call: context KV + chunk, q_offset=ctx."""
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (1, c, 4, 16), jnp.float32)
    kj, kt = _pair(rng, (1, ctx + c, 2, 16), jnp.float32)
    vj, vt = _pair(rng, (1, ctx + c, 2, 16), jnp.float32)
    kl = np.full((1,), ctx + c, np.int32)
    got = flash_attention(qt, kt, vt, causal=True, q_offset=ctx,
                          kv_len=torch.from_numpy(kl))
    _close(got, jax_flash_ref(qj, kj, vj, causal=True, q_offset=ctx,
                              kv_len=jnp.asarray(kl)), jnp.float32)


@pytest.mark.parametrize("b,hq,hkv,d,page,npages,maxp", [
    (2, 8, 2, 64, 16, 32, 4),
    (4, 4, 4, 32, 8, 16, 8),
    (1, 16, 1, 128, 32, 8, 2),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_sweep(b, hq, hkv, d, page, npages, maxp, dtype):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (b, hq, d), dtype)
    kj, kt = _pair(rng, (npages, page, hkv, d), dtype)
    vj, vt = _pair(rng, (npages, page, hkv, d), dtype)
    bt = rng.integers(0, npages, (b, maxp)).astype(np.int32)
    lengths = rng.integers(1, maxp * page + 1, (b,)).astype(np.int32)
    got = paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                 torch.from_numpy(lengths))
    pallas = paged_decode_attention_pallas(
        qj, kj, vj, jnp.asarray(bt), jnp.asarray(lengths), interpret=True)
    _close(got, pallas, dtype)
    _close(got, jax_paged_ref(qj, kj, vj, jnp.asarray(bt),
                              jnp.asarray(lengths)), dtype)


# test_paged_decode_sweep's grid, then shapes whose walk spans several of
# kernel B1's splits (split_plan: 64 positions at page 16, one page of 64,
# two pages of 32), the last split cut short
SPLIT_GRID = [
    (2, 8, 2, 64, 16, 32, 4),
    (4, 4, 4, 32, 8, 16, 8),
    (1, 16, 1, 128, 32, 8, 2),
    (2, 8, 2, 64, 16, 32, 9),
    (3, 4, 4, 32, 64, 12, 3),
    (2, 16, 2, 128, 32, 16, 5),
]


def _paged_inputs(rng, b, hq, hkv, d, page, npages, maxp, dtype, lengths):
    qj, qt = _pair(rng, (b, hq, d), dtype)
    kj, kt = _pair(rng, (npages, page, hkv, d), dtype)
    vj, vt = _pair(rng, (npages, page, hkv, d), dtype)
    bt = rng.integers(0, npages, (b, maxp)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    return ((qj, kj, vj, jnp.asarray(bt), jnp.asarray(lengths)),
            (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(lengths)))


@pytest.mark.parametrize("b,hq,hkv,d,page,npages,maxp", SPLIT_GRID)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_split_ref_sweep(b, hq, hkv, d, page, npages, maxp,
                                      dtype):
    """B1's partition into splits and its merge (``paged_decode_split_ref``)
    against the Pallas kernel in interpret mode and the jnp oracle, at the
    unchanged tolerances."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, maxp * page + 1, (b,))
    J, T = _paged_inputs(rng, b, hq, hkv, d, page, npages, maxp, dtype,
                         lengths)
    got = paged_decode_split_ref(*T)
    assert got.dtype == T[0].dtype and got.shape == T[0].shape
    _close(got, paged_decode_attention_pallas(*J, interpret=True), dtype)
    _close(got, jax_paged_ref(*J), dtype)


@pytest.mark.parametrize("b,hq,hkv,d,page,npages,maxp", SPLIT_GRID[3:])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_split_ref_at_split_edges(b, hq, hkv, d, page, npages,
                                               maxp, dtype):
    """Lengths at the edges of the splits: 1, one and two whole splits and
    one past each, the block table's last position, and 0 (no visible
    position: the mean of V over the whole row, as the jnp oracle gives;
    the Pallas kernel, which skips every page of such a row, is held to
    the other rows only)."""
    span = split_plan(b, hkv, maxp, page)[0] * page
    cap = maxp * page
    lengths = [1, span, span + 1, 2 * span, 2 * span + 1, cap, 0]
    assert all(n <= cap for n in lengths)
    rng = np.random.default_rng(3)
    J, T = _paged_inputs(rng, len(lengths), hq, hkv, d, page, npages, maxp,
                         dtype, lengths)
    got = paged_decode_split_ref(*T)
    _close(got, jax_paged_ref(*J), dtype)
    _close(got[:-1], paged_decode_attention_pallas(
        *J, interpret=True)[:-1], dtype)
    _close(got, paged_decode_ref(*T).float(), dtype)


@pytest.mark.parametrize("b,hkv,maxp,page", [
    (8, 32, 64, 16),      # the engine's decode (llama2-7b, 8 slots)
    (1, 32, 64, 16),      # one sequence
    (8, 8, 64, 16),       # GQA 32/8
    (64, 32, 64, 16),     # a large batch: longer splits
    (2, 2, 9, 16), (3, 4, 3, 64), (4, 4, 8, 8), (1, 1, 2, 32),
    (2, 1, 130, 1),       # pages of one position
    (1, 1, 20000, 1),     # more pages than 256 splits of 64 would hold
])
def test_split_plan_covers_every_position_once(b, hkv, maxp, page):
    """Split s covers [s * span, (s + 1) * span) cut at the block table's
    end: for every length, each position before it lies in exactly one
    split, and no split starts at or past max_pages * page. A split holds
    at most 64 pages, and a sequence has at most 256 splits unless its
    splits are already 64 pages (the wrapper then refuses the call)."""
    pages, n = split_plan(b, hkv, maxp, page)
    cap, span = maxp * page, pages * page
    assert 1 <= pages <= 64
    assert n <= 256 or pages == 64
    assert (n - 1) * span < cap <= n * span
    for length in sorted({1, span - 1, span, span + 1, cap - 1, cap}):
        if not 0 < length <= cap:
            continue
        cover = np.zeros(length, np.int64)
        for s in range(n):
            lo, hi = s * span, min((s + 1) * span, cap, length)
            if lo < length:
                cover[lo:hi] += 1
        assert (cover == 1).all()


def test_split_plan_fills_the_card_at_the_main_path():
    """At the engine's decode shapes (8 slots, 32 kv heads, 64 pages of 16)
    the live splits put several CTAs on each of the H100's 132 SMs: with
    the main path's ragged batch (960, 544, 160 and five idle slots of
    length 1) and with one live sequence of 1024 positions beside seven
    idle slots."""
    pages, n = split_plan(8, 32, 64, 16)
    span = pages * 16
    assert n * 32 * 8 <= 4096 and pages * 16 >= 64
    for lengths in ((960, 544, 160, 1, 1, 1, 1, 1), (1024,) + (1,) * 7):
        live = sum(-(-length // span) for length in lengths) * 32
        assert live >= 2 * 132, (lengths, live)


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (1, 256), (3, 96)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_kernel_sweep(shape, dtype, with_res):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, shape, dtype)
    wj, wt = _pair(rng, shape[-1:], dtype)
    rj, rt = _pair(rng, shape, dtype) if with_res else (None, None)
    got = rmsnorm(xt, wt, rt)
    _close(got, rmsnorm_pallas(xj, wj, rj, interpret=True, block_rows=2),
           dtype)
    _close(got, jax_rmsnorm_ref(xj, wj, rj), dtype)


def test_rmsnorm_mixed_weight_dtype():
    """Decode normalises fp32 activations with bf16 weights."""
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (5, 96), jnp.float32)
    wj, wt = _pair(rng, (96,), jnp.bfloat16)
    _close(rmsnorm(xt, wt), jax_rmsnorm_ref(xj, wj), jnp.float32)


def test_cpu_tensors_never_build(monkeypatch):
    """A CPU tensor runs the plain version and never reaches the kernel
    build (this machine may have no nvcc and no card)."""
    def refuse(*a, **k):
        raise AssertionError("kernel build touched by a CPU call")
    for name in ("build", "module"):
        monkeypatch.setattr(_build, name, refuse)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 32))).float()
    kv = torch.from_numpy(rng.standard_normal((1, 16, 2, 32))).float()
    assert torch.equal(flash_attention(q, kv, kv),
                       flash_attention_ref(q, kv, kv))
    x = torch.from_numpy(rng.standard_normal((3, 32))).float()
    assert torch.equal(rmsnorm(x, x[0]), rmsnorm_ref(x, x[0]))
    pages = torch.from_numpy(rng.standard_normal((4, 8, 2, 32))).float()
    bt = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(paged_decode_attention(q[:, 0], pages, pages, bt, ln),
                       paged_decode_ref(q[:, 0], pages, pages, bt, ln))
    x = torch.from_numpy(rng.standard_normal((1, 5, 2, 8))).float()
    dt = torch.full((1, 5, 2), 0.05)
    bm = torch.from_numpy(rng.standard_normal((1, 5, 1, 4))).float()
    a = -torch.ones(2)
    for got, want in zip(ssd_scan(x, dt, a, bm, bm, a, chunk=4),
                         ssd_ref(x, dt, a, bm, bm, a)):
        assert torch.equal(got, want)


def test_non_cpu_non_cuda_tensor_raises():
    """No quiet fallback: a device that is neither CPU nor CUDA raises."""
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty((64,), device="meta"))
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, 0], q, q,
                               torch.empty((1, 1), dtype=torch.int32),
                               torch.empty((1,), dtype=torch.int32))
    h = torch.empty((2,), device="meta")
    with pytest.raises(ValueError):
        ssd_scan(torch.empty((1, 8, 2, 16), device="meta"),
                 torch.empty((1, 8, 2), device="meta"), h,
                 torch.empty((1, 8, 1, 16), device="meta"),
                 torch.empty((1, 8, 1, 16), device="meta"), h)


def test_flash_head_dim_112_matches_pallas():
    """zamba2-7b's shared attention block has heads of 112 (3584 / 32)."""
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (2, 64, 4, 112), jnp.bfloat16)
    kj, kt = _pair(rng, (2, 64, 4, 112), jnp.bfloat16)
    vj, vt = _pair(rng, (2, 64, 4, 112), jnp.bfloat16)
    got = flash_attention(qt, kt, vt, causal=True)
    _close(got, flash_attention_pallas(qj, kj, vj, causal=True, block_q=32,
                                       block_k=32, interpret=True),
           jnp.bfloat16)
    _close(got, jax_dense_ref(qj, kj, vj, causal=True), jnp.bfloat16)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kv_chunk", [64, 48])
def test_flash_fully_masked_row_matches_oracle(dtype, kv_chunk):
    """A sequence with kv_len 0 sees no key: the plain versions (chunked,
    and dense when Skv is not a multiple of the chunk) give what the jnp
    oracles give, the mean of V over all Skv keys. The CUDA kernel is held
    to the same answer on the card."""
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (2, 16, 4, 32), dtype)
    kj, kt = _pair(rng, (2, 128, 2, 32), dtype)
    vj, vt = _pair(rng, (2, 128, 2, 32), dtype)
    kvlen = np.array([0, 100], np.int32)
    got = flash_attention(qt, kt, vt, causal=True, q_offset=100,
                          kv_len=torch.from_numpy(kvlen), kv_chunk=kv_chunk)
    _close(got, jax_flash_ref(qj, kj, vj, causal=True, q_offset=100,
                              kv_len=jnp.asarray(kvlen), kv_chunk=kv_chunk),
           dtype)
    mean_v = vt[0].float().mean(dim=0)                   # (Hkv, D)
    want = mean_v.repeat_interleave(2, dim=0)[None].expand(16, 4, 32)
    _close(got[0], want.to(qt.dtype).float(), dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_fully_masked_row_matches_oracle(dtype):
    """lengths[b] == 0: the mean of V over every gathered position, as the
    jnp oracle computes it."""
    rng = np.random.default_rng(6)
    qj, qt = _pair(rng, (3, 8, 64), dtype)
    kj, kt = _pair(rng, (16, 8, 2, 64), dtype)
    vj, vt = _pair(rng, (16, 8, 2, 64), dtype)
    bt = rng.integers(0, 16, (3, 4)).astype(np.int32)
    lengths = np.array([0, 9, 32], np.int32)
    got = paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                 torch.from_numpy(lengths))
    _close(got, jax_paged_ref(qj, kj, vj, jnp.asarray(bt),
                              jnp.asarray(lengths)), dtype)


def test_build_digest_covers_every_kernel_header(tmp_path):
    """A header beside one kernel (``<kernel>/csrc/*.cuh``), not only the
    shared ``kernels/csrc`` ones, names the library: adding or editing one
    rebuilds it, and its directory is on the include path. No nvcc
    needed."""
    import shutil
    root = tmp_path / "kernels"
    shutil.copytree(_build.KERNELS_DIR, root,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    flags = _build.NVCC_FLAGS
    before = _build._digest(flags, root)
    assert _build._digest(flags, root) == before
    assert str(root / "flash_attention" / "csrc") in \
        _build.include_flags(root)
    new = root / "flash_attention" / "csrc" / "extra.cuh"
    new.write_text("#pragma once\n")
    added = _build._digest(flags, root)
    assert added != before
    new.write_text("#pragma once\n// edited\n")
    assert _build._digest(flags, root) not in (before, added)
    new.unlink()
    assert _build._digest(flags, root) == before
    shared = root / "csrc" / "common.cuh"
    shared.write_text(shared.read_text() + "\n")
    assert _build._digest(flags, root) != before


@pytest.mark.parametrize("which", [0, 1])
def test_build_name_covers_the_python_it_is_imported_by(monkeypatch, which):
    """The library is imported as a CPython extension module, so a build
    kept from another interpreter must not be reused: Python's include
    directory (its version) and the extension suffix (its ABI) name the
    library, beside the sources and flags. No nvcc needed."""
    import sysconfig
    abi = _build.python_abi()
    assert abi == [sysconfig.get_paths()["include"],
                   sysconfig.get_config_var("EXT_SUFFIX") or ""]
    before = _build.library_name()
    other = list(abi)
    other[which] += "-other"
    monkeypatch.setattr(_build, "python_abi", lambda: other)
    assert _build.library_name() != before
    monkeypatch.setattr(_build, "python_abi", lambda: abi)
    assert _build.library_name() == before


@pytest.mark.parametrize("b,sq,hq,block_q,tiles", [
    (1, 64, 32, 64, 32),          # llama2-7b buckets, 32 heads
    (1, 128, 32, 64, 64),
    (1, 512, 32, 64, 256),
    (1, 1024, 32, 128, 256),
    (2, 1024, 32, 128, 512),      # zamba2-7b, B=2
    (2, 1000, 32, 128, 512),      # ragged Sq
    (1, 512, 16, 64, 128),        # D=64 case, 16 heads
])
def test_flash_launch_plan(b, sq, hq, block_q, tiles):
    """The bf16 kernel takes 128-row q tiles only while that still gives a
    tile for every SM of the H100; otherwise 64 rows (two CTAs an SM). At
    the 512 and 1024 buckets the tiles fill the 132 SMs; at 128 tokens the
    32 heads give 64 tiles of 64 rows, the most a 64-row warpgroup tile
    allows without splitting the keys."""
    assert launch_plan(b, sq, hq) == (block_q, tiles)
    assert tiles == hq * -(-sq // block_q) * b
    if hq == 32 and sq >= 512:            # llama2-7b and zamba2-7b
        assert tiles >= 132


@pytest.mark.parametrize("sq", [64, 128, 1000, 1024])
@pytest.mark.parametrize("b,hq", [(1, 32), (2, 32), (1, 8)])
def test_flash_tiles_cover_rows_once_heaviest_first(b, sq, hq):
    """Every q row of every (batch, head) is covered by exactly one tile,
    and the tiles are taken in order of falling causal work (a q tile's
    last row bounds the keys it reads)."""
    tiles = tile_rows(b, sq, hq)
    seen = {}
    for z, h, r0, n in tiles:
        assert n > 0
        for r in range(r0, r0 + n):
            seen[(z, h, r)] = seen.get((z, h, r), 0) + 1
    assert set(seen.values()) == {1}
    assert len(seen) == b * hq * sq
    ends = [r0 + n for _, _, r0, n in tiles]
    assert ends == sorted(ends, reverse=True)


@pytest.mark.parametrize("what,err,make", [
    ("x fp16", TypeError, lambda x, w: (x.half(), w, None)),
    ("w int32", TypeError, lambda x, w: (x, w.int(), None)),
    ("w (32,)", ValueError, lambda x, w: (x, w[:32], None)),
    ("w (1, 64)", ValueError, lambda x, w: (x, w[None], None)),
    ("w on meta", ValueError, lambda x, w: (x, w.to("meta"), None)),
    ("x not contiguous", ValueError, lambda x, w: (x.t(), w[:4], None)),
    ("w not contiguous", ValueError,
     lambda x, w: (x, torch.ones((64, 2))[:, 0], None)),
    ("residual bf16", ValueError, lambda x, w: (x, w, x.bfloat16())),
    ("residual (4, 32)", ValueError, lambda x, w: (x, w, x[:, :32])),
    ("residual not contiguous", ValueError,
     lambda x, w: (x, w, torch.zeros((4, 128))[:, ::2])),
])
def test_rmsnorm_checks_refuse_what_the_kernel_does_not_take(what, err,
                                                             make):
    """The checks B3's wrapper runs before a launch, on CPU tensors: each
    input the kernel does not take raises its error type; the inputs the
    kernel takes pass."""
    from repro_torch.kernels.rmsnorm.ops import _check
    x, w = torch.zeros((4, 64)), torch.ones((64,))
    with pytest.raises(err):
        _check(*make(x, w))
    _check(x, w, None)
    _check(x, w.bfloat16(), x.clone())


def test_kernel_sources_include_no_torch_headers():
    """Every CUDA source builds with nvcc alone: the CPython binding
    includes Python.h, no source includes PyTorch's headers (minutes to
    compile), and Python's include directory is on the include path. Every
    kernel's source includes ``launch.cuh``, the declarations the binding
    calls, so the compiler holds each entry point to its declaration."""
    import re
    import sysconfig
    srcs = _build.sources() + _build.headers()
    assert any(p.name == "module.cu" for p in srcs)
    for p in srcs:
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', p.read_text()):
            assert not inc.startswith(("torch/", "ATen/", "c10/")), (p, inc)
    assert sysconfig.get_paths()["include"] in _build.include_flags()
    shared = _build.KERNELS_DIR / "csrc"
    kernels = [p for p in _build.sources() if p.parent != shared]
    assert len(kernels) == 9
    for p in kernels:
        assert '#include "launch.cuh"' in p.read_text(), p
