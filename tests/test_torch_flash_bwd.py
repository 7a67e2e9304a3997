"""Kernel B2's backward on the CPU: what the backward kernel reads and how
it walks its tiles, held against the reference.

- The plain forward's logsumexp (``flash_attention_ref(...,
  return_lse=True)``, the quantity the forward kernel writes for the
  backward): exp(scale q k^T - lse) @ v reproduces the reference's
  ``flash_attention_ref`` on every row that sees a key, lse equals the
  masked scores' logsumexp, and a row that sees no key gets +inf.
- ``flash_attention_bwd`` given that lse equals it recomputing lse.
- ``bwd_tiles`` (the backward kernel's visits): every (query row, key) pair
  that the plain version's mask allows is visited exactly once, no pair
  outside a visited tile is allowed, and no tile visited is wholly masked,
  over causal masking with a q_offset, kv_len with a dead sequence, GQA
  groups 1, 4 and 8, and both the bf16 (128 keys a CTA) and fp32 (64)
  tilings; in bf16 the CTA's two warpgroups (64 keys each, both walking
  the CTA's visits) reach every allowed pair exactly once too; and with no
  kv_len the CTAs launch longest first.

Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_tiles, flash_attention_bwd, flash_attention_ref)

LSE_CASES = [
    # b, sq, skv, hq, hkv, d, causal, q_offset, kv_len, kv_chunk
    (2, 32, 32, 4, 2, 16, True, 0, None, 256),      # causal, one chunk
    (1, 24, 40, 4, 4, 16, False, 0, None, 16),      # 40 % 16: dense form
    (2, 16, 48, 4, 2, 32, False, 0, None, 16),      # chunked
    (2, 8, 40, 4, 2, 16, True, 32, None, 16),       # causal, q_offset
    (2, 8, 24, 4, 2, 16, True, 16, [0, 20], 8),     # a sequence sees no key
    (2, 12, 12, 4, 1, 16, False, 0, [12, 0], 4),    # MQA, dead batch
    (1, 20, 36, 8, 1, 16, True, 16, [30], 12),      # kv_len cuts mid-chunk
]
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _inputs(case, dtype, seed):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _mask(b, sq, skv, causal, q_offset, kv_len):
    """(B, Sq, Skv): which keys each query row sees."""
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    m = np.ones((b, sq, skv), bool)
    if causal:
        m &= (kpos <= qpos)[None]
    if kv_len is not None:
        m &= kpos[None] < np.asarray(kv_len)[:, None, None]
    return m


@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_reproduces_the_output(case, dtype):
    b, sq, skv, hq, hkv, d, causal, q_offset, kv_len, kv_chunk = case
    arrs, (q, k, v, _) = _inputs(case, dtype, len(str(case)))
    klt = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=klt, kv_chunk=kv_chunk,
                                   return_lse=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=klt,
        kv_chunk=kv_chunk))
    seen = torch.from_numpy(_mask(b, sq, skv, causal, q_offset, kv_len))
    live = seen.any(-1)                                   # (B, Sq)
    assert torch.isinf(lse).equal(~live[:, None, :].expand(b, hq, sq))
    assert bool((lse[torch.isinf(lse)] > 0).all())
    # lse is the masked scores' logsumexp
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    s = torch.where(seen[:, None], s, -torch.inf)
    want = torch.logsumexp(s, dim=-1)
    fin = live[:, None, :].expand(b, hq, sq)
    torch.testing.assert_close(lse[fin], want[fin], rtol=1e-5, atol=1e-5)
    # exp(S - lse) @ v is the output of every row that sees a key
    p = torch.exp(s - lse[..., None])
    rebuilt = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    ref = np.asarray(jax_flash_ref(
        *(jnp.asarray(a, jnp.float32 if dtype == torch.float32
                      else jnp.bfloat16) for a in arrs[:3]),
        causal=causal, q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
        kv_chunk=kv_chunk).astype(jnp.float32))
    rows = live.numpy()
    np.testing.assert_allclose(rebuilt.numpy()[rows], ref[rows],
                               **TOL[dtype])
    np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("case", LSE_CASES)
def test_bwd_with_lse_equals_recomputed(case):
    b, sq, skv, hq, hkv, d, causal, q_offset, kv_len, kv_chunk = case
    _, (q, k, v, do) = _inputs(case, torch.float32, 7 + len(str(case)))
    klt = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=klt, kv_chunk=kv_chunk,
                                   return_lse=True)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=klt)
    for got, want in zip(flash_attention_bwd(q, k, v, out, do, lse=lse, **kw),
                         flash_attention_bwd(q, k, v, out, do, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


TILE_CASES = [
    # b, sq, skv, hq, hkv, causal, q_offset, kv_len
    (1, 100, 100, 4, 4, True, 0, None),           # MHA square, ragged
    (2, 64, 300, 8, 2, True, 236, None),          # GQA 4, q_offset
    (2, 200, 520, 8, 1, True, 320, [0, 450]),     # MQA 8, dead sequence
    (1, 130, 260, 4, 1, False, 0, None),          # full, GQA 4
    (2, 70, 130, 8, 1, False, 0, [129, 5]),       # kv_len cuts tiles
    (1, 1, 4096, 8, 8, True, 4095, None),         # one row, long cache
    (1, 256, 256, 8, 1, True, 0, [200]),          # causal and kv_len
]


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("bf16", [True, False])
def test_bwd_tiles_visit_every_allowed_pair_once(case, bf16):
    b, sq, skv, hq, hkv, causal, q_offset, kv_len = case
    allowed = _mask(b, sq, skv, causal, q_offset, kv_len)   # (B, Sq, Skv)
    count = np.zeros((b, hq, sq, skv), np.int32)
    ctas = bwd_tiles(b, sq, skv, hq, hkv, causal=causal, q_offset=q_offset,
                     kv_len=kv_len, bf16=bf16)
    bk = 128 if bf16 else 64
    assert len(ctas) == -(-skv // bk) * hkv * b
    for bb, hk, k0, keys, visits in ctas:
        assert k0 % bk == 0 and 0 < keys <= bk and k0 + keys <= skv
        for h, q0, rows in visits:
            assert h // (hq // hkv) == hk and q0 % 64 == 0 and rows <= 64
            tile = allowed[bb, q0:q0 + rows, k0:k0 + keys]
            assert tile.any(), f"tile {(bb, h, q0, k0)} is wholly masked"
            count[bb, h, q0:q0 + rows, k0:k0 + keys] += 1
    want = np.broadcast_to(allowed[:, None], count.shape)
    assert (count <= 1).all()
    np.testing.assert_array_equal(count.astype(bool) & want, want)


@pytest.mark.parametrize("case", TILE_CASES)
def test_bwd_tiles_warpgroups_split_each_cta(case):
    """bf16: a CTA's two warpgroups take 64 of its keys each (keys k0 ..
    k0 + 63 and k0 + 64 .., the second fewer or none where Skv ends) and
    both walk all its visits; every allowed (row, key) pair is reached by
    exactly one (warpgroup, visit)."""
    b, sq, skv, hq, hkv, causal, q_offset, kv_len = case
    allowed = _mask(b, sq, skv, causal, q_offset, kv_len)
    count = np.zeros((b, hq, sq, skv), np.int32)
    for bb, hk, k0, keys, visits in bwd_tiles(
            b, sq, skv, hq, hkv, causal=causal, q_offset=q_offset,
            kv_len=kv_len):
        halves = [(w0, max(0, min(64, k0 + keys - w0)))
                  for w0 in (k0, k0 + 64)]
        assert sum(n for _, n in halves) == keys
        for w0, n in halves:
            for h, q0, rows in visits:
                count[bb, h, q0:q0 + rows, w0:w0 + n] += 1
    want = np.broadcast_to(allowed[:, None], count.shape)
    assert (count <= 1).all()
    np.testing.assert_array_equal(count.astype(bool) & want, want)


@pytest.mark.parametrize("case", [c for c in TILE_CASES if c[7] is None])
@pytest.mark.parametrize("bf16", [True, False])
def test_bwd_tiles_launch_longest_first(case, bf16):
    """With no kv_len no CTA has more visits than one launched before it:
    key tile 0, seen from every query tile under causal masking, first."""
    b, sq, skv, hq, hkv, causal, q_offset, _ = case
    counts = [len(c[4]) for c in bwd_tiles(b, sq, skv, hq, hkv,
                                           causal=causal, q_offset=q_offset,
                                           bf16=bf16)]
    assert counts == sorted(counts, reverse=True) and counts[0] > 0
