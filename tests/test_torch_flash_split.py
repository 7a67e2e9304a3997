"""The numerics of kernel B2's fp32 route on the CPU: the kernel takes each
fp32 product on the tensor cores as three tf32 products of split operands
(hi = tf32(x) to nearest, lo = x - hi read truncated to tf32; hi.hi + hi.lo
+ lo.hi in fp32), and ``flash_attention_split`` repeats that in plain
PyTorch. Held against the reference's jnp oracle (``flash_attention_ref``)
within the fp32 gate that the card holds the kernel to (2e-5), at reduced
shapes of the engine's chunked prefill: the chunk's queries at a q_offset
against context plus chunk keys, kv_len cut inside a 32-key tile, a
sequence that sees no key. A single tf32 product misses that gate, which
is why the kernel splits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref, ops)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _tf32, flash_attention_split, split_einsum)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _oracle(qkv, q_offset, kv_len):
    q, k, v = (jnp.asarray(x) for x in qkv)
    return np.asarray(jax_flash_ref(q, k, v, causal=True, q_offset=q_offset,
                                    kv_len=jnp.asarray(kv_len)), np.float32)


def _f32(x: float) -> float:
    return float(np.float32(x))


@pytest.mark.parametrize("x,hi", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),               # a tie goes away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),             # below the tie: down
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),            # a tie above an odd value
    (2 - 2 ** -23, 2.0),                        # the carry into the exponent
    (0.0, 0.0),
])
def test_tf32_rounds_to_nearest_ties_away(x, hi):
    got = _tf32(torch.tensor([_f32(x)]))
    assert got.item() == _f32(hi)
    lo = torch.tensor([_f32(x)]) - got
    assert (got + lo).item() == _f32(x)          # the split is exact
    assert abs(lo.item()) <= 2 ** -11 * abs(_f32(x))


def test_split_einsum_is_fp32_accurate_and_one_tf32_product_is_not():
    """hi.hi + hi.lo + lo.hi is within ~2^-20 of each term's magnitude of
    the exact product; hi.hi alone, a plain tf32 product, is ~2^-11 off."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 128)).astype(np.float32))
    exact = torch.einsum("ik,jk->ij", a.double(), b.double())
    scale = torch.einsum("ik,jk->ij", a.abs().double(), b.abs().double())
    split = split_einsum("ik,jk->ij", a, b).double()
    one = torch.einsum("ik,jk->ij", _tf32(a), _tf32(b)).double()
    assert float(((split - exact).abs() / scale).max()) < 2 ** -19
    assert float(((one - exact).abs() / scale).max()) > 2 ** -14


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,q_offset", [(64, 192, 128), (32, 96, 64)])
def test_split_matches_jax_oracle_at_chunk_shapes(hq, hkv, d, sq, skv,
                                                  q_offset):
    """Two sequences: the first sees all context plus chunk keys, the
    second's kv_len ends 13 keys into a 32-key tile of the chunk."""
    qkv = _inputs(hq * d + sq, 2, sq, skv, hq, hkv, d)
    kv_len = np.array([skv, q_offset + 13], np.int32)
    got = flash_attention_split(*map(torch.from_numpy, qkv), causal=True,
                                q_offset=q_offset,
                                kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), _oracle(qkv, q_offset, kv_len),
                               **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_split_row_with_no_key_is_the_mean_of_v(d):
    """kv_len 0: the oracle's uniform softmax of all-masked logits, the
    mean of V over every key (C7); its logsumexp is +inf, the other
    sequence's equals the plain version's."""
    qkv = _inputs(d, 2, 32, 96, 8, 2, d)
    kv_len = np.array([0, 77], np.int32)
    q, k, v = map(torch.from_numpy, qkv)
    kl = torch.from_numpy(kv_len)
    got, lse = flash_attention_split(q, k, v, causal=True, q_offset=64,
                                     kv_len=kl, return_lse=True)
    np.testing.assert_allclose(got.numpy(), _oracle(qkv, 64, kv_len), **TOL)
    mean_v = v[0].mean(dim=0).repeat_interleave(4, dim=0)   # (Hq, D)
    np.testing.assert_allclose(got[0].numpy(),
                               mean_v[None].expand(32, 8, d).numpy(), **TOL)
    _, want = flash_attention_ref(q, k, v, causal=True, q_offset=64,
                                  kv_len=kl, return_lse=True)
    assert bool(torch.isinf(lse[0]).all())
    torch.testing.assert_close(lse[1], want[1], **TOL)


def test_single_tf32_products_miss_the_fp32_gate(monkeypatch):
    """The same attention with one tf32 product where the kernel takes
    three misses 2e-5 at the path's widths: the split is needed."""
    qkv = _inputs(3, 1, 64, 192, 4, 4, 128)
    kv_len = np.array([192], np.int32)
    monkeypatch.setattr(ops, "split_einsum", lambda eq, a, b: torch.einsum(
        eq, _tf32(a), _tf32(b)))
    one = flash_attention_split(*map(torch.from_numpy, qkv), causal=True,
                                q_offset=128, kv_len=torch.from_numpy(kv_len))
    assert not np.allclose(one.numpy(), _oracle(qkv, 128, kv_len), **TOL)


@pytest.mark.parametrize("b,sq,skv,hq,q_offset,kv_len,splits", [
    (1, 64, 576, 32, 512, None, 4),         # the chunked path's tails
    (1, 128, 896, 32, 768, None, 2),
    (1, 256, 768, 32, 512, None, 1),        # a full chunk: 128 q tiles
    (2, 100, 300, 8, 200, [0, 250], 4),     # ragged, kv_len 0 and mid-tile
    (1, 32, 128, 4, 96, [77], 2),           # one split per 64 keys at most
])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_tiles_cover_every_visible_key_once(b, sq, skv, hq, q_offset,
                                                kv_len, splits, causal):
    """The fp32 kernel's CTAs (``f32_tiles``): the key splits of a 64-row
    q tile and their two key groups load every key that a row of the tile
    sees exactly once, and nothing past the tile's last visible key; the
    splits fill the card where the q tiles alone would not."""
    assert ops.f32_kv_splits(b, sq, skv, hq) == splits
    ctas = ops.f32_tiles(b, sq, skv, hq, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    assert len(ctas) == -(-sq // 64) * hq * b * splits
    seen = {}
    for bb, h, q0, split, g0, g1 in ctas:
        assert 0 <= split < splits and len(g0) - len(g1) in (0, 1)
        for k0, n in g0 + g1:
            for key in range(k0, k0 + n):
                seen[(bb, h, q0, key)] = seen.get((bb, h, q0, key), 0) + 1
    assert max(seen.values(), default=1) == 1
    for bb in range(b):
        lim = skv if kv_len is None else min(skv, kv_len[bb])
        for q0 in range(0, sq, 64):
            last = min(q0 + 64, sq) - 1
            want = 0 if lim <= 0 else \
                min(lim, q_offset + last + 1) if causal else lim
            for h in range(hq):
                got = sorted(k for (b_, h_, q_, k) in seen
                             if (b_, h_, q_) == (bb, h, q0))
                assert got == list(range(want))
