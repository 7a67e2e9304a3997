"""Kernel B2 (flash attention) on the card: the CUDA kernel against its
plain version (``flash_attention_ref``, on the same CUDA tensors) over the
grid of the CPU sweep in ``tests/test_torch_kernels.py`` (head dims raised
to 64 where that grid has 16 or 32, below what the kernel takes), causal
and not; non-causal key counts at the edges of its 64-key tiles (1, 63,
64, 65 and the VLM frontend's 1601) with query groups 1, 4 and 8 and
Sq != Skv; the mixed-dtype route of ``cross_attention_full`` (a bf16
layer and an fp32 frontend: q joins k and v in fp32); the chunked
prefill's ``q_offset`` / ``kv_len`` cases and rows that see no key; the
fp32 route (split-tf32 tensor-core products) at the shapes of llama2-7b's
chunked prefill with ``prefill_chunk=256`` and its tails, beside its
numerics in plain PyTorch (``flash_attention_split``), its logsumexp and
gradients under autograd, and its launches counted by route.

These tests need an NVIDIA card and nvcc (the kernel is built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_flash.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref, ops)
from repro_torch.models.attention import cross_attention_full  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, b, sq, skv, hq, hkv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)


def _check(q, k, v, **kw):
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[q.dtype])


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 64, 64, 8, 2, 64),        # GQA
    (2, 128, 128, 8, 1, 64),      # MQA
    (1, 32, 128, 4, 4, 128),      # rectangular (chunked prefill q block)
])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_sweep(card, b, sq, skv, hq, hkv, d, dtype, causal):
    q, k, v = _qkv(card, dtype, b, sq, skv, hq, hkv, d)
    _check(q, k, v, causal=causal, q_offset=skv - sq if causal else 0)


@pytest.mark.parametrize("skv", [1, 63, 64, 65, 1601])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_cross_at_tile_edges(card, skv, group, dtype):
    """Non-causal, Sq != Skv, no q_offset or kv_len: every key is seen,
    and the last K/V tile may hold a single one (1601 = 25 x 64 + 1)."""
    q, k, v = _qkv(card, dtype, 2, 100, skv, 8, 8 // group, 128, seed=skv)
    _check(q, k, v, causal=False)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_cross_at_the_vlm_heads(card, dtype):
    """llama-3.2-vision-90b's cross-attention: 64 query heads over 8, 1601
    frontend keys."""
    q, k, v = _qkv(card, dtype, 1, 160, 1601, 64, 8, 128)
    _check(q, k, v, causal=False)


def test_cross_attention_mixed_dtype_route(card):
    """A bf16 layer and an fp32 frontend: k and v are projected in fp32
    and q joins them for B2's fp32 path; the output comes back in bf16 and
    agrees with the same layer on the CPU (plain versions)."""
    arch = dataclasses.replace(
        reduced(get_arch("llama-3.2-vision-90b"), n_layers=2, d_model=256,
                vocab=64), param_dtype="bfloat16", n_frontend_tokens=65)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    p = {k: t[0] for k, t in params["seg0"]["cross"].items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 40, 256), generator=g).to(torch.bfloat16)
    fr = torch.randn((2, 65, 256), generator=g)
    before = flash_attention.launches
    got, (gk, gv) = cross_attention_full(
        x.to(card), fr.to(card), {k: t.to(card) for k, t in p.items()}, arch,
        return_kv=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, (wk, wv) = cross_attention_full(x, fr, p, arch, return_kv=True)
    assert got.dtype == torch.bfloat16 and gk.dtype == torch.float32
    for g_, w_ in ((gk, wk), (gv, wv)):
        torch.testing.assert_close(g_.cpu(), w_, rtol=1e-4, atol=1e-4)
    want = want.float()
    torch.testing.assert_close(got.cpu().float(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_offset_and_kv_len(card, dtype):
    q, k, v = _qkv(card, dtype, 2, 64, 256, 4, 2, 64, seed=1)
    kl = torch.tensor([100, 256], dtype=torch.int32, device=card)
    _check(q, k, v, causal=True, q_offset=192, kv_len=kl)


@pytest.mark.parametrize("ctx,c", [(0, 8), (8, 8), (16, 32), (40, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_chunked_prefill_shapes(card, ctx, c, dtype):
    """The engine's chunk call: context K/V + chunk, q_offset = ctx."""
    q, k, v = _qkv(card, dtype, 1, c, ctx + c, 4, 2, 64, seed=2)
    kl = torch.full((1,), ctx + c, dtype=torch.int32, device=card)
    _check(q, k, v, causal=True, q_offset=ctx, kv_len=kl)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_fully_masked_rows(card, dtype):
    """kv_len 0 sees no key: the mean of V, as the plain version gives."""
    q, k, v = _qkv(card, dtype, 2, 16, 128, 4, 2, 64, seed=5)
    kl = torch.tensor([0, 100], dtype=torch.int32, device=card)
    _check(q, k, v, causal=True, q_offset=100, kv_len=kl)


def test_flash_kernel_refuses_mixed_dtypes(card):
    q, k, v = _qkv(card, torch.bfloat16, 1, 16, 16, 4, 4, 64)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v.float(), causal=False)


def test_flash_kernel_counts_one_launch_a_call(card):
    q, k, v = _qkv(card, torch.bfloat16, 1, 64, 65, 8, 8, 128)
    before = flash_attention.launches
    flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1


# llama2-7b's chunked prefill at prefill_chunk=256 (32/32 heads of 128):
# (Sq, Skv, q_offset) of the full chunks and of the tails the engine pads to
# a power-of-two bucket; kv_len = Skv, as the engine passes it
CHUNK_SHAPES = [(256, 256, 0), (256, 512, 256), (256, 768, 512),
                (256, 1024, 768), (64, 576, 512), (128, 896, 768),
                (64, 832, 768)]


@pytest.mark.parametrize("sq,skv,q_offset", CHUNK_SHAPES)
def test_flash_f32_at_the_chunked_path_shapes(card, sq, skv, q_offset):
    q, k, v = _qkv(card, torch.float32, 1, sq, skv, 32, 32, 128, seed=sq)
    kl = torch.full((1,), skv, dtype=torch.int32, device=card)
    _check(q, k, v, causal=True, q_offset=q_offset, kv_len=kl)
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kl)
    want = ops.flash_attention_split(q, k, v, causal=True, q_offset=q_offset,
                                     kv_len=kl)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("cut", [1, 13, 31, 32, 33])
def test_flash_f32_kv_len_inside_a_tile(card, cut):
    """kv_len ends ``cut`` keys into the chunk (32-key tiles)."""
    q, k, v = _qkv(card, torch.float32, 2, 256, 768, 32, 32, 128, seed=cut)
    kl = torch.tensor([512 + cut, 768], dtype=torch.int32, device=card)
    _check(q, k, v, causal=True, q_offset=512, kv_len=kl)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_gqa_d64_rows_with_no_key(card, causal):
    """D = 64, 8 query heads over 2, a sequence with kv_len 0 (the mean of
    V) beside one cut mid-tile; a ragged Sq."""
    q, k, v = _qkv(card, torch.float32, 2, 100, 300, 8, 2, 64, seed=7)
    kl = torch.tensor([0, 250], dtype=torch.int32, device=card)
    _check(q, k, v, causal=causal, q_offset=200 if causal else 0, kv_len=kl)


@pytest.mark.parametrize("sq,skv,q_offset", [(256, 768, 512), (100, 300, 0)])
def test_flash_f32_lse_and_gradients_under_autograd(card, sq, skv, q_offset):
    """The forward kernel's logsumexp (what the backward reads) against the
    plain version's, and the gradients through the autograd Function
    against autograd of the plain version (fp32 backward gate: 1e-4 of each
    gradient's largest value)."""
    q, k, v = _qkv(card, torch.float32, 1, sq, skv, 8, 8, 128, seed=3)
    lse = torch.empty((1, 8, sq), dtype=torch.float32, device=card)
    out = ops._launch(q, k, v, True, q_offset, None, None, lse)
    want, want_lse = flash_attention_ref(q, k, v, causal=True,
                                         q_offset=q_offset, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    dout = torch.randn_like(q)
    got = torch.autograd.grad(
        flash_attention(*xs, causal=True, q_offset=q_offset), xs, dout)
    ref = torch.autograd.grad(
        flash_attention_ref(*xs, causal=True, q_offset=q_offset), xs, dout)
    for g, w in zip(got, ref):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


def test_flash_counts_launches_by_route(card):
    """``launches`` counts every launch, ``launches_fp32`` and
    ``launches_bf16`` each route's."""
    before = (flash_attention.launches, flash_attention.launches_fp32,
              flash_attention.launches_bf16)
    for dtype in (torch.float32, torch.bfloat16, torch.float32):
        flash_attention(*_qkv(card, dtype, 1, 64, 96, 4, 4, 64), causal=True,
                        q_offset=32)
    assert (flash_attention.launches, flash_attention.launches_fp32,
            flash_attention.launches_bf16) == (before[0] + 3, before[1] + 2,
                                               before[2] + 1)
