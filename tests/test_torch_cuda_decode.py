"""Kernel B1 (paged decode attention) on the card: the CUDA kernel against
its plain version (``paged_decode_ref``) and against the plain version of
its own partition and merge (``paged_decode_split_ref``), over head dims,
query groups (1, 2, 3, 4, 8), page sizes, both types and the lengths at the
edges of its splits: 0 (C7), 1, a split's span and one past it, the block
table's last position and past it.

These tests need an NVIDIA card and nvcc (the kernel is built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_decode.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_ref, paged_decode_split_ref,
    split_plan)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, dtype, hq, hkv, d, page, max_pages, n_pages=48, seed=0):
    """Inputs whose lengths sit at the edges of the kernel's splits; block
    tables drawn over the whole pool (page 0 included)."""
    pages, _ = split_plan(8, hkv, max_pages, page)
    span, cap = pages * page, max_pages * page
    lengths = [0, 1, span, span + 1, cap, cap + 5, min(2 * span + 3, cap),
               max(1, cap // 3)]
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q = randn(len(lengths), hq, d)
    k, v = randn(n_pages, page, hkv, d), randn(n_pages, page, hkv, d)
    bt = torch.randint(0, n_pages, (len(lengths), max_pages), generator=g,
                       device=dev, dtype=torch.int32)
    return q, k, v, bt, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (8, 4), (12, 4), (32, 8),
                                    (16, 2)])
@pytest.mark.parametrize("page,max_pages", [(16, 64), (8, 20), (32, 3),
                                            (1, 130)])
def test_paged_decode_kernel_matches_plain(card, dtype, d, hq, hkv, page,
                                           max_pages):
    q, k, v, bt, ln = _case(card, dtype, hq, hkv, d, page, max_pages)
    got = paged_decode_attention(q, k, v, bt, ln)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    for want in (paged_decode_ref(q, k, v, bt, ln),
                 paged_decode_split_ref(q, k, v, bt, ln)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_paged_decode_kernel_counts_one_launch_a_call(card):
    q, k, v, bt, ln = _case(card, torch.float32, 32, 32, 128, 16, 64)
    before = paged_decode_attention.launches
    paged_decode_attention(q, k, v, bt, ln)
    assert paged_decode_attention.launches == before + 1
