"""Training on the card: kernels B2, B3 and B4 under autograd.

On CUDA, B2 (flash attention), B3 (RMSNorm) and B4 (the SSD scan) run
inside ``torch.autograd.Function``s whose forward is the kernel and whose
backward is a backward kernel: B2's (``flash_attention_backward``, reading
the logsumexp its forward writes), B3's (``rmsnorm_backward``) and B4's
(``ssd_scan_backward``, held against its closed form ``ssd_scan_bwd`` over
a grid in ``tests/test_torch_cuda_ssd.py``). B2 and B3 are held here,
forward and gradients, against autograd of their plain versions on the
same CUDA tensors, each backward kernel launched once a call: B2 over the
grid of ``tests/test_torch_cuda_flash.py`` (causal and not, query groups
1-8, head dims 64, 112 and 128, key counts 1, 63, 64, 65, 1601 and 4096,
zamba2-7b's 32 heads of 112 at 4096), a kv_len case with a sequence that
sees no key, and dK and dV equal bit for bit over two runs; B3 over the
grid of its CPU sweep, a weight of the other type, and the training
shape; B4's gradients equal the plain version's. B1 has no backward and
must refuse an input that requires grad. A reduced fp32 model's every
parameter gets a finite gradient on the card, equal to the CPU's:
granite-3-8b and llama2-7b, and the SSM and hybrid families, mamba2-1.3b
and zamba2-7b.

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward, flash_attention_ref)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm, rmsnorm_backward, rmsnorm_ref)
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_scan, ssd_scan_backward)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.training import DataConfig, batch_at_step  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dev, dtype, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _grads_against_plain(kernel_fn, plain_fn, inputs, dout):
    """Forward and gradients of ``kernel_fn`` (the wrapper, on CUDA inputs
    that require grad) and of ``plain_fn`` under autograd."""
    outs = []
    for fn in (kernel_fn, plain_fn):
        xs = [t.detach().clone().requires_grad_() for t in inputs]
        y = fn(*xs)
        outs.append((y, torch.autograd.grad(y, xs, dout)))
    torch.cuda.synchronize()
    return outs


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


FLASH_GRID = [
    # b, sq, skv, hq, hkv, d, causal, dtypes
    (1, 128, 128, 4, 4, 64, True, DTYPES),         # MHA square
    (2, 64, 64, 8, 2, 64, True, DTYPES),           # GQA
    (2, 128, 128, 8, 1, 64, False, DTYPES),        # MQA, full
    (1, 32, 128, 4, 4, 128, True, DTYPES),         # rectangular, q_offset
    (2, 100, 1, 8, 8, 128, False, DTYPES),         # key counts at the edges
    (2, 100, 63, 8, 2, 128, False, DTYPES),        # of the 64-key tiles
    (2, 100, 64, 8, 1, 128, False, DTYPES),
    (2, 100, 65, 8, 8, 128, False, DTYPES),
    (2, 100, 1601, 8, 1, 128, False, DTYPES),      # the VLM frontend's
    (2, 256, 256, 32, 32, 112, True, [torch.bfloat16]),   # zamba2's heads
    (1, 512, 4096, 8, 2, 128, False, DTYPES),      # 4096 keys
    (1, 4096, 4096, 8, 2, 128, True, [torch.bfloat16]),   # training length
    (2, 4096, 4096, 32, 32, 112, True, [torch.bfloat16]),  # zamba2 training
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,dtype", [
    case[:7] + (dt,) for case in FLASH_GRID for dt in case[7]])
def test_flash_function_matches_autograd_of_plain(card, b, sq, skv, hq, hkv,
                                                   d, causal, dtype):
    gen = torch.Generator(device=card).manual_seed(sq * 7 + skv)
    q = _randn(gen, card, dtype, b, sq, hq, d)
    k, v = (_randn(gen, card, dtype, b, skv, hkv, d) for _ in range(2))
    dout = _randn(gen, card, dtype, b, sq, hq, d)
    q_offset = skv - sq if causal else 0
    before = (flash_attention.launches, flash_attention_backward.launches)
    (out, grads), (want, wgrads) = _grads_against_plain(
        lambda *a: flash_attention(*a, causal=causal, q_offset=q_offset),
        lambda *a: flash_attention_ref(*a, causal=causal, q_offset=q_offset),
        (q, k, v), dout)
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    assert out.grad_fn is not None
    _close(out, want, dtype)
    for g, w in zip(grads, wgrads):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_function_kv_len_and_masked_rows(card, dtype):
    """q_offset and kv_len, with a sequence that sees no key (its rows
    get the mean of V, so dQ is 0 and dV gets dO / Skv)."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = _randn(gen, card, dtype, 2, 64, 8, 128)
    k, v = (_randn(gen, card, dtype, 2, 200, 4, 128) for _ in range(2))
    dout = _randn(gen, card, dtype, 2, 64, 8, 128)
    kl = torch.tensor([0, 150], dtype=torch.int32, device=card)
    before = flash_attention_backward.launches
    (out, grads), (want, wgrads) = _grads_against_plain(
        lambda *a: flash_attention(*a, causal=True, q_offset=136, kv_len=kl),
        lambda *a: flash_attention_ref(*a, causal=True, q_offset=136,
                                       kv_len=kl), (q, k, v), dout)
    assert flash_attention_backward.launches == before + 1
    _close(out, want, dtype)
    for g, w in zip(grads, wgrads):
        _close(g, w, dtype)
    assert not bool(grads[0][0].float().any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_dk_dv_are_deterministic(card, dtype):
    """dK and dV accumulate in each CTA's registers and are written once:
    two backward runs give them bit for bit (dQ, summed by atomics, may
    differ in its last bits)."""
    gen = torch.Generator(device=card).manual_seed(11)
    q = _randn(gen, card, dtype, 2, 1000, 8, 128)
    k, v = (_randn(gen, card, dtype, 2, 1000, 2, 128) for _ in range(2))
    dout = _randn(gen, card, dtype, 2, 1000, 8, 128)
    xs = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention(*xs, causal=True)
    runs = [torch.autograd.grad(out, xs, dout, retain_graph=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    _close(runs[0][0], runs[1][0], dtype)


def test_flash_without_grad_launches_bare(card):
    q, k, v = (torch.randn(1, 64, 4, 64, device=card) for _ in range(3))
    assert flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q, k, v).grad_fn is not None


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (1, 256), (3, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_function_matches_autograd_of_plain(card, shape, dtype,
                                                     with_res):
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    x, r, dy = (_randn(gen, card, dtype, *shape) for _ in range(3))
    w = _randn(gen, card, dtype, shape[-1])
    inputs = (x, w, r) if with_res else (x, w)
    before = (rmsnorm.launches, rmsnorm_backward.launches)
    (y, grads), (want, wgrads) = _grads_against_plain(
        lambda *a: rmsnorm(*a, eps=1e-5), lambda *a: rmsnorm_ref(*a, eps=1e-5),
        inputs, dy)
    assert (rmsnorm.launches, rmsnorm_backward.launches) == (
        before[0] + 1, before[1] + 1) and y.grad_fn is not None
    _close(y, want, dtype)
    for g, w_ in zip(grads, wgrads):
        _close(g, w_, dtype)


def test_rmsnorm_function_mixed_weight_dtype(card):
    """fp32 activations normed with a bf16 weight: dx in fp32, dw in
    bf16."""
    gen = torch.Generator(device=card).manual_seed(5)
    x, dy = (_randn(gen, card, torch.float32, 5, 96) for _ in range(2))
    w = _randn(gen, card, torch.bfloat16, 96)
    (y, grads), (want, wgrads) = _grads_against_plain(
        lambda *a: rmsnorm(*a, eps=1e-5), lambda *a: rmsnorm_ref(*a, eps=1e-5),
        (x, w), dy)
    assert grads[0].dtype == torch.float32 and grads[1].dtype == torch.bfloat16
    _close(grads[0], wgrads[0], torch.float32)
    _close(grads[1], wgrads[1], torch.bfloat16)


def test_rmsnorm_function_training_shape(card):
    gen = torch.Generator(device=card).manual_seed(8)
    x, dy = (_randn(gen, card, torch.bfloat16, 8192, 4096) for _ in range(2))
    w = _randn(gen, card, torch.bfloat16, 4096)
    (y, grads), (want, wgrads) = _grads_against_plain(
        lambda *a: rmsnorm(*a, eps=1e-5), lambda *a: rmsnorm_ref(*a, eps=1e-5),
        (x, w), dy)
    _close(y, want, torch.bfloat16)
    _close(grads[0], wgrads[0], torch.bfloat16)
    # dw sums 8192 rows: bf16 rounding of the sum, relative to its size
    torch.testing.assert_close(grads[1].float(), wgrads[1].float(),
                               rtol=2e-2, atol=2e-2 * float(
                                   wgrads[1].float().abs().max()))


def test_paged_decode_refuses_grad(card):
    q = torch.randn(2, 8, 128, device=card, requires_grad=True)
    kp = torch.randn(4, 16, 8, 128, device=card)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=card)
    ln = torch.tensor([5, 9], dtype=torch.int32, device=card)
    before = paged_decode_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        paged_decode_attention(q, kp, kp, bt, ln)
    assert paged_decode_attention.launches == before
    with torch.no_grad():
        assert paged_decode_attention(q, kp, kp, bt, ln).shape == q.shape


def test_ssd_scan_refuses_grad(card):
    """B4 no longer refuses an input that requires grad: its gradients
    (forward kernel, then the backward kernel, one launch each) are finite
    and equal the plain version's under autograd; under no_grad it
    launches the forward alone."""
    b, s, h, p, g, n = 1, 64, 2, 16, 1, 16
    x = torch.randn(b, s, h, p, device=card, requires_grad=True)
    dt = torch.rand(b, s, h, device=card)
    a = -torch.rand(h, device=card)
    bm, cm = (torch.randn(b, s, g, n, device=card) for _ in range(2))
    d = torch.ones(h, device=card)
    dy = torch.randn(b, s, h, p, device=card)
    before = (ssd_scan.launches, ssd_scan_backward.launches)
    (y, _), (want, _) = (fn(x, dt, a, bm, cm, d, chunk=32)
                         for fn in (ssd_scan, ssd_chunked_ref))
    (dx,), (dx_want,) = (torch.autograd.grad(t, [x], dy)
                         for t in (y, want))
    assert (ssd_scan.launches, ssd_scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(dx).all())
    _close(y, want, torch.float32)
    torch.testing.assert_close(dx, dx_want, rtol=1e-4,
                               atol=1e-4 * float(dx_want.abs().max()))
    with torch.no_grad():
        assert ssd_scan(x, dt, a, bm, cm, d, chunk=32)[0].shape == x.shape
    assert ssd_scan_backward.launches == before[1] + 1


def _cpu_and_card_grads(card, arch, counters):
    """Every leaf's gradient of ``train_loss`` on one batch, on the CPU
    and on the card from the same params; the launches of ``counters``
    during the card's forward and backward."""
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(1))
    batch = batch_at_step(DataConfig(vocab=512, seq_len=128,
                                     global_batch=2), 0)
    grads, launched = {}, None
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = [c.launches for c in counters]
        loss, _ = LM(arch, device=dev, loss_chunk=64).train_loss(p, b)
        leaves = tree_leaves(p)
        grads[str(dev)] = torch.autograd.grad(loss, leaves,
                                              allow_unused=True)
        if dev == card:
            launched = [c.launches - n for c, n in zip(counters, before)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert g is not None and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))
    return launched


@pytest.mark.parametrize("name,d_model", [("granite-3-8b", 256),
                                          ("llama2-7b", 512)])
def test_every_parameter_gets_the_cpus_gradient(card, name, d_model):
    """Reduced fp32 model (heads of 64 or 128): on the card every leaf's
    gradient exists, is finite and equals the CPU's within 1e-4 of the
    leaf's largest; B2 and B3 launched in the forward, and their backward
    kernels in the backward."""
    arch = dataclasses.replace(
        reduced(get_arch(name), n_layers=2, d_model=d_model, vocab=512),
        param_dtype="float32")
    assert _cpu_and_card_grads(card, arch, (
        flash_attention, rmsnorm, flash_attention_backward,
        rmsnorm_backward)) == [2, 5, 2, 5]


@pytest.mark.parametrize("name,n_layers,mamba,attn", [
    ("mamba2-1.3b", 4, 4, 0), ("zamba2-7b", 5, 3, 2)])
def test_ssm_every_parameter_gets_the_cpus_gradient(card, name, n_layers,
                                                    mamba, attn):
    """Reduced fp32 Mamba-2 and hybrid models (d_model 256: SSD heads of
    16, a state of 16, chunks of 32 over 128 tokens; zamba2's shared
    attention heads of 64): every leaf's card gradient exists, is finite
    and equals the CPU's within 1e-4 of the leaf's largest; B4's forward
    and backward kernels launched once per Mamba layer, B2's forward and
    backward once per attention site, B3's once per norm."""
    arch = dataclasses.replace(
        reduced(get_arch(name), n_layers=n_layers, d_model=256, vocab=512),
        param_dtype="float32")
    got = _cpu_and_card_grads(card, arch, (
        ssd_scan, ssd_scan_backward, flash_attention, rmsnorm,
        flash_attention_backward, rmsnorm_backward))
    norms = mamba + 2 * attn + 1
    assert got == [mamba, mamba, attn, norms, attn, norms]
