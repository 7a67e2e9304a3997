"""Kernel B4 on the card: the SSD scan's forward kernel and its backward
kernel (``ssd_scan_backward``, through ``ssd_scan``'s autograd Function)
against the plain versions on the same CUDA tensors.

The forward goes over ``tests/test_torch_ssd.py``'s grid (G = 2 < H among
it; a state of 8 raised to 16, which the kernel needs) plus ragged last
chunks, a chunk that is not a multiple of the kernels' 64-row tiles and
an S under the chunk, held against ``ssd_chunked_ref`` (or ``ssd_ref`` at
a ragged S); the backward over the same cases, with and
without an initial state and a final-state gradient, held against
``ssd_scan_bwd`` (the closed form, which ``tests/test_torch_ssd_bwd.py``
holds against the reference's autodiff on the CPU) and against autograd
of the plain forward. Inputs are drawn with numpy as that file draws
them. Tolerances: the forward at 2e-5 (fp32) and 2e-2 (bf16), the final
state at 1e-3 (the reference's ``test_ssd_sweep``); every gradient within
1e-4 (fp32) or 2e-2 (bf16) of its largest magnitude.

For bf16 inputs the backward kernel is also held against its own numerics
in plain PyTorch, ``ssd_scan_bwd(..., split=True)`` (every product with an
fp32 operand as bf16 hi and lo parts), within ``SPLIT_REL`` = 5e-3 of each
gradient's largest magnitude (rtol the same): what is left is the order of
fp32 sums and the bf16 rounding of dx, dB and dC, one bf16 step (2^-8 of
the value) where the two fp32 values round apart. It is checked at
mamba2-1.3b's and zamba2-7b's training shapes and at two groups, and its
outputs are the same, bit for bit, from call to call (no atomics).

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_ssd.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_ref, ssd_scan,
                                          ssd_scan_backward, ssd_scan_bwd)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
Y_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
         torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SPLIT_REL = 5e-3     # bf16: the kernel against ssd_scan_bwd(split=True)
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dinit")
# (b, s, h, p, g, n, chunk): test_torch_ssd.py's grid (its first case's
# state of 8 raised to 16, the kernel's multiple), then ragged last chunks,
# one at the models' head dim, state and chunk; then a chunk of 100, whose
# second 64-row tile is partial, and S under the chunk (a chunk of S)
GRID = [(2, 128, 4, 16, 2, 16, 32), (1, 64, 8, 32, 1, 16, 16),
        (2, 256, 2, 64, 2, 32, 64), (2, 50, 4, 16, 2, 16, 16),
        (2, 45, 4, 16, 1, 16, 32), (1, 1000, 2, 64, 1, 128, 256),
        (1, 250, 2, 32, 1, 32, 100), (2, 45, 2, 16, 1, 16, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, s, h, p, g, n, dtype, seed=4, init=True):
    """x, dt, A, Bm, Cm, D, init state, drawn as test_ssd_sweep draws
    them, and an output and a final-state gradient."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dt)
    x = t(rng.standard_normal((b, s, h, p)), dtype)
    dt = t(rng.uniform(0.001, 0.1, (b, s, h)))
    A = t(-rng.uniform(0.5, 2.0, (h,)))
    Bm = t(rng.standard_normal((b, s, g, n)), dtype)
    Cm = t(rng.standard_normal((b, s, g, n)), dtype)
    D = t(rng.standard_normal((h,)))
    st = t(rng.standard_normal((b, h, p, n)) * 0.1) if init else None
    dy = t(rng.standard_normal((b, s, h, p)), dtype)
    dfin = t(rng.standard_normal((b, h, p, n)))
    return [x, dt, A, Bm, Cm, D, st], dy, dfin


def _plain(x, dt, A, Bm, Cm, D, st, chunk):
    s = x.shape[1]
    q = min(chunk, s)
    if s % q:
        return ssd_ref(x, dt, A, Bm, Cm, D, st)
    return ssd_chunked_ref(x, dt, A, Bm, Cm, D, st, chunk=q)


def _grad_close(got, want, rel, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(torch.isfinite(got.float()).all()), what
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                               atol=rel * scale, msg=what)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("init", [True, False])
def test_forward_matches_plain(card, b, s, h, p, g, n, chunk, dtype, init):
    ins, _, _ = _inputs(card, b, s, h, p, g, n, dtype, init=init)
    before = ssd_scan.launches
    y, fin = ssd_scan(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    y_p, fin_p = _plain(*ins, chunk)
    assert y.dtype == dtype and fin.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **Y_TOL[dtype])
    torch.testing.assert_close(fin, fin_p, **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("with_dfinal", [True, False])
def test_backward_kernel_matches_plain(card, b, s, h, p, g, n, chunk, dtype,
                                       init, with_dfinal):
    """Every input's gradient through the autograd Function (forward and
    backward kernels, one launch each) against ``ssd_scan_bwd`` and
    against autograd of the plain forward."""
    ins, dy, dfin = _inputs(card, b, s, h, p, g, n, dtype, init=init)
    xs = [t.detach().clone().requires_grad_() if t is not None else None
          for t in ins]
    live = [t for t in xs if t is not None]
    n_f, n_b = ssd_scan.launches, ssd_scan_backward.launches
    y, fin = ssd_scan(*xs, chunk=chunk)
    assert y.grad_fn is not None
    outs, grads_out = ([y, fin], [dy, dfin]) if with_dfinal else ([y], [dy])
    got = torch.autograd.grad(outs, live, grads_out)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n_f + 1
    assert ssd_scan_backward.launches == n_b + 1
    closed = ssd_scan_bwd(*ins, dy, dfin if with_dfinal else None,
                          chunk=chunk)
    closed = closed if init else closed[:6]
    ps = [t.detach().clone().requires_grad_() if t is not None else None
          for t in ins]
    yp, fp = _plain(*ps, chunk)
    outs = [yp, fp] if with_dfinal else [yp]
    auto = torch.autograd.grad(outs, [t for t in ps if t is not None],
                               grads_out)
    for name, gk, gc, ga in zip(NAMES, got, closed, auto):
        _grad_close(gk, gc, GRAD_REL[dtype], f"{name} vs ssd_scan_bwd")
        _grad_close(gk, ga, GRAD_REL[dtype], f"{name} vs autograd")
    if dtype == torch.bfloat16:
        split = ssd_scan_bwd(*ins, dy, dfin if with_dfinal else None,
                             chunk=chunk, split=True)
        for name, gk, gs in zip(NAMES, got, split):
            _grad_close(gk, gs, SPLIT_REL, f"{name} vs split")


def test_backward_kernel_direct_call(card):
    """``ssd_scan_backward`` called on the forward's scratch gives the
    autograd Function's gradients, with dinit even without an initial
    state."""
    from repro_torch.kernels.ssd_scan.ops import _check, _launch
    ins, dy, dfin = _inputs(card, 2, 100, 4, 32, 2, 32, torch.float32,
                            seed=5, init=False)
    q = _check(*ins, 32)
    _, _, entry, cum = _launch(*ins, q)
    got = ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
    want = ssd_scan_bwd(*ins, dy, dfin, chunk=q)
    for gk, gc in zip(got, want):
        _grad_close(gk, gc, 1e-4, "direct")



# (b, s, h, p, g, n, chunk, init): mamba2-1.3b's and zamba2-7b's training
# microbatches (2 x 4096 tokens from a zero state), and two groups at the
# models' head dim, state and chunk, with an initial state
TRAIN_SHAPES = [(2, 4096, 64, 64, 1, 128, 256, False),
                (2, 4096, 112, 64, 1, 64, 256, False),
                (2, 1024, 8, 64, 2, 128, 256, True)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", TRAIN_SHAPES)
def test_backward_kernel_at_training_shapes(card, b, s, h, p, g, n, chunk,
                                            init):
    """bf16 at the training paths' shapes: the kernel against the closed
    form and autograd of the plain forward at ``GRAD_REL``, and against its
    split numerics at ``SPLIT_REL``; a second call gives the same bits."""
    from repro_torch.kernels.ssd_scan.ops import _check, _launch
    dtype = torch.bfloat16
    ins, dy, dfin = _inputs(card, b, s, h, p, g, n, dtype, seed=6,
                            init=init)
    dfin = dfin if init else None
    q = _check(*ins, chunk)
    _, _, entry, cum = _launch(*ins, q)
    got = ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
    again = ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
    torch.cuda.synchronize()
    for name, a, a2 in zip(NAMES, got, again):
        assert torch.equal(a, a2), f"{name}: two calls differ"
    closed = ssd_scan_bwd(*ins, dy, dfin, chunk=q)
    split = ssd_scan_bwd(*ins, dy, dfin, chunk=q, split=True)
    for name, gk, gc, gs in zip(NAMES, got, closed, split):
        _grad_close(gk, gc, GRAD_REL[dtype], f"{name} vs ssd_scan_bwd")
        _grad_close(gk, gs, SPLIT_REL, f"{name} vs split")
    del closed, split
    ps = [t.detach().clone().requires_grad_() if t is not None else None
          for t in ins]
    yp, fp = _plain(*ps, q)
    outs, cot = ([yp, fp], [dy, dfin]) if init else ([yp], [dy])
    auto = torch.autograd.grad(outs, [t for t in ps if t is not None], cot)
    for name, gk, ga in zip(NAMES, got, auto):
        _grad_close(gk, ga, GRAD_REL[dtype], f"{name} vs autograd")


@pytest.mark.parametrize("hs", [1, 2, 4])
def test_backward_heads_per_cta_agree(card, monkeypatch, hs):
    """The heads a CTA of passes 3 and 4 takes (``_heads_per_cta``) change
    only the order of dB's and dC's sums over a group's heads: every
    gradient as with the wrapper's choice, dx, ddt, dA, dD and dinit bit
    for bit. The kernel refuses a count that does not divide a group's
    heads."""
    from repro_torch.kernels.ssd_scan import ops
    ins, dy, dfin = _inputs(card, 2, 1000, 8, 64, 2, 128, torch.bfloat16,
                            seed=7)
    q = ops._check(*ins, 256)
    _, _, entry, cum = ops._launch(*ins, q)
    want = ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
    monkeypatch.setattr(ops, "_heads_per_cta", lambda *a: hs)
    got = ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
    for name, a, w in zip(NAMES, got, want):
        if name in ("dBm", "dCm"):
            _grad_close(a, w, SPLIT_REL, name)
        else:
            assert torch.equal(a, w), name
    monkeypatch.setattr(ops, "_heads_per_cta", lambda *a: 3)
    with pytest.raises(RuntimeError):
        ssd_scan_backward(*ins[:6], dy, dfin, entry, cum, chunk=q)
