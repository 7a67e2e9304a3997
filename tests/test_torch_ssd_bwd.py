"""The closed-form gradient of the SSD scan (``ssd_scan_bwd``, the plain
version of kernel B4's backward) against the reference's autodiff:
``jax.vjp`` of ``repro.kernels.ssd_scan.ref.ssd_chunked_ref`` over
``tests/test_torch_ssd.py``'s grid (G = 2 < H among it), and of ``ssd_ref``
at a ragged S, in fp32 and bf16, with and without an initial state and a
final-state gradient; and against torch autograd of the port's own
``ssd_chunked_ref``. The card holds the backward kernel against
``ssd_scan_bwd`` (``tests/test_torch_cuda_ssd.py``, ``chip_smoke.py``).

Tolerance: each gradient within rtol 1e-4 plus 1e-5 of its largest
magnitude in fp32 (``tests/test_torch_training.py``'s GRAD), within 2e-2
of its largest magnitude in bf16 (the inputs' and the gradients'
rounding).

``ssd_scan_bwd(..., split=True)`` takes the backward kernel's numerics for
bf16 inputs (each product with an fp32 operand as bf16 hi and lo parts,
the cumsum in double). It is held against ``jax.vjp`` of the reference at
the bf16 tolerance, and, on fp32 tensors holding the same bf16 values (so
that no output is rounded to bf16), against the fp32 closed form within
``SPLIT_TOL``: 1e-4 of each gradient's largest magnitude (the split keeps
~16 bits of each fp32 operand; the error seen is ~1e-5 at most), where
one bf16 pass would leave ~2^-8."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jax_chunked  # noqa: E402,E501
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_scan_bwd)
from test_torch_ssd import GRID, _inputs  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dinit")
SPLIT_TOL = 1e-4     # of each gradient's largest: split vs fp32 closed form


def _tol(dtype, want):
    scale = float(np.abs(want).max())
    if dtype == jnp.bfloat16:
        return dict(rtol=2e-2, atol=2e-2 * scale)
    return dict(rtol=1e-4, atol=1e-5 * scale)


def _cotangents(b, s, h, p, n, dtype, with_dfinal, seed=11):
    """dy (like y) and dfinal (fp32, zeros without ``with_dfinal``) as jnp
    arrays and torch tensors of the same values (dfinal None)."""
    rng = np.random.default_rng(seed)
    dy = jnp.asarray(rng.standard_normal((b, s, h, p)), dtype)
    df = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy_t = torch.from_numpy(np.array(dy, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    if not with_dfinal:
        return (dy, jnp.zeros((b, h, p, n), jnp.float32)), (dy_t, None)
    return (dy, jnp.asarray(df)), (dy_t, torch.from_numpy(df))


def _vjp(fn, J, init, cot):
    """jax.vjp of ``fn`` (x, dt, A, Bm, Cm, D[, init]) -> (y, final)."""
    args = J[:6] + ([J[6]] if init else [])
    _, vjp = jax.vjp(lambda *a: fn(*a[:6], a[6] if init else None), *args)
    return vjp(cot)


def _check(got, want, dtype, init):
    got = got if init else got[:6]
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name,
                                   **_tol(dtype, w))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("with_dfinal", [True, False])
def test_bwd_matches_jax_vjp_of_chunked(b, s, h, p, g, n, chunk, dtype, init,
                                        with_dfinal):
    J, T = _inputs(b, s, h, p, g, n, dtype, init=init)
    cot, (dy, dfinal) = _cotangents(b, s, h, p, n, dtype, with_dfinal)
    want = _vjp(lambda *a: jax_chunked(*a, chunk=chunk), J, init, cot)
    got = ssd_scan_bwd(*T, dy, dfinal, chunk=chunk)
    assert got[0].dtype == T[0].dtype and got[3].dtype == T[3].dtype
    assert all(t.dtype == torch.float32 for t in got[1:3] + got[5:])
    _check(got, want, dtype, init)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 50, 4, 16, 2, 8, 16), (1, 45, 4, 16, 1, 16, 32),
    (1, 300, 2, 64, 1, 128, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_dfinal", [True, False])
def test_bwd_matches_jax_vjp_of_sequential_at_ragged_s(b, s, h, p, g, n,
                                                      chunk, dtype,
                                                      with_dfinal):
    """A ragged last chunk (padded with dt = 0, x = 0) gives the
    recurrence's own gradient: the reference dispatches such an S to its
    sequential oracle."""
    J, T = _inputs(b, s, h, p, g, n, dtype, seed=9)
    cot, (dy, dfinal) = _cotangents(b, s, h, p, n, dtype, with_dfinal)
    want = _vjp(jax_ref, J, True, cot)
    _check(ssd_scan_bwd(*T, dy, dfinal, chunk=chunk), want, dtype, True)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bwd_matches_autograd_of_the_ports_chunked_ref(b, s, h, p, g, n,
                                                       chunk, dtype):
    J, T = _inputs(b, s, h, p, g, n, dtype, seed=12)
    _, (dy, dfinal) = _cotangents(b, s, h, p, n, dtype, True, seed=13)
    xs = [t.clone().requires_grad_() for t in T]
    y, fin = ssd_chunked_ref(*xs, chunk=chunk)
    want = torch.autograd.grad([y, fin], xs, [dy, dfinal])
    _check(ssd_scan_bwd(*T, dy, dfinal, chunk=chunk),
           [w.float().numpy() for w in want], dtype, True)


def test_bwd_blocks_of_chunks_agree():
    """Chunks taken a block at a time (a small ``block_elems``) give the
    gradients of all chunks at once."""
    _, T = _inputs(2, 256, 2, 64, 2, 32, jnp.float32, seed=14)
    _, (dy, dfinal) = _cotangents(2, 256, 2, 64, 32, jnp.float32, True)
    whole = ssd_scan_bwd(*T, dy, dfinal, chunk=64)
    blocks = ssd_scan_bwd(*T, dy, dfinal, chunk=64, block_elems=1)
    for name, a, b in zip(NAMES, whole, blocks):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("with_dfinal", [True, False])
def test_split_bwd_matches_jax_vjp_of_chunked(b, s, h, p, g, n, chunk, init,
                                              with_dfinal):
    """The backward kernel's bf16 numerics in plain PyTorch against the
    reference's autodiff, at the bf16 tolerance."""
    J, T = _inputs(b, s, h, p, g, n, jnp.bfloat16, init=init)
    cot, (dy, dfinal) = _cotangents(b, s, h, p, n, jnp.bfloat16, with_dfinal)
    want = _vjp(lambda *a: jax_chunked(*a, chunk=chunk), J, init, cot)
    got = ssd_scan_bwd(*T, dy, dfinal, chunk=chunk, split=True)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.bfloat16
    _check(got, want, jnp.bfloat16, init)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID + [
    (1, 1024, 2, 64, 1, 128, 256), (2, 50, 4, 16, 2, 8, 16),
    (1, 300, 2, 64, 1, 128, 256)])
@pytest.mark.parametrize("init", [True, False])
def test_split_bwd_near_the_fp32_closed_form(b, s, h, p, g, n, chunk, init):
    """The split's own error, without the outputs' bf16 rounding: on fp32
    tensors holding bf16 values, every gradient within ``SPLIT_TOL`` of its
    largest of the fp32 closed form's, at the models' head dim, state and
    chunk and at a ragged S too."""
    _, T = _inputs(b, s, h, p, g, n, jnp.bfloat16, seed=15, init=init)
    _, (dy, dfinal) = _cotangents(b, s, h, p, n, jnp.bfloat16, True, seed=16)
    T = [None if t is None else t.float() for t in T]
    got = ssd_scan_bwd(*T, dy.float(), dfinal, chunk=chunk, split=True)
    want = ssd_scan_bwd(*T, dy.float(), dfinal, chunk=chunk)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        scale = float(w.abs().max())
        torch.testing.assert_close(a, w, rtol=SPLIT_TOL,
                                   atol=SPLIT_TOL * scale, msg=name)
