"""The port's SSD scan (kernel B4's plain versions and the CPU dispatch of
``ssd_scan``) against the reference's oracles, its dispatcher and its
Pallas kernel in interpret mode, over ``test_ssd_sweep``'s grid. The CUDA
kernel is held against these plain versions on the card by
chip_smoke.py; ``ssd_split_ref``, its numerics in plain PyTorch (three
passes, split-bf16 products), is held against the reference here, so the
precision plan is checked before any card runs it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_chunked_ref as jax_chunked  # noqa: E402
from repro.kernels.ssd_scan import ssd_decode_step as jax_step  # noqa: E402
from repro.kernels.ssd_scan import ssd_ref as jax_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_scan  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_decode_step, ssd_ref, ssd_scan,
                                          ssd_split_ref)

_TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
GRID = [(2, 128, 4, 16, 2, 8, 32), (1, 64, 8, 32, 1, 16, 16),
        (2, 256, 2, 64, 2, 32, 64)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(b, s, h, p, g, n, dtype, seed=4, init=True):
    """test_ssd_sweep's draws, as jnp arrays and torch tensors of the same
    values."""
    rng = np.random.default_rng(seed)
    j = {"x": jnp.asarray(rng.standard_normal((b, s, h, p)), dtype),
         "dt": jnp.asarray(rng.uniform(0.001, 0.1, (b, s, h)), jnp.float32),
         "A": jnp.asarray(-rng.uniform(0.5, 2.0, (h,)), jnp.float32),
         "Bm": jnp.asarray(rng.standard_normal((b, s, g, n)), dtype),
         "Cm": jnp.asarray(rng.standard_normal((b, s, g, n)), dtype),
         "D": jnp.asarray(rng.standard_normal((h,)), jnp.float32)}
    j["st"] = jnp.asarray(rng.standard_normal((b, h, p, n)),
                          jnp.float32) * 0.1 if init else None

    def conv(a):
        if a is None:
            return None
        tdt = _TORCH_DT.get(a.dtype.type, torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(tdt)
    return ([j[k] for k in ("x", "dt", "A", "Bm", "Cm", "D", "st")],
            [conv(j[k]) for k in ("x", "dt", "A", "Bm", "Cm", "D", "st")])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_sweep_matches_jax(b, s, h, p, g, n, chunk, dtype):
    """Plain sequential and chunked versions and the CPU dispatch against
    the reference's oracles and its Pallas kernel (interpret mode)."""
    J, T = _inputs(b, s, h, p, g, n, dtype)
    y_ref, f_ref = jax_ref(*J)
    y_p, f_p = ssd_scan_pallas(*J, chunk=chunk, interpret=True)
    tol = _tol(dtype)
    for y, f in (ssd_ref(*T), ssd_chunked_ref(*T, chunk=chunk),
                 ssd_scan(*T, chunk=chunk)):
        assert y.dtype == T[0].dtype and f.dtype == torch.float32
        _close(y, y_ref, tol)
        _close(y, y_p, tol)
        _close(f, f_ref, STATE_TOL)
        _close(f, f_p, STATE_TOL)
    y_c, f_c = jax_chunked(*J, chunk=chunk)
    _close(ssd_chunked_ref(*T, chunk=chunk)[0], y_c, tol)
    _close(ssd_chunked_ref(*T, chunk=chunk)[1], f_c, STATE_TOL)


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (10, 64)])
def test_ssd_scan_dispatch_matches_jax(s, chunk):
    """The CPU dispatch mirrors the reference's: ``min(chunk, S)``, the
    sequential oracle at a ragged S, the chunked one otherwise."""
    J, T = _inputs(2, s, 4, 16, 1, 8, jnp.float32, seed=6)
    y, f = ssd_scan(*T, chunk=chunk)
    y_j, f_j = jax_scan(*J, chunk=chunk, use_pallas=False)
    _close(y, y_j, _tol(jnp.float32))
    _close(f, f_j, STATE_TOL)


def test_ssd_no_init_state():
    J, T = _inputs(2, 64, 4, 16, 1, 8, jnp.float32, seed=5, init=False)
    y_p, f_p = ssd_scan_pallas(*J, chunk=16, interpret=True)
    for y, f in (ssd_ref(*T), ssd_chunked_ref(*T, chunk=16),
                 ssd_scan(*T, chunk=16)):
        _close(y, y_p, _tol(jnp.float32))
        _close(f, f_p, STATE_TOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_decode_step_matches_jax(g, dtype):
    J, T = _inputs(3, 1, 4, 16, g, 8, dtype, seed=7)
    x, dt, A, Bm, Cm, D, st = J
    y_j, s_j = jax_step(st, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    x, dt, A, Bm, Cm, D, st = T
    y, s = ssd_decode_step(st, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    assert y.dtype == x.dtype and s.dtype == torch.float32
    _close(y, y_j, _tol(dtype))
    _close(s, s_j, dict(rtol=1e-5, atol=1e-5))


def test_ssd_decode_continues_the_scan():
    """A scan over S positions then one decode step equals the scan over
    S + 1 (the model's prefill-then-decode)."""
    _, T = _inputs(2, 33, 4, 16, 1, 8, jnp.float32, seed=8)
    x, dt, A, Bm, Cm, D, st = T
    y_all, f_all = ssd_scan(x, dt, A, Bm, Cm, D, st, chunk=16)
    _, f_pre = ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], D,
                        st, chunk=16)
    y1, f1 = ssd_decode_step(f_pre, x[:, 32], dt[:, 32], A, Bm[:, 32],
                             Cm[:, 32], D)
    torch.testing.assert_close(y1, y_all[:, 32], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(f1, f_all, rtol=1e-5, atol=1e-5)


# the models' chunk, head dim and state at two heads, so that it runs in
# seconds on the CPU
MODEL_CASE = (1, 1024, 2, 64, 1, 128, 256)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID + [MODEL_CASE])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_split_ref_matches_jax(b, s, h, p, g, n, chunk, dtype):
    """The kernel's numerics (for bf16 inputs the fp32 operand of three
    products split into bf16 hi and lo) against the sequential and chunked
    oracles and the Pallas kernel, at the unchanged tolerances."""
    J, T = _inputs(b, s, h, p, g, n, dtype)
    y, f = ssd_split_ref(*T, chunk=chunk)
    assert y.dtype == T[0].dtype and f.dtype == torch.float32
    tol = _tol(dtype)
    for y_j, f_j in (jax_ref(*J), jax_chunked(*J, chunk=chunk),
                     ssd_scan_pallas(*J, chunk=chunk, interpret=True)):
        _close(y, y_j, tol)
        _close(f, f_j, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", [
    (2, 50, 4, 16, 2, 8, 16, True), (1, 1000, 2, 64, 1, 128, 256, True),
    (2, 45, 4, 16, 1, 16, 32, False)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_split_ref_ragged_matches_oracle(b, s, h, p, g, n, chunk, init,
                                             dtype):
    """A ragged last chunk (padded with dt = 0, x = 0, as the kernel does)
    gives the recurrence's own result."""
    J, T = _inputs(b, s, h, p, g, n, dtype, seed=9, init=init)
    y, f = ssd_split_ref(*T, chunk=chunk)
    y_j, f_j = jax_ref(*J)
    _close(y, y_j, _tol(dtype))
    _close(f, f_j, STATE_TOL)
    y_t, f_t = ssd_ref(*T)
    _close(y, y_t.float().numpy(), _tol(dtype))
    _close(f, f_t.numpy(), STATE_TOL)
