"""The port's int8 KV quantization (``repro_torch.serving.kv_quant``)
against the reference's, bit for bit: values, scales, the dequantized
tensor and the diagnostic error, in fp32 and bf16, including exact .5
ties, which both round half to even."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import kv_quant as jax_kv_quant  # noqa: E402
from repro_torch.serving import kv_quant  # noqa: E402


def _inputs(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 9, 4, 32)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero vector
    # ties: with max 127 the scale is 1 + 1e-12 = 1.0 in fp32, so k + 0.5
    # quantizes to the even neighbour
    x[1, 0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    xj = jnp.asarray(x, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(tdt)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kv_quant_matches_jax_bit_for_bit(dtype):
    xj, xt = _inputs(dtype)
    qj, sj = jax_kv_quant.quantize_kv(xj)
    qt, st = kv_quant.quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt[1, 0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_kv_quant.dequantize_kv(qj, sj, jd), np.float32)
        got = kv_quant.dequantize_kv(qt, st, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert kv_quant.kv_quant_error(xt) == jax_kv_quant.kv_quant_error(xj)
