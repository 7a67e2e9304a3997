"""Distribution on the card: ``chip_smoke.py``'s distribution phase at 4
of granite-3-8b's layers (full width; the sharded ``LM`` on a one-rank
mesh, prefill and decode, and on a two-rank mesh, prefill; its B2 and B3
launches on the local shards counted per prefill and per step, its
logits held against the unsharded ``LM``), and each kernel wrapper's
refusal of a CUDA DTensor with no launch.

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_dist.py
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from torch_dist_jobs import fake_world, wrapper_calls  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_distribution_phase_at_four_layers(card):
    sys.path.insert(0, ROOT)
    import chip_smoke
    res = chip_smoke.dist_phase(torch, "test", layers=4)
    one, two = res[chip_smoke.DIST_RANKS], res[chip_smoke.DIST_TP_RANKS]
    assert one["layers"] == two["layers"] == 4
    assert (one["ranks"], two["ranks"]) == (1, 2)
    assert [p["b2"] for p in one["prefill"] + two["prefill"]] == [4] * 4
    assert {p["b3"] for p in one["prefill"] + one["steps"]} == {9}
    assert len(one["steps"]) == chip_smoke.DIST_STEPS and not two["steps"]
    assert max(one["max_rel_err"]) == 0
    assert max(two["max_rel_err"]) <= chip_smoke.DIST_TOL
    assert two["prefill_collectives"].get("all_reduce", 0) > 0


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "paged_decode_attention", "ssd_scan"])
def test_kernel_wrapper_refuses_cuda_dtensor(card, name):
    """A CUDA DTensor passes ``is_cuda``; the wrapper refuses it with a
    TypeError before it launches."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    wrapper = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
               "paged_decode_attention": paged_decode_attention,
               "ssd_scan": ssd_scan}[name]
    call = wrapper_calls()[name]
    before = wrapper.launches
    with fake_world(1, device_type="cuda") as mesh:
        with pytest.raises(TypeError, match="DTensor"):
            call(lambda t: DTensor.from_local(t.to(card), mesh,
                                              [Replicate(), Replicate()]))
    assert wrapper.launches == before
