"""The port's dry run (``repro_torch.launch.dryrun``): one full-size cell
traced on rank 0 of a fake 256-rank process group on fake tensors (the
twin of ``tests/test_dryrun.py::test_dryrun_cell_compiles``), and a
reduced ``train_4k`` cell on a fake 2x4 mesh. Each runs in a subprocess:
the fake process group is process-wide state."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one layer's local K+V shard of granite-3-8b's decode_32k cache on
# 16x16: batch 128/16, 32768/16 positions, 8 KV heads of 128, bf16
KV_SHARD_BYTES = 8 * 2048 * 8 * 128 * 2 * 2


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


@pytest.mark.slow
def test_dryrun_cell_traces(tmp_path):
    """Full-size granite decode on the 16x16 mesh: every number is a
    host-derived count; the cache is never gathered."""
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "granite-3-8b",
          "--shape", "decode_32k", "--out", str(tmp_path)], timeout=540)
    rec = json.load(open(tmp_path / "granite-3-8b_decode_32k_pod1.json"))
    assert rec["ok"]
    assert rec["n_devices"] == 256
    assert rec["peak_bytes_per_device"] < 80 * 10**9, "must fit H100 HBM"
    assert rec["hlo_dot_flops"] > 0
    assert 0 < rec["largest_collective_bytes"] < KV_SHARD_BYTES
    assert rec["collective_bytes"] > 0 and "all-reduce" in rec["collectives"]
    assert rec["resident_bytes_per_device"] <= rec["peak_bytes_per_device"]
    for key in ("compile_s", "alias_size_bytes", "error"):
        assert key not in rec


_TRAIN_CELL = r"""
import dataclasses, json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get_arch, reduced
from repro_torch.launch.dryrun import trace_cell
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
arch = reduced(get_arch("granite-3-8b"), n_layers=2, d_model=64, vocab=128)
print(json.dumps(trace_cell(arch, ShapeSpec("train_4k", "train", 64, 8),
                            mesh)))
"""


def test_dryrun_reduced_train_cell_on_a_2x4_mesh():
    """A train cell traces the step with its backward and AdamW: pure
    FSDP (the batch over both axes, one sequence a rank, the weights
    gathered and their gradients reduce-scattered)."""
    rec = json.loads(_run(["-c", _TRAIN_CELL], timeout=300)
                     .stdout.strip().splitlines()[-1])
    assert rec["attn_mode"] == "data" and rec["params_mode"] == "fsdp"
    assert rec["hlo_dot_flops"] > 0 and rec["flops"] > rec["hlo_dot_flops"]
    assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
    assert rec["peak_bytes_per_device"] >= rec["argument_size_bytes"] > 0
