"""Hardware spec of the card the port serves on.

``core/worker_config.py`` is a verbatim copy of the reference and lists
only TPU v5e, A100 and V100 parts, so the H100 lives here. Figures are
NVIDIA's H100 SXM5 datasheet values (dense, no sparsity); ``link_bw`` is
NVLink 4's 450 GB/s each way. The latency per collective is the same
order as the A100/V100 entries' NVLink figure."""
from __future__ import annotations

from repro_torch.core.worker_config import HardwareSpec

H100_SXM = HardwareSpec("h100-sxm", mem_bytes=80e9, peak_flops=989e12,
                        hbm_bw=3.35e12, link_bw=450e9, link_latency=10e-6,
                        max_group=8)
