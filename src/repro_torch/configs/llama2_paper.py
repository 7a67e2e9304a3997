"""The paper's own evaluation models (Llama-2 chat family, Table 2).

Used by the worker-configuration benchmark (Table 3) and the cluster simulator;
not part of the assigned (arch x shape) dry-run matrix.
"""
from repro_torch.configs.base import ArchConfig, Family, register

LLAMA2_7B = register(ArchConfig(
    name="llama2-7b", family=Family.DENSE, n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=32000,
    source="arXiv:2307.09288"))

LLAMA2_13B = register(ArchConfig(
    name="llama2-13b", family=Family.DENSE, n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=13824, vocab=32000,
    source="arXiv:2307.09288"))

LLAMA2_70B = register(ArchConfig(
    name="llama2-70b", family=Family.DENSE, n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=32000,
    source="arXiv:2307.09288"))
