"""phi4-mini-3.8b — RoPE SwiGLU GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064. [arXiv:2412.08905]
"""
from repro_torch.configs.base import ArchConfig, Family, register

PHI4_MINI_3P8B = register(ArchConfig(
    name="phi4-mini-3.8b",
    family=Family.DENSE,
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    head_dim=128,
    tie_embeddings=True,
    source="arXiv:2412.08905 (hf)",
))
