"""qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) — 4 shared + 60 routed top-4.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.configs.base import ArchConfig, Family, MoEConfig, register

QWEN2_MOE_A2P7B = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family=Family.MOE,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4, d_expert=1408,
                  d_shared=5632, n_dense_layers=0),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B (hf)",
))
