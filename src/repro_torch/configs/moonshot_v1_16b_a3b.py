"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — DeepSeek-V3-style MoE.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 routed experts
top-6 + 2 shared experts, first layer dense. [hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ArchConfig, Family, MoEConfig, register

MOONSHOT_V1_16B = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family=Family.MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                      # FFN is MoE in all non-dense layers
    vocab=163840,
    head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
                  d_shared=2816, n_dense_layers=1),
    source="hf:moonshotai/Moonlight-16B-A3B (hf)",
))
