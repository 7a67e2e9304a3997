"""llama-3.2-vision-90b — VLM: text decoder with cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment]
The vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings (already projected to d_model); every 5th layer cross-attends
to them (20 cross-attention sites).
"""
from repro_torch.configs.base import ArchConfig, Family, register

LLAMA_3P2_VISION_90B = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family=Family.VLM,
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=5e5,
    cross_attn_every=5,
    n_frontend_tokens=1601,       # 1 tile x (1600 patches + cls), pre-projected
    source="hf:meta-llama/Llama-3.2-11B-Vision (unverified)",
))
