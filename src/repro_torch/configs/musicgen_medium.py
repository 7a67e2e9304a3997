"""musicgen-medium — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.  [arXiv:2306.05284]
The EnCodec frontend (RVQ codebooks, delay pattern) is a STUB: ``input_specs``
provides precomputed frame embeddings; the backbone is the transformer only.
MusicGen uses GELU MLP + sinusoidal positions (no RoPE).
"""
from repro_torch.configs.base import ArchConfig, Family, PosEmb, register

MUSICGEN_MEDIUM = register(ArchConfig(
    name="musicgen-medium",
    family=Family.AUDIO,
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    pos_emb=PosEmb.SINUSOIDAL,
    act="gelu",
    n_frontend_tokens=0,          # frames arrive as embeddings via input stub
    source="arXiv:2306.05284 (hf)",
))
