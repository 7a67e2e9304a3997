"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 attn-free d_ff=0 vocab=50280 ssm_state=128.
Pure Mamba-2 stack: no attention, no FFN (the Mamba block subsumes it).
"""
from repro_torch.configs.base import ArchConfig, Family, PosEmb, SSMConfig, register

MAMBA2_1P3B = register(ArchConfig(
    name="mamba2-1.3b",
    family=Family.SSM,
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    pos_emb=PosEmb.NONE,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256, ngroups=1),
    attn_every=-1,
    source="arXiv:2405.21060 (unverified)",
))
