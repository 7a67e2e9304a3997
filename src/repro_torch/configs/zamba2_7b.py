"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block. [arXiv:2411.15242]

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Every 6th layer applies the single *shared* full-attention block (Zamba2's
shared transformer block); all other layers are Mamba2. The shared block also
carries the d_ff=14336 SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig, Family, SSMConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    family=Family.HYBRID,
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256, ngroups=1),
    attn_every=6,                 # layers 5, 11, ..., 77 -> 13 attention sites
    shared_attn_block=True,
    source="arXiv:2411.15242 (unverified)",
))
