"""granite-3-8b — dense GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0 family]
"""
from repro_torch.configs.base import ArchConfig, Family, register

GRANITE_3_8B = register(ArchConfig(
    name="granite-3-8b",
    family=Family.DENSE,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    head_dim=128,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base (hf; scaled per assignment)",
))
