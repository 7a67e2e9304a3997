"""mistral-nemo-12b — dense GQA, 128k context, explicit head_dim=128.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Mistral-Nemo-Base-2407]
"""
from repro_torch.configs.base import ArchConfig, Family, register

MISTRAL_NEMO_12B = register(ArchConfig(
    name="mistral-nemo-12b",
    family=Family.DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407 (hf)",
))
