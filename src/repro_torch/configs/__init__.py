"""Config registry: importing this package registers all architectures."""
from repro_torch.configs.base import (                                    # noqa: F401
    ALL_SHAPES, ArchConfig, Family, MoEConfig, PosEmb, SHAPES_BY_NAME,
    SSMConfig, ShapeSpec, all_archs, get_arch, reduced, register,
    shape_applicable, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

# Assigned architecture pool (10) --------------------------------------------
from repro_torch.configs.mamba2_1p3b import MAMBA2_1P3B                   # noqa: F401
from repro_torch.configs.moonshot_v1_16b_a3b import MOONSHOT_V1_16B       # noqa: F401
from repro_torch.configs.qwen2_moe_a2p7b import QWEN2_MOE_A2P7B           # noqa: F401
from repro_torch.configs.musicgen_medium import MUSICGEN_MEDIUM           # noqa: F401
from repro_torch.configs.qwen2p5_32b import QWEN2P5_32B                   # noqa: F401
from repro_torch.configs.mistral_nemo_12b import MISTRAL_NEMO_12B         # noqa: F401
from repro_torch.configs.phi4_mini_3p8b import PHI4_MINI_3P8B             # noqa: F401
from repro_torch.configs.granite_3_8b import GRANITE_3_8B                 # noqa: F401
from repro_torch.configs.zamba2_7b import ZAMBA2_7B                       # noqa: F401
from repro_torch.configs.llama_3p2_vision_90b import LLAMA_3P2_VISION_90B # noqa: F401

# The paper's own models ------------------------------------------------------
from repro_torch.configs.llama2_paper import LLAMA2_7B, LLAMA2_13B, LLAMA2_70B  # noqa: F401

ASSIGNED_ARCHS = (
    "mamba2-1.3b",
    "moonshot-v1-16b-a3b",
    "qwen2-moe-a2.7b",
    "musicgen-medium",
    "qwen2.5-32b",
    "mistral-nemo-12b",
    "phi4-mini-3.8b",
    "granite-3-8b",
    "zamba2-7b",
    "llama-3.2-vision-90b",
)
