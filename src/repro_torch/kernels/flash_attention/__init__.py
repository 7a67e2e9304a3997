from repro_torch.kernels.flash_attention.ops import (attention_dense_ref,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_ref",
           "attention_dense_ref"]
