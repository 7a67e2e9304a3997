from repro_torch.kernels.rmsnorm.ops import (bwd_ctas, rmsnorm,
                                             rmsnorm_backward, rmsnorm_bwd,
                                             rmsnorm_dw_partials, rmsnorm_ref)

__all__ = ["rmsnorm", "rmsnorm_backward", "rmsnorm_bwd", "rmsnorm_ref",
           "rmsnorm_dw_partials", "bwd_ctas"]
