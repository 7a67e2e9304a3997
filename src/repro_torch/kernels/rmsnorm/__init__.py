from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_ref"]
