from repro_torch.kernels.fastsim.ops import whole_trace, whole_trace_plain

__all__ = ["whole_trace", "whole_trace_plain"]
