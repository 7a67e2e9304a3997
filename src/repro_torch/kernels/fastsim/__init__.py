from repro_torch.kernels.fastsim.ops import (chunk, chunk_layout, chunk_plain,
                                             whole_trace, whole_trace_plain)

__all__ = ["chunk", "chunk_layout", "chunk_plain", "whole_trace",
           "whole_trace_plain"]
