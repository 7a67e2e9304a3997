from repro_torch.kernels.fastsim.ops import (STATS, chunk, chunk_layout,
                                             chunk_plain, chunk_scratch_bytes,
                                             whole_trace, whole_trace_plain)

__all__ = ["STATS", "chunk", "chunk_layout", "chunk_plain",
           "chunk_scratch_bytes", "whole_trace", "whole_trace_plain"]
