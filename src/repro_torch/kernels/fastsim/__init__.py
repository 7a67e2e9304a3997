from repro_torch.kernels.fastsim.ops import (STATS, WHOLE_STATS, chunk,
                                             chunk_layout, chunk_plain,
                                             chunk_scratch_bytes, whole_trace,
                                             whole_trace_plain,
                                             whole_trace_scratch_bytes)

__all__ = ["STATS", "WHOLE_STATS", "chunk", "chunk_layout", "chunk_plain",
           "chunk_scratch_bytes", "whole_trace", "whole_trace_plain",
           "whole_trace_scratch_bytes"]
