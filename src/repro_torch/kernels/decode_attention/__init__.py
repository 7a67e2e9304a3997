from repro_torch.kernels.decode_attention.ops import (
    attend_partial, merge_partials, paged_decode_attention, paged_decode_ref,
    paged_decode_split_ref, split_plan)

__all__ = ["paged_decode_attention", "paged_decode_ref",
           "paged_decode_split_ref", "split_plan", "attend_partial",
           "merge_partials"]
