from repro_torch.kernels.decode_attention.ops import (attend_partial,
                                                      merge_partials,
                                                      paged_decode_attention,
                                                      paged_decode_ref)

__all__ = ["paged_decode_attention", "paged_decode_ref", "attend_partial",
           "merge_partials"]
