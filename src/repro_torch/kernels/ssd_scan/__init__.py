from repro_torch.kernels.ssd_scan.ops import (ssd_chunked_ref,
                                              ssd_decode_step, ssd_ref,
                                              ssd_scan, ssd_scan_backward,
                                              ssd_scan_bwd, ssd_split_ref)

__all__ = ["ssd_scan", "ssd_scan_backward", "ssd_scan_bwd", "ssd_ref",
           "ssd_chunked_ref", "ssd_split_ref", "ssd_decode_step"]
