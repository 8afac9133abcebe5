from repro_torch.distributed.compression import (compress_grads_int8,
                                                 psum_int8,
                                                 quantize_roundtrip)

__all__ = ["compress_grads_int8", "psum_int8", "quantize_roundtrip"]
