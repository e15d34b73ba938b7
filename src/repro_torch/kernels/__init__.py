"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version (``ref.py``) and a launch counter.

  * sparqle_encode — quantize, clip and split into LSB4/MSB4/PBM planes
  * sparqle_matmul — dual-pass W4A8 matmul on pack_int4 weights, and its
    LSB4-only draft form (``msb_skip``)
  * kv_attention   — paged packed-KV4 flash-decode attention, and the
    multi-token verify window of speculative decoding
"""
from repro_torch.kernels import kv_attention, sparqle_encode, sparqle_matmul
from repro_torch.kernels._build import (KERNELS, build_all, launch_counts,
                                        reset_launch_counts)

__all__ = ["KERNELS", "build_all", "kv_attention", "launch_counts",
           "reset_launch_counts", "sparqle_encode", "sparqle_matmul"]
