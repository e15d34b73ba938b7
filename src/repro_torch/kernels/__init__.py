"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version (``ref.py``) and a launch counter.

  * sparqle_encode — quantize, clip and split into LSB4/MSB4/PBM planes,
    in int8 containers or packed in the wire format, and its
    quantize-only form (one int8 plane, for the dense baseline)
  * sparqle_matmul — dual-pass W4A8 matmul on pack_int4 weights, on
    unpacked or wire-format planes, each with its LSB4-only draft form
    (``msb_skip``)
  * quant_matmul   — the dense single-pass W4A8 baseline matmul (the
    dual-pass kernel's one-plane instance)
  * kv_attention   — paged packed-KV4 flash-decode attention, the
    multi-token verify window of speculative decoding, the mixed
    KV4/KV2 tier decode of the precision ladder, and the decode over the
    contiguous cache of the fixed-batch path

``ops`` holds the standalone linears over them (``sparqle_linear``,
``dense_quant_linear``).
"""
from repro_torch.kernels import (kv_attention, quant_matmul, sparqle_encode,
                                 sparqle_matmul)
from repro_torch.kernels._build import (KERNELS, build_all, launch_counts,
                                        reset_launch_counts)

__all__ = ["KERNELS", "build_all", "kv_attention", "launch_counts",
           "quant_matmul", "reset_launch_counts", "sparqle_encode",
           "sparqle_matmul"]
