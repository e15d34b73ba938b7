"""SPARQLe on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Mirrors the JAX package's layout (configs, core, kernels, models, obs,
serving, launch) and its param-tree layout, and never imports JAX or the
JAX package. Every Pallas kernel on the serving path is a hand-written
CUDA kernel for sm_90a under ``csrc/``, built at first use, with its
plain PyTorch version beside it for the CPU.
"""
