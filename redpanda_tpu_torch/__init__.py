"""redpanda_tpu_torch: the coproc engine of redpanda_tpu on PyTorch and CUDA.

A port of the JAX package ``redpanda_tpu`` that imports nothing of it. Its
device work runs as hand-written CUDA kernels for the NVIDIA H100
(``csrc/``, built with nvcc at first use); every kernel keeps a plain
PyTorch version beside it, which runs for CPU tensors.
"""
