"""flashmoe_tpu_torch: the PyTorch/CUDA port of flashmoe_tpu for NVIDIA
Hopper (H100).

The JAX package ``flashmoe_tpu`` is the reference; this package mirrors its
layout and names, imports neither JAX nor anything of it, and runs its
hand-written CUDA kernels (``csrc/``) on CUDA tensors.  On CPU tensors
every kernel wrapper runs its plain torch version.
"""
