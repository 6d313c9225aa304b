"""flashmoe_tpu_torch: the PyTorch/CUDA port of flashmoe_tpu for NVIDIA
Hopper (H100).

The JAX package ``flashmoe_tpu`` is the reference; this package mirrors its
layout and names, imports neither JAX nor anything of it, and runs its
hand-written CUDA kernels (``csrc/``) on CUDA tensors.  On CPU tensors
every kernel wrapper runs its plain torch version.  The top level exports
the reference's API facade, as the JAX package does.
"""

from flashmoe_tpu_torch.api import (  # noqa: F401
    get_bookkeeping,
    get_compiled_config,
    get_num_local_experts,
    run_moe,
)

__all__ = [
    "run_moe",
    "get_bookkeeping",
    "get_compiled_config",
    "get_num_local_experts",
]
