"""Build and binding of the port's CUDA kernels (sources in ``flashmoe_tpu_torch/csrc/``)."""
