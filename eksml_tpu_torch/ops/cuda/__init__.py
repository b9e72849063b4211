"""Hand-written CUDA kernels (sources in ``eksml_tpu_torch/csrc``), their
builder and their PyTorch wrappers."""
