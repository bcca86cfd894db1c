"""Hand-written CUDA kernels (sources in ccfindr_tpu_torch/csrc)."""
