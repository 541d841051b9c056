"""The port's CUDA kernels (sources in ``eve_tpu_torch/csrc``)."""
