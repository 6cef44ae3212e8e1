"""Kernels of the port and their plain PyTorch versions (port of
``yuki_tpu.ops``).  ``path_fused`` holds the dense path-tracing wave;
``csrc/`` its CUDA sources, built at first use by ``_build``."""
