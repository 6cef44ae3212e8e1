"""Kernels of the port and their plain PyTorch versions (port of
``yuki_tpu.ops``): ``path_fused`` (the dense path-tracing wave),
``trace_treelets`` (the two-level treelet walks), ``shade_fused`` (the
shading body and the treelet path's shade and resolve); ``csrc/`` holds
their CUDA sources, built at first use by ``_build``."""
