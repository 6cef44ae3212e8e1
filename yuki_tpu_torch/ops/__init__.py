"""Kernels of the port and their plain PyTorch versions (port of
``yuki_tpu.ops``): ``path_fused`` (the dense path-tracing wave),
``trace_treelets`` (the two-level treelet walks), ``shade_fused`` (the
shading body and the treelet path's shade and resolve), ``trace_cull``
(the two-level cull), ``trace_stream`` (crossing words, candidate lists,
the slot stream and its walks), ``trace_rows`` (the dispatch's probe),
``strat_draws`` (the stratified sampler's draws); ``csrc/`` holds their
CUDA sources, built at first use by ``_build``."""
