"""One reader a metric, found by the metric's name: ``read(readings)``
returns the metric's value, or None where the run has nothing to read.

``readings`` holds the run's ``win`` (harness.Window), ``setup_s``,
``scene_build_s``, ``trace`` (trace.TraceSummary of the traced frames, or
None), ``own_kernels`` (the program's CUDA kernel names) and ``scene``
(the reference's scene, for its sizes).
"""
