"""Scene tables and built-in scenes (port of ``yuki_tpu.scene``)."""
