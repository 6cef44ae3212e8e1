"""Application layer: settings, scene load dispatch, headless rendering
and EXR output (port of ``yuki_tpu/app``; the web viewer is not ported)."""
