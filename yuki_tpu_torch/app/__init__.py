"""Application layer: settings, scene load dispatch, headless rendering,
EXR output and the web viewer (port of ``yuki_tpu/app``)."""
