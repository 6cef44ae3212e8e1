"""CLI entry point (yuki/src/main.rs): port of ``yuki_tpu/__main__.py``.

Usage:
  python -m yuki_tpu_torch --out=render.exr [--scene=path]
      [--settings=settings.yaml] [--profile=DIR] [--device=cuda|cpu]
  python -m yuki_tpu_torch [--view] [--port=8000] [...]   # web viewer

Headless when --out is given, like the reference's ``--out=FILE`` flag
(main.rs:94-137); otherwise the web viewer serves on 127.0.0.1:PORT (0:
any free port) and prints its URL.  settings.yaml is
read from the working directory by default if present.  Renders on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _setup_logging() -> None:
    """fern-equivalent: stdout + yuki.log, info level (main.rs:43-65)."""
    fmt = "[%(asctime)s][yuki][%(levelname)s] %(message)s"
    logging.basicConfig(
        level=logging.INFO,
        format=fmt,
        handlers=[
            logging.StreamHandler(sys.stdout),
            logging.FileHandler("yuki.log", mode="a"),
        ],
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="yuki_tpu_torch",
        description="physically-based renderer, PyTorch + CUDA port",
    )
    parser.add_argument("--out", help="render headless into this EXR file")
    parser.add_argument("--scene", help="scene file (.ply/.xml/.pbrt)")
    parser.add_argument(
        "--settings",
        default="settings.yaml" if os.path.exists("settings.yaml") else None,
        help="yaml settings file (default: ./settings.yaml if present)",
    )
    parser.add_argument("--view", action="store_true",
                        help="start the web viewer (also the default without "
                        "--out)")
    parser.add_argument(
        "--profile",
        help="capture a torch.profiler trace of the render into this "
        "directory (DIR/trace.json, Chrome trace format)",
    )
    parser.add_argument("--port", type=int, default=8000,
                        help="viewer port (default: 8000; 0: any free port)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)

    _setup_logging()

    from .app.settings import load_settings

    settings = load_settings(args.settings)
    if args.scene:
        settings.load_settings.path = args.scene

    if args.out:
        from .app import headless
        from .profiling import device_trace

        with device_trace(args.profile):
            headless.render(settings, args.out, device=args.device)
        return 0

    from .app import viewer

    viewer.serve(settings, port=args.port, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
