"""CPU tests of the benchmark (``python -m pytest portbench/tests``); the
one marked ``cuda`` runs a cell on the card and skips without one."""
