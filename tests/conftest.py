"""Test harness: force the CPU backend with 8 virtual devices.

The real chip is a single TPU behind a slow remote compiler; tests run on
the XLA CPU backend (numerics-equivalent for everything but transcendental
rounding) with an 8-device mesh so multi-chip sharding paths are exercised
exactly as SURVEY.md §4 prescribes.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() "
        "is False (run on the card: python -m pytest -m cuda "
        "tests/test_torch_*.py)",
    )
