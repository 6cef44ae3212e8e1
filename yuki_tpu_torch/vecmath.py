"""Float helpers shared by the port's plain tensor code.

``sqrt`` is the correctly rounded square root.  XLA and CUDA (without
fast-math) round ``sqrt`` exactly, but torch's CPU float32 ``sqrt`` goes
through a vector library that is off by an ulp on about 1% of inputs, and
the watertight edge functions and near-grazing hemisphere samples amplify
such an ulp.  The float64 square root of a float32, rounded back to
float32, is the correctly rounded float32 result (53 >= 2*24 + 2 bits, so
the double rounding is innocuous).
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root, in x's dtype."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)
