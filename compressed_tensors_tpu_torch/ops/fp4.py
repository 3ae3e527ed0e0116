"""FP4 E2M1 rounding.

Counterpart of ``compressed_tensors_tpu/ops/fp4.py``, bit for bit: values
round to 0, +-0.5, +-1, +-1.5, +-2, +-3, +-4, +-6 through the same cascade
of thresholds, whose >= / > choices encode round half to even, and the sign
of -0.0 survives.
"""

from __future__ import annotations

import torch

__all__ = ["cast_to_fp4", "FP4_VALUES"]

FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)

# (value, threshold, inclusive): |x| >= or > threshold rounds up to value
_STEPS = ((0.5, 0.25, False), (1.0, 0.75, True), (1.5, 1.25, False),
          (2.0, 1.75, True), (3.0, 2.5, False), (4.0, 3.5, True),
          (6.0, 5.0, False))


def cast_to_fp4(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest E2M1 value, keeping x's dtype:
    |x| <= 0.25 -> 0; (0.25, 0.75) -> 0.5; [0.75, 1.25] -> 1.0;
    (1.25, 1.75) -> 1.5; [1.75, 2.5] -> 2.0; (2.5, 3.5) -> 3.0;
    [3.5, 5.0] -> 4.0; > 5.0 -> 6.0."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    sign = torch.where(torch.signbit(x), -one, one)
    ax = x.abs()
    result = torch.zeros_like(ax)
    for value, threshold, inclusive in _STEPS:
        above = ax >= threshold if inclusive else ax > threshold
        result = torch.where(above, one * value, result)
    return result * sign
