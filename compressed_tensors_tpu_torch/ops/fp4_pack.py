"""FP4 (E2M1) nibble packing codec.

Counterpart of ``compressed_tensors_tpu/ops/fp4_pack.py``, bit for bit:
each fp4 value maps to a 4-bit code (magnitude index into 0, 0.5, 1, 1.5,
2, 3, 4, 6 in bits 0-2, sign in bit 3), and consecutive pairs pack into
one uint8, low nibble first.
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.ops.fp4 import FP4_VALUES as KE2M1_TO_FLOAT

__all__ = ["pack_fp4_to_uint8", "unpack_fp4_from_uint8", "KE2M1_TO_FLOAT"]

# doubled magnitudes 0, 1, 2, 3, 4, 6, 8, 12: the code is the count of
# thresholds a doubled value reaches
_DOUBLED_THRESHOLDS = (1, 2, 3, 4, 6, 8, 12)


def pack_fp4_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Pack an (m, n) tensor of exact fp4 values (``cast_to_fp4``'s
    output) into (m, n // 2) uint8."""
    m, n = x.shape
    if n % 2 != 0:
        raise ValueError(
            "tensor must have an even number of columns for nvfp4 compression")
    sign = torch.signbit(x).to(torch.uint8)
    doubled = (x.to(torch.float32) * 2).abs().to(torch.int32)
    idx = torch.zeros_like(doubled, dtype=torch.uint8)
    for t in _DOUBLED_THRESHOLDS:
        idx += (doubled >= t).to(torch.uint8)
    idx = (idx | (sign << 3)).reshape(-1, 2)
    return (idx[:, 0] | (idx[:, 1] << 4)).reshape(m, n // 2)


def unpack_fp4_from_uint8(a: torch.Tensor, m: int, n: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack (m, n // 2) uint8 into (m, n) fp4 values in ``dtype``."""
    flat = a.reshape(-1)
    codes = torch.stack((flat & 0x0F, flat >> 4), dim=1).reshape(-1)
    lut = torch.tensor(KE2M1_TO_FLOAT, dtype=torch.float32, device=a.device)
    values = lut[(codes & 0x07).long()]
    values = torch.where((codes & 0x08).bool(), -values, values)
    return values.reshape(m, n).to(dtype)
