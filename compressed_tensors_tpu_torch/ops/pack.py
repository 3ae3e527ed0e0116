"""Dense int32 bit-packing codec for 1-8 bit integer weights.

Counterpart of ``compressed_tensors_tpu/ops/pack.py``, bit for bit: E
elements of B bits pack into ceil(E*B/32) int32 words with no padding bits;
elements may straddle word boundaries. Values are offset to unsigned by
``1 << (num_bits-1)`` before packing. Arithmetic runs in int64 so the
unsigned 32-bit words never meet a sign bit until the final cast.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

__all__ = ["pack_to_int32", "unpack_from_int32", "packed_cols"]

_MASK32 = 0xFFFFFFFF


def packed_cols(cols: int, num_bits: int) -> int:
    """Number of int32 words per row after packing."""
    return math.ceil(cols * num_bits / 32)


@lru_cache(maxsize=None)
def _layout(num_bits: int):
    """Per-element layout for one 32-element group: element i occupies bits
    [bit_offset, bit_offset + lo_bits) of word word_idx; when lo_bits <
    num_bits its high bits sit at the bottom of word word_idx + 1."""
    bit_starts = [i * num_bits for i in range(32)]
    word_idx = [b // 32 for b in bit_starts]
    bit_offset = [b % 32 for b in bit_starts]
    lo_bits = [min(32 - o, num_bits) for o in bit_offset]
    return word_idx, bit_offset, lo_bits


def _check_bits(num_bits: int) -> None:
    if not 1 <= num_bits <= 8:
        raise ValueError(
            f"Packing is only supported for num_bits in [1, 8], got {num_bits}"
        )


def pack_to_int32(
    value: torch.Tensor, num_bits: int, packed_dim: int = 1
) -> torch.Tensor:
    """Pack an int8 tensor of B-bit values into int32 along the last
    (packed_dim=1) or second-to-last (packed_dim=0) dim; leading dims are
    batch dims."""
    if value.dtype != torch.int8:
        raise ValueError("Tensor must be quantized to int8 before packing")
    _check_bits(num_bits)
    v = value.to(torch.int64) + (1 << (num_bits - 1))
    if packed_dim == 0:
        v = v.transpose(-1, -2)
    *lead, rows, cols = v.shape
    padded = math.ceil(cols / 32) * 32
    if padded > cols:
        v = torch.nn.functional.pad(v, (0, padded - cols))
    v = v.reshape(*lead, rows, padded // 32, 32)

    word_idx, bit_offset, lo_bits = _layout(num_bits)
    dev = v.device
    shift_lo = torch.tensor(bit_offset, dtype=torch.int64, device=dev)
    words = torch.zeros((*v.shape[:-1], num_bits), dtype=torch.int64,
                        device=dev)
    words.index_add_(-1, torch.tensor(word_idx, device=dev),
                     (v << shift_lo) & _MASK32)
    over = [i for i in range(32) if lo_bits[i] < num_bits]
    if over:
        words.index_add_(
            -1, torch.tensor([word_idx[i] + 1 for i in over], device=dev),
            v[..., over] >> torch.tensor([lo_bits[i] for i in over],
                                         dtype=torch.int64, device=dev),
        )
    words = words.reshape(*lead, rows, -1)[..., :packed_cols(cols, num_bits)]
    # unsigned 32-bit words -> two's-complement int32
    out = torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)
    if packed_dim == 0:
        out = out.transpose(-1, -2)
    return out.contiguous()


def unpack_from_int32(
    value: torch.Tensor,
    num_bits: int,
    shape: tuple[int, ...],
    packed_dim: int = 1,
) -> torch.Tensor:
    """Unpack int32-packed values back to int8.

    :param shape: original pre-pack shape (of the trailing-2D slice for N-D)
    """
    if value.dtype != torch.int32:
        raise ValueError(f"Expected int32 but got {value.dtype}, aborting unpack")
    _check_bits(num_bits)
    shape = tuple(int(s) for s in shape)
    cols = shape[-2 + packed_dim] if len(shape) >= 2 else shape[packed_dim]
    w = value.to(torch.int64) & _MASK32
    if packed_dim == 0:
        w = w.transpose(-1, -2)
    *lead, rows, num_words = w.shape
    if num_words % num_bits:
        w = torch.nn.functional.pad(w, (0, num_bits - num_words % num_bits))
    w = w.reshape(*lead, rows, -1, num_bits)

    word_idx, bit_offset, lo_bits = _layout(num_bits)
    dev = w.device

    def _t(xs):
        return torch.tensor(xs, dtype=torch.int64, device=dev)

    out = (w[..., word_idx] >> _t(bit_offset)) & ((1 << _t(lo_bits)) - 1)
    over = [i for i in range(32) if lo_bits[i] < num_bits]
    if over:
        hi = _t([num_bits - lo_bits[i] for i in over])
        right = ((w[..., [word_idx[i] + 1 for i in over]] & ((1 << hi) - 1))
                 << _t([lo_bits[i] for i in over]))
        out[..., over] |= right
    out = out.reshape(*lead, rows, -1)[..., :cols]
    if packed_dim == 0:
        out = out.transpose(-1, -2)
    return (out - (1 << (num_bits - 1))).to(torch.int8).contiguous()
