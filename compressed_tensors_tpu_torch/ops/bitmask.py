"""Bitmask and 2:4 structured-sparse codecs.

Counterpart of ``compressed_tensors_tpu/ops/bitmask.py``, bit for bit:
the same bitmask bytes and the same compressed values.

Format (the historical compressed-tensors layout):
- ``bitmask``: uint8, shape (R, ceil(C/8)), little-endian bit order along
  the last axis (bit k of byte j is column 8j + k).
- sparse-bitmask (unstructured): ``compressed`` the nonzero values, 1-D in
  row-major order, ``row_offsets`` each row's start index, ``shape``.
- sparse-24-bitmask (2:4): ``compressed`` (R, C/2) values, the two kept
  values of each group of four in their original order, ``shape``.

The JAX package blocks the 2:4 codecs by rows for the TPU's lanes; here
each runs in one pass (a (14336, 4096) weight's temporaries take under
1 GB on the card).
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = [
    "pack_bitmasks",
    "unpack_bitmasks",
    "get_24_bytemasks",
    "sparse24_compress",
    "sparse24_decompress",
    "bitmask_compress",
    "bitmask_decompress",
    "tensor_follows_mask_structure",
]


def _bit_weights(device) -> torch.Tensor:
    return torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=device)


def pack_bitmasks(bytemasks: torch.Tensor) -> torch.Tensor:
    """(R, C) bool -> (R, ceil(C/8)) uint8, little-endian bit order (as
    ``numpy.packbits(..., bitorder="little")``)."""
    rows, cols = bytemasks.shape
    m = bytemasks.to(torch.uint8)
    pad = (-cols) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(rows, -1, 8)
    return (m * _bit_weights(m.device)).sum(dim=-1).to(torch.uint8)


def unpack_bitmasks(packed: torch.Tensor,
                    original_shape: tuple[int, ...]) -> torch.Tensor:
    """(R, ceil(C/8)) uint8 -> (R, C) bool."""
    rows, cols = original_shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(rows, -1)[:, :cols].to(torch.bool)


def get_24_bytemasks(tensor: torch.Tensor) -> torch.Tensor:
    """2:4 mask: the two largest |w| of each contiguous group of four, ties
    to the lower index, NaN last: the first two of a stable argsort of
    -|w| in f32, as the JAX package keeps them. A group with fewer than
    two nonzeros still marks two positions, zeros among them, so the mask
    is not ``w != 0``.

    Each position's place in that order is counted from the three others
    of its group (larger, or equal at a lower index): on the H100 a sort
    or scan along a dimension of 4 takes 40-95 ms at (14336, 4096), these
    elementwise counts a few."""
    flat = tensor.reshape(-1, 4)
    mag = flat.to(torch.float32).abs()
    mag = torch.where(mag.isnan(), torch.full_like(mag, -1.0), mag)
    cols = mag.t().contiguous()
    keep = []
    for j in range(4):
        ahead = sum((cols[i] > cols[j]) | ((cols[i] == cols[j]) & (i < j))
                    for i in range(4) if i != j)
        keep.append(ahead < 2)
    return torch.stack(keep, dim=1).reshape(tensor.shape)


def tensor_follows_mask_structure(tensor: torch.Tensor,
                                  mask: str = "2:4") -> bool:
    """True if each group of ``m`` holds at most ``n`` nonzeros."""
    n, m = (int(v) for v in mask.split(":"))
    nonzero = (tensor.to(torch.float32) != 0).reshape(-1, m)
    return bool((nonzero.sum(dim=-1) <= n).all())


def sparse24_compress(weight: torch.Tensor):
    """(R, C) weight -> (compressed (R, C/2), bitmask (R, C/8) uint8).

    The weight is projected onto its 2:4 mask (``get_24_bytemasks``); each
    group's two kept values stay in their original order."""
    rows, cols = weight.shape
    mask = get_24_bytemasks(weight)
    # the mask keeps exactly two of every four, so the kept values in
    # row-major order are the (R, C/2) rows
    compressed = byte_view(weight)[mask].reshape(rows, cols // 2)
    return compressed.view(weight.dtype), pack_bitmasks(mask)


def sparse24_decompress(compressed: torch.Tensor, bitmask: torch.Tensor,
                        shape: tuple[int, int]) -> torch.Tensor:
    """Scatter (R, C/2) values back to a dense (R, C) tensor: a kept
    position takes its group's first value if no position before it in the
    group is kept, else the second (the JAX package's cumulative sum of the
    mask, less one, clipped to {0, 1}); the others are zero. Worked out
    column by column: a scan along the groups' 4-wide dimension takes
    95 ms on the H100 at (14336, 4096)."""
    rows, cols = shape
    flat_m = unpack_bitmasks(bitmask, (rows, cols)).reshape(-1, 4)
    flat_c = byte_view(compressed).reshape(-1, 2)
    first, second = flat_c[:, 0], flat_c[:, 1]
    zero = torch.zeros((), dtype=flat_c.dtype, device=flat_c.device)
    out, seen = [], None
    for j in range(4):
        kept = flat_m[:, j]
        vals = first if seen is None else torch.where(seen, second, first)
        out.append(torch.where(kept, vals, zero))
        seen = kept if seen is None else seen | kept
    dense = torch.stack(out, dim=1)
    return dense.reshape(rows, cols).view(compressed.dtype)


def bitmask_compress(weight: torch.Tensor):
    """Unstructured bitmask compression -> (values 1-D, bitmask,
    row_offsets). ``row_offsets`` is int32, as the JAX package gives it
    with 64-bit mode off (its default)."""
    mask = weight.to(torch.float32) != 0
    counts = mask.sum(dim=-1)
    row_offsets = (torch.cumsum(counts, dim=0) - counts).to(torch.int32)
    values = byte_view(weight)[mask].view(weight.dtype)
    return values, pack_bitmasks(mask), row_offsets


def bitmask_decompress(values: torch.Tensor, bitmask: torch.Tensor,
                       shape: tuple[int, int]) -> torch.Tensor:
    """Scatter 1-D nonzero values back to dense through the bitmask."""
    mask = unpack_bitmasks(bitmask, tuple(shape))
    out = torch.zeros(tuple(shape), dtype=byte_view(values).dtype,
                      device=values.device)
    out[mask] = byte_view(values)
    return out.view(values.dtype)
