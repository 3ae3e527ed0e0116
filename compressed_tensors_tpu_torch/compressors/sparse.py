"""Sparse codecs: sparse-bitmask (unstructured) and sparse-24-bitmask (2:4
structured).

Counterpart of ``compressed_tensors_tpu/compressors/sparse.py``, on the
bit-exact codecs of ``ops/bitmask.py``. A module's state holds:

- ``weight.compressed``: the kept values (1-D for unstructured; (R, C/2)
  for 2:4)
- ``weight.bitmask``: packed little-endian bit rows, (R, ceil(C/8)) uint8
- ``weight.shape``: the dense shape, int32
- ``weight.row_offsets``: each row's start offset (unstructured only)

A sparse codec stacks over a quantization codec that leaves a ``weight``
(naive / int / float quantized): the quantized values are what it keeps.
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.compressors.base import (
    BaseCompressor,
    TensorStateDict,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.bitmask import (
    bitmask_compress,
    bitmask_decompress,
    sparse24_compress,
    sparse24_decompress,
)
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

__all__ = ["BitmaskCompressor", "Sparse24BitMaskCompressor"]


def _shape_tensor(weight: torch.Tensor) -> torch.Tensor:
    return torch.tensor(tuple(weight.shape), dtype=torch.int32)


def _pop_shape(state_dict: TensorStateDict) -> tuple[int, ...]:
    return tuple(int(v) for v in state_dict.pop("weight.shape"))


@BaseCompressor.register(name=CompressionFormat.sparse_bitmask.value)
class BitmaskCompressor(BaseCompressor):
    """Unstructured sparsity: a bitmask and the nonzero values."""

    COMPRESSION_PARAM_SUFFIXES = ("compressed", "bitmask", "shape",
                                  "row_offsets")

    @classmethod
    def compression_param_names(
        cls, scheme: QuantizationScheme | None = None
    ) -> tuple[str, ...]:
        return tuple(f"weight.{s}" for s in cls.COMPRESSION_PARAM_SUFFIXES)

    @classmethod
    def compress(cls, state_dict: TensorStateDict,
                 scheme: QuantizationScheme | None = None) -> TensorStateDict:
        state_dict = dict(state_dict)
        weight = state_dict.pop("weight")
        values, bitmask, row_offsets = bitmask_compress(weight)
        state_dict["weight.compressed"] = values
        state_dict["weight.bitmask"] = bitmask
        state_dict["weight.shape"] = _shape_tensor(weight)
        state_dict["weight.row_offsets"] = row_offsets
        return state_dict

    @classmethod
    def decompress(cls, state_dict: TensorStateDict,
                   scheme: QuantizationScheme | None = None
                   ) -> TensorStateDict:
        state_dict = dict(state_dict)
        values = state_dict.pop("weight.compressed")
        bitmask = state_dict.pop("weight.bitmask")
        shape = _pop_shape(state_dict)
        state_dict.pop("weight.row_offsets", None)
        state_dict["weight"] = bitmask_decompress(values, bitmask, shape)
        return state_dict

    @classmethod
    def can_compress(cls, module_type: str, scheme) -> bool:
        return True


@BaseCompressor.register(name=CompressionFormat.sparse_24_bitmask.value)
class Sparse24BitMaskCompressor(BaseCompressor):
    """2:4 structured sparsity: (R, C/2) values and a bitmask."""

    COMPRESSION_PARAM_SUFFIXES = ("compressed", "bitmask", "shape")

    @classmethod
    def compression_param_names(
        cls, scheme: QuantizationScheme | None = None
    ) -> tuple[str, ...]:
        return tuple(f"weight.{s}" for s in cls.COMPRESSION_PARAM_SUFFIXES)

    @classmethod
    def compress(cls, state_dict: TensorStateDict,
                 scheme: QuantizationScheme | None = None) -> TensorStateDict:
        state_dict = dict(state_dict)
        weight = state_dict.pop("weight")
        compressed, bitmask = sparse24_compress(weight)
        state_dict["weight.compressed"] = compressed
        state_dict["weight.bitmask"] = bitmask
        state_dict["weight.shape"] = _shape_tensor(weight)
        return state_dict

    @classmethod
    def decompress(cls, state_dict: TensorStateDict,
                   scheme: QuantizationScheme | None = None
                   ) -> TensorStateDict:
        state_dict = dict(state_dict)
        compressed = state_dict.pop("weight.compressed")
        bitmask = state_dict.pop("weight.bitmask")
        shape = _pop_shape(state_dict)
        state_dict["weight"] = sparse24_decompress(compressed, bitmask, shape)
        return state_dict

    @classmethod
    def can_compress(cls, module_type: str, scheme) -> bool:
        return True
