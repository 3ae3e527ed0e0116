"""Compression format enums + sparsity config schemas.

Mirrors `compressed_tensors/config/` (ref config/base.py); copied from
``compressed_tensors_tpu/config/__init__.py``. The sparse formats are
first-class (the reference demoted them to legacy, but the engine consumes
them — see SURVEY.md §2.3 note).
"""

from __future__ import annotations

from enum import Enum, unique

from pydantic import BaseModel

from compressed_tensors_tpu_torch.registry import RegistryMixin

__all__ = [
    "CompressionFormat",
    "SparsityStructure",
    "SparsityCompressionConfig",
    "BitmaskConfig",
    "Sparse24BitMaskConfig",
    "DenseSparsityConfig",
    "QUANTIZATION_CONFIG_NAME",
    "SPARSITY_CONFIG_NAME",
    "TRANSFORM_CONFIG_NAME",
    "COMPRESSION_VERSION_NAME",
    "QUANTIZATION_METHOD_NAME",
    "QUANTIZATION_METHOD",
]

# serialization constants (ref base.py:4-12)
QUANTIZATION_CONFIG_NAME = "quantization_config"
SPARSITY_CONFIG_NAME = "sparsity_config"
TRANSFORM_CONFIG_NAME = "transform_config"
COMPRESSION_VERSION_NAME = "version"
QUANTIZATION_METHOD_NAME = "quant_method"
QUANTIZATION_METHOD = "compressed-tensors"


@unique
class CompressionFormat(str, Enum):
    dense = "dense"
    sparse_bitmask = "sparse-bitmask"
    sparse_24_bitmask = "sparse-24-bitmask"
    int_quantized = "int-quantized"
    float_quantized = "float-quantized"
    naive_quantized = "naive-quantized"
    pack_quantized = "pack-quantized"
    marlin_24 = "marlin-24"
    mixed_precision = "mixed-precision"
    nvfp4_pack_quantized = "nvfp4-pack-quantized"
    mxfp4_pack_quantized = "mxfp4-pack-quantized"
    mxfp8_quantized = "mxfp8-quantized"


@unique
class SparsityStructure(Enum):
    """Sparsity structure: "2:4", "unstructured", "0:0"; case-insensitive,
    None -> unstructured (ref config/base.py SparsityStructure)."""

    TWO_FOUR = "2:4"
    UNSTRUCTURED = "unstructured"
    ZERO_ZERO = "0:0"

    def __new__(cls, value):
        obj = object.__new__(cls)
        obj._value_ = value.lower() if value is not None else value
        return obj

    @classmethod
    def _missing_(cls, value):
        if value is None:
            return cls.UNSTRUCTURED
        for member in cls:
            if member.value == value.lower():
                return member
        raise ValueError(f"{value} is not a valid {cls.__name__}")


class SparsityCompressionConfig(RegistryMixin, BaseModel):
    """Base config for sparsity compression (ref config/base.py)."""

    format: str
    targets: list[str] | None = None
    ignore: list[str] | None = None
    global_sparsity: float | None = 0.0
    sparsity_structure: str | None = "unstructured"


@SparsityCompressionConfig.register(name=CompressionFormat.sparse_bitmask.value)
class BitmaskConfig(SparsityCompressionConfig):
    format: str = CompressionFormat.sparse_bitmask.value


@SparsityCompressionConfig.register(name=CompressionFormat.sparse_24_bitmask.value)
class Sparse24BitMaskConfig(SparsityCompressionConfig):
    format: str = CompressionFormat.sparse_24_bitmask.value


@SparsityCompressionConfig.register(name=CompressionFormat.dense.value)
class DenseSparsityConfig(SparsityCompressionConfig):
    format: str = CompressionFormat.dense.value
