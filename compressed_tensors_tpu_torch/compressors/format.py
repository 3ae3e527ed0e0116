"""Compression-format inference. Counterpart of
``compressed_tensors_tpu/compressors/format.py``."""

from __future__ import annotations

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

__all__ = [
    "COMPRESSION_FORMAT_PRIORITY",
    "infer_module_format",
]

# priority order: more specific formats first
COMPRESSION_FORMAT_PRIORITY: list[CompressionFormat] = [
    CompressionFormat.mxfp4_pack_quantized,
    CompressionFormat.mxfp8_quantized,
    CompressionFormat.nvfp4_pack_quantized,
    CompressionFormat.int_quantized,
    CompressionFormat.pack_quantized,
    CompressionFormat.float_quantized,
    CompressionFormat.naive_quantized,
    CompressionFormat.dense,
]


def infer_module_format(
    module_type: str, scheme: QuantizationScheme
) -> CompressionFormat:
    """First format in priority order whose can_compress matches."""
    from compressed_tensors_tpu_torch.compressors.base import BaseCompressor

    return next(
        format
        for format in COMPRESSION_FORMAT_PRIORITY
        if BaseCompressor.get_value_from_registry(format.value).can_compress(
            module_type, scheme
        )
    )
