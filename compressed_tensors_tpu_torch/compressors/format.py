"""Compression-format inference. Counterpart of
``compressed_tensors_tpu/compressors/format.py``."""

from __future__ import annotations

from typing import Iterable, Optional

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

__all__ = [
    "COMPRESSION_FORMAT_PRIORITY",
    "infer_module_format",
    "infer_format_from_schemes",
    "flatten_formats",
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


def flatten_formats(formats: Iterable[CompressionFormat]) -> CompressionFormat:
    """dense if empty, the single format, else mixed-precision."""
    formats = set(formats)
    if len(formats) == 0:
        return CompressionFormat.dense
    if len(formats) == 1:
        return next(iter(formats))
    return CompressionFormat.mixed_precision


def infer_format_from_schemes(
    schemes: Iterable[tuple[str, QuantizationScheme]],
    force_compression_format: Optional[str] = None,
) -> CompressionFormat:
    """A model-level format from (module_type, scheme) pairs, setting each
    scheme's format (a forced format first, then the scheme's own, then
    inference)."""
    formats = set()
    for module_type, scheme in schemes:
        format = infer_module_format(module_type, scheme)
        if force_compression_format is not None:
            format = CompressionFormat(force_compression_format)
        elif scheme.format is not None:
            format = CompressionFormat(scheme.format)
        scheme.format = CompressionFormat(format)
        if format != CompressionFormat.dense:
            formats.add(CompressionFormat(format))
    return flatten_formats(formats)
