"""Format codecs: stateless classmethod compressors over per-module state
dicts of torch tensors.

Counterpart of ``compressed_tensors_tpu/compressors/base.py``: codecs are
looked up in the registry by CompressionFormat value and called as
``decompress(state_dict, scheme)`` where keys are local names
("weight_packed", "weight_scale", ...), and ``compress`` the other way.
"""

from __future__ import annotations

from abc import ABC
from typing import Dict, Optional

import torch

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization import QuantizationScheme
from compressed_tensors_tpu_torch.registry import RegistryMixin

__all__ = [
    "BaseCompressor",
    "TensorStateDict",
    "COMPRESSIBLE_MODULE_TYPES",
    "get_compressor",
    "compress_state_dict",
    "decompress_state_dict",
]

TensorStateDict = Dict[str, torch.Tensor]

# module types whose weights can be compressed
COMPRESSIBLE_MODULE_TYPES = ("Linear", "Embedding")


class BaseCompressor(RegistryMixin, ABC):
    """Base class for compression-format codecs.

    Look up via ``BaseCompressor.get_value_from_registry(format)`` and call
    the classmethods directly on the returned class.
    """

    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        """Names of parameters this format stores for a module."""
        raise NotImplementedError(
            f"{cls.__name__} does not implement compression_param_names"
        )

    @classmethod
    def compress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        """Compress a per-module state dict; does not modify the input."""
        raise NotImplementedError(f"{cls.__name__} does not implement compress")

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        """Decompress a per-module state dict; does not modify the input."""
        raise NotImplementedError(f"{cls.__name__} does not implement decompress")

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """True if this codec applies to (module type, scheme)."""
        raise NotImplementedError(f"{cls.__name__} does not implement can_compress")

    @classmethod
    def _remove_symmetric_zp(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        """Drop the zero points of symmetric schemes."""
        for prefix, args in (("input", scheme.input_activations),
                             ("weight", scheme.weights),
                             ("output", scheme.output_activations)):
            if args and args.symmetric:
                state_dict.pop(f"{prefix}_zero_point", None)
        return state_dict


def get_compressor(format: str | CompressionFormat) -> type[BaseCompressor]:
    value = format.value if isinstance(format, CompressionFormat) else format
    return BaseCompressor.get_value_from_registry(value)


def _resolve_format(scheme: QuantizationScheme,
                    format: Optional[str]) -> CompressionFormat:
    from compressed_tensors_tpu_torch.compressors.format import (
        infer_module_format,
    )

    fmt = CompressionFormat(
        format or scheme.format or infer_module_format("Linear", scheme))
    scheme.format = fmt
    return fmt


def compress_state_dict(state_dict: TensorStateDict,
                        scheme: QuantizationScheme,
                        format: Optional[str] = None) -> TensorStateDict:
    """Compress one module's state dict in the format given by (1)
    ``format``, (2) ``scheme.format``, (3) inference; sets
    ``scheme.format``."""
    return get_compressor(_resolve_format(scheme, format)).compress(
        state_dict, scheme)


def decompress_state_dict(state_dict: TensorStateDict,
                          scheme: QuantizationScheme,
                          format: Optional[str] = None) -> TensorStateDict:
    """Decompress one module's state dict (format resolved as in
    ``compress_state_dict``)."""
    return get_compressor(_resolve_format(scheme, format)).decompress(
        state_dict, scheme)
