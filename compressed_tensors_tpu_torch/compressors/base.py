"""Format codecs: stateless classmethod compressors over per-module state
dicts of torch tensors.

Counterpart of ``compressed_tensors_tpu/compressors/base.py``: codecs are
looked up in the registry by CompressionFormat value and called as
``decompress(state_dict, scheme)`` where keys are local names
("weight_packed", "weight_scale", ...). ``compress`` exists for the codecs
that build checkpoints in the port (naive, NVFP4, MXFP4, MXFP8); the rest
belongs to the PTQ save path, which a later slice ports.
"""

from __future__ import annotations

from abc import ABC
from typing import Dict

import torch

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization import QuantizationScheme
from compressed_tensors_tpu_torch.registry import RegistryMixin

__all__ = [
    "BaseCompressor",
    "TensorStateDict",
    "COMPRESSIBLE_MODULE_TYPES",
    "get_compressor",
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
