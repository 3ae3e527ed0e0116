"""Naive quantization codec: the weight stored in its closest storage dtype
(int8 / fp8_e4m3), plus the int-quantized / float-quantized aliases.

Counterpart of ``compressed_tensors_tpu/compressors/naive_quantized.py``
(the block strategy's padding waits for that strategy).
"""

from __future__ import annotations

from compressed_tensors_tpu_torch.compressors.base import (
    COMPRESSIBLE_MODULE_TYPES,
    BaseCompressor,
    TensorStateDict,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.quantize import dequantize, quantize
from compressed_tensors_tpu_torch.quantization import (
    ActivationOrdering,
    QuantizationScheme,
    QuantizationType,
)
from compressed_tensors_tpu_torch.utils import getattr_chain

__all__ = [
    "NaiveQuantizationCompressor",
    "IntQuantizationCompressor",
    "FloatQuantizationCompressor",
]


@BaseCompressor.register(name=CompressionFormat.naive_quantized.value)
class NaiveQuantizationCompressor(BaseCompressor):
    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        param_names = ("weight", "weight_scale")
        if not getattr_chain(scheme, "weights.symmetric", True):
            param_names += ("weight_zero_point",)
        if getattr_chain(scheme, "weights.actorder", None) == \
                ActivationOrdering.GROUP:
            param_names += ("weight_g_idx",)
        return param_names

    @classmethod
    def compress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        weights = scheme.weights
        state_dict["weight"] = quantize(
            state_dict.pop("weight"), state_dict.get("weight_scale"),
            state_dict.get("weight_zero_point"), weights,
            dtype=weights.storage_dtype(),
            g_idx=state_dict.get("weight_g_idx"))
        return cls._remove_symmetric_zp(state_dict, scheme)

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        weight = state_dict.pop("weight")
        state_dict["weight"] = dequantize(
            weight, state_dict.get("weight_scale"),
            state_dict.get("weight_zero_point"),
            g_idx=state_dict.get("weight_g_idx"),
        )
        return state_dict

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """Fallback: matches any quantized weight scheme."""
        return module_type in COMPRESSIBLE_MODULE_TYPES and \
            scheme.weights is not None


@BaseCompressor.register(name=CompressionFormat.int_quantized.value)
class IntQuantizationCompressor(NaiveQuantizationCompressor):
    """Alias matching W8A8-int style quantization."""

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        return (
            module_type in COMPRESSIBLE_MODULE_TYPES
            and scheme.input_activations is not None
            and scheme.weights is not None
            and scheme.weights.type == QuantizationType.INT.value
        )


@BaseCompressor.register(name=CompressionFormat.float_quantized.value)
class FloatQuantizationCompressor(NaiveQuantizationCompressor):
    """Alias matching FP8 W8A8 style quantization."""

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        return (
            module_type in COMPRESSIBLE_MODULE_TYPES
            and scheme.input_activations is not None
            and scheme.weights is not None
            and scheme.weights.type == QuantizationType.FLOAT.value
        )
