"""NVFP4 / MXFP4 packed and MXFP8 codecs.

Counterpart of ``compressed_tensors_tpu/compressors/nvfp4.py``, bit for
bit:
- NVFP4: FP4 E2M1 nibble-packed weights, fp8 e4m3 group scales (g = 16)
  and an f32 ``weight_global_scale``;
- MXFP4: the same packing, uint8 E8M0 scales (g = 32), no global scale;
- MXFP8: fp8 e4m3 weights (naive), uint8 E8M0 scales (g = 32).
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.compressors.base import (
    COMPRESSIBLE_MODULE_TYPES,
    BaseCompressor,
    TensorStateDict,
)
from compressed_tensors_tpu_torch.compressors.naive_quantized import (
    NaiveQuantizationCompressor,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.fp4_pack import (
    pack_fp4_to_uint8,
    unpack_fp4_from_uint8,
)
from compressed_tensors_tpu_torch.ops.mx import (
    compress_mx_scale,
    decompress_mx_scale,
)
from compressed_tensors_tpu_torch.ops.quantize import dequantize, quantize
from compressed_tensors_tpu_torch.quantization import (
    QuantizationArgs,
    QuantizationScheme,
    QuantizationType,
)
from compressed_tensors_tpu_torch.utils import getattr_chain

__all__ = [
    "NVFP4PackedCompressor",
    "MXFP4PackedCompressor",
    "MXFP8QuantizationCompressor",
]


def _is_float(scheme: QuantizationScheme, num_bits: int,
              group_size: int) -> bool:
    w = scheme.weights
    return (w is not None and w.num_bits == num_bits
            and w.type == QuantizationType.FLOAT.value
            and w.group_size == group_size)


@BaseCompressor.register(name=CompressionFormat.nvfp4_pack_quantized.value)
class NVFP4PackedCompressor(BaseCompressor):
    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        param_names = ("weight_packed", "weight_scale", "weight_global_scale")
        if not getattr_chain(scheme, "weights.symmetric", True):
            param_names += ("weight_zero_point",)
        if not getattr_chain(scheme, "input_activations.dynamic", True):
            param_names += ("input_global_scale",)
        return param_names

    @classmethod
    def _compress_scale(cls, scale, weights: QuantizationArgs):
        return scale.to(weights.scale_dtype or torch.float8_e4m3fn)

    @classmethod
    def _decompress_scale(cls, scale, dtype):
        return scale.to(dtype)

    @classmethod
    def compress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        weight = state_dict.pop("weight")
        scale = state_dict.pop("weight_scale")
        quantized = quantize(
            weight, scale, state_dict.get("weight_zero_point"),
            scheme.weights,
            global_scale=state_dict.get("weight_global_scale"))
        state_dict["weight_packed"] = pack_fp4_to_uint8(quantized)
        state_dict["weight_scale"] = cls._compress_scale(scale,
                                                         scheme.weights)
        return cls._remove_symmetric_zp(state_dict, scheme)

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        packed = state_dict.pop("weight_packed")
        m, n = packed.shape
        unpacked = unpack_fp4_from_uint8(packed, m, n * 2)
        scale = cls._decompress_scale(state_dict.get("weight_scale"),
                                      unpacked.dtype)
        state_dict["weight"] = dequantize(
            unpacked, scale,
            global_scale=state_dict.get("weight_global_scale"),
            dtype=unpacked.dtype)
        state_dict["weight_scale"] = scale
        return state_dict

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """FP4 with group size 16."""
        return module_type in COMPRESSIBLE_MODULE_TYPES and _is_float(
            scheme, 4, 16)


@BaseCompressor.register(name=CompressionFormat.mxfp4_pack_quantized.value)
class MXFP4PackedCompressor(NVFP4PackedCompressor):
    """MXFP4: E8M0 (bias-127 exponent) scales, group size 32."""

    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        return tuple(p for p in super().compression_param_names(scheme)
                     if p != "weight_global_scale")

    @classmethod
    def _compress_scale(cls, scale, weights: QuantizationArgs):
        return compress_mx_scale(scale, weights.scale_dtype or torch.uint8)

    @classmethod
    def _decompress_scale(cls, scale, dtype):
        return decompress_mx_scale(scale).to(dtype)

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """FP4 with group size 32."""
        return module_type in COMPRESSIBLE_MODULE_TYPES and _is_float(
            scheme, 4, 32)


@BaseCompressor.register(name=CompressionFormat.mxfp8_quantized.value)
class MXFP8QuantizationCompressor(NaiveQuantizationCompressor):
    """MXFP8: fp8 e4m3 weights with uint8 E8M0 scales."""

    @classmethod
    def compress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = NaiveQuantizationCompressor.compress(state_dict, scheme)
        state_dict["weight_scale"] = compress_mx_scale(
            state_dict["weight_scale"],
            scheme.weights.scale_dtype or torch.uint8)
        return state_dict

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        state_dict["weight_scale"] = decompress_mx_scale(
            state_dict["weight_scale"])
        return NaiveQuantizationCompressor.decompress(state_dict, scheme)

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """FP8 with group size 32 and uint8 scales."""
        return (module_type in COMPRESSIBLE_MODULE_TYPES
                and _is_float(scheme, 8, 32)
                and scheme.weights.scale_dtype == torch.uint8)
