"""Pack-quantized codec: INT 1-8 bit weights densely packed into int32.

Counterpart of ``compressed_tensors_tpu/compressors/pack_quantized.py``,
on the bit-exact codec of ``ops/pack.py``.
"""

from __future__ import annotations

import torch

from compressed_tensors_tpu_torch.compressors.base import (
    COMPRESSIBLE_MODULE_TYPES,
    BaseCompressor,
    TensorStateDict,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.pack import (
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.ops.quantize import dequantize, quantize
from compressed_tensors_tpu_torch.quantization import (
    ActivationOrdering,
    QuantizationScheme,
    QuantizationStrategy,
    QuantizationType,
)
from compressed_tensors_tpu_torch.utils import getattr_chain

__all__ = ["PackedQuantizationCompressor", "PACK_ZP_STRATS"]

PACK_ZP_STRATS = [
    QuantizationStrategy.GROUP.value,
    QuantizationStrategy.CHANNEL.value,
]


@BaseCompressor.register(name=CompressionFormat.pack_quantized.value)
class PackedQuantizationCompressor(BaseCompressor):
    @classmethod
    def compression_param_names(cls, scheme: QuantizationScheme) -> tuple[str, ...]:
        param_names = ("weight_packed", "weight_scale", "weight_shape")
        if not getattr_chain(scheme, "weights.symmetric", True):
            param_names += ("weight_zero_point",)
        if getattr_chain(scheme, "weights.actorder", None) == \
                ActivationOrdering.GROUP:
            param_names += ("weight_g_idx",)
        if (
            getattr_chain(scheme, "input_activations.strategy", None)
            == QuantizationStrategy.TENSOR_GROUP.value
        ):
            param_names += ("input_global_scale",)
        return param_names

    @classmethod
    def compress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        weight = state_dict.pop("weight")
        zero_point = state_dict.get("weight_zero_point")
        weights = scheme.weights
        quantized = quantize(weight, state_dict.get("weight_scale"),
                             zero_point, weights, dtype=torch.int8,
                             g_idx=state_dict.get("weight_g_idx"))
        state_dict["weight_packed"] = pack_to_int32(quantized,
                                                    weights.num_bits)
        state_dict["weight_shape"] = torch.tensor(tuple(weight.shape),
                                                  dtype=torch.int32)
        if not weights.symmetric and weights.strategy in PACK_ZP_STRATS:
            if zero_point is None:
                raise ValueError("Asymmetric quant requires zero-point values")
            state_dict["weight_zero_point"] = pack_to_int32(
                zero_point.to(torch.int8), weights.num_bits, packed_dim=0)
        return cls._remove_symmetric_zp(state_dict, scheme)

    @classmethod
    def decompress(
        cls, state_dict: TensorStateDict, scheme: QuantizationScheme
    ) -> TensorStateDict:
        state_dict = dict(state_dict)
        packed = state_dict.pop("weight_packed")
        scale = state_dict.get("weight_scale")
        zero_point = state_dict.get("weight_zero_point", None)
        original_shape = tuple(int(v) for v in state_dict["weight_shape"])
        weights = scheme.weights

        if not weights.symmetric and weights.strategy in PACK_ZP_STRATS:
            if zero_point is None:
                raise ValueError("Asymmetric quant requires zero-point values")
            zero_point = unpack_from_int32(
                zero_point, weights.num_bits,
                (*original_shape[:-1], scale.shape[-1]), packed_dim=0)
            state_dict["weight_zero_point"] = zero_point

        unpacked = unpack_from_int32(packed, weights.num_bits, original_shape)
        state_dict["weight"] = dequantize(
            unpacked, scale, zero_point, g_idx=state_dict.get("weight_g_idx"))
        return state_dict

    @classmethod
    def can_compress(cls, module_type: str, scheme: QuantizationScheme) -> bool:
        """INT-only 1-8 bit weight quant; float activation schemes (W4AFP8)
        go naive."""
        if scheme.input_activations is not None:
            if scheme.input_activations.type == QuantizationType.FLOAT.value:
                return False
        return (
            module_type in COMPRESSIBLE_MODULE_TYPES
            and scheme.weights is not None
            and 1 <= scheme.weights.num_bits <= 8
            and scheme.weights.type == QuantizationType.INT.value
        )
