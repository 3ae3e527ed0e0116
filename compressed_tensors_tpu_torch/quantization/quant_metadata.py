"""Canonical quantization-parameter names (the serialized tensor
vocabulary). Counterpart of
``compressed_tensors_tpu/quantization/quant_metadata.py``."""

from __future__ import annotations

from enum import Enum

__all__ = ["QuantizationMetadata", "KVCacheScaleType", "ALL_QPARAM_KEYS"]


class KVCacheScaleType(Enum):
    KEY = "k_scale"
    VALUE = "v_scale"
    QUERY = "q_scale"


class QuantizationMetadata:
    """Canonical names of quantization parameters attached to modules."""

    @staticmethod
    def all_qparam_names() -> tuple[str, ...]:
        return tuple(
            f"{base}_{suffix}"
            for base in ("input", "weight", "output")
            for suffix in ("global_scale", "scale", "shape", "zero_point",
                           "g_idx")
        ) + tuple(t.value for t in KVCacheScaleType)


ALL_QPARAM_KEYS = QuantizationMetadata.all_qparam_names()


def is_quantization_param(name: str) -> bool:
    """True if a tensor name is a quantization parameter (q/k/v scales
    included)."""
    short = name.rsplit(".", 1)[-1]
    if short in ("k_scale", "v_scale", "q_scale"):
        return True
    return any(short.endswith(suffix) for suffix in (
        "_global_scale", "_scale", "_shape", "_zero_point", "_g_idx"))
