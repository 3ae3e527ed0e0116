"""Dtype vocabulary shared across the port.

The on-disk format (config.json + safetensors) names dtypes the way torch
does (``"torch.float8_e4m3fn"``) and safetensors headers use short codes
(``"BF16"``, ``"F8_E4M3"``); this module maps both onto ``torch.dtype``.
Counterpart of ``compressed_tensors_tpu/utils/dtypes.py``.
"""

from __future__ import annotations

from typing import Annotated, Any

import torch
from pydantic import GetCoreSchemaHandler
from pydantic_core import core_schema

__all__ = [
    "TensorDType",
    "parse_dtype",
    "serialize_dtype",
    "SAFETENSORS_DTYPES",
    "byte_view",
    "is_float_dtype",
    "dtype_bits",
    "finfo_max",
    "finfo_min",
    "finfo_eps",
]

# canonical names -> torch dtype; names are torch's, so `torch.<name>`
# round-trips through config.json. Newer dtypes only where torch has them.
_NAME_TO_DTYPE: dict[str, torch.dtype] = {
    name: getattr(torch, name)
    for name in (
        "float64", "float32", "float16", "bfloat16", "float8_e4m3fn",
        "float8_e5m2", "int64", "int32", "int16", "int8", "uint8",
        "uint16", "uint32", "uint64", "bool", "float8_e8m0fnu",
        "float4_e2m1fn_x2",
    )
    if hasattr(torch, name)
}

_DTYPE_TO_NAME: dict[torch.dtype, str] = {v: k for k, v in _NAME_TO_DTYPE.items()}

# safetensors header dtype strings <-> torch dtypes
SAFETENSORS_DTYPES: dict[str, torch.dtype] = {
    code: _NAME_TO_DTYPE[name]
    for code, name in (
        ("F64", "float64"), ("F32", "float32"), ("F16", "float16"),
        ("BF16", "bfloat16"), ("F8_E4M3", "float8_e4m3fn"),
        ("F8_E5M2", "float8_e5m2"), ("F8_E8M0", "float8_e8m0fnu"),
        ("I64", "int64"), ("I32", "int32"), ("I16", "int16"), ("I8", "int8"),
        ("U8", "uint8"), ("U16", "uint16"), ("U32", "uint32"),
        ("U64", "uint64"), ("BOOL", "bool"),
    )
    if name in _NAME_TO_DTYPE
}


def parse_dtype(value: Any) -> torch.dtype:
    """Parse ``"torch.int8"``, ``"int8"`` or a ``torch.dtype``."""
    if isinstance(value, str):
        name = value.removeprefix("torch.")
        if name not in _NAME_TO_DTYPE:
            raise ValueError(f"No such dtype `torch.{name}`")
        return _NAME_TO_DTYPE[name]
    if isinstance(value, torch.dtype) and value in _DTYPE_TO_NAME:
        return value
    raise ValueError(f"Unsupported dtype {value}")


def serialize_dtype(dtype: torch.dtype | None) -> str | None:
    """Serialize to the checkpoint-compatible ``torch.<name>`` string."""
    if dtype is None:
        return None
    return f"torch.{_DTYPE_TO_NAME[dtype]}"


def is_float_dtype(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


def dtype_bits(dtype: torch.dtype) -> int:
    """Bits of one element of storage (8 for a bool and for a pair of fp4
    values, as the JAX package counts them)."""
    return dtype.itemsize * 8


# torch.finfo has no fp4 entry: the e2m1 element's (max 6, eps 0.5)
_FP4_FINFO = {"max": 6.0, "min": -6.0, "eps": 0.5}


def _finfo(dtype: torch.dtype, field: str) -> float:
    """A float dtype's finfo field; an integer or bool dtype raises
    ValueError, as the JAX package's ``ml_dtypes.finfo`` does."""
    if not dtype.is_floating_point:
        raise ValueError(f"data type {dtype} not inexact")
    if dtype == getattr(torch, "float4_e2m1fn_x2", None):
        return _FP4_FINFO[field]
    return float(getattr(torch.finfo(dtype), field))


def finfo_max(dtype: torch.dtype) -> float:
    return _finfo(dtype, "max")


def finfo_min(dtype: torch.dtype) -> float:
    return _finfo(dtype, "min")


def finfo_eps(dtype: torch.dtype) -> float:
    return _finfo(dtype, "eps")


class _TensorDTypeAnnotation:
    """Pydantic annotation: validates torch-style strings / torch dtypes,
    serializes as ``torch.<name>`` for config.json compatibility."""

    @classmethod
    def __get_pydantic_core_schema__(
        cls, _source_type: Any, _handler: GetCoreSchemaHandler
    ) -> core_schema.CoreSchema:
        from_any = core_schema.no_info_plain_validator_function(parse_dtype)
        return core_schema.json_or_python_schema(
            json_schema=core_schema.chain_schema(
                [core_schema.str_schema(), from_any]
            ),
            python_schema=from_any,
            serialization=core_schema.plain_serializer_function_ser_schema(
                serialize_dtype
            ),
        )


TensorDType = Annotated[torch.dtype, _TensorDTypeAnnotation]


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors as same-size uint8 views, for pure data movement (index
    writes, gathers, concatenation: CUDA lacks some of these for fp8);
    other dtypes as they are."""
    if t.dtype.is_floating_point and t.dtype.itemsize == 1:
        return t.view(torch.uint8)
    return t
