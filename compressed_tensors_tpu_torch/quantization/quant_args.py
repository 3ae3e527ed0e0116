"""Quantization argument schemas (the on-disk spec vocabulary).

Byte-compatible re-implementation of the reference's pydantic models
(`compressed_tensors/quantization/quant_args.py:169-496`): same field names,
validation, strategy inference and serialization so real ``config.json``
files parse identically. Counterpart of
``compressed_tensors_tpu/quantization/quant_args.py``; dtypes are torch's.
"""

from __future__ import annotations

import warnings
from enum import Enum
from typing import Any

import torch
from pydantic import (
    BaseModel,
    ConfigDict,
    Field,
    field_serializer,
    field_validator,
    model_validator,
)

from compressed_tensors_tpu_torch.utils.dtypes import TensorDType, parse_dtype

__all__ = [
    "FP8_E4M3_DATA",
    "FP4_E2M1_DATA",
    "BFLOAT16_DATA",
    "FLOAT16_DATA",
    "FLOAT32_DATA",
    "FLOAT64_DATA",
    "FloatArgs",
    "QuantizationType",
    "QuantizationStrategy",
    "QuantizationArgs",
    "ActivationOrdering",
    "DynamicType",
]


class FloatArgs:
    exponent: int
    mantissa: int
    bits: int | None = None
    max: float | None = None
    min: float | None = None
    dtype: torch.dtype | None = None


class FP4_E2M1_DATA(FloatArgs):
    """FP4 E2M1: values 0, ±0.5, ±1, ±1.5, ±2, ±3, ±4, ±6 (ref quant_args.py:49)."""

    exponent = 2
    mantissa = 1
    bits = 4
    max = 6.0
    min = -6.0
    dtype = None  # no standalone fp4 storage dtype; stored packed


class FP8_E4M3_DATA(FloatArgs):
    exponent = 4
    mantissa = 3
    bits = 8
    max = float(torch.finfo(torch.float8_e4m3fn).max)  # 448.0
    min = float(torch.finfo(torch.float8_e4m3fn).min)  # -448.0
    dtype = torch.float8_e4m3fn


class BFLOAT16_DATA(FloatArgs):
    exponent = 8
    mantissa = 7


class FLOAT16_DATA(FloatArgs):
    exponent = 5
    mantissa = 10


class FLOAT32_DATA(FloatArgs):
    exponent = 8
    mantissa = 23


class FLOAT64_DATA(FloatArgs):
    exponent = 11
    mantissa = 52


class QuantizationType(str, Enum):
    INT = "int"
    FLOAT = "float"


class QuantizationStrategy(str, Enum):
    TENSOR = "tensor"
    CHANNEL = "channel"
    GROUP = "group"
    BLOCK = "block"
    TOKEN = "token"
    TENSOR_GROUP = "tensor_group"
    ATTN_HEAD = "attn_head"


class DynamicType(str, Enum):
    """"local" means only local qparams are dynamic (NVFP4 activations)."""

    LOCAL = "local"


class ActivationOrdering(str, Enum):
    """GPTQ activation-ordering strategies; "dynamic"/"static" are aliases
    for "group"/"weight" (ref quant_args.py:138-166)."""

    GROUP = "group"
    WEIGHT = "weight"
    DYNAMIC = "dynamic"
    STATIC = "static"

    @classmethod
    def _missing_(cls, value):
        aliases = {"dynamic": "group", "static": "weight"}
        if isinstance(value, str) and value.lower() in aliases:
            return cls(aliases[value.lower()])
        return None

    def __eq__(self, other):
        aliases = {"dynamic": "group", "static": "weight"}
        if isinstance(other, (ActivationOrdering, str)):
            a = aliases.get(str(self.value), str(self.value))
            b = aliases.get(str(other.value if isinstance(other, Enum) else other),
                            str(other.value if isinstance(other, Enum) else other))
            return a == b
        return NotImplemented

    def __hash__(self):
        aliases = {"dynamic": "group", "static": "weight"}
        return hash(aliases.get(str(self.value), str(self.value)))


class QuantizationArgs(BaseModel, use_enum_values=True):
    """User-facing arguments defining quantization of a weight or activation.

    Field semantics identical to the reference (`quant_args.py:169-429`).
    """

    num_bits: int = 8
    type: QuantizationType = QuantizationType.INT
    symmetric: bool = True
    group_size: int | None = None
    strategy: QuantizationStrategy | None = None
    block_structure: list[int] | None = None
    dynamic: DynamicType | bool = False
    actorder: ActivationOrdering | bool | None = None
    scale_dtype: TensorDType | None = None
    zp_dtype: TensorDType | None = None
    observer: str | None = Field(default=None)
    observer_kwargs: dict[str, Any] = Field(default_factory=dict)

    @field_serializer("zp_dtype")
    def serialize_zp_dtype(self, dtype):
        if self.symmetric:
            return None
        from compressed_tensors_tpu_torch.utils.dtypes import serialize_dtype

        return serialize_dtype(dtype)

    @field_validator("type", mode="before")
    def validate_type(cls, value):
        if isinstance(value, str):
            return QuantizationType(value.lower())
        return value

    @field_validator("group_size", mode="before")
    def validate_group(cls, value):
        if value is None:
            return value
        if value < -1:
            raise ValueError(
                f"Invalid group size {value}. Use group_size > 0 for "
                "strategy='group' and group_size = -1 for 'channel'"
            )
        return value

    @field_validator("block_structure", mode="before")
    def validate_block_structure(cls, value):
        if value is None:
            return value
        error = ValueError(
            f"Invalid block_structure '{value}'. Must be a list of positive ints "
            "[rows, cols]."
        )
        if isinstance(value, str):
            try:
                value = [int(x) for x in value.split("x")]
            except Exception:
                raise error
        if isinstance(value, (list, tuple)):
            if (
                len(value) != 2
                or not all(isinstance(v, int) for v in value)
                or not all(v > 0 for v in value)
            ):
                raise error
            return list(value)
        raise error

    @field_validator("strategy", mode="before")
    def validate_strategy(cls, value):
        if isinstance(value, str):
            return QuantizationStrategy(value.lower())
        return value

    @field_validator("actorder", mode="before")
    def validate_actorder(cls, value):
        if isinstance(value, bool):
            return ActivationOrdering.GROUP if value else None
        if isinstance(value, str):
            return ActivationOrdering(value.lower())
        return value

    @field_validator("dynamic", mode="before")
    def validate_dynamic(cls, value):
        if isinstance(value, str):
            return DynamicType(value.lower())
        return value

    @model_validator(mode="after")
    def validate_model_after(model: "QuantizationArgs") -> "QuantizationArgs":
        strategy = model.strategy
        group_size = model.group_size
        block_structure = model.block_structure
        actorder = model.actorder
        dynamic = model.dynamic
        observer = model.observer
        zp_dtype = model.zp_dtype

        # group_size doubles as a strategy selector when strategy is
        # omitted: positive -> group, -1 -> channel, absent -> tensor
        # (ref quant_args.py:313-324 behavior)
        if strategy is None:
            if group_size is None:
                strategy = QuantizationStrategy.TENSOR
            elif group_size > 0:
                strategy = QuantizationStrategy.GROUP
            elif group_size == -1:
                strategy = QuantizationStrategy.CHANNEL
            else:
                raise ValueError(
                    f"group_size={group_size} selects no strategy: positive "
                    "means 'group', -1 means 'channel'"
                )

        if strategy == QuantizationStrategy.TOKEN and not dynamic:
            # token scales depend on the activation batch, which only
            # exists at run time
            raise ValueError(
                "token strategy is inherently dynamic; set dynamic=True"
            )

        grouped = strategy in (QuantizationStrategy.GROUP,
                               QuantizationStrategy.TENSOR_GROUP)
        if grouped and (group_size is None or group_size <= 0):
            raise ValueError(
                f"a positive group_size is required for strategy {strategy}"
            )
        if not grouped and group_size is not None and group_size > 0:
            raise ValueError(
                f"group_size is meaningless under strategy {strategy}; "
                "use 'group' or 'tensor_group'"
            )

        if (strategy == QuantizationStrategy.BLOCK) != (
            block_structure is not None
        ):
            raise ValueError(
                "block strategy and block_structure come as a pair — "
                f"got strategy={strategy}, block_structure={block_structure}"
            )

        if (
            actorder is not None
            and actorder == ActivationOrdering.GROUP
            and not grouped
        ):
            raise ValueError(
                "actorder='group' reorders within quantization groups, so "
                "it needs a grouped strategy"
            )

        if dynamic:
            if strategy not in (
                QuantizationStrategy.TOKEN,
                QuantizationStrategy.TENSOR,
                QuantizationStrategy.TENSOR_GROUP,
                QuantizationStrategy.GROUP,
            ):
                raise ValueError(
                    f"dynamic quantization cannot compute {strategy} scales "
                    "at run time; use token/tensor/group/tensor_group"
                )
            if (
                dynamic == DynamicType.LOCAL
                and strategy != QuantizationStrategy.TENSOR_GROUP
            ):
                raise ValueError(
                    "dynamic='local' (static global scale, dynamic locals) "
                    "only makes sense for tensor_group"
                )
            if observer is not None:
                if dynamic is True:
                    if observer != "memoryless":
                        warnings.warn(
                            "dynamic quantization needs no observer; "
                            "dropping it"
                        )
                    observer = None
            elif dynamic == DynamicType.LOCAL:
                observer = "minmax"
        elif observer is None:
            observer = "memoryless_minmax"

        if zp_dtype is None:
            if model.num_bits == 4 and model.type == QuantizationType.FLOAT.value:
                zp_dtype = FP8_E4M3_DATA.dtype
            else:
                zp_dtype = model.storage_dtype()

        model.strategy = strategy
        model.observer = observer
        model.zp_dtype = zp_dtype
        return model

    def __hash__(self):
        # value-based hash so schemes can serve as static jit metadata
        # (QuantizedTensor pytrees specialize kernels per scheme)
        return hash(self.model_dump_json())

    def storage_dtype(self) -> torch.dtype:
        """Closest storage dtype for the quantized representation.

        Mirrors ``QuantizationArgs.pytorch_dtype`` (ref quant_args.py:413-427).
        """
        if self.type == QuantizationType.FLOAT.value:
            if self.num_bits == 8:
                return FP8_E4M3_DATA.dtype
            raise NotImplementedError("Only num_bits in (8) are supported")
        elif self.type == QuantizationType.INT.value:
            if self.num_bits <= 8:
                return torch.int8
            elif self.num_bits <= 16:
                return torch.int16
            return torch.int32
        raise ValueError(f"Invalid quantization type {self.type}")

    # keep the reference's method name as an alias for API parity
    pytorch_dtype = storage_dtype

    model_config = ConfigDict(extra="forbid")


def round_to_quantized_type_dtype(tensor, dtype, cast_to_original_dtype: bool = True):
    """Round values to the nearest representable value of ``dtype``: clamp
    to its finfo/iinfo range, then cast (optionally back)."""
    dtype = parse_dtype(dtype)
    original_dtype = tensor.dtype
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        rounded = tensor.clamp(info.min, info.max).to(dtype)
    else:
        info = torch.iinfo(dtype)
        rounded = torch.round(tensor.clamp(info.min, info.max)).to(dtype)
    if cast_to_original_dtype:
        return rounded.to(original_dtype)
    return rounded
