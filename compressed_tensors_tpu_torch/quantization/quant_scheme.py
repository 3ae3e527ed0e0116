"""QuantizationScheme + preset schemes.

Mirrors `compressed_tensors/quantization/quant_scheme.py` (ref :26-439): the
same ~30 preset names must resolve to the same args so checkpoints written
with preset group names load identically. Copied from
``compressed_tensors_tpu/quantization/quant_scheme.py`` with torch dtypes.
"""

from __future__ import annotations

import warnings
from copy import deepcopy

import torch

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization.quant_args import (
    FP8_E4M3_DATA,
    DynamicType,
    QuantizationArgs,
    QuantizationStrategy,
)
from pydantic import BaseModel, ConfigDict, model_validator

__all__ = ["QuantizationScheme", "preset_name_to_scheme", "is_preset_scheme",
           "PRESET_SCHEMES"]


class QuantizationScheme(BaseModel, use_enum_values=True):
    """Set of QuantizationArgs for the weights/inputs/outputs of a target set.

    :param targets: list of module targets (names, types, or "re:" regexes)
    :param weights: quantization args for weights
    :param input_activations: quantization args for inputs
    :param output_activations: quantization args for outputs
    :param format: CompressionFormat for the layer
    """

    targets: list[str]
    weights: QuantizationArgs | None = None
    input_activations: QuantizationArgs | None = None
    output_activations: QuantizationArgs | None = None
    format: CompressionFormat | None = None

    # strategies that make sense for activations: per-call-row (token),
    # whole-tensor, grouped along the feature dim, or per attention head —
    # never channel/block, which index the weight matrix
    _ACT_STRATEGIES = frozenset({
        QuantizationStrategy.TOKEN,
        QuantizationStrategy.TENSOR,
        QuantizationStrategy.GROUP,
        QuantizationStrategy.TENSOR_GROUP,
        QuantizationStrategy.ATTN_HEAD,
    })

    @model_validator(mode="after")
    def validate_model_after(model: "QuantizationScheme") -> "QuantizationScheme":
        weights = model.weights

        for field, acts in (("input", model.input_activations),
                            ("output", model.output_activations)):
            if acts is None:
                continue
            if field == "input" and acts.strategy not in model._ACT_STRATEGIES:
                raise NotImplementedError(
                    f"activation quantization has no {acts.strategy} variant"
                )
            if acts.actorder is not None:
                raise ValueError(
                    f"actorder is a weight-only option; remove it from "
                    f"{field}_activations"
                )

        if model.format == CompressionFormat.mixed_precision:
            # mixed_precision is a whole-model summary format; individual
            # schemes must each carry their concrete format
            raise ValueError(
                "a single QuantizationScheme cannot use the mixed-precision "
                "format"
            )

        inputs = model.input_activations
        if (
            weights is not None
            and inputs is not None
            and QuantizationStrategy.GROUP
            == weights.strategy
            == inputs.strategy
            and weights.group_size != inputs.group_size
        ):
            warnings.warn(
                f"weight group_size {weights.group_size} != activation "
                f"group_size {inputs.group_size}; a fused kernel would have "
                "to reconcile the two grids — prefer equal sizes (or "
                "TENSOR_GROUP on both sides)",
                UserWarning,
                stacklevel=2,
            )

        return model

    def __hash__(self):
        # value-based hash so schemes can serve as static jit metadata
        return hash(self.model_dump_json())

    model_config = ConfigDict(extra="forbid")


def _q(bits: int, qtype: str, strategy: str, **kw) -> QuantizationArgs:
    """Terse QuantizationArgs constructor for the preset table (defaults:
    symmetric, static)."""
    return QuantizationArgs(num_bits=bits, type=qtype, strategy=strategy, **kw)


def _int_wnam(weight_bits: int, act_bits: int = 16) -> dict:
    """Generic WxAy integer scheme template (ref quant_scheme.py:104-131):
    g128 symmetric int weights; below 16-bit, dynamic per-token int acts."""
    if weight_bits < 2 or weight_bits > 8:
        raise ValueError(f"weight_bits must be 2-8, got {weight_bits}")
    if act_bits not in (4, 8, 16):
        raise ValueError(f"act_bits must be 4, 8, or 16, got {act_bits}")
    if weight_bits > act_bits:
        raise ValueError(
            f"weight_bits ({weight_bits}) must be <= act_bits ({act_bits})"
        )
    scheme = dict(weights=_q(weight_bits, "int", "group", group_size=128))
    if act_bits < 16:
        scheme["input_activations"] = _q(act_bits, "int", "token",
                                         dynamic=True)
    return scheme


def preset_name_to_scheme(name: str, targets: list[str]) -> QuantizationScheme:
    name = name.upper()
    if name not in PRESET_SCHEMES:
        raise KeyError(
            f"Unknown preset scheme name {name}, "
            f"available names: {list(PRESET_SCHEMES.keys())}"
        )
    scheme_args = deepcopy(PRESET_SCHEMES[name])
    return QuantizationScheme(targets=targets, **scheme_args)


def is_preset_scheme(name: str) -> bool:
    return name.upper() in PRESET_SCHEMES


UNQUANTIZED = dict()

_UINT8 = torch.uint8
_FP8D = FP8_E4M3_DATA.dtype

# --- FP4/FP8 microscaling families ---------------------------------------
# NVFP4: 16-element groups, fp8 local scales + fp32 global scale
# (tensor_group); MX: 32-element groups with uint8 E8M0 power-of-two scales.

_NVFP4_W = _q(4, "float", "tensor_group", group_size=16,
              scale_dtype=_FP8D, zp_dtype=_FP8D)

NVFP4A16 = dict(weights=_NVFP4_W)
NVFP4 = dict(
    weights=_NVFP4_W,
    input_activations=_q(4, "float", "tensor_group", group_size=16,
                         dynamic=DynamicType.LOCAL, observer="static_minmax",
                         scale_dtype=_FP8D, zp_dtype=_FP8D),
)


def _mx(bits: int, acts: bool) -> dict:
    kw = dict(group_size=32, scale_dtype=_UINT8, zp_dtype=_UINT8)
    scheme = dict(weights=_q(bits, "float", "group", **kw))
    if acts:
        scheme["input_activations"] = _q(bits, "float", "group",
                                         dynamic=True, **kw)
    return scheme


MXFP4A16 = _mx(4, acts=False)
MXFP4 = _mx(4, acts=True)
MXFP8A16 = _mx(8, acts=False)
MXFP8 = _mx(8, acts=True)

# --- integer WxAy family --------------------------------------------------

W2A4 = _int_wnam(2, 4)
W2A8 = _int_wnam(2, 8)
W2A16 = _int_wnam(2)
W3A4 = _int_wnam(3, 4)
W3A8 = _int_wnam(3, 8)
W3A16 = _int_wnam(3)
W4A4 = _int_wnam(4, 4)
W4A8 = _int_wnam(4, 8)
W4A16 = _int_wnam(4)
W5A8 = _int_wnam(5, 8)
W5A16 = _int_wnam(5)
W6A8 = _int_wnam(6, 8)
W6A16 = _int_wnam(6)
W7A8 = _int_wnam(7, 8)
W7A16 = _int_wnam(7)
W8A16 = _int_wnam(8)

# --- named production schemes --------------------------------------------

# per-channel int8 weights, dynamic per-token int8 acts
INT8_W8A8 = dict(
    weights=_q(8, "int", "channel"),
    input_activations=_q(8, "int", "token", dynamic=True),
)

# AWQ-style asymmetric 4-bit grouped weights, bf16 acts
W4A16_ASYM = dict(
    weights=_q(4, "int", "group", group_size=128, symmetric=False),
)

# int4 grouped weights with dynamic per-token fp8 acts
W4AFP8 = dict(
    weights=_q(4, "int", "group", group_size=128),
    input_activations=_q(8, "float", "token", dynamic=True, observer=None),
)

# static per-tensor fp8 on both sides
FP8 = dict(
    weights=_q(8, "float", "tensor"),
    input_activations=_q(8, "float", "tensor", observer="static_minmax"),
)

# per-channel fp8 weights, dynamic per-token fp8 acts
FP8_DYNAMIC = dict(
    weights=_q(8, "float", "channel"),
    input_activations=_q(8, "float", "token", dynamic=True),
)

# DeepSeek-style 128x128 block fp8 weights, dynamic 128-group fp8 acts
FP8_BLOCK = dict(
    weights=_q(8, "float", "block", block_structure=[128, 128]),
    input_activations=_q(8, "float", "group", group_size=128, dynamic=True),
)

PRESET_SCHEMES: dict[str, dict] = {
    "UNQUANTIZED": UNQUANTIZED,
    "W4A16_ASYM": W4A16_ASYM,
    "W8A8": INT8_W8A8,
    "INT8": INT8_W8A8,
    "W4AFP8": W4AFP8,
    "FP8": FP8,
    "FP8_DYNAMIC": FP8_DYNAMIC,
    "FP8_BLOCK": FP8_BLOCK,
    "NVFP4A16": NVFP4A16,
    "NVFP4": NVFP4,
    "MXFP4A16": MXFP4A16,
    "MXFP4": MXFP4,
    "MXFP8A16": MXFP8A16,
    "MXFP8": MXFP8,
    "W2A4": W2A4,
    "W2A8": W2A8,
    "W2A16": W2A16,
    "W3A4": W3A4,
    "W3A8": W3A8,
    "W3A16": W3A16,
    "W4A4": W4A4,
    "W4A8": W4A8,
    "W4A16": W4A16,
    "W5A8": W5A8,
    "W5A16": W5A16,
    "W6A8": W6A8,
    "W6A16": W6A16,
    "W7A8": W7A8,
    "W7A16": W7A16,
    "W8A16": W8A16,
}
