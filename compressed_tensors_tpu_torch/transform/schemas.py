"""Transform config schemas (TransformArgs / Scheme / Config).

Counterpart of ``compressed_tensors_tpu/transform/schemas.py``:
``model_dump(mode="json")`` gives the same ``transform_config`` block of
config.json (``precision`` through the port's ``TensorDType``, written
``"torch.float32"`` as the JAX package writes it).
"""

from __future__ import annotations

from enum import Enum

import torch
from pydantic import BaseModel, ConfigDict, Field, field_validator

from compressed_tensors_tpu_torch.utils.dtypes import TensorDType

__all__ = ["TransformArgs", "TransformLocation", "TransformScheme",
           "TransformConfig"]


class TransformLocation(str, Enum):
    """Where a transform applies on a module. WEIGHT_* are offline (fused
    into weights before quantization); the rest are online (applied to
    activations at run time)."""

    INPUT = "input"
    WEIGHT_INPUT = "weight_input"
    WEIGHT_OUTPUT = "weight_output"
    OUTPUT = "output"
    K_CACHE = "k_cache"
    Q_ATTN = "q_attn"

    def is_online(self) -> bool:
        return self not in (
            TransformLocation.WEIGHT_INPUT,
            TransformLocation.WEIGHT_OUTPUT,
        )


class TransformArgs(BaseModel, use_enum_values=True):
    """How and where one transform weight applies.

    :param targets: module targets (names/regex/classes)
    :param location: one of TransformLocation
    :param inverse: apply the inverse of the transform
    :param ignore: modules to exclude
    """

    targets: list[str]
    location: TransformLocation
    inverse: bool = Field(default=False)
    ignore: list[str] = Field(default_factory=list)

    @field_validator("targets", "ignore", mode="before")
    @classmethod
    def wrap_singleton(cls, value):
        if isinstance(value, str):
            return [value]
        return value

    def is_online(self) -> bool:
        return TransformLocation(self.location).is_online()

    model_config = ConfigDict(extra="forbid")


class TransformScheme(BaseModel):
    """One transform type + where to apply it.

    :param type: registered transform type ("hadamard", "random-hadamard",
        "random-matrix")
    :param apply: list of TransformArgs
    :param randomize: unique randomized weights per application
    :param requires_grad: trainable transform weights
    :param head_dim: block-diagonal block size
    :param precision: online application precision (fused rotations always
        run in float64, on the weights' device)
    """

    type: str
    apply: list[TransformArgs] = Field(default_factory=list)
    randomize: bool = Field(default=False)
    requires_grad: bool = Field(default=False)
    head_dim: int | None = Field(default=None)
    precision: TensorDType = Field(default=torch.float32)

    model_config = ConfigDict(extra="forbid")


class TransformConfig(BaseModel):
    """Full transform configuration: name -> scheme."""

    config_groups: dict[str, TransformScheme]

    model_config = ConfigDict(extra="forbid")
