"""QuantizationConfig: the `config.json["quantization_config"]` schema.

Mirrors `compressed_tensors/quantization/quant_config.py:56-382`: lifecycle
status enum with ordering, preset-group resolution on parse, merge semantics,
and reconstruction of a config from per-module schemes. Copied from
``compressed_tensors_tpu/quantization/quant_config.py``.
"""

from __future__ import annotations

import warnings
from enum import Enum
from typing import Annotated, Any

from pydantic import BaseModel, ConfigDict, Field

from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.quantization.quant_args import (
    DynamicType,
    QuantizationArgs,
)
from compressed_tensors_tpu_torch.quantization.quant_scheme import (
    QuantizationScheme,
    preset_name_to_scheme,
)
from compressed_tensors_tpu_torch.utils.match import match_name

__all__ = [
    "QuantizationStatus",
    "QuantizationConfig",
    "LIFECYCLE_ORDER",
    "DEFAULT_QUANTIZATION_METHOD",
    "DEFAULT_QUANTIZATION_FORMAT",
]


class QuantizationStatus(str, Enum):
    """Lifecycle states: INITIALIZED -> CALIBRATION -> FROZEN -> COMPRESSED
    -> DECOMPRESSED, with comparison operators over the lifecycle order
    (ref quant_config.py:56-121)."""

    INITIALIZED = "initialized"
    CALIBRATION = "calibration"
    FROZEN = "frozen"
    COMPRESSED = "compressed"
    DECOMPRESSED = "decompressed"

    def __ge__(self, other):
        if other is None:
            return True
        if not isinstance(other, self.__class__):
            raise NotImplementedError
        return LIFECYCLE_ORDER.index(self) >= LIFECYCLE_ORDER.index(other)

    def __gt__(self, other):
        if other is None:
            return True
        if not isinstance(other, self.__class__):
            raise NotImplementedError
        return LIFECYCLE_ORDER.index(self) > LIFECYCLE_ORDER.index(other)

    def __lt__(self, other):
        if other is None:
            return False
        if not isinstance(other, self.__class__):
            raise NotImplementedError
        return LIFECYCLE_ORDER.index(self) < LIFECYCLE_ORDER.index(other)

    def __le__(self, other):
        if other is None:
            return False
        if not isinstance(other, self.__class__):
            raise NotImplementedError
        return LIFECYCLE_ORDER.index(self) <= LIFECYCLE_ORDER.index(other)


LIFECYCLE_ORDER = [
    QuantizationStatus.INITIALIZED,
    QuantizationStatus.CALIBRATION,
    QuantizationStatus.FROZEN,
    QuantizationStatus.COMPRESSED,
    QuantizationStatus.DECOMPRESSED,
]

DEFAULT_QUANTIZATION_METHOD = "compressed-tensors"
DEFAULT_QUANTIZATION_FORMAT = "fakequant"


def find_unique_name(name: str, existing: Any) -> str:
    """Return ``name`` or ``name_1``, ``name_2``, ... avoiding collisions."""
    existing = set(existing)
    if name not in existing:
        return name
    i = 1
    while f"{name}_{i}" in existing:
        i += 1
    return f"{name}_{i}"


class QuantizationConfig(BaseModel):
    """Full model quantization configuration.

    :param config_groups: dict of group name -> QuantizationScheme (or preset
        name -> target list, resolved on init)
    :param quant_method: constant "compressed-tensors"
    :param kv_cache_scheme: optional args for KV-cache quantization
    :param format: on-disk compression format
    :param quantization_status: lifecycle status of all quantized layers
    :param ignore: layers to exclude even if targeted
    """

    config_groups: dict[str, QuantizationScheme | list[str]]
    quant_method: str = DEFAULT_QUANTIZATION_METHOD
    kv_cache_scheme: QuantizationArgs | None = None
    format: str = DEFAULT_QUANTIZATION_FORMAT
    quantization_status: QuantizationStatus = QuantizationStatus.INITIALIZED
    global_compression_ratio: float | None = None
    ignore: list[str] | None = Field(default_factory=list)
    # dummy arg for transformers backwards compatibility
    run_compressed: Annotated[Any, Field(exclude=True)] = None

    def model_post_init(self, __context):
        # resolve preset-name groups into full schemes (ref quant_config.py:168)
        for group_name, targets_or_scheme in self.config_groups.items():
            if isinstance(targets_or_scheme, QuantizationScheme):
                continue
            self.config_groups[group_name] = preset_name_to_scheme(
                name=group_name,
                targets=targets_or_scheme,
            )

    def to_dict(self):
        return self.model_dump()

    @staticmethod
    def from_schemes(
        schemes: list[QuantizationScheme],
        status: QuantizationStatus | None = None,
        kv_cache_scheme: QuantizationArgs | None = None,
        format: str | list | None = None,
        ignore: list[str] | None = None,
    ) -> "QuantizationConfig | None":
        """Build a config from a list of unique schemes (the model-free
        analogue of ref ``from_pretrained``, quant_config.py:185-289)."""
        if len(schemes) == 0 and kv_cache_scheme is None:
            return None

        config_groups = {
            f"group_{idx}": scheme for idx, scheme in enumerate(schemes)
        }

        if format is None:
            if status == QuantizationStatus.COMPRESSED:
                format = CompressionFormat.int_quantized.value
            else:
                format = CompressionFormat.dense.value
        elif isinstance(format, list):
            format = (
                CompressionFormat.mixed_precision.value
                if len(format) > 1
                else format[0]
            )

        return QuantizationConfig(
            config_groups=config_groups,
            quantization_status=status or QuantizationStatus.INITIALIZED,
            kv_cache_scheme=kv_cache_scheme,
            global_compression_ratio=None,
            format=format,
            ignore=ignore or [],
        )

    @staticmethod
    def from_module_states(
        modules,
        states,
        format: str | list | None = None,
    ) -> "QuantizationConfig | None":
        """Reconstruct a config from per-module quantization states — the
        analogue of the reference's ``from_pretrained(model)``
        (ref quant_config.py:185-289): collect the unique schemes in first-
        appearance order, detect the kv-cache scheme from attention states
        carrying k/v scales, and build the consolidated ignore list (every
        quantizable module that ended up unquantized).

        :param modules: name -> ModuleInfo graph
        :param states: name -> ModuleQuantState, as produced by
            apply_quantization_config
        :return: config, or None if nothing is quantized
        """
        quantizable_types = ("Linear", "Embedding")

        schemes: list = []
        statuses: list[QuantizationStatus] = []
        kv_cache_scheme = None
        quantized_names = set()
        for name, state in states.items():
            if "k_scale" in state.qparams:
                kv_cache_scheme = state.scheme.input_activations
                continue
            quantized_names.add(name)
            statuses.append(state.status)
            if state.scheme not in schemes:
                schemes.append(state.scheme)

        ignore = [
            name
            for name, info in modules.items()
            if getattr(info, "type_name", None) in quantizable_types
            and name not in quantized_names
        ]

        status = max(statuses) if statuses else QuantizationStatus.INITIALIZED
        return QuantizationConfig.from_schemes(
            schemes,
            status=status,
            kv_cache_scheme=kv_cache_scheme,
            format=format,
            ignore=ignore,
        )

    def requires_calibration_data(self) -> bool:
        if self.kv_cache_scheme is not None:
            return True
        for _, scheme in self.config_groups.items():
            if scheme.weights is not None:
                if scheme.weights.observer == "imatrix_mse":
                    return True
            if scheme.input_activations is not None:
                if scheme.input_activations.dynamic in (False, DynamicType.LOCAL):
                    return True
            if scheme.output_activations is not None:
                if not scheme.output_activations.dynamic:
                    return True
        return False

    def merge(self, config: "QuantizationConfig") -> None:
        """Merge another config into self in place (ref quant_config.py:308)."""
        warnings.warn(
            "merging two quantization configs; the combined ignore/target "
            "resolution may not round-trip through every loader — prefer "
            "richer target lists over overlapping ignore lists"
        )

        pruned_ignore_list = []
        for ign in self.ignore:
            if ign.startswith("re:"):
                pruned_ignore_list.append(ign)
                continue
            if any(
                match_name(ign, target)
                for scheme in config.config_groups.values()
                for target in scheme.targets
            ):
                continue
            pruned_ignore_list.append(ign)
        self.ignore = pruned_ignore_list

        for scheme_name, scheme in config.config_groups.items():
            new_scheme_name = find_unique_name(scheme_name, self.config_groups.keys())
            self.config_groups[new_scheme_name] = scheme

        unique_formats = set(scheme.format for scheme in self.config_groups.values())
        self.format = (
            next(iter(unique_formats))
            if len(unique_formats) == 1
            else CompressionFormat.mixed_precision.value
        )

        if config.quantization_status > self.quantization_status:
            self.quantization_status = config.quantization_status

    model_config = ConfigDict(extra="ignore")


def get_vllm_module_type(module_type: str) -> str:
    """MoE gate/router layers are treated as "Linear" for config matching
    (ref quant_config.py:370-382)."""
    if "ExpertMLP" not in module_type and (
        "Router" in module_type or "Gate" in module_type or "Gating" in module_type
    ):
        module_type = "Linear"
    return module_type
