"""Checkpoint converters: streaming, model-free rewrites of safetensors
tensors into (or out of) the compressed-tensors format.

Counterpart of ``compressed_tensors_tpu/entrypoints/convert/converters.py``:
the Converter protocol, inverse weight maps, AutoAWQ GEMM nibble
unpacking, the CT dequantizer, ModelOpt NVFP4 renames/inversions and the
DeepSeek-style FP8-block dequantizer. Each converter does its tensor math
on ``device`` (default the card): the tensors it converts are moved there,
the ones it passes through stay where they were read.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, Protocol

import torch

from compressed_tensors_tpu_torch.compressors import (
    BaseCompressor,
    infer_module_format,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
from compressed_tensors_tpu_torch.quantization import (
    QuantizationArgs,
    QuantizationConfig,
    QuantizationScheme,
    QuantizationStatus,
    QuantizationStrategy,
    QuantizationType,
)
from compressed_tensors_tpu_torch.quantization.quant_scheme import NVFP4
from compressed_tensors_tpu_torch.utils.match import (
    match_name,
    match_quantizable_tensors,
)

__all__ = [
    "Converter",
    "build_inverse_weight_maps",
    "AutoAWQConverter",
    "CompressedTensorsDequantizer",
    "ModelOptNvfp4Converter",
    "FP8BlockDequantizer",
]

TensorDict = Dict[str, torch.Tensor]


def _device(device) -> torch.device:
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    return resolve_device(device)


class Converter(Protocol):
    """Converter interface."""

    def process(self, tensors: TensorDict) -> TensorDict:
        raise NotImplementedError()

    def validate(self, tensors: TensorDict) -> None:
        raise NotImplementedError()

    def create_config(self) -> QuantizationConfig | None:
        raise NotImplementedError()

    def get_dependencies(self, weight_name: str) -> set[str]:
        raise NotImplementedError()


def build_inverse_weight_maps(
    weight_map: dict[str, str],
    model_files: dict[str, str],
    converters: list[Converter],
) -> dict[str, dict[str, list[str]]]:
    """Per output shard: which tensors to read from which source files,
    including cross-shard dependencies."""

    def deps_recursive(weight_name: str, current: set[str]) -> set[str]:
        for converter in converters:
            for dep in converter.get_dependencies(weight_name):
                if dep not in current:
                    current.add(dep)
                    deps_recursive(dep, current)
        return current

    weight_deps = {
        name: deps_recursive(name, set()) for name in weight_map
    }
    for name, deps in weight_deps.items():
        assert name not in deps, f"{name} found in its own dependencies"

    all_dependencies: set[str] = set().union(*weight_deps.values()) \
        if weight_deps else set()

    inverse: dict[str, dict[str, list[str]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for name, shard in weight_map.items():
        if name in all_dependencies:
            continue  # partner tensor of another primary; loaded with it
        iwm = inverse[shard]
        for add_name in [name, *weight_deps[name]]:
            if add_name not in weight_map:
                raise ValueError(
                    f"Dependency weight {add_name} not found in weight map"
                )
            resolved = model_files[weight_map[add_name]]
            iwm[resolved].append(add_name)

    return {k: dict(v) for k, v in inverse.items()}


# --------------------------------------------------------------------------- #
# AutoAWQ


class AutoAWQConverter:
    """AutoAWQ GEMM (qweight/qzeros/scales) -> CT pack-quantized W4A16-asym.

    AWQ packs 8 nibbles per int32 in the order [0, 4, 1, 5, 2, 6, 3, 7]
    along dim 1, with weights transposed relative to CT; the conversion
    unpacks, un-reorders, offsets to signed, transposes and repacks. The
    scales keep the checkpoint's dtype (fp16 in AutoAWQ's files).
    """

    AWQ_REVERSE_ORDER = [0, 4, 1, 5, 2, 6, 3, 7]

    def __init__(
        self,
        bits: int = 4,
        group_size: int = 128,
        zero_point: bool = True,
        version: str = "gemm",
        ignore: Iterable[str] = ("lm_head",),
        targets: Iterable[str] = ("Linear",),
        device="cuda",
    ):
        if bits != 4:
            raise ValueError(
                "AutoAWQConverter currently supports only 4-bit weights"
            )
        if version != "gemm":
            raise ValueError(f"Unsupported AutoAWQ version: {version}")
        self.bits = bits
        self.group_size = group_size
        self.zero_point = zero_point
        self.version = version
        self.ignore = list(ignore)
        self.targets = list(targets)
        self.device = _device(device)

    @classmethod
    def from_autoawq_config(
        cls, autoawq_config: dict, targets: Iterable[str] = ("Linear",),
        device="cuda",
    ) -> "AutoAWQConverter":
        ignore = ["lm_head"]
        for module in autoawq_config.get("modules_to_not_convert") or []:
            ignore.append(f"re:.*{re.escape(module)}.*")
        return cls(
            bits=autoawq_config.get("bits", 4),
            group_size=autoawq_config.get("group_size", 128),
            zero_point=autoawq_config.get("zero_point", True),
            version=autoawq_config.get("version", "gemm"),
            ignore=ignore,
            targets=targets,
            device=device,
        )

    def _is_targeted(self, module_name: str) -> bool:
        if any(match_name(module_name, ign) for ign in self.ignore):
            return False
        if len(self.targets) == 0 or "Linear" in self.targets:
            return True
        return any(match_name(module_name, t) for t in self.targets)

    @staticmethod
    def unpack_awq(qweight: torch.Tensor, qzeros: torch.Tensor | None,
                   bits: int):
        """AWQ int32 words -> int8 nibbles (not yet masked), in AWQ's
        order, on the words' device."""
        shifts = torch.arange(0, 32, bits, dtype=torch.int64,
                              device=qweight.device)

        def unpack(words):
            return ((words[:, :, None].to(torch.int64)
                     >> shifts[None, None, :]).to(torch.int8)
                    .reshape(words.shape[0], -1))

        return unpack(qweight), (unpack(qzeros) if qzeros is not None
                                 else None)

    @classmethod
    def reverse_awq_order(cls, iweights, izeros, bits: int):
        """Undo AWQ's intra-int32 nibble order."""
        order = torch.arange(iweights.shape[-1], dtype=torch.int64,
                             device=iweights.device)
        order = order.reshape(-1, 32 // bits)[:, cls.AWQ_REVERSE_ORDER]
        order = order.reshape(-1)
        iweights = iweights[:, order]
        if izeros is not None:
            izeros = izeros[:, order]
        return iweights, izeros

    def _convert_gemm_module(self, qweight, scales, qzeros):
        if self.zero_point and qzeros is None:
            raise ValueError("Found qweight without corresponding qzeros")
        iweight, izeros = self.unpack_awq(qweight, qzeros, self.bits)
        iweight, izeros = self.reverse_awq_order(iweight, izeros, self.bits)

        iweight = iweight & ((2**self.bits) - 1)
        quantized_weight = (iweight - 2 ** (self.bits - 1)).to(torch.int8)

        weight_zero_point = None
        if self.zero_point:
            assert izeros is not None
            zp = (izeros & ((2**self.bits) - 1)) - 2 ** (self.bits - 1)
            weight_zero_point = zp.T.contiguous().to(torch.int8)

        return (
            quantized_weight.T.contiguous(),
            scales.T.contiguous(),
            weight_zero_point,
        )

    def process(self, tensors: TensorDict) -> TensorDict:
        for name in list(tensors):
            if not name.endswith(".qweight"):
                continue
            module_name = name.removesuffix(".qweight")
            if not self._is_targeted(module_name):
                continue

            qweight = tensors.pop(f"{module_name}.qweight")
            qzeros = tensors.pop(f"{module_name}.qzeros", None)
            scales = tensors.pop(f"{module_name}.scales")
            weight, weight_scale, weight_zp = self._convert_gemm_module(
                qweight.to(self.device), scales.to(self.device),
                qzeros.to(self.device) if qzeros is not None else None,
            )

            tensors[f"{module_name}.weight_scale"] = weight_scale
            tensors[f"{module_name}.weight_packed"] = pack_to_int32(
                weight, self.bits)
            tensors[f"{module_name}.weight_shape"] = torch.tensor(
                weight.shape, dtype=torch.int64, device=self.device)
            if weight_zp is not None:
                tensors[f"{module_name}.weight_zero_point"] = pack_to_int32(
                    weight_zp, self.bits, packed_dim=0)
        return tensors

    def validate(self, tensors: TensorDict) -> None:
        for name in tensors:
            module_name, _, param_name = name.rpartition(".")
            if param_name in {"qweight", "qzeros", "scales"}:
                if not self._is_targeted(module_name):
                    raise ValueError(
                        f"Found unexpected non-targeted tensor {name}"
                    )
            if param_name != "qweight" or not self._is_targeted(module_name):
                continue
            for dependency in self.get_dependencies(name):
                if dependency not in tensors:
                    raise ValueError(
                        f"Found qweight without corresponding {dependency}"
                    )

    def create_config(self) -> QuantizationConfig:
        weights = QuantizationArgs(
            num_bits=self.bits,
            type=QuantizationType.INT,
            symmetric=not self.zero_point,
            group_size=self.group_size,
            strategy=QuantizationStrategy.GROUP,
        )
        return QuantizationConfig(
            config_groups={
                "config_group_0": QuantizationScheme(
                    targets=self.targets,
                    weights=weights,
                    format=CompressionFormat.pack_quantized.value,
                )
            },
            ignore=self.ignore,
            format=CompressionFormat.pack_quantized.value,
            quantization_status=QuantizationStatus.COMPRESSED.value,
        )

    def get_dependencies(self, weight_name: str) -> set[str]:
        module_name, _, suffix = weight_name.rpartition(".")
        if suffix == "qweight" and self._is_targeted(module_name):
            deps = {f"{module_name}.scales"}
            if self.zero_point:
                deps.add(f"{module_name}.qzeros")
            return deps
        return set()


# --------------------------------------------------------------------------- #
# CT -> dense dequantizer


class CompressedTensorsDequantizer:
    """CT checkpoint -> dense upconvert using the registered compressors'
    decompress and compression_param_names."""

    def __init__(self, quant_config: QuantizationConfig | dict,
                 ignore: Iterable[str] = (), dtype=torch.bfloat16,
                 device="cuda"):
        if isinstance(quant_config, dict):
            quant_config = QuantizationConfig.model_validate(quant_config)
        self.quant_config = quant_config
        self.dtype = dtype
        self.device = _device(device)
        self.quant_config.ignore = (self.quant_config.ignore or []) + \
            list(ignore)
        for scheme in self.quant_config.config_groups.values():
            if scheme.format is None:
                scheme.format = infer_module_format("Linear", scheme)

    @classmethod
    def from_pretrained(cls, model_stub: str, ignore: Iterable[str] = (),
                        dtype=torch.bfloat16, device="cuda"):
        from compressed_tensors_tpu_torch.utils.safetensors_io import (
            get_quantization_config_dict,
        )

        qdict = get_quantization_config_dict(model_stub)
        if qdict is None:
            raise ValueError("Could not find quantization_config in config.json")
        return cls(qdict, ignore=ignore, dtype=dtype, device=device)

    def process(self, tensors: TensorDict) -> TensorDict:
        from compressed_tensors_tpu_torch.quantization.quant_metadata import (
            KVCacheScaleType,
        )

        dequantized: TensorDict = {}
        tensors = dict(tensors)
        for scheme in self.quant_config.config_groups.values():
            compressor = BaseCompressor.get_value_from_registry(
                CompressionFormat(scheme.format).value
            )
            param_names = compressor.compression_param_names(scheme)
            for module_name, _ in match_quantizable_tensors(
                tensors,
                ignore=self.quant_config.ignore,
                targets=scheme.targets,
                param_targets=[param_names[0]],
            ):
                state_dict = {
                    p: tensors.pop(f"{module_name}.{p}").to(self.device)
                    for p in param_names
                    if f"{module_name}.{p}" in tensors
                }
                out = compressor.decompress(state_dict, scheme)
                dequantized[f"{module_name}.weight"] = out["weight"].to(
                    self.dtype)

        kv_names = [v.value for v in KVCacheScaleType]
        for name, tensor in tensors.items():
            if any(name.endswith(p) for p in kv_names):
                continue
            dequantized[name] = tensor
        return dequantized

    def validate(self, tensors: TensorDict) -> None:
        consumed, matched = set(), set()
        for scheme in self.quant_config.config_groups.values():
            compressor = BaseCompressor.get_value_from_registry(
                CompressionFormat(scheme.format).value
            )
            param_names = compressor.compression_param_names(scheme)
            for module_name, _ in match_quantizable_tensors(
                tensors, self.quant_config.ignore, scheme.targets,
                param_targets=[param_names[0]],
            ):
                matched.add(module_name)
                for p in param_names:
                    key = f"{module_name}.{p}"
                    if key not in tensors:
                        raise ValueError(f"Expected key {key} not found")
                    consumed.add(key)
        unconsumed = [
            n for n in tensors
            if n not in consumed and n.rpartition(".")[0] in matched
        ]
        if unconsumed:
            raise ValueError(
                f"Found {len(unconsumed)} unconsumed keys -- {unconsumed}"
            )

    def create_config(self) -> None:
        return None

    def get_dependencies(self, weight_name: str) -> set[str]:
        module_name, _, param_name = weight_name.rpartition(".")
        if any(match_name(module_name, ign)
               for ign in self.quant_config.ignore):
            return set()
        for scheme in self.quant_config.config_groups.values():
            compressor = BaseCompressor.get_value_from_registry(
                CompressionFormat(scheme.format).value
            )
            param_names = compressor.compression_param_names(scheme)
            if "Linear" in scheme.targets or any(
                match_name(module_name, t) for t in scheme.targets
            ):
                if param_name == param_names[0]:
                    return {f"{module_name}.{p}" for p in param_names[1:]}
                return set()
        return set()


# --------------------------------------------------------------------------- #
# ModelOpt NVFP4


class ModelOptNvfp4Converter:
    """NVIDIA ModelOpt NVFP4 -> CT nvfp4-pack-quantized: input_scale and
    weight_scale_2 are inverted (f32 division) into input_global_scale and
    weight_global_scale, weight renames to weight_packed."""

    def __init__(self, ignore: Iterable[str] = (), targets: Iterable[str] = (),
                 kv_cache_scheme: QuantizationArgs | None = None,
                 device="cuda"):
        self.ignore = list(ignore)
        self.targets = list(targets)
        self.kv_cache_scheme = kv_cache_scheme
        self.device = _device(device)
        self.param_names = ["input_scale", "weight", "weight_scale",
                            "weight_scale_2"]
        if kv_cache_scheme is not None:
            self.param_names += ["k_scale", "v_scale"]

    def _inverse(self, scale: torch.Tensor) -> torch.Tensor:
        s = scale.to(self.device, torch.float32)
        return torch.ones_like(s) / s

    def process(self, tensors: TensorDict) -> TensorDict:
        tensors = dict(tensors)
        for module_name, name in list(match_quantizable_tensors(
            tensors, self.ignore, self.targets,
            param_targets=self.param_names,
        )):
            param_name = name.rpartition(".")[-1]
            if param_name == "input_scale":
                tensors[f"{module_name}.input_global_scale"] = self._inverse(
                    tensors[name])
                del tensors[name]
            elif param_name == "weight":
                tensors[f"{module_name}.weight_packed"] = tensors[name].to(
                    self.device)
                del tensors[name]
            elif param_name == "weight_scale_2":
                tensors[f"{module_name}.weight_global_scale"] = \
                    self._inverse(tensors[name])
                del tensors[name]
            elif param_name in ("k_scale", "v_scale"):
                target = self.kv_cache_scheme.scale_dtype or torch.bfloat16
                tensors[name] = tensors[name].to(self.device, target)
        return tensors

    def validate(self, tensors: TensorDict) -> None:
        targeted = {
            name for _, name in match_quantizable_tensors(
                tensors, self.ignore, self.targets,
                param_targets=self.param_names,
            )
        }
        disallowed = {"input_scale", "weight_scale", "weight_scale_2",
                      "k_scale", "v_scale"}
        for name in tensors:
            if name in targeted:
                continue
            if any(match_name(name, ign) for ign in self.ignore):
                continue
            if name.rpartition(".")[-1] in disallowed:
                raise ValueError(f"Hit unexpected non-targeted tensor {name}")

    def get_dependencies(self, weight_name: str) -> set[str]:
        module_name, _, param_name = weight_name.rpartition(".")
        if (
            any(match_name(module_name, t) for t in self.targets)
            and not any(match_name(module_name, ign) for ign in self.ignore)
            and param_name == "weight"
        ):
            deps = {
                f"{module_name}.input_scale",
                f"{module_name}.weight_scale",
                f"{module_name}.weight_scale_2",
            }
            if self.kv_cache_scheme:
                if module_name.endswith("k_proj"):
                    deps.add(f"{module_name}.k_scale")
                if module_name.endswith("v_proj"):
                    deps.add(f"{module_name}.v_scale")
            return deps
        return set()

    def create_config(self) -> QuantizationConfig:
        return QuantizationConfig(
            config_groups={
                "config_group_0": QuantizationScheme(
                    **NVFP4,
                    targets=self.targets,
                    format=CompressionFormat.nvfp4_pack_quantized.value,
                )
            },
            ignore=self.ignore,
            kv_cache_scheme=self.kv_cache_scheme,
            format=CompressionFormat.nvfp4_pack_quantized.value,
            quantization_status=QuantizationStatus.COMPRESSED.value,
        )


# --------------------------------------------------------------------------- #
# DeepSeek-style FP8 block dequantizer


class FP8BlockDequantizer:
    """FP8 128x128-block checkpoint (weight + weight_scale_inv) -> dense."""

    def __init__(self, ignore: Iterable[str] = (), targets: Iterable[str] = (),
                 weight_block_size=(128, 128), dtype=torch.bfloat16,
                 device="cuda"):
        self.ignore = list(ignore)
        self.targets = list(targets)
        self.weight_block_size = tuple(weight_block_size)
        self.dtype = dtype
        self.device = _device(device)
        self.param_names = ["weight", "weight_scale_inv"]

    def _dequantize(self, weight: torch.Tensor, scale_inv: torch.Tensor):
        bh, bw = self.weight_block_size
        rows, cols = weight.shape
        pad_r = (bh - rows % bh) % bh
        pad_c = (bw - cols % bw) % bw
        w = weight.to(self.device).to(torch.float32)
        if pad_r or pad_c:
            w = torch.nn.functional.pad(w, (0, pad_c, 0, pad_r))
        R, C = w.shape
        w = w.reshape(R // bh, bh, C // bw, bw)
        s = scale_inv.to(self.device, torch.float32)[:, None, :, None]
        w = (w * s).reshape(R, C)[:rows, :cols]
        return w.to(self.dtype)

    def process(self, tensors: TensorDict) -> TensorDict:
        tensors = dict(tensors)
        for module_name, name in list(match_quantizable_tensors(
            tensors, self.ignore, self.targets,
            param_targets=self.param_names,
        )):
            if name.rpartition(".")[-1] == "weight" and \
                    f"{module_name}.weight_scale_inv" in tensors:
                tensors[f"{module_name}.weight"] = self._dequantize(
                    tensors[f"{module_name}.weight"],
                    tensors.pop(f"{module_name}.weight_scale_inv"),
                )
        return tensors

    def validate(self, tensors: TensorDict) -> None:
        for module_name, name in match_quantizable_tensors(
            tensors, self.ignore, self.targets,
            param_targets=["weight_scale_inv"],
        ):
            if f"{module_name}.weight" not in tensors:
                raise ValueError(
                    f"Found weight_scale_inv without weight for {module_name}"
                )

    def create_config(self) -> None:
        return None

    def get_dependencies(self, weight_name: str) -> set[str]:
        module_name, _, param_name = weight_name.rpartition(".")
        if (
            any(match_name(module_name, t) for t in self.targets)
            and not any(match_name(module_name, ign) for ign in self.ignore)
            and param_name == "weight"
        ):
            return {f"{module_name}.weight_scale_inv"}
        return set()
