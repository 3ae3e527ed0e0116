"""ModelCompressor: the run-compressed load path of a compressed-tensors
checkpoint -- parse ``config.json["quantization_config"]``, build the module
graph from checkpoint names and resolve each module's scheme -- and the
per-module compress / decompress of state dicts, with a sparse codec
stacked over the quantization codec.

Counterpart of ``compressed_tensors_tpu/compressors/model_compressor.py``.
Still missing from the save side (ROADMAP A5): ``save_checkpoint``,
``load_checkpoint``, ``update_config`` and the format inference over a
model's schemes (``infer_format_from_schemes``).
"""

from __future__ import annotations

from typing import Callable, Mapping

from compressed_tensors_tpu_torch.compressors.base import (
    BaseCompressor,
    TensorStateDict,
    get_compressor,
)
from compressed_tensors_tpu_torch.compressors.format import (
    infer_module_format,
)
from compressed_tensors_tpu_torch.config import (
    CompressionFormat,
    SparsityCompressionConfig,
)
from compressed_tensors_tpu_torch.quantization import (
    QuantizationConfig,
    QuantizationScheme,
    QuantizationStatus,
)
from compressed_tensors_tpu_torch.utils.match import (
    ModuleInfo,
    is_match,
    match_targets,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import (
    get_quantization_config_dict,
)

__all__ = ["ModelCompressor", "module_graph_from_names", "resolve_module_schemes"]


def module_graph_from_names(
    module_names: list[str],
    embedding_names: tuple[str, ...] = ("embed_tokens", "wte", "embeddings"),
) -> dict[str, ModuleInfo]:
    """Build a matching-compatible module graph from checkpoint module
    prefixes. Weight-bearing modules are Linear unless they look like
    embeddings; ancestor modules are generic containers."""
    graph: dict[str, ModuleInfo] = {}
    for name in module_names:
        parts = name.split(".")
        for i in range(1, len(parts)):
            graph.setdefault(".".join(parts[:i]), ModuleInfo(type_name="Module"))
        leaf = parts[-1]
        graph[name] = ModuleInfo(
            type_name="Embedding" if any(e in leaf for e in embedding_names)
            else "Linear")
    return graph


def resolve_module_schemes(
    modules: Mapping[str, ModuleInfo],
    config: QuantizationConfig,
) -> dict[str, QuantizationScheme]:
    """Map each module to its quantization scheme via target matching with
    ignore-list handling; when several targets match, the most specific
    wins (exact > regex > class)."""
    target_to_scheme: dict[str, QuantizationScheme] = {}
    for scheme in config.config_groups.values():
        for target in scheme.targets:
            target_to_scheme[target] = scheme

    ignore = config.ignore or []
    resolved: dict[str, QuantizationScheme] = {}
    for name, info in modules.items():
        if info.type_name == "Module":
            continue
        matched = match_targets(name, info, list(target_to_scheme))
        if not matched or is_match(name, info, ignore):
            continue
        resolved[name] = target_to_scheme[matched[0]]
    return resolved


class ModelCompressor:
    """Holds a checkpoint's quantization (and sparsity) config."""

    def __init__(
        self,
        quantization_config: QuantizationConfig | None = None,
        sparsity_config: SparsityCompressionConfig | None = None,
    ):
        self.quantization_config = quantization_config
        self.sparsity_config = sparsity_config

    @classmethod
    def from_compression_config(cls, config: dict) -> "ModelCompressor | None":
        """Build from a raw config.json["quantization_config"] dict."""
        if config is None:
            return None
        sparsity_config = config.get("sparsity_config") or None
        if sparsity_config:
            sparsity_config = SparsityCompressionConfig.load_from_registry(
                sparsity_config.get("format", "dense"), **sparsity_config)
        qconfig = {k: v for k, v in config.items()
                   if k not in ("sparsity_config", "transform_config",
                                "version")}
        quantization_config = (
            QuantizationConfig.model_validate(qconfig)
            if qconfig.get("config_groups") is not None else None
        )
        if quantization_config is None and sparsity_config is None:
            return None
        return cls(quantization_config=quantization_config,
                   sparsity_config=sparsity_config)

    @classmethod
    def from_pretrained(cls, path: str) -> "ModelCompressor | None":
        """Build from a checkpoint directory's config.json."""
        return cls.from_compression_config(get_quantization_config_dict(path))

    def resolve_schemes(
        self, modules: Mapping[str, ModuleInfo]
    ) -> dict[str, QuantizationScheme]:
        if self.quantization_config is None:
            return {}
        return resolve_module_schemes(modules, self.quantization_config)

    def _global_format(self) -> str | None:
        """The model-level format, which applies to every module unless the
        config is mixed-precision (then per-scheme or inferred formats
        win)."""
        if self.quantization_config is None:
            return None
        fmt = self.quantization_config.format
        if fmt in ("fakequant", CompressionFormat.dense.value,
                   CompressionFormat.mixed_precision.value, None):
            return None
        return fmt

    def _module_compressor(self, module_type: str,
                           scheme: QuantizationScheme
                           ) -> type[BaseCompressor]:
        fmt = CompressionFormat(
            scheme.format or self._global_format()
            or infer_module_format(module_type, scheme))
        scheme.format = fmt
        return get_compressor(fmt)

    def compress_state(
        self,
        module_states: Mapping[str, TensorStateDict],
        modules: Mapping[str, ModuleInfo],
        progress: Callable | None = None,
    ) -> dict[str, TensorStateDict]:
        """Compress every matched module's local state dict: the
        quantization codec first, then, where the sparsity config applies
        and a ``weight`` remains (not after pack-quantized), the sparse
        codec over the quantized values."""
        schemes = self.resolve_schemes(modules)
        out: dict[str, TensorStateDict] = {}
        for name, state in module_states.items():
            state = dict(state)
            scheme = schemes.get(name)
            if scheme is not None and scheme.weights is not None:
                state = self._module_compressor(
                    modules[name].type_name, scheme).compress(state, scheme)
            if self._sparsity_applies(name, modules.get(name)) and \
                    "weight" in state:
                state = get_compressor(self.sparsity_config.format).compress(
                    state, scheme)
            out[name] = state
            if progress is not None:
                progress(name)
        if self.quantization_config is not None:
            self.quantization_config.quantization_status = (
                QuantizationStatus.COMPRESSED)
        return out

    def decompress_state(
        self,
        module_states: Mapping[str, TensorStateDict],
        modules: Mapping[str, ModuleInfo],
        progress: Callable | None = None,
    ) -> dict[str, TensorStateDict]:
        """Decompress every matched module: the sparse codec first, then the
        quantization codec over what it leaves."""
        schemes = self.resolve_schemes(modules)
        out: dict[str, TensorStateDict] = {}
        for name, state in module_states.items():
            state = dict(state)
            if self._sparsity_applies(name, modules.get(name)) and \
                    "weight.compressed" in state:
                state = get_compressor(
                    self.sparsity_config.format).decompress(state, None)
            scheme = schemes.get(name)
            if scheme is not None and scheme.weights is not None and (
                    "weight_packed" in state
                    or ("weight" in state and self._is_quantized_repr(state))):
                state = self._module_compressor(
                    modules[name].type_name, scheme).decompress(state, scheme)
            out[name] = state
            if progress is not None:
                progress(name)
        if self.quantization_config is not None:
            self.quantization_config.quantization_status = (
                QuantizationStatus.DECOMPRESSED)
        return out

    @staticmethod
    def _is_quantized_repr(state: TensorStateDict) -> bool:
        w = state.get("weight")
        return w is not None and (not w.dtype.is_floating_point
                                  or w.dtype.itemsize == 1)

    def _sparsity_applies(self, name: str, info: ModuleInfo | None) -> bool:
        if self.sparsity_config is None or info is None:
            return False
        if self.sparsity_config.format == CompressionFormat.dense.value:
            return False
        return is_match(name, info, self.sparsity_config.targets or ["Linear"],
                        self.sparsity_config.ignore or [])
