"""ModelCompressor: the run-compressed load path of a compressed-tensors
checkpoint -- parse ``config.json["quantization_config"]``, build the module
graph from checkpoint names and resolve each module's scheme.

Counterpart of ``compressed_tensors_tpu/compressors/model_compressor.py``
(load side; the compress/save path belongs to a later slice).
"""

from __future__ import annotations

from typing import Mapping

from compressed_tensors_tpu_torch.config import SparsityCompressionConfig
from compressed_tensors_tpu_torch.quantization import (
    QuantizationConfig,
    QuantizationScheme,
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
