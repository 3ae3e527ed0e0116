"""ModelCompressor: whole-model compress / decompress and checkpoint I/O.

Counterpart of ``compressed_tensors_tpu/compressors/model_compressor.py``:
parse ``config.json["quantization_config"]``, build the module graph from
checkpoint names, resolve each module's scheme, compress / decompress
per-module state dicts (a sparse codec stacked over the quantization
codec), and the checkpoint level:

- save: compress every matched module -> shards by size (+ index) ->
  ``update_config``; the state dicts may lie on the card, and each tensor
  is copied to the host once, as it is written;
- load: read the shards into per-module state dicts on ``device`` and
  hand them to the engine run compressed, or decompress them.

A ``transform_config`` is kept and written into ``config.json``. At load,
as in the JAX package, the compressor that ``from_compression_config``
builds holds none: its offline (``weight_*``) transforms are already fused
into the checkpoint's weights. A config with an online transform is
refused there, since no engine of either package applies one.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import torch

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
from compressed_tensors_tpu_torch.transform.schemas import TransformLocation
from compressed_tensors_tpu_torch.utils.match import (
    ModuleInfo,
    is_match,
    match_targets,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import (
    CheckpointReader,
    get_quantization_config_dict,
    save_safetensors,
    update_config,
    update_safetensors_index,
)

__all__ = ["ModelCompressor", "module_graph_from_names", "resolve_module_schemes"]


def _refuse_online_transforms(transform_config: dict | None) -> None:
    """Raise NotImplementedError if a checkpoint's raw ``transform_config``
    block applies any transform online (``input``, ``output``,
    ``q_attn``, ``k_cache``): no engine of this package or of the JAX
    package applies one, and the model would silently run without it.
    ``weight_input`` / ``weight_output`` transforms are fused into the
    weights and need nothing at run time. The block is not parsed
    otherwise: the JAX package drops it unread, so whatever else it holds
    loads as there."""
    online_locations = {loc.value for loc in TransformLocation
                        if loc.is_online()}
    groups = (transform_config or {}).get("config_groups") or {}
    online = sorted({
        f"{name}: {args['location']}"
        for name, scheme in groups.items()
        for args in (scheme or {}).get("apply") or ()
        if args.get("location") in online_locations})
    if online:
        raise NotImplementedError(
            f"transform_config applies online transforms ({', '.join(online)}"
            "): no engine of either package (compressed_tensors_tpu_torch or "
            "compressed_tensors_tpu) applies online transforms; only "
            "weight_input/weight_output transforms, fused into the weights, "
            "load")


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
    """Whole-model compression orchestrator."""

    def __init__(
        self,
        quantization_config: QuantizationConfig | None = None,
        sparsity_config: SparsityCompressionConfig | None = None,
        transform_config=None,
        force_compression_format: str | None = None,
    ):
        self.quantization_config = quantization_config
        self.sparsity_config = sparsity_config
        self.transform_config = transform_config
        self.force_compression_format = force_compression_format

    @classmethod
    def from_compression_config(cls, config: dict) -> "ModelCompressor | None":
        """Build from a raw config.json["quantization_config"] dict. The
        compressor holds no ``transform_config`` (as in the JAX package):
        a checkpoint's ``weight_*`` transforms are fused into its weights.
        An online transform (``input``, ``output``, ``q_attn``,
        ``k_cache``) raises NotImplementedError: neither package's engine
        applies one, and the model would run without it."""
        if config is None:
            return None
        _refuse_online_transforms(config.get("transform_config"))
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
            self.force_compression_format or scheme.format
            or self._global_format()
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

    def save_checkpoint(
        self,
        save_directory: str,
        module_states: Mapping[str, TensorStateDict],
        modules: Mapping[str, ModuleInfo],
        extra_tensors: Mapping[str, torch.Tensor] | None = None,
        max_shard_bytes: int = 5 * 1024**3,
    ) -> None:
        """Compress and write a sharded safetensors checkpoint, its index
        (more than one shard) and ``config.json``, as the JAX package
        writes them: tensors in module order, a new shard when the next
        tensor would pass ``max_shard_bytes``."""
        os.makedirs(save_directory, exist_ok=True)
        compressed = self.compress_state(module_states, modules)
        flat: dict[str, torch.Tensor] = {}
        for mod_name, state in compressed.items():
            for local, tensor in state.items():
                flat[f"{mod_name}.{local}" if mod_name else local] = tensor
        flat.update(extra_tensors or {})

        shards: list[dict[str, torch.Tensor]] = [{}]
        sizes = [0]
        for name, tensor in flat.items():
            nbytes = tensor.numel() * tensor.element_size()
            if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
                shards.append({})
                sizes.append(0)
            shards[-1][name] = tensor
            sizes[-1] += nbytes
        names = (["model.safetensors"] if len(shards) == 1 else
                 [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
                  for i in range(len(shards))])
        weight_map: dict[str, str] = {}
        for fname, shard in zip(names, shards):
            save_safetensors(os.path.join(save_directory, fname), shard,
                             metadata={"format": "pt"})
            weight_map.update(dict.fromkeys(shard, fname))
        if len(shards) > 1:
            update_safetensors_index(save_directory, weight_map)
        self.update_config(save_directory)

    def load_checkpoint(
        self,
        path: str,
        modules: Mapping[str, ModuleInfo] | None = None,
        run_compressed: bool = True,
        device: str | torch.device = "cuda",
    ) -> tuple[dict[str, TensorStateDict], dict[str, QuantizationScheme]]:
        """Read a checkpoint into per-module state dicts on ``device``.

        :param run_compressed: True (the default) returns the compressed
            representations, which the engine runs; False decompresses
            them to dense weights (on ``device``)
        :return: (module states, resolved schemes)
        """
        from compressed_tensors_tpu_torch.models.llama import resolve_device

        device = resolve_device(device)
        reader = CheckpointReader(path)
        try:
            module_names = reader.module_names()
            if modules is None:
                modules = module_graph_from_names(module_names)
            module_states = {
                name: {k: v.to(device) for k, v in
                       reader.module_state_dict(name).items()}
                for name in module_names}
        finally:
            reader.close()
        schemes = self.resolve_schemes(modules)
        if not run_compressed:
            module_states = self.decompress_state(module_states, modules)
        return module_states, schemes

    def update_config(self, save_directory: str) -> None:
        """Write this compressor's configs into ``config.json`` (the real
        sparsity config and the transform config; see
        ``utils.safetensors_io.update_config``)."""
        if self.quantization_config is None and \
                self.sparsity_config is None and self.transform_config is None:
            return
        update_config(save_directory,
                      quantization_config=self.quantization_config,
                      sparsity_config=self.sparsity_config,
                      transform_config=self.transform_config)
