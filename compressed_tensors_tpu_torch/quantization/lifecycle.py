"""Quantization lifecycle: apply config -> initialize qparams -> calibrate ->
QDQ forward -> compress.

Counterpart of ``compressed_tensors_tpu/quantization/lifecycle.py``. A
model is a module graph (name -> ``ModuleInfo``) plus per-module weights;
the lifecycle keeps one ``ModuleQuantState`` (scheme, status, qparams) per
matched module and transforms it, with the JAX package's shape rules,
status transitions and forward semantics. Functions that create tensors
take ``device`` (the card unless the caller passes ``device="cpu"``); the
others work on their tensors' device.

The QDQ gate (``enable_quantization`` / ``disable_quantization``) acts at
call time: the port runs eagerly, as the upstream library does. The JAX
package reads it at trace time (jit bakes it into compiled callers), so
the two agree wherever no jitted caller outlives a toggle.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Mapping, Optional

import torch

from compressed_tensors_tpu_torch.ops.qparams import (
    KV_CACHE_TARGETS,
    calculate_qparams,
    compute_dynamic_scales_and_zp,
    generate_gparam,
    strategy_cdiv,
)
from compressed_tensors_tpu_torch.ops.quantize import fake_quantize, quantize
from compressed_tensors_tpu_torch.quantization.quant_args import (
    ActivationOrdering,
    DynamicType,
    QuantizationArgs,
    QuantizationStrategy,
)
from compressed_tensors_tpu_torch.quantization.quant_config import (
    QuantizationConfig,
    QuantizationStatus,
)
from compressed_tensors_tpu_torch.quantization.quant_scheme import (
    QuantizationScheme,
)
from compressed_tensors_tpu_torch.utils.match import (
    ModuleInfo,
    is_match,
    match_named_modules,
    match_targets,
)

__all__ = [
    "ModuleQuantState",
    "apply_quantization_config",
    "load_pretrained_quantization_parameters",
    "initialize_qparam_shapes",
    "initialize_module_for_quantization",
    "calibrate_module",
    "quantized_module_forward",
    "quantized_embedding_forward",
    "compress_quantized_weights",
    "expected_qparam_shapes",
    "enable_quantization",
    "disable_quantization",
    "quantization_enabled",
]

_QUANTIZATION_ENABLED = True


def enable_quantization() -> None:
    """Turn the global QDQ gate on (for every later forward)."""
    global _QUANTIZATION_ENABLED
    _QUANTIZATION_ENABLED = True


def disable_quantization() -> None:
    """Turn the global QDQ gate off (for every later forward)."""
    global _QUANTIZATION_ENABLED
    _QUANTIZATION_ENABLED = False


def quantization_enabled() -> bool:
    return _QUANTIZATION_ENABLED


@dataclasses.dataclass
class ModuleQuantState:
    """Quantization state attached to one module."""

    scheme: QuantizationScheme
    status: QuantizationStatus = QuantizationStatus.INITIALIZED
    qparams: dict = dataclasses.field(default_factory=dict)
    enabled: bool = True
    # whether weight_g_idx holds an ordering, keyed by that tensor's
    # storage and version: read once, not by every forward
    _g_idx_set: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)


def _is_local(args: QuantizationArgs) -> bool:
    return args.dynamic == DynamicType.LOCAL.value or \
        args.dynamic == DynamicType.LOCAL


def expected_qparam_shapes(
    args: QuantizationArgs,
    observed_shape: tuple[int, ...],
) -> Optional[tuple[int, ...]]:
    """Scale / zero-point shape for a strategy and observed shape; None
    when fully dynamic."""
    strategy = args.strategy
    if args.dynamic is True or _is_local(args):
        return None  # dynamic, or only the global scale is static
    if strategy == QuantizationStrategy.TENSOR.value:
        return (1,)
    if strategy == QuantizationStrategy.TOKEN.value:
        raise ValueError("Cannot perform static token quantization")
    if strategy == QuantizationStrategy.CHANNEL.value:
        if len(observed_shape) < 2:
            raise ValueError("Channel quant requires at least 2 observed "
                             "dimensions")
        return (observed_shape[-2], 1)
    if strategy in (QuantizationStrategy.GROUP.value,
                    QuantizationStrategy.TENSOR_GROUP.value):
        assert args.group_size is not None
        if len(observed_shape) < 1:
            raise ValueError("Group quant requires at least 1 observed "
                             "dimension")
        num_groups = strategy_cdiv(observed_shape[-1], args.group_size,
                                   strategy)
        return (*observed_shape[:-1], num_groups)
    if strategy == QuantizationStrategy.BLOCK.value:
        assert args.block_structure is not None
        if len(observed_shape) < 2:
            raise ValueError("Block quant requires at least 2 observed "
                             "dimensions")
        bh, bw = args.block_structure
        return (math.ceil(observed_shape[-2] / bh),
                strategy_cdiv(observed_shape[-1], bw, strategy))
    if strategy == QuantizationStrategy.ATTN_HEAD.value:
        if len(observed_shape) < 3:
            raise ValueError("Attention quant requires at least 3 observed "
                             "dimensions")
        return (observed_shape[-3], 1, 1)
    raise AssertionError(f"Unknown strategy {strategy}")


def initialize_qparam_shapes(
    base_name: str,
    args: QuantizationArgs,
    observed_shape: tuple[int, ...],
    observed_dtype: torch.dtype = torch.bfloat16,
    force_zero_point: bool = True,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Empty qparams for one (base_name, args) pair: {param_name:
    tensor}. Scales take the observed dtype (float16 for a dtype that is
    no 16/32/64-bit float), zero points ``args.zp_dtype``."""
    out: dict[str, torch.Tensor] = {}
    if args.strategy == QuantizationStrategy.TENSOR_GROUP.value:
        out[f"{base_name}_global_scale"] = torch.zeros(
            (1,), dtype=torch.float32, device=device)
    shape = expected_qparam_shapes(args, observed_shape)
    if shape is None:
        return out
    scale_dtype = observed_dtype
    if scale_dtype not in (torch.float16, torch.float32, torch.float64,
                           torch.bfloat16):
        scale_dtype = torch.float16
    out[f"{base_name}_scale"] = torch.zeros(shape, dtype=scale_dtype,
                                            device=device)
    if force_zero_point or not args.symmetric:
        out[f"{base_name}_zero_point"] = torch.zeros(
            shape, dtype=args.zp_dtype, device=device)
    if args.actorder is not None and args.actorder == ActivationOrdering.GROUP:
        out[f"{base_name}_g_idx"] = torch.full(
            (observed_shape[-1],), -1, dtype=torch.int32, device=device)
    return out


def initialize_module_for_quantization(
    scheme: QuantizationScheme,
    weight_shape: tuple[int, ...],
    weight_dtype: torch.dtype = torch.bfloat16,
    force_zero_point: bool = True,
    status: QuantizationStatus = QuantizationStatus.INITIALIZED,
    device: str | torch.device = "cuda",
) -> ModuleQuantState:
    """The quantization state of one module: weight qparams over the
    weight's shape, input qparams over its columns, output qparams over
    its rows."""
    state = ModuleQuantState(scheme=scheme, status=status)
    for base, args, shape in (
            ("weight", scheme.weights, tuple(weight_shape)),
            ("input", scheme.input_activations, (weight_shape[-1],)),
            ("output", scheme.output_activations, (weight_shape[-2],))):
        if args is not None:
            state.qparams.update(initialize_qparam_shapes(
                base, args, shape, weight_dtype, force_zero_point, device))
    return state


def apply_quantization_config(
    modules: Mapping[str, ModuleInfo],
    weight_shapes: Mapping[str, tuple[int, ...]],
    config: QuantizationConfig | None,
    kv_module_names: list[str] | None = None,
    num_kv_heads: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, ModuleQuantState]:
    """Resolve schemes and initialize quantization state for every matched
    module.

    :param modules: module graph (name -> ModuleInfo)
    :param weight_shapes: name -> weight shape of the weight-bearing modules
    :param config: quantization config (None -> no-op)
    :param kv_module_names: attention-module names for the config's
        ``kv_cache_scheme`` (default: those matching ``KV_CACHE_TARGETS``)
    :param num_kv_heads: needed by an ``attn_head`` kv_cache_scheme
    :return: name -> ModuleQuantState
    """
    if config is None:
        return {}
    config = config.model_copy(deep=True)
    force_zero_point = (
        config.quantization_status < QuantizationStatus.COMPRESSED)
    states: dict[str, ModuleQuantState] = {}

    if config.kv_cache_scheme is not None:
        kv_scheme = QuantizationScheme(
            targets=list(KV_CACHE_TARGETS),
            input_activations=config.kv_cache_scheme)
        names = kv_module_names
        if names is None:
            names = [name for name, info in modules.items()
                     if is_match(name, info, KV_CACHE_TARGETS)]
        # attn_head schemes carry (num_kv_heads, 1, 1) scales, the others
        # one per tensor
        per_head = config.kv_cache_scheme.strategy == "attn_head"
        if per_head and num_kv_heads is None:
            raise ValueError("attn_head kv_cache_scheme requires "
                             "num_kv_heads")
        scale_shape = (num_kv_heads, 1, 1) if per_head else (1,)
        for name in names:
            state = ModuleQuantState(scheme=kv_scheme,
                                     status=config.quantization_status)
            for key in ("k_scale", "v_scale"):
                state.qparams[key] = torch.zeros(
                    scale_shape, dtype=torch.float32, device=device)
            states[name] = state

    target_to_scheme: "OrderedDict[str, QuantizationScheme]" = OrderedDict()
    for scheme in config.config_groups.values():
        for target in scheme.targets:
            target_to_scheme[target] = scheme

    for name, info in match_named_modules(
            modules, list(target_to_scheme), config.ignore, warn_on_fail=True):
        if name not in weight_shapes:
            continue
        matched = match_targets(name, info, list(target_to_scheme))
        states[name] = initialize_module_for_quantization(
            target_to_scheme[matched[0]], weight_shapes[name],
            force_zero_point=force_zero_point,
            status=config.quantization_status, device=device)
    return states


def _load_quant_args_from_mapping(state: ModuleQuantState, base_name: str,
                                  module_name: str,
                                  mapping: Mapping[str, str]) -> None:
    """Load {base}_scale / _zero_point / _g_idx of one module from its
    shards onto the device of the state's own qparams. Symmetric
    checkpoints carry no zero point: zeros then."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        SafetensorsFile,
    )

    own = next(iter(state.qparams.values()), None)
    device = own.device if own is not None else torch.device("cuda")

    def fetch(param: str):
        path = mapping.get(f"{module_name}.{param}")
        if path is None:
            return None
        f = SafetensorsFile(path)
        try:
            return f.get(f"{module_name}.{param}").to(device)
        finally:
            f.close()

    g_idx = fetch(f"{base_name}_g_idx")
    if g_idx is not None:
        state.qparams[f"{base_name}_g_idx"] = g_idx
    scale = fetch(f"{base_name}_scale")
    if scale is not None:
        state.qparams[f"{base_name}_scale"] = scale
        zp = fetch(f"{base_name}_zero_point")
        state.qparams[f"{base_name}_zero_point"] = (
            zp if zp is not None else torch.zeros_like(scale))


def load_pretrained_quantization_parameters(
    states: Mapping[str, ModuleQuantState],
    model_path: str,
    load_weight_qparams: bool = False,
) -> None:
    """Load static qparams (scales, zero points, g_idx) from a checkpoint
    into initialized module states: input and output activation qparams
    always, weight qparams with ``load_weight_qparams``."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        get_quantization_parameter_to_path_mapping,
    )

    mapping = get_quantization_parameter_to_path_mapping(model_path)
    for name, state in states.items():
        if state.scheme.input_activations is not None:
            _load_quant_args_from_mapping(state, "input", name, mapping)
        if state.scheme.output_activations is not None:
            _load_quant_args_from_mapping(state, "output", name, mapping)
        if load_weight_qparams and state.scheme.weights is not None:
            _load_quant_args_from_mapping(state, "weight", name, mapping)


# --------------------------------------------------------------------------- #
# calibration (min-max observation)

def _observe_minmax(value: torch.Tensor, args: QuantizationArgs):
    """Observed min and max reduced per strategy."""
    strategy = args.strategy
    if strategy == QuantizationStrategy.TENSOR.value:
        return value.min(), value.max()
    if strategy == QuantizationStrategy.CHANNEL.value:
        return (value.amin(dim=-1, keepdim=True),
                value.amax(dim=-1, keepdim=True))
    if strategy in (QuantizationStrategy.GROUP.value,
                    QuantizationStrategy.TENSOR_GROUP.value):
        g = args.group_size
        v = value.reshape(*value.shape[:-1], math.ceil(value.shape[-1] / g),
                          g)
        return v.amin(dim=-1), v.amax(dim=-1)
    if strategy == QuantizationStrategy.BLOCK.value:
        bh, bw = args.block_structure
        r, c = value.shape[-2:]
        v = value.reshape(r // bh, bh, c // bw, bw)
        return v.amin(dim=(1, 3)), v.amax(dim=(1, 3))
    raise ValueError(f"Cannot observe strategy {strategy}")


def calibrate_module(
    state: ModuleQuantState,
    weight: torch.Tensor | None = None,
    sample_input: torch.Tensor | None = None,
    sample_output: torch.Tensor | None = None,
) -> ModuleQuantState:
    """Min-max calibration: fill the static scales / zero points from the
    observed tensors (on their device) and advance to CALIBRATION."""
    scheme = state.scheme

    def _calibrate(base: str, args: QuantizationArgs, value):
        if value is None or args is None or args.dynamic is True:
            return
        mn, mx = _observe_minmax(value, args)
        global_scale = None
        if args.strategy == QuantizationStrategy.TENSOR_GROUP.value:
            global_scale = generate_gparam(value.min(), value.max())
            state.qparams[f"{base}_global_scale"] = global_scale
        if _is_local(args):
            return  # only the global scale is static
        scale, zp = calculate_qparams(mn, mx, args, global_scale=global_scale)
        state.qparams[f"{base}_scale"] = scale
        if not args.symmetric or f"{base}_zero_point" in state.qparams:
            state.qparams[f"{base}_zero_point"] = zp

    _calibrate("weight", scheme.weights, weight)
    if sample_input is not None:
        _calibrate("input", scheme.input_activations, sample_input)
    if sample_output is not None:
        _calibrate("output", scheme.output_activations, sample_output)
    state.status = QuantizationStatus.CALIBRATION
    return state


# --------------------------------------------------------------------------- #
# QDQ forward

def _active_g_idx(state: ModuleQuantState):
    """The weight's g_idx, or None when unset (all -1). The check reads
    the tensor on the host once per g_idx tensor and version."""
    g_idx = state.qparams.get("weight_g_idx")
    if g_idx is None:
        return None
    key = (g_idx.data_ptr(), g_idx._version, g_idx.device)
    if key not in state._g_idx_set:
        state._g_idx_set.clear()
        state._g_idx_set[key] = not bool((g_idx == -1).all())
    return g_idx if state._g_idx_set[key] else None


def _forward_quantize(state: ModuleQuantState, value, base: str,
                      args: QuantizationArgs):
    """Fake-quantize a value with dynamic or static scales."""
    if value.numel() == 0:
        return value
    g_idx = _active_g_idx(state)
    global_scale = state.qparams.get(f"{base}_global_scale")
    if args.dynamic is True or _is_local(args):
        scale, zero_point = compute_dynamic_scales_and_zp(
            value, args, global_scale=global_scale)
    else:
        scale = state.qparams[f"{base}_scale"]
        zero_point = state.qparams.get(f"{base}_zero_point")
    return fake_quantize(value, scale, zero_point, args, g_idx=g_idx,
                         global_scale=global_scale)


def _gate(state: ModuleQuantState) -> bool:
    return (state.enabled and state.scheme is not None
            and _QUANTIZATION_ENABLED)


def quantized_module_forward(
    x: torch.Tensor,
    weight: torch.Tensor,
    state: ModuleQuantState,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Linear forward with QDQ per the module's scheme: quantize the input,
    fake-quantize the weight (not at status COMPRESSED or later), matmul,
    quantize the output; nothing when the module or the global gate is
    off. Operands of different dtypes meet in their promoted dtype, as in
    the JAX package."""
    scheme = state.scheme
    enabled = _gate(state)
    if enabled and scheme.input_activations is not None:
        x = _forward_quantize(state, x, "input", scheme.input_activations)
    if enabled and scheme.weights is not None and \
            state.status < QuantizationStatus.COMPRESSED:
        weight = _forward_quantize(state, weight, "weight", scheme.weights)
    dtype = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if bias is not None:
        out = out + bias
    if enabled and scheme.output_activations is not None:
        out = _forward_quantize(state, out, "output",
                                scheme.output_activations)
    return out


def quantized_embedding_forward(
    indices: torch.Tensor,
    weight: torch.Tensor,
    state: ModuleQuantState,
) -> torch.Tensor:
    """Embedding gather with the weight fake-quantized per the module's
    scheme (the whole table, so that channel and group scales stay aligned
    with the embedding dim).

    As in the JAX package, the input and output activation args are not
    applied: the gathered rows are returned as the fake-quantized table
    holds them. The upstream library's embedding forward also quantizes
    ``output_activations``."""
    scheme = state.scheme
    if _gate(state) and scheme.weights is not None and \
            state.status < QuantizationStatus.COMPRESSED:
        weight = _forward_quantize(state, weight, "weight", scheme.weights)
    return weight[indices]


def compress_quantized_weights(
    state: ModuleQuantState, weight: torch.Tensor
) -> tuple[ModuleQuantState, torch.Tensor]:
    """Quantize the weight to its storage dtype (on its device) and set
    status COMPRESSED; dynamic or weightless schemes pass through."""
    args = state.scheme.weights
    if args is None or args.dynamic:
        return state, weight
    quantized = quantize(
        weight, state.qparams["weight_scale"],
        state.qparams.get("weight_zero_point"), args,
        dtype=args.storage_dtype(), g_idx=_active_g_idx(state),
        global_scale=state.qparams.get("weight_global_scale"))
    state.status = QuantizationStatus.COMPRESSED
    return state, quantized
