"""Carry parameters built by the JAX package over to this port.

``params_from_numpy`` takes the JAX params tree with every leaf already
turned into numpy (the conversion from JAX happens on the caller's side),
rebuilds each linear from its checkpoint-layout fields and runs this
port's own ``prepare_for_kernels``; the JAX kernel layouts are never read.
"""

from __future__ import annotations

import numpy as np
import torch

from compressed_tensors_tpu_torch.models.llama import resolve_device
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    prepare_for_kernels,
)
from compressed_tensors_tpu_torch.quantization import QuantizationScheme

__all__ = ["params_from_numpy"]

# fields of a linear in checkpoint layout
_LINEAR_FIELDS = ("weight", "weight_packed", "scale", "zero_point", "bias",
                  "g_idx", "global_scale", "input_global_scale",
                  "sparse_values", "sparse_bitmask")
# numpy extension dtypes (ml_dtypes) -> same-size integer view + torch dtype
_VIEW_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name in _VIEW_DTYPES:
        view, dtype = _VIEW_DTYPES[arr.dtype.name]
        return torch.from_numpy(arr.view(view)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def _linear(leaf: dict, device, use_kernels: bool) -> QuantizedTensor:
    scheme = leaf.get("scheme")
    qt = QuantizedTensor(
        format=leaf["format"],
        shape=tuple(int(s) for s in leaf["shape"]),
        scheme=(QuantizationScheme.model_validate(scheme)
                if scheme is not None else None),
        **{f: _tensor(leaf[f], device) for f in _LINEAR_FIELDS
           if leaf.get(f) is not None},
    )
    return prepare_for_kernels(qt) if use_kernels else qt


def _convert(value, device, use_kernels):
    if isinstance(value, dict) and "format" in value:
        return _linear(value, device, use_kernels)
    if isinstance(value, dict):
        # MLA's kv_b_proj is read as a dense matrix, never by a matmul
        # kernel: it keeps its checkpoint layout, as the loaders keep it
        return {k: _convert(v, device, use_kernels and k != "kv_b_proj")
                for k, v in value.items()}
    if isinstance(value, list):
        return [_convert(v, device, use_kernels) for v in value]
    if isinstance(value, np.ndarray):
        return _tensor(value, device)
    return value


def params_from_numpy(tree: dict, device="cuda",
                      use_kernels: bool = True) -> dict:
    """Port params from a numpy tree of the JAX package's params.

    Each linear is a dict of its checkpoint-layout fields: ``format``,
    ``shape``, ``scheme`` (``QuantizationScheme.model_dump()``) and the
    arrays ``weight_packed`` / ``weight``, ``scale``, ``zero_point``,
    ``bias``, ``g_idx``, ``global_scale``, ``input_global_scale``, and
    the 2:4 sparse leaves ``sparse_values`` / ``sparse_bitmask`` (absent
    or None when unused; the Qwen2 qkv biases ride in ``bias``). Each
    linear carries its own scheme, so per-layer mixed schemes come across
    as they are. An MoE layer's ``moe`` dict carries over with its dense
    ``router`` and its stacked (E, N, K) expert linears, which take the
    stacked kernel layouts. An MLA layer's linears (``q_proj`` or
    ``q_a_proj``/``q_b_proj``, ``kv_a_proj_with_mqa``, ``o_proj``) take
    their kernel layouts in the engine's half-rotation rope layout, as the
    JAX loader left them; ``kv_b_proj`` stays in checkpoint layout and is
    dequantized by ``models.mla.mla_attention`` in each forward, as the
    JAX package does. Every other
    array (embeddings, norms with the Qwen3 per-head ``q_norm`` /
    ``k_norm`` and MLA's ``q_a_layernorm``/``kv_a_layernorm``, k/v/q
    scales) carries over as it is.
    """
    return _convert(tree, resolve_device(device), use_kernels)
