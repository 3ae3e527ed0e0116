"""Fused projections: concatenate same-input projections (q/k/v, gate/up)
into single quantized matmuls.

Counterpart of ``compressed_tensors_tpu/ops/fuse.py``. Fusion needs equal
schemes, formats and input widths, and NVFP4 members need bit-equal global
scales; otherwise the layer stays unfused. The checkpoint-layout leaves
(the Qwen2 qkv biases with them) concatenate along output features and
the kernel layout is rebuilt from them, in the members' 4-bit layout.
(The JAX package fuses NVFP4 members with unequal global scales and
keeps the first one's, which its non-kernel path then applies to every
member: ROADMAP C. Checkpoints made for fused loading share one global
scale across q/k/v and across gate/up.)
"""

from __future__ import annotations

import dataclasses

import torch

from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    prepare_for_kernels,
)
from compressed_tensors_tpu_torch.utils.dtypes import byte_view

__all__ = ["fuse_quantized_tensors", "fuse_llama_layers"]

# the w4_layout that rebuilds each 4-bit kernel kind
_W4_LAYOUTS = {"w4a16": "b8", "w4e8": "e8", "w4packed": "packed"}


def _concat_field(tensors, field):
    vals = [getattr(t, field) for t in tensors]
    if any(v is None for v in vals):
        return None
    return torch.cat([byte_view(v) for v in vals], dim=0).view(vals[0].dtype)


def fuse_quantized_tensors(
    tensors: list[QuantizedTensor],
) -> QuantizedTensor | None:
    """Concatenate QuantizedTensors along output features (dim 0).

    Returns None if fusion is unsupported for these tensors (mismatched
    schemes/formats/K or global scales, actorder, sparse leaves, mixed
    bias presence).
    """
    first = tensors[0]
    if any(t.format != first.format or t.scheme != first.scheme
           or t.shape[1] != first.shape[1] for t in tensors):
        return None
    if any(t.g_idx is not None or t.sparse_values is not None
           for t in tensors):
        return None
    for field in ("global_scale", "input_global_scale"):
        vals = [getattr(t, field) for t in tensors]
        if any(v is not None for v in vals) and not all(
                v is not None and torch.equal(v, vals[0]) for v in vals):
            return None
    has_bias = [t.bias is not None for t in tensors]
    if any(has_bias) and not all(has_bias):
        return None

    fused = dataclasses.replace(
        first,
        weight=_concat_field(tensors, "weight"),
        weight_packed=_concat_field(tensors, "weight_packed"),
        scale=_concat_field(tensors, "scale"),
        zero_point=_concat_field(tensors, "zero_point"),
        bias=_concat_field(tensors, "bias"),
        kernel_packed=None, kernel_scales=None, kernel_zp=None,
        kernel_perm=None, kernel_meta=None,
        shape=(sum(t.shape[0] for t in tensors), first.shape[1]),
    )
    if all(t.kernel_meta is not None for t in tensors):
        fused = prepare_for_kernels(
            fused, w4_layout=_W4_LAYOUTS.get(first.kernel_meta[0]))
    return fused


def fuse_llama_layers(params: dict) -> dict:
    """Fuse q/k/v -> qkv_proj and gate/up -> gate_up_proj in every layer
    where the members share a scheme. Unfusable layers stay as they are."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        qkv = [layer.get("q_proj"), layer.get("k_proj"), layer.get("v_proj")]
        if all(isinstance(t, QuantizedTensor) for t in qkv):
            fused = fuse_quantized_tensors(qkv)
            if fused is not None:
                new_layer["qkv_proj"] = fused
                new_layer["qkv_splits"] = (
                    qkv[0].shape[0], qkv[0].shape[0] + qkv[1].shape[0])
                for k in ("q_proj", "k_proj", "v_proj"):
                    del new_layer[k]
        gu = [layer.get("gate_proj"), layer.get("up_proj")]
        if all(isinstance(t, QuantizedTensor) for t in gu):
            fused = fuse_quantized_tensors(gu)
            if fused is not None:
                new_layer["gate_up_proj"] = fused
                new_layer["gate_up_split"] = gu[0].shape[0]
                for k in ("gate_proj", "up_proj"):
                    del new_layer[k]
        out["layers"].append(new_layer)
    return out
