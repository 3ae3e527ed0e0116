"""Spec layer of the PyTorch port against the JAX package: presets,
config.json round trips, dtype vocabulary, registry and target matching
give the same answers in both."""

import json

import pytest
import torch

import compressed_tensors_tpu.quantization as jq
from compressed_tensors_tpu.compressors import (
    module_graph_from_names as j_graph,
    resolve_module_schemes as j_resolve,
)
from compressed_tensors_tpu.utils import match as jmatch

import compressed_tensors_tpu_torch.quantization as tq
from compressed_tensors_tpu_torch.compressors import (
    BaseCompressor,
    infer_module_format,
    module_graph_from_names as t_graph,
    resolve_module_schemes as t_resolve,
)
from compressed_tensors_tpu_torch.config import CompressionFormat
from compressed_tensors_tpu_torch.utils import match as tmatch
from compressed_tensors_tpu_torch.utils.dtypes import (
    SAFETENSORS_DTYPES,
    parse_dtype,
    serialize_dtype,
)


@pytest.mark.parametrize("name", sorted(jq.PRESET_SCHEMES))
def test_preset_model_dump_matches(name):
    j = jq.preset_name_to_scheme(name, ["Linear", "re:.*q_proj"])
    t = tq.preset_name_to_scheme(name, ["Linear", "re:.*q_proj"])
    assert t.model_dump() == j.model_dump()
    assert t.model_dump_json() == j.model_dump_json()


CONFIGS = [
    # preset-name groups, resolved on parse
    {"config_groups": {"W4A16": ["Linear"]}, "format": "pack-quantized",
     "ignore": ["lm_head"], "quantization_status": "compressed"},
    # explicit asymmetric group args + a kv-cache scheme
    {"config_groups": {"group_0": {
        "targets": ["re:.*proj$"],
        "weights": {"num_bits": 4, "type": "int", "symmetric": False,
                    "strategy": "group", "group_size": 32,
                    "actorder": "dynamic"},
        "format": "pack-quantized"}},
     "kv_cache_scheme": {"num_bits": 8, "type": "float",
                         "strategy": "tensor"},
     "format": "pack-quantized", "quantization_status": "frozen"},
    # mixed precision: W4A16 layers with a W8A8-int lm_head
    {"config_groups": {
        "group_0": {"targets": ["Linear"],
                    "weights": {"num_bits": 4, "type": "int",
                                "strategy": "group", "group_size": 128},
                    "format": "pack-quantized"},
        "group_1": {"targets": ["lm_head"],
                    "weights": {"num_bits": 8, "type": "int",
                                "strategy": "channel"},
                    "input_activations": {"num_bits": 8, "type": "int",
                                          "strategy": "token",
                                          "dynamic": True},
                    "format": "int-quantized"}},
     "format": "mixed-precision", "quantization_status": "compressed",
     "quant_method": "compressed-tensors"},
    # fp8 scale dtypes serialize as torch names
    {"config_groups": {"NVFP4": ["Linear"]}, "format": "nvfp4-pack-quantized"},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
def test_config_json_round_trip(cfg):
    text = json.dumps(cfg)
    j = jq.QuantizationConfig.model_validate(json.loads(text))
    t = tq.QuantizationConfig.model_validate(json.loads(text))
    assert t.model_dump() == j.model_dump()
    dumped = t.model_dump(mode="json")
    assert dumped == j.model_dump(mode="json")
    again = tq.QuantizationConfig.model_validate(json.loads(json.dumps(dumped)))
    assert again.model_dump() == t.model_dump()


@pytest.mark.parametrize("code,dtype", [
    ("BF16", torch.bfloat16), ("F8_E4M3", torch.float8_e4m3fn),
    ("F32", torch.float32), ("I32", torch.int32), ("I8", torch.int8),
    ("U8", torch.uint8),
])
def test_safetensors_dtype_codes(code, dtype):
    assert SAFETENSORS_DTYPES[code] is dtype
    assert parse_dtype(serialize_dtype(dtype)) is dtype


def test_storage_dtype_and_unknown_dtype():
    args = tq.QuantizationArgs(num_bits=4, strategy="group", group_size=128)
    assert args.storage_dtype() is torch.int8
    assert tq.QuantizationArgs(num_bits=8, type="float").storage_dtype() \
        is torch.float8_e4m3fn
    with pytest.raises(ValueError):
        parse_dtype("torch.float3")


def test_codec_registry_and_format_inference():
    for fmt in ("dense", "pack-quantized", "naive-quantized",
                "int-quantized", "float-quantized"):
        assert BaseCompressor.get_value_from_registry(fmt) is not None
    w4 = tq.preset_name_to_scheme("W4A16", ["Linear"])
    w8 = tq.preset_name_to_scheme("W8A8", ["Linear"])
    fp8 = tq.preset_name_to_scheme("FP8_DYNAMIC", ["Linear"])
    assert infer_module_format("Linear", w4) == CompressionFormat.pack_quantized
    assert infer_module_format("Linear", w8) == CompressionFormat.int_quantized
    assert infer_module_format("Linear", fp8) == \
        CompressionFormat.float_quantized


NAMES = ["model.embed_tokens", "model.layers.0.self_attn.q_proj",
         "model.layers.0.self_attn.k_proj", "model.layers.0.mlp.down_proj",
         "model.layers.1.self_attn.q_proj", "lm_head"]


@pytest.mark.parametrize("targets,ignore", [
    (["Linear"], ["lm_head"]),
    (["re:.*self_attn.*"], []),
    (["Linear", "lm_head"], ["re:.*layers\\.1\\..*"]),
])
def test_scheme_resolution_matches(targets, ignore):
    cfg = {"config_groups": {"group_0": {
        "targets": targets,
        "weights": {"num_bits": 4, "type": "int", "strategy": "group",
                    "group_size": 128}}}, "ignore": ignore}
    j = j_resolve(j_graph(NAMES), jq.QuantizationConfig.model_validate(cfg))
    t = t_resolve(t_graph(NAMES), tq.QuantizationConfig.model_validate(cfg))
    assert sorted(t) == sorted(j)
    assert all(t[n].model_dump() == j[n].model_dump() for n in t)


@pytest.mark.parametrize("name,target", [
    ("model.layers.0.self_attn.qkv_proj", "re:.*k_proj"),
    ("model.layers.0.mlp.gate_up_proj", "model.layers.0.mlp.up_proj"),
    ("lm_head", "re:^lm"),
    ("model.layers.0.self_attn.o_proj", "re:.*q_proj"),
])
def test_match_name_with_fused_mapping(name, target):
    fused = jmatch.DEFAULT_FUSED_MAPPING
    assert tmatch.match_name(name, target, fused) == \
        jmatch.match_name(name, target, fused)
