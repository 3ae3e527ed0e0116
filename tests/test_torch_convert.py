"""The checkpoint converters of compressed_tensors_tpu_torch
(``entrypoints/convert/``) against the JAX package's: every converter's
``process``, ``validate``, ``create_config`` and ``get_dependencies`` on
the same numpy-made tensors (bit for bit; bf16 and fp8 compared as their
bits), inverse weight maps across shards, ``convert_checkpoint`` of a
tiny AutoAWQ, compressed-tensors and ModelOpt NVFP4 checkpoint by both
packages (equal files), and the converted models run by the port."""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import compressed_tensors_tpu.entrypoints.convert as jcv
import compressed_tensors_tpu_torch.entrypoints.convert as tcv
from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.quantization import QuantizationArgs as JArgs
from compressed_tensors_tpu.utils import safetensors_io as jio
from compressed_tensors_tpu_torch.engine import greedy_generate
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.quantization import QuantizationArgs as TArgs
from compressed_tensors_tpu_torch.utils import safetensors_io as tio
from testing_utils import make_tiny_llama_checkpoint
from torch_port_utils import TORCH_TINY_CONFIG, to_numpy, to_torch, w4a16_config

CFG = TORCH_TINY_CONFIG
AWQ_PACK_ORDER = np.argsort(jcv.AutoAWQConverter.AWQ_REVERSE_ORDER)


def awq_pack(values_u4: np.ndarray) -> np.ndarray:
    """Unsigned 4-bit values (R, C) -> AutoAWQ GEMM int32 words (R, C/8)."""
    r, c = values_u4.shape
    v = values_u4.reshape(r, c // 8, 8)[:, :, AWQ_PACK_ORDER].astype(np.uint32)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    return (v << shifts).sum(axis=-1, dtype=np.uint32).view(np.int32)


def _bits(t) -> np.ndarray:
    """A torch tensor or numpy array as an integer array of its bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype.is_floating_point:
            t = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()])
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.kind in "fV" or a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        a = a.view({1: np.uint8, 2: np.int16, 4: np.int32,
                    8: np.int64}[a.dtype.itemsize])
    return a


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.asarray(t).dtype.name


def _same_tensors(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert _dtype_name(got[k]) == _dtype_name(want[k]), k
        assert tuple(got[k].shape) == tuple(np.asarray(want[k]).shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _both_process(tconv, jconv, tensors):
    """process() in both packages on copies of the same numpy tensors; the
    port's outputs lie on the CPU (its device here)."""
    got = tconv.process({k: to_torch(v) for k, v in tensors.items()})
    want = jconv.process(dict(tensors))
    _same_tensors(got, want)
    for v in got.values():
        assert v.device.type == "cpu"
    return got


def _both_raise(tconv, jconv, tensors):
    with pytest.raises(ValueError) as jerr:
        jconv.validate(dict(tensors))
    with pytest.raises(ValueError) as terr:
        tconv.validate({k: to_torch(v) for k, v in tensors.items()})
    assert str(terr.value) == str(jerr.value)


def _same_config(tconv, jconv):
    t, j = tconv.create_config(), jconv.create_config()
    assert (t is None) == (j is None)
    if t is not None:
        assert t.model_dump(mode="json") == j.model_dump(mode="json")


# --------------------------------------------------------------------------- #
# AutoAWQ


def _awq_tensors(rng, K=256, N=128, G=64, scale_dtype=np.float16,
                 prefix="model.layers.0.mlp.up_proj"):
    return {
        f"{prefix}.qweight": awq_pack(rng.integers(0, 16, (K, N))),
        f"{prefix}.qzeros": awq_pack(rng.integers(0, 16, (K // G, N))),
        f"{prefix}.scales": (rng.random((K // G, N)) * 0.01 + 1e-3).astype(
            scale_dtype),
        "model.layers.0.input_layernorm.weight": rng.random(K).astype(
            np.float32),
        "lm_head.weight": rng.standard_normal((8, K)).astype(np.float32),
    }


@pytest.mark.parametrize("zero_point", (True, False))
@pytest.mark.parametrize("scale_dtype", (np.float16, np.float32))
def test_autoawq_converter_matches_jax(rng, zero_point, scale_dtype):
    tensors = _awq_tensors(rng, scale_dtype=scale_dtype)
    if not zero_point:
        del tensors["model.layers.0.mlp.up_proj.qzeros"]
    kw = dict(group_size=64, zero_point=zero_point)
    tconv = tcv.AutoAWQConverter(**kw, device="cpu")
    jconv = jcv.AutoAWQConverter(**kw)
    tconv.validate({k: to_torch(v) for k, v in tensors.items()})
    jconv.validate(dict(tensors))
    got = _both_process(tconv, jconv, tensors)
    assert got["model.layers.0.mlp.up_proj.weight_scale"].dtype == \
        to_torch(tensors["model.layers.0.mlp.up_proj.scales"]).dtype
    _same_config(tconv, jconv)
    for name in ("model.layers.0.mlp.up_proj.qweight",
                 "model.layers.0.mlp.up_proj.scales", "lm_head.qweight",
                 "x.weight"):
        assert tconv.get_dependencies(name) == jconv.get_dependencies(name)


def test_autoawq_validation_and_config_match_jax(rng):
    tensors = _awq_tensors(rng)
    tconv, jconv = (tcv.AutoAWQConverter(group_size=64, device="cpu"),
                    jcv.AutoAWQConverter(group_size=64))
    missing = dict(tensors)
    del missing["model.layers.0.mlp.up_proj.qzeros"]
    _both_raise(tconv, jconv, missing)
    stray = dict(tensors, **{"lm_head.qzeros": tensors[
        "model.layers.0.mlp.up_proj.qzeros"]})
    _both_raise(tconv, jconv, stray)
    awq = {"bits": 4, "group_size": 128, "zero_point": True,
           "version": "gemm", "quant_method": "awq",
           "modules_to_not_convert": ["visual", "mlp.gate"]}
    t = tcv.AutoAWQConverter.from_autoawq_config(awq, device="cpu")
    j = jcv.AutoAWQConverter.from_autoawq_config(awq)
    assert t.ignore == j.ignore
    _same_config(t, j)
    for bad in ({"bits": 8}, {"version": "gemv"}):
        with pytest.raises(ValueError):
            tcv.AutoAWQConverter(**bad, device="cpu")


def test_autoawq_unpack_order_matches_jax(rng):
    words = awq_pack(rng.integers(0, 16, (4, 64)))
    jw, _ = jcv.AutoAWQConverter.reverse_awq_order(
        *jcv.AutoAWQConverter.unpack_awq(words, None, 4), 4)
    tw, _ = tcv.AutoAWQConverter.reverse_awq_order(
        *tcv.AutoAWQConverter.unpack_awq(torch.from_numpy(words), None, 4), 4)
    np.testing.assert_array_equal(tw.numpy(), jw)


# --------------------------------------------------------------------------- #
# the other converters


def _ct_config(fmt_case):
    if fmt_case == "int8-channel":
        weights = {"num_bits": 8, "type": "int", "strategy": "channel",
                   "symmetric": True}
        fmt = "naive-quantized"
    elif fmt_case == "w4-group-asym":
        weights = {"num_bits": 4, "type": "int", "strategy": "group",
                   "group_size": 32, "symmetric": False}
        fmt = "pack-quantized"
    else:
        weights = {"num_bits": 8, "type": "float", "strategy": "channel",
                   "symmetric": True}
        fmt = "float-quantized"
    return {"quant_method": "compressed-tensors", "config_groups": {
        "group_0": {"targets": ["re:.*mlp.*"], "weights": weights,
                    "format": fmt}}, "ignore": ["lm_head"]}


@pytest.mark.parametrize("fmt_case", ("int8-channel", "w4-group-asym",
                                      "fp8-channel"))
def test_ct_dequantizer_matches_jax(rng, tmp_path, fmt_case):
    """A JAX-written checkpoint's tensors dequantized by both packages: bf16
    weights equal bit for bit; k/v scales dropped alike."""
    qc = _ct_config(fmt_case)
    src, _ = make_tiny_llama_checkpoint(tmp_path, rng, qc,
                                        model_config=CFG, kv_scales=True)
    tensors = jio.load_safetensors(os.path.join(src, "model.safetensors"))
    tconv = tcv.CompressedTensorsDequantizer(qc, device="cpu")
    jconv = jcv.CompressedTensorsDequantizer(qc)
    tconv.validate({k: to_torch(v) for k, v in tensors.items()})
    jconv.validate(dict(tensors))
    got = _both_process(tconv, jconv, tensors)
    assert got["model.layers.0.mlp.up_proj.weight"].dtype == torch.bfloat16
    assert not any(k.endswith("k_scale") for k in got)
    _same_config(tconv, jconv)
    for name in ("model.layers.0.mlp.up_proj." + p for p in
                 ("weight", "weight_packed", "weight_scale")):
        assert tconv.get_dependencies(name) == jconv.get_dependencies(name)
    bad = {k: v for k, v in tensors.items()
           if not k.endswith("mlp.up_proj.weight_scale")}
    _both_raise(tconv, jconv, bad)


def _fp8_block_tensors(rng, rows, cols, bh=8, bw=8):
    w = (rng.normal(size=(rows, cols)) * 10).astype(ml_dtypes.float8_e4m3fn)
    s = rng.random((-(-rows // bh), -(-cols // bw))).astype(np.float32)
    return {"x.proj.weight": w, "x.proj.weight_scale_inv": s,
            "x.norm.weight": rng.random(cols).astype(np.float32)}


@pytest.mark.parametrize("shape", ((16, 24), (20, 30)))
def test_fp8_block_dequantizer_matches_jax(rng, shape):
    tensors = _fp8_block_tensors(rng, *shape)
    kw = dict(targets=["re:.*proj"], weight_block_size=(8, 8))
    tconv = tcv.FP8BlockDequantizer(**kw, device="cpu")
    jconv = jcv.FP8BlockDequantizer(**kw)
    got = _both_process(tconv, jconv, tensors)
    assert got["x.proj.weight"].dtype == torch.bfloat16
    _same_config(tconv, jconv)
    for name in ("x.proj.weight", "x.proj.weight_scale_inv", "y.weight"):
        assert tconv.get_dependencies(name) == jconv.get_dependencies(name)
    orphan = {"x.proj.weight_scale_inv": tensors["x.proj.weight_scale_inv"]}
    _both_raise(tconv, jconv, orphan)


@pytest.mark.parametrize("kv", (False, True))
def test_modelopt_nvfp4_converter_matches_jax(rng, kv):
    tensors = {}
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        p = f"model.layers.0.self_attn.{proj}"
        tensors.update({
            f"{p}.weight": rng.integers(0, 256, (16, 8)).astype(np.uint8),
            f"{p}.weight_scale": rng.random((16, 1)).astype(
                ml_dtypes.float8_e4m3fn),
            f"{p}.weight_scale_2": (rng.random(1) * 1e-3 + 1e-4).astype(
                np.float32),
            f"{p}.input_scale": (rng.random(1) * 0.1 + 0.01).astype(
                np.float32)})
    if kv:
        tensors["model.layers.0.self_attn.k_proj.k_scale"] = np.asarray(
            [0.0375], np.float32)
        tensors["model.layers.0.self_attn.v_proj.v_scale"] = np.asarray(
            [0.0213], np.float32)
    tensors["lm_head.weight"] = rng.standard_normal((8, 16)).astype(
        np.float32)
    kvs = dict(num_bits=8, type="float", strategy="tensor", symmetric=True,
               dynamic=False)
    tconv = tcv.ModelOptNvfp4Converter(
        targets=["re:.*proj"], kv_cache_scheme=TArgs(**kvs) if kv else None,
        device="cpu")
    jconv = jcv.ModelOptNvfp4Converter(
        targets=["re:.*proj"], kv_cache_scheme=JArgs(**kvs) if kv else None)
    tconv.validate({k: to_torch(v) for k, v in tensors.items()})
    jconv.validate(dict(tensors))
    got = _both_process(tconv, jconv, tensors)
    assert got["model.layers.0.self_attn.q_proj.weight_global_scale"].dtype \
        == torch.float32
    _same_config(tconv, jconv)
    for name in ("model.layers.0.self_attn.k_proj.weight",
                 "model.layers.0.self_attn.v_proj.weight",
                 "model.layers.0.self_attn.q_proj.input_scale",
                 "lm_head.weight"):
        assert tconv.get_dependencies(name) == jconv.get_dependencies(name)
    stray = {"model.layers.0.mlp.gate.input_scale": np.ones(1, np.float32)}
    _both_raise(tconv, jconv, stray)


def test_converters_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (tcv.AutoAWQConverter, tcv.ModelOptNvfp4Converter,
                 tcv.FP8BlockDequantizer,
                 lambda: tcv.CompressedTensorsDequantizer(
                     _ct_config("int8-channel"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_build_inverse_weight_maps_cross_shard(tmp_path, rng):
    """Dependencies resolve across shards as in the JAX package."""
    w = rng.integers(0, 100, size=(4, 16)).astype(np.int32)
    s = rng.random((4, 1)).astype(np.float32)
    jio.save_safetensors(str(tmp_path / "a.safetensors"),
                         {"m.qweight": w, "n.qweight": w})
    jio.save_safetensors(str(tmp_path / "b.safetensors"),
                         {"m.scales": s, "m.qzeros": w[:1], "n.scales": s,
                          "n.qzeros": w[:1], "o.weight": s})
    weight_map = {"m.qweight": "a.safetensors", "n.qweight": "a.safetensors",
                  "m.scales": "b.safetensors", "m.qzeros": "b.safetensors",
                  "n.scales": "b.safetensors", "n.qzeros": "b.safetensors",
                  "o.weight": "b.safetensors"}
    model_files = {f: str(tmp_path / f) for f in ("a.safetensors",
                                                   "b.safetensors")}
    got = tcv.build_inverse_weight_maps(
        weight_map, model_files, [tcv.AutoAWQConverter(device="cpu")])
    want = jcv.build_inverse_weight_maps(weight_map, model_files,
                                         [jcv.AutoAWQConverter()])
    assert got == want
    assert set(got["a.safetensors"][str(tmp_path / "b.safetensors")]) == \
        {"m.scales", "m.qzeros", "n.scales", "n.qzeros"}
    assert got["b.safetensors"] == {str(tmp_path / "b.safetensors"):
                                    ["o.weight"]}
    with pytest.raises(ValueError, match="not found"):
        tcv.build_inverse_weight_maps(
            {"m.qweight": "a.safetensors"}, model_files,
            [tcv.AutoAWQConverter(device="cpu")])


# --------------------------------------------------------------------------- #
# convert_checkpoint


def _awq_checkpoint(path, rng, group=128):
    """A tiny AutoAWQ GEMM checkpoint written by the JAX package's
    safetensors writer in two shards with an index: every decoder linear
    as qweight/qzeros/scales (fp16), the embedding, norms and lm_head
    dense in fp16, and AutoAWQ's quantization_config."""
    H, I, V = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    NH, KVH, D = (CFG["num_attention_heads"], CFG["num_key_value_heads"],
                  CFG["head_dim"])
    shards = [{}, {}]
    shards[0]["model.embed_tokens.weight"] = (
        rng.normal(size=(V, H)) * 0.05).astype(np.float16)
    for i in range(CFG["num_hidden_layers"]):
        p = f"model.layers.{i}"
        for name, (n, k) in {"self_attn.q_proj": (NH * D, H),
                             "self_attn.k_proj": (KVH * D, H),
                             "self_attn.v_proj": (KVH * D, H),
                             "self_attn.o_proj": (H, NH * D),
                             "mlp.gate_proj": (I, H), "mlp.up_proj": (I, H),
                             "mlp.down_proj": (H, I)}.items():
            shard = shards[i]
            shard[f"{p}.{name}.qweight"] = awq_pack(rng.integers(0, 16,
                                                                 (k, n)))
            shard[f"{p}.{name}.qzeros"] = awq_pack(rng.integers(
                6, 11, (k // group, n)))
            shard[f"{p}.{name}.scales"] = (
                rng.random((k // group, n)) * 0.004 + 0.002).astype(
                np.float16)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            shards[i][f"{p}.{norm}.weight"] = np.ones(H, np.float16)
    shards[1]["model.norm.weight"] = np.ones(H, np.float16)
    shards[1]["lm_head.weight"] = (rng.normal(size=(V, H)) * 0.05).astype(
        np.float16)
    os.makedirs(path, exist_ok=True)
    names = [f"model-0000{i + 1}-of-00002.safetensors" for i in range(2)]
    weight_map = {}
    for fname, shard in zip(names, shards):
        jio.save_safetensors(os.path.join(path, fname), shard,
                             metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(CFG, torch_dtype="float16", quantization_config={
            "quant_method": "awq", "bits": 4, "group_size": group,
            "zero_point": True, "version": "gemm",
            "modules_to_not_convert": None}), f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": 1}, f)
    return path


def _same_dirs(jdir, tdir):
    """Equal file lists; config.json and the index equal as JSON (the
    version strings excepted), every other file equal byte for byte."""
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for fname in os.listdir(jdir):
        with open(os.path.join(jdir, fname), "rb") as f:
            jb = f.read()
        with open(os.path.join(tdir, fname), "rb") as f:
            tb = f.read()
        if fname.endswith(".json"):
            j, t = json.loads(jb), json.loads(tb)
            for d in (j, t):
                d.get("quantization_config", {}).pop("version", None)
            assert j == t, fname
        else:
            assert jb == tb, fname


@pytest.fixture(scope="module")
def awq_converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("awq")
    src = _awq_checkpoint(str(root / "awq"), np.random.default_rng(7))
    with open(os.path.join(src, "config.json")) as f:
        awq = json.load(f)["quantization_config"]
    jcv.convert_checkpoint(src, str(root / "jax"),
                           jcv.AutoAWQConverter.from_autoawq_config(awq))
    tcv.convert_checkpoint(src, str(root / "torch"),
                           tcv.AutoAWQConverter.from_autoawq_config(
                               awq, device="cpu"), max_workers=2)
    return root


def test_convert_autoawq_checkpoint_equal_files(awq_converted):
    root = awq_converted
    _same_dirs(str(root / "jax"), str(root / "torch"))
    with open(root / "torch" / "config.json") as f:
        qc = json.load(f)["quantization_config"]
    assert qc["format"] == "pack-quantized" and qc["transform_config"] == {}
    assert qc["config_groups"]["config_group_0"]["weights"]["symmetric"] \
        is False
    weight_map = tio.get_weight_map(str(root / "torch"))
    assert weight_map["model.layers.1.mlp.up_proj.weight_zero_point"] == \
        "model-00002-of-00002.safetensors"
    assert os.path.exists(root / "torch" / "generation_config.json")


def test_converted_awq_greedy_tokens_match_jax(awq_converted):
    """The converted AWQ checkpoint (fp16 scales, zero points) loaded by the
    port: greedy tokens equal the JAX package's on its own conversion."""
    root = awq_converted
    ids = np.random.default_rng(4).integers(0, CFG["vocab_size"], (2, 12))
    jp, jc, _ = jl.load_llama_params(str(root / "jax"), dtype=jnp.float32,
                                     use_kernels=False)
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=6, dtype=jnp.float32,
                                 use_kernels=False))
    tp, tc, _ = tl.load_llama_params(str(root / "torch"), dtype=torch.float32,
                                     device="cpu")
    got = greedy_generate(fuse_llama_layers(tp), tc, ids, max_new_tokens=6,
                          dtype=torch.float32, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_convert_ct_checkpoint_to_dense_equal_files(rng, tmp_path):
    """A JAX-written W4A16 (asymmetric, group 32) checkpoint with k/v
    scales dequantized to a dense bf16 checkpoint by both packages."""
    src, _ = make_tiny_llama_checkpoint(
        tmp_path, rng, w4a16_config(symmetric=False, group_size=32),
        model_config=CFG, kv_scales=True)
    jcv.convert_checkpoint(src, str(tmp_path / "jax"),
                           jcv.CompressedTensorsDequantizer.from_pretrained(
                               src), max_workers=2)
    tcv.convert_checkpoint(src, str(tmp_path / "torch"),
                           tcv.CompressedTensorsDequantizer.from_pretrained(
                               src, device="cpu"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "torch"))
    with open(tmp_path / "torch" / "config.json") as f:
        assert "quantization_config" not in json.load(f)
    params, _, _ = tl.load_llama_params(str(tmp_path / "torch"),
                                        dtype=torch.float32, device="cpu")
    assert params["layers"][0]["q_proj"].format == "dense"


def test_ct_dequantizer_refuses_linear_biases_like_jax(rng):
    """Reference caveat: ``CompressedTensorsDequantizer.validate`` counts a
    quantized linear's ``bias`` as an unconsumed key, so neither package's
    ``convert_checkpoint`` dequantizes a checkpoint with qkv biases (a
    converted Qwen2 AWQ model); ``process`` itself passes the bias
    through, in both alike."""
    qc = _ct_config("int8-channel")
    qc["config_groups"]["group_0"]["targets"] = ["re:.*proj.*"]
    tensors = {
        "model.layers.0.self_attn.q_proj.weight":
            rng.integers(-128, 127, (64, 64)).astype(np.int8),
        "model.layers.0.self_attn.q_proj.weight_scale":
            rng.random((64, 1)).astype(np.float32),
        "model.layers.0.self_attn.q_proj.bias":
            rng.standard_normal(64).astype(np.float32)}
    tconv = tcv.CompressedTensorsDequantizer(qc, device="cpu")
    jconv = jcv.CompressedTensorsDequantizer(qc)
    _both_raise(tconv, jconv, tensors)
    got = _both_process(tconv, jconv, tensors)
    assert "model.layers.0.self_attn.q_proj.bias" in got


def test_modelopt_nvfp4_checkpoint_converts_and_loads(tmp_path, rng):
    """A ModelOpt NVFP4 checkpoint (``weight`` packed bytes, e4m3
    ``weight_scale``, ``weight_scale_2`` = 1 / the global scale,
    ``input_scale``) made from a JAX-written NVFP4A16 checkpoint, converted
    by both packages (equal files): the config is NVFP4 (fp4 input
    activations), the port loads it weight-only and its logits equal the
    NVFP4A16 checkpoint's within one f32 ulp of the global scales."""
    from torch_port_utils import make_tiny_fp4_checkpoint

    src = make_tiny_fp4_checkpoint(tmp_path, rng, fused_global=True)
    tensors = jio.load_safetensors(os.path.join(src, "model.safetensors"))
    modelopt = {}
    for name, t in tensors.items():
        module, _, local = name.rpartition(".")
        if local == "weight_packed":
            modelopt[f"{module}.weight"] = t
        elif local == "weight_global_scale":
            modelopt[f"{module}.weight_scale_2"] = (
                np.float32(1) / np.asarray(t, np.float32))
            modelopt[f"{module}.input_scale"] = np.full_like(
                np.asarray(t, np.float32), 0.0125)
        else:
            modelopt[name] = t
    mo = tmp_path / "modelopt"
    os.makedirs(mo)
    jio.save_safetensors(str(mo / "model.safetensors"), modelopt)
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg["quantization_config"] = {"quant_method": "modelopt",
                                  "quant_algo": "NVFP4"}
    with open(mo / "config.json", "w") as f:
        json.dump(cfg, f)
    kw = dict(targets=["re:.*_proj$"], ignore=["lm_head"])
    jcv.convert_checkpoint(str(mo), str(tmp_path / "jax"),
                           jcv.ModelOptNvfp4Converter(**kw))
    tcv.convert_checkpoint(str(mo), str(tmp_path / "torch"),
                           tcv.ModelOptNvfp4Converter(**kw, device="cpu"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "torch"))
    with open(tmp_path / "torch" / "config.json") as f:
        scheme = json.load(f)["quantization_config"]["config_groups"][
            "config_group_0"]
    assert scheme["input_activations"]["num_bits"] == 4
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG["vocab_size"], (1, 16)))
    pos = torch.arange(16)[None]
    outs = []
    for path in (src, str(tmp_path / "torch")):
        params, config, _ = tl.load_llama_params(path, dtype=torch.float32,
                                                 device="cpu")
        if path != src:
            assert params["layers"][0]["q_proj"].input_global_scale is not None
        outs.append(to_numpy(tl.llama_forward(params, config, ids, pos)[0]))
    np.testing.assert_allclose(outs[1], outs[0],
                               atol=1e-5 * np.abs(outs[0]).max(), rtol=0)
