"""The PTQ walk end to end in both packages, from the same numpy weights of
a tiny Llama (2 layers, hidden 256): ``apply_quantization_config`` ->
``calibrate_module`` (min-max) -> ``compress_quantized_weights`` ->
``ModelCompressor.save_checkpoint`` with a small ``max_shard_bytes``.

The two checkpoints hold the same tensors bit for bit, in the same shards;
their ``config.json`` and index are equal as JSON. Each package's loader
reads the other's files: the port's ``load_llama_params`` (CPU, f32) holds
the JAX ``llama_forward`` on the JAX-written files within 1e-3 of
max|logits| and the JAX loader reads the port's files, with equal greedy
tokens. Also: the FP8 walk with a ``kv_cache_scheme`` and
``calibrate_kv_scales`` (masked by row lengths in the port),
``load_pretrained_quantization_parameters``, ``load_checkpoint``
decompressed against ``fake_quantize``, ``save_mtp_tensors_to_checkpoint``,
and the one place where the packages' ``config.json`` differ: the port
writes a sparse model's real ``sparsity_config``, the JAX package ``{}``.
"""

import json
import os
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compressed_tensors_tpu as jct
import compressed_tensors_tpu_torch as tct
from compressed_tensors_tpu.engine import greedy_generate as j_generate
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.modeling import attention as jattn
from compressed_tensors_tpu.quantization import lifecycle as jlc
from compressed_tensors_tpu.transform import TransformConfig as JTransformConfig
from compressed_tensors_tpu_torch.transform import (
    TransformConfig as TTransformConfig,
)
from compressed_tensors_tpu.utils import mtp as jmtp
from compressed_tensors_tpu.utils import safetensors_io as jio
from compressed_tensors_tpu_torch.engine import greedy_generate
from compressed_tensors_tpu_torch.modeling import attention as tattn
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.quantization import lifecycle as tlc
from compressed_tensors_tpu_torch.utils import mtp as tmtp
from compressed_tensors_tpu_torch.utils import safetensors_io as tio
from torch_port_utils import TORCH_TINY_CONFIG, raw_bytes, to_numpy

CFG = TORCH_TINY_CONFIG
# ~ a third of the tiny model's bytes: several shards and an index
SHARD_BYTES = 600_000
W4_RECIPE = {"config_groups": {"W4A16": ["Linear"], "W8A8": ["lm_head"]},
             "quant_method": "compressed-tensors"}
FP8_RECIPE = {"config_groups": {"FP8": ["Linear"]},
              "ignore": ["lm_head"],
              "kv_cache_scheme": {"num_bits": 8, "type": "float",
                                  "strategy": "tensor", "symmetric": True,
                                  "dynamic": False},
              "quant_method": "compressed-tensors"}


def _dense_model(seed=0, cfg=CFG):
    """name -> (N, K) f32 weight of every linear and the embedding, and
    the norms as extra tensors."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    NH, KVH, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    shapes = {"model.embed_tokens": (V, H)}
    extra = {"model.norm.weight": np.ones(H, np.float32)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        shapes.update({f"{p}.self_attn.q_proj": (NH * D, H),
                       f"{p}.self_attn.k_proj": (KVH * D, H),
                       f"{p}.self_attn.v_proj": (KVH * D, H),
                       f"{p}.self_attn.o_proj": (H, NH * D),
                       f"{p}.mlp.gate_proj": (I, H),
                       f"{p}.mlp.up_proj": (I, H),
                       f"{p}.mlp.down_proj": (H, I)})
        for norm in ("input_layernorm", "post_attention_layernorm"):
            extra[f"{p}.{norm}.weight"] = (
                1 + 0.1 * rng.normal(size=H)).astype(np.float32)
    shapes["lm_head"] = (V, H)
    weights = {n: (rng.normal(size=s) * 0.05).astype(np.float32)
               for n, s in shapes.items()}
    return weights, extra


def _walk(pkg, out_dir, recipe, weights, extra, inputs=None, cfg=CFG):
    """The PTQ walk in one package ("jax" or "torch"); returns the module
    states and the codes ``compress_quantized_weights`` gave."""
    if pkg == "jax":
        ct, lc, arr = jct, jlc, jnp.asarray
        kw = {}
    else:
        ct, lc, arr = tct, tlc, torch.from_numpy
        kw = {"device": "cpu"}
    modules = ct.module_graph_from_names(list(weights))
    config = ct.QuantizationConfig.model_validate(recipe)
    shapes = {n: w.shape for n, w in weights.items()}
    kv_names = [n for n in modules if n.endswith("self_attn")]
    states = lc.apply_quantization_config(modules, shapes, config,
                                          kv_module_names=kv_names, **kw)
    codes = {}
    for name, state in states.items():
        if name not in weights:
            continue
        sample = None if inputs is None else arr(inputs[name])
        lc.calibrate_module(state, arr(weights[name]), sample_input=sample)
        args = state.scheme.weights
        if args.type == "float" and args.num_bits == 4:
            continue  # no fp4 storage dtype: the codec packs these
        _, codes[name] = lc.compress_quantized_weights(
            lc.ModuleQuantState(scheme=state.scheme, status=state.status,
                                qparams=dict(state.qparams)),
            arr(weights[name]))
    module_states = {n: {"weight": arr(w),
                         **(states[n].qparams if n in states else {})}
                     for n, w in weights.items()}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    ct.ModelCompressor(quantization_config=config).save_checkpoint(
        out_dir, module_states, modules,
        extra_tensors={k: arr(v) for k, v in extra.items()},
        max_shard_bytes=SHARD_BYTES)
    return states, codes


def _json(path):
    with open(path) as f:
        return json.load(f)


def _same_checkpoint(jdir, tdir):
    """Equal files, weight maps, index and config JSON, and every tensor
    equal bit for bit."""
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    jmap, tmap = jio.get_weight_map(jdir), tio.get_weight_map(tdir)
    assert jmap == tmap
    assert len(set(tmap.values())) >= 3
    for name in ("model.safetensors.index.json", "config.json"):
        assert _json(os.path.join(jdir, name)) == _json(
            os.path.join(tdir, name)), name
    for fname in set(tmap.values()):
        jt = jio.load_safetensors(os.path.join(jdir, fname))
        tt = tio.load_safetensors(os.path.join(tdir, fname))
        assert list(jt) == list(tt)
        for k in jt:
            assert tuple(jt[k].shape) == tuple(tt[k].shape), k
            np.testing.assert_array_equal(raw_bytes(tt[k]), raw_bytes(jt[k]),
                                          err_msg=k)
    return tmap


@pytest.fixture(scope="module")
def w4_walk(tmp_path_factory):
    root = pathlib.Path(tmp_path_factory.mktemp("ptq"))
    weights, extra = _dense_model()
    js, jcodes = _walk("jax", str(root / "jax"), W4_RECIPE, weights, extra)
    ts, tcodes = _walk("torch", str(root / "torch"), W4_RECIPE, weights,
                       extra)
    return root, weights, (js, jcodes), (ts, tcodes)


def test_walk_states_and_codes_match(w4_walk):
    _, weights, (js, jcodes), (ts, tcodes) = w4_walk
    assert sorted(js) == sorted(ts)
    for name in weights:
        if name not in ts:
            continue
        assert ts[name].status == js[name].status
        for k, v in js[name].qparams.items():
            np.testing.assert_array_equal(raw_bytes(ts[name].qparams[k]),
                                          raw_bytes(v), err_msg=f"{name} {k}")
        np.testing.assert_array_equal(raw_bytes(tcodes[name]),
                                      raw_bytes(jcodes[name]), err_msg=name)


def test_saved_checkpoints_match(w4_walk):
    root = w4_walk[0]
    tmap = _same_checkpoint(str(root / "jax"), str(root / "torch"))
    assert "lm_head.weight" in tmap and "lm_head.weight_scale" in tmap
    assert "model.layers.0.self_attn.q_proj.weight_packed" in tmap
    qc = _json(str(root / "torch" / "config.json"))["quantization_config"]
    assert qc["quantization_status"] == "compressed"
    assert qc["sparsity_config"] == {} and qc["transform_config"] == {}


def test_ct_dequantizer_over_port_checkpoint_matches_jax(w4_walk,
                                                         tmp_path):
    """``CompressedTensorsDequantizer`` by ``convert_checkpoint`` over the
    port-written W4A16 + W8A8-int-head checkpoint (no linear biases).

    Reference caveat: ``get_dependencies`` reads only the first scheme
    that targets ``Linear`` (here W4A16, whose first param is
    ``weight_packed``), so ``lm_head.weight`` of the W8A8 scheme gets no
    dependencies, and where its ``weight_scale`` lies in another shard
    both packages' ``validate`` refuse the checkpoint alike. The same
    tensors in one file convert in both: equal dense bf16 tensors, every
    quantized module dequantized and its qparams gone."""
    import compressed_tensors_tpu.entrypoints.convert as jcv
    import compressed_tensors_tpu_torch.entrypoints.convert as tcv

    src = str(w4_walk[0] / "torch")
    weight_map = tio.get_weight_map(src)
    assert weight_map["lm_head.weight"] != weight_map["lm_head.weight_scale"]
    errors = []
    for cv, kw in ((jcv, {}), (tcv, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            cv.convert_checkpoint(src, str(tmp_path / "refused"),
                                  cv.CompressedTensorsDequantizer
                                  .from_pretrained(src, **kw))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "Expected key lm_head.weight_scale not found"

    one = tmp_path / "one_file"
    one.mkdir()
    shutil.copy(os.path.join(src, "config.json"), one / "config.json")
    tio.save_safetensors(str(one / "model.safetensors"), {
        n: t for f in sorted(set(weight_map.values()))
        for n, t in tio.load_safetensors(os.path.join(src, f)).items()})
    jcv.convert_checkpoint(str(one), str(tmp_path / "jax"),
                           jcv.CompressedTensorsDequantizer.from_pretrained(
                               str(one)))
    tcv.convert_checkpoint(str(one), str(tmp_path / "torch"),
                           tcv.CompressedTensorsDequantizer.from_pretrained(
                               str(one), device="cpu"))
    quantized = {n.rpartition(".")[0] for n in weight_map
                 if n.endswith(".weight_scale")}
    assert len(quantized) == 7 * CFG["num_hidden_layers"] + 1
    jt = jio.load_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    tt = tio.load_safetensors(str(tmp_path / "torch" / "model.safetensors"))
    assert list(jt) == list(tt)
    assert {n for n in tt if n.rpartition(".")[0] in quantized} == {
        f"{m}.weight" for m in quantized}
    assert all(tt[f"{m}.weight"].dtype == torch.bfloat16 for m in quantized)
    with open(tmp_path / "jax" / "model.safetensors", "rb") as f:
        want = f.read()
    with open(tmp_path / "torch" / "model.safetensors", "rb") as f:
        assert f.read() == want


def _ids(S, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                size=(2, S))


@pytest.mark.parametrize("reader,files", [("torch", "jax"), ("jax", "torch")])
def test_cross_read_logits_and_tokens(w4_walk, reader, files):
    """Each loader on the other package's files, against the JAX forward
    on the JAX package's own files."""
    root = w4_walk[0]
    jp, jc, _ = jl.load_llama_params(str(root / "jax"), dtype=jnp.float32,
                                     use_kernels=False)
    ids = _ids(40, 3)
    pos = np.broadcast_to(np.arange(40), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    want = np.asarray(want)
    want_tokens = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                        max_new_tokens=6, dtype=jnp.float32,
                                        use_kernels=False))
    if reader == "torch":
        tp, tc, _ = tl.load_llama_params(str(root / files),
                                         dtype=torch.float32, device="cpu")
        got, _ = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                                  torch.from_numpy(np.array(pos)))
        tokens = greedy_generate(fuse_llama_layers(tp), tc, ids,
                                 max_new_tokens=6, dtype=torch.float32,
                                 device="cpu").numpy()
    else:
        op, oc, _ = jl.load_llama_params(str(root / files),
                                         dtype=jnp.float32, use_kernels=False)
        got, _ = jl.llama_forward(op, oc, jnp.asarray(ids), jnp.asarray(pos),
                                  use_kernels=False)
        tokens = np.asarray(j_generate(op, oc, jnp.asarray(ids, jnp.int32),
                                       max_new_tokens=6, dtype=jnp.float32,
                                       use_kernels=False))
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(tokens, want_tokens)


def test_load_checkpoint_decompressed_is_fake_quantized(w4_walk):
    """``load_checkpoint(run_compressed=False)`` gives the QDQ weights:
    equal bit for bit to ``fake_quantize`` of the dense weights with the
    calibrated qparams, and to the JAX package's decompression."""
    root, weights, _, (ts, _) = w4_walk
    path = str(root / "torch")
    mc = tct.ModelCompressor.from_pretrained(path)
    states, schemes = mc.load_checkpoint(path, run_compressed=False,
                                         device="cpu")
    jmc = jct.ModelCompressor.from_pretrained(path)
    jstates, _ = jmc.load_checkpoint(path, run_compressed=False)
    for name in ("model.layers.0.self_attn.q_proj", "model.layers.1.mlp."
                 "down_proj", "lm_head"):
        q = ts[name].qparams
        want = tct.fake_quantize(torch.from_numpy(weights[name]),
                                 q["weight_scale"], q.get("weight_zero_point"),
                                 schemes[name].weights)
        got = states[name]["weight"]
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want), name
        np.testing.assert_array_equal(to_numpy(got),
                                      np.asarray(jstates[name]["weight"]))
    compressed, _ = mc.load_checkpoint(path, device="cpu")
    assert compressed["lm_head"]["weight"].dtype == torch.int8
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mc.load_checkpoint(path)


def test_fp8_walk_with_kv_scales(tmp_path):
    """FP8 (static per-tensor inputs) with an fp8 ``kv_cache_scheme``: the
    input scales calibrated from sample inputs, the k/v scales from
    post-RoPE rows of a padded cache (masked by length in the port, the
    valid rows alone in JAX) -- equal bit for bit --, saved beside the
    weights; then ``load_pretrained_quantization_parameters`` reads the
    input scales back into fresh states in both packages."""
    weights, extra = _dense_model(1)
    rng = np.random.default_rng(7)
    inputs = {n: rng.normal(size=(6, w.shape[1])).astype(np.float32)
              for n, w in weights.items()}
    B, S, KVH, D = 3, 12, CFG["num_key_value_heads"], CFG["head_dim"]
    lengths = np.array([12, 5, 9])
    for i in range(CFG["num_hidden_layers"]):
        k = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
        v = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
        # padding beyond each row's length, which must not count
        for b, n in enumerate(lengths):
            k[b, n:] = -50.0
            v[b, n:] = 60.0
        kv = jct.QuantizationConfig.model_validate(FP8_RECIPE).kv_cache_scheme
        jst = jattn.calibrate_kv_scales(
            jattn.initialize_hooked_kv_cache(kv),
            jnp.concatenate([jnp.asarray(k[b, :n]) for b, n in
                             enumerate(lengths)])[None],
            jnp.concatenate([jnp.asarray(v[b, :n]) for b, n in
                             enumerate(lengths)])[None])
        tkv = tct.QuantizationConfig.model_validate(FP8_RECIPE).kv_cache_scheme
        tst = tattn.calibrate_kv_scales(
            tattn.initialize_hooked_kv_cache(tkv, device="cpu"),
            torch.from_numpy(k), torch.from_numpy(v),
            lengths=torch.from_numpy(lengths))
        for a, b in ((tst.k_scale, jst.k_scale), (tst.v_scale, jst.v_scale)):
            np.testing.assert_array_equal(raw_bytes(a), raw_bytes(b))
        assert float(tst.k_scale[0]) < 50.0 / 448.0
        extra[f"model.layers.{i}.self_attn.k_scale"] = to_numpy(tst.k_scale)
        extra[f"model.layers.{i}.self_attn.v_scale"] = to_numpy(tst.v_scale)

    js, _ = _walk("jax", str(tmp_path / "jax"), FP8_RECIPE, weights, extra,
                  inputs)
    ts, _ = _walk("torch", str(tmp_path / "torch"), FP8_RECIPE, weights,
                  extra, inputs)
    assert any(n.endswith("self_attn") for n in ts)
    _same_checkpoint(str(tmp_path / "jax"), str(tmp_path / "torch"))

    modules = tct.module_graph_from_names(list(weights))
    config = tct.QuantizationConfig.model_validate(FP8_RECIPE)
    shapes = {n: w.shape for n, w in weights.items()}
    fresh = tlc.apply_quantization_config(modules, shapes, config,
                                          device="cpu")
    jfresh = jlc.apply_quantization_config(
        jct.module_graph_from_names(list(weights)), shapes,
        jct.QuantizationConfig.model_validate(FP8_RECIPE))
    tlc.load_pretrained_quantization_parameters(fresh, str(tmp_path / "jax"))
    jlc.load_pretrained_quantization_parameters(jfresh,
                                                str(tmp_path / "torch"))
    name = "model.layers.1.mlp.up_proj"
    for st in (fresh[name].qparams, jfresh[name].qparams):
        np.testing.assert_array_equal(
            raw_bytes(st["input_scale"]),
            raw_bytes(ts[name].qparams["input_scale"]))
    assert float(fresh[name].qparams["input_zero_point"].float().abs().max()
                 ) == 0.0

    # the FP8 model with its k/v scales loads in both and agrees
    tp, tc, _ = tl.load_llama_params(str(tmp_path / "torch"),
                                     dtype=torch.float32, device="cpu")
    assert float(tp["layers"][1]["k_scale"].reshape(-1)[0]) == float(
        extra["model.layers.1.self_attn.k_scale"][0])
    jp, jc, _ = jl.load_llama_params(str(tmp_path / "torch"),
                                     dtype=jnp.float32, use_kernels=False)
    ids = _ids(20, 9)
    pos = np.broadcast_to(np.arange(20), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    got, _ = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                              torch.from_numpy(np.array(pos)),
                              use_kernels=False)
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)


def test_save_mtp_tensors_matches_jax(w4_walk, tmp_path):
    root = w4_walk[0]
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(11)
    mtp = {"mtp.layers.0.proj.weight": rng.normal(size=(8, 16)).astype(
        np.float32), "mtp.norm.weight": np.ones(16, np.float32),
        "model.norm.weight": np.ones(16, np.float32)}
    jio.save_safetensors(str(src / "model.safetensors"), mtp)
    for pkg, fn in (("jax", jmtp), ("torch", tmtp)):
        shutil.copytree(root / "torch", tmp_path / pkg)
        fn.save_mtp_tensors_to_checkpoint(str(src), str(tmp_path / pkg))
    _same_checkpoint(str(tmp_path / "jax"), str(tmp_path / "torch"))
    qc = _json(str(tmp_path / "torch" / "config.json"))["quantization_config"]
    assert "re:^mtp.*" in qc["ignore"]
    assert tio.get_weight_map(str(tmp_path / "torch"))[
        "mtp.norm.weight"] == "model_mtp.safetensors"
    with pytest.raises(ValueError):
        tmtp.save_mtp_tensors_to_checkpoint(str(src), str(tmp_path / "src2"))


def test_update_config_sparsity_differs_from_jax(tmp_path):
    """The one intended difference in ``config.json``: for a sparse model the
    port writes its sparsity config, the JAX ``update_config`` writes
    ``sparsity_config: {}`` (ROADMAP, known caveats); everything else is
    equal. A transform config is kept and written; at load the compressor
    holds none (as the JAX one), and an online transform is refused."""
    recipe = dict(W4_RECIPE, sparsity_config={
        "format": "sparse-24-bitmask", "targets": ["Linear"],
        "sparsity_structure": "2:4"})
    jmc = jct.ModelCompressor.from_compression_config(recipe)
    tmc = tct.ModelCompressor.from_compression_config(recipe)
    for pkg, mc in (("jax", jmc), ("torch", tmc)):
        os.makedirs(tmp_path / pkg)
        mc.update_config(str(tmp_path / pkg))
    jcfg = _json(str(tmp_path / "jax" / "config.json"))
    tcfg = _json(str(tmp_path / "torch" / "config.json"))
    assert jcfg["quantization_config"].pop("sparsity_config") == {}
    sparse = tcfg["quantization_config"].pop("sparsity_config")
    assert sparse["format"] == "sparse-24-bitmask"
    assert sparse["sparsity_structure"] == "2:4"
    assert jcfg == tcfg
    fused = {"config_groups": {"R1": {"type": "hadamard", "apply": [
        {"targets": ["Linear"], "location": "weight_input"}]}}}
    for name, pkg, tc, mc in (("jt", jct, JTransformConfig, jmc),
                              ("tt", tct, TTransformConfig, tmc)):
        os.makedirs(tmp_path / name)
        pkg.ModelCompressor(quantization_config=mc.quantization_config,
                            transform_config=tc.model_validate(fused)
                            ).update_config(str(tmp_path / name))
    written = _json(str(tmp_path / "tt" / "config.json"))
    assert written == _json(str(tmp_path / "jt" / "config.json"))
    assert written["quantization_config"]["transform_config"] == \
        TTransformConfig.model_validate(fused).model_dump(mode="json")
    for pkg in (jct, tct):
        mc = pkg.ModelCompressor.from_compression_config(
            dict(W4_RECIPE, transform_config=fused))
        assert mc.transform_config is None and mc.quantization_config
    online = {"config_groups": {"R4": {"type": "hadamard", "apply": [
        {"targets": ["down_proj"], "location": "input"}]}}}
    with pytest.raises(NotImplementedError, match="online"):
        tct.ModelCompressor.from_compression_config(
            dict(W4_RECIPE, transform_config=online))


def test_infer_format_from_schemes_matches_jax():
    from compressed_tensors_tpu.compressors.format import (
        infer_format_from_schemes as jinfer,
    )
    from compressed_tensors_tpu.quantization import (
        preset_name_to_scheme as jpreset,
    )
    from compressed_tensors_tpu_torch.compressors.format import (
        flatten_formats,
        infer_format_from_schemes,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    cases = [["W4A16"], ["W4A16", "W8A8"], ["FP8", "FP8_DYNAMIC"],
             ["NVFP4A16"], ["MXFP4A16", "W4A16"], []]
    for presets in cases:
        got = infer_format_from_schemes(
            [("Linear", preset_name_to_scheme(p, ["Linear"]))
             for p in presets])
        want = jinfer([("Linear", jpreset(p, ["Linear"])) for p in presets])
        assert got.value == want.value, presets
    forced = preset_name_to_scheme("W4A16", ["Linear"])
    assert infer_format_from_schemes(
        [("Linear", forced)], "naive-quantized").value == "naive-quantized"
    assert forced.format == "naive-quantized"
    assert flatten_formats([]).value == "dense"


@pytest.mark.parametrize("preset", ["FP8_BLOCK", "MXFP4A16", "W4A16_ASYM"])
def test_walk_other_recipes_match_jax(tmp_path, preset):
    """The walk for block FP8 (its layers load and run as the JAX package
    runs them: ``materialize_weight`` dequantizes the fp8 blocks and one
    dense matmul follows, with no activation quantization), MXFP4A16 (E8M0
    group-32 scales from ``calculate_qparams``' MX branch, the MXFP4
    codec) and asymmetric W4A16 (packed zero points): the same
    checkpoint in both packages and logits within 1e-3 of max|ref|."""
    recipe = {"config_groups": {preset: ["Linear"]}, "ignore": ["lm_head"],
              "quant_method": "compressed-tensors"}
    # 128-row k/v projections: whole 128 x 128 blocks (the min-max
    # observer of both packages takes no partial block)
    cfg = dict(CFG, num_key_value_heads=4)
    weights, extra = _dense_model(2, cfg)
    _walk("jax", str(tmp_path / "jax"), recipe, weights, extra, cfg=cfg)
    _walk("torch", str(tmp_path / "torch"), recipe, weights, extra, cfg=cfg)
    _same_checkpoint(str(tmp_path / "jax"), str(tmp_path / "torch"))
    jp, jc, _ = jl.load_llama_params(str(tmp_path / "jax"), dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(str(tmp_path / "torch"),
                                     dtype=torch.float32, device="cpu")
    if preset == "FP8_BLOCK":
        q = tp["layers"][0]["q_proj"]
        assert q.kernel_meta is None and q.weight.dtype == torch.float8_e4m3fn
        assert tuple(q.scale.shape) == (2, 2)
    ids = _ids(24, 5)
    pos = np.broadcast_to(np.arange(24), ids.shape)
    want, _ = jl.llama_forward(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                               use_kernels=False)
    got, _ = tl.llama_forward(tp, tc, torch.from_numpy(ids),
                              torch.from_numpy(np.array(pos)))
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)
