"""The port's spec-layer, I/O and helper leftovers held against the JAX
package: the matchers, the ``utils`` helpers, the safetensors helpers, the
native host library (skipped only where ``g++`` is absent), the flags and
their environment reload (``enforce_eager`` and ``w4_dense_m`` on the
matmul path), ``ImplBackend`` with toy ops, the logger, the version, the
qparam metadata, the deprecated ``CompressedLinear`` and the top-level
export list."""

import importlib
import json
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compressed_tensors_tpu as jct
import compressed_tensors_tpu_torch as tct
from compressed_tensors_tpu.utils import match as jm
from compressed_tensors_tpu.utils import safetensors_io as jio
from compressed_tensors_tpu_torch import flags as tflags
from compressed_tensors_tpu_torch.utils import match as tm
from compressed_tensors_tpu_torch.utils import safetensors_io as tio
from torch_port_utils import raw_bytes, to_numpy


def _bits(t):
    """Bytes of a torch tensor or JAX/numpy array as integers (bf16 and
    fp8 included)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    a = np.asarray(t) if not isinstance(t, torch.Tensor) else None
    if a is not None and a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return raw_bytes(t)


# the JAX top-level names the port does not export (none since the
# offload names came, ROADMAP A8a)
NOT_YET_PORTED = set()


def _graph(pkg, layers=3):
    info = pkg.ModuleInfo
    modules = {"": info("LlamaForCausalLM"), "model": info("LlamaModel"),
               "model.embed_tokens": info("Embedding")}
    for i in range(layers):
        p = f"model.layers.{i}"
        modules[p] = info("LlamaDecoderLayer")
        modules[f"{p}.self_attn"] = info("LlamaAttention")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            modules[f"{p}.self_attn.{proj}"] = info("Linear")
        modules[f"{p}.mlp"] = info("LlamaMLP")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            modules[f"{p}.mlp.{proj}"] = info(
                "Linear", is_internal=(i == 2 and proj == "up_proj"))
        modules[f"{p}.input_layernorm"] = info("RMSNorm")
    modules["lm_head"] = info("Linear", parent_classes=("LinearBase",))
    return modules


TARGET_SETS = [
    (["Linear"], None),
    (["Linear"], ["lm_head", "re:.*down_proj$"]),
    (["re:.*self_attn$"], None),
    ([r"re:model\.layers\.1\..*", "Embedding"], ["re:.*o_proj"]),
    (["LlamaAttention", "nothing_matches"], None),
]


def _both(fn_name, *args, **kwargs):
    got = list(getattr(tm, fn_name)(_graph(tm), *args, **kwargs))
    want = list(getattr(jm, fn_name)(_graph(jm), *args, **kwargs))
    return got, want


@pytest.mark.parametrize("targets,ignore", TARGET_SETS)
def test_module_and_parameter_matchers_match_jax(targets, ignore):
    got, want = _both("match_named_modules", targets, ignore,
                      warn_on_fail=True)
    assert [n for n, _ in got] == [n for n, _ in want]
    got, want = _both("match_named_parameters",
                      [t for t in targets if t.startswith("re:")] or
                      ["re:.*weight$"], ignore)
    assert [(p, n) for p, n, _ in got] == [(p, n) for p, n, _ in want]
    for name in ("model.layers.0.self_attn", "model.layers.1.mlp.up_proj",
                 "lm_head", "model"):
        assert tm.is_narrow_match(_graph(tm), targets, name) == \
            jm.is_narrow_match(_graph(jm), targets, name)
        assert tm.match_targets(name, _graph(tm)[name], targets) == \
            jm.match_targets(name, _graph(jm)[name], targets)


@pytest.mark.parametrize("targets", [
    ["re:.*q_proj$", "re:.*k_proj$", "re:.*v_proj$"],
    ["re:.*gate_proj$", "re:.*down_proj$"],
    ["re:.*input_layernorm$", "re:.*self_attn$"]])
def test_match_modules_set_matches_jax(targets):
    got, want = _both("match_modules_set", targets,
                      error_on_module_rematch=False)
    assert got == want
    assert len(got) >= 2


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


def test_module_set_errors_match_jax():
    errors = 0
    for targets in (["re:.*q_proj$", "re:model.layers.2.mlp.gate"],
                    ["re:.*q_proj$", "Linear"],
                    ["re:.*gate_proj$", "re:.*up_proj$"]):
        got = _outcome(lambda: list(tm.match_modules_set(_graph(tm),
                                                         targets)))
        want = _outcome(lambda: list(jm.match_modules_set(_graph(jm),
                                                          targets)))
        assert got == want
        errors += str(got).startswith("ValueError")
    assert errors == 2


def test_lowest_common_ancestor_and_quantizable_tensors():
    for names in (["a.b.c", "a.b.d"], ["a.b", None, "a.c.d"], [], ["x"],
                  ["model.layers.1.mlp", "model.layers.10.mlp"]):
        assert tm.get_lowest_common_ancestor_name(names) == \
            jm.get_lowest_common_ancestor_name(names)
    tensors = dict.fromkeys([
        "model.layers.0.self_attn.q_proj.weight",
        "model.layers.0.self_attn.q_proj.bias",
        "model.layers.0.input_layernorm.weight",
        "model.layers.0.mlp.down_proj.weight", "lm_head.weight"])
    for kw in (dict(ignore=["lm_head"]),
               dict(ignore=[], targets=["re:.*mlp.*"]),
               dict(ignore=[], allow_nonquantizable=True,
                    param_targets=["re:.*"])):
        assert list(tm.match_quantizable_tensors(tensors, **kw)) == \
            list(jm.match_quantizable_tensors(tensors, **kw))


def test_utils_helpers_match_jax():
    from enum import Enum

    from compressed_tensors_tpu.utils import combine_shards as jcombine
    from compressed_tensors_tpu.utils import shard_tensor as jshard
    from compressed_tensors_tpu_torch.utils import (
        Aliasable,
        ParameterizedDefaultDict,
        combine_shards,
        getattr_chain,
        shard_tensor,
    )

    class Kind(Aliasable, Enum):
        STATIC = "static"
        FIXED = "fixed"

        @staticmethod
        def get_aliases():
            return {"fixed": "static"}

    assert Kind.FIXED == Kind.STATIC and Kind.STATIC == "fixed"
    assert hash(Kind.FIXED) == hash(Kind.STATIC)

    calls = []

    def factory(a, b=0, scale=1):
        calls.append((a, b))
        return (a + b) * scale

    d = ParameterizedDefaultDict(factory)
    assert d[3] == 3 and d[(2, 5)] == 7 and d[(2, 5)] == 7
    assert d.get(4, 1, factory_kwargs={"scale": 10}) == 50
    assert calls == [(3, 0), (2, 5), (4, 1)]

    x = np.arange(60, dtype=np.float32).reshape(6, 10)
    for sizes, dim in (([2, 4], 0), ([3, 3, 4], 1)):
        got = shard_tensor(torch.from_numpy(x), sizes, dim)
        want = jshard(jnp.asarray(x), sizes, dim)
        assert [to_numpy(g).tolist() for g in got] == \
            [np.asarray(w).tolist() for w in want]
        np.testing.assert_array_equal(
            to_numpy(combine_shards(got, dim)),
            np.asarray(jcombine(list(want), dim)))
    with pytest.raises(ValueError):
        shard_tensor(torch.from_numpy(x), [1, 2], 0)
    with pytest.raises(ValueError):
        combine_shards([torch.zeros(2), torch.zeros(2, dtype=torch.int32)])
    with pytest.raises(ValueError):
        combine_shards([])
    scheme = tct.QuantizationScheme(targets=["Linear"],
                                    weights={"num_bits": 4})
    assert getattr_chain(scheme, "weights.num_bits") == 4
    assert getattr_chain(scheme, "input_activations.num_bits", 16) == 16


@pytest.fixture
def sharded(tmp_path):
    """A two-shard checkpoint with an index, written by the port."""
    rng = np.random.default_rng(0)
    shards = {
        "model-00001-of-00002.safetensors": {
            "a.q_proj.weight_packed": torch.from_numpy(
                rng.integers(-2**31, 2**31, (8, 4), dtype=np.int32)),
            "a.q_proj.weight_scale": torch.rand(8, 2).to(torch.bfloat16),
            "a.q_proj.weight_zero_point": torch.zeros(1, 2, dtype=torch.int32),
            "a.self_attn.k_scale": torch.tensor([0.5]),
        },
        "model-00002-of-00002.safetensors": {
            "a.q_proj.weight_g_idx": torch.arange(32, dtype=torch.int32),
            "b.weight": torch.randn(3, 5),
            "b.weight.compressed": torch.randn(7).to(torch.float8_e4m3fn),
            "norm.weight": torch.ones(5),
        },
    }
    weight_map = {}
    for fname, tensors in shards.items():
        tio.save_safetensors(str(tmp_path / fname), tensors,
                             metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(tensors, fname))
    tio.update_safetensors_index(str(tmp_path), weight_map)
    return tmp_path


def test_safetensors_helpers_match_jax(sharded):
    path = str(sharded)
    jdir = sharded / "jax_index"
    jdir.mkdir()
    for f in sharded.glob("*.safetensors"):
        shutil.copy(f, jdir)
    jio.update_safetensors_index(str(jdir), jio.get_weight_map(path))
    with open(sharded / "model.safetensors.index.json") as f:
        tindex = json.load(f)
    with open(jdir / "model.safetensors.index.json") as f:
        assert json.load(f) == tindex

    assert tio.get_weight_map(path) == jio.get_weight_map(path)
    assert tio.get_checkpoint_files(path) == jio.get_checkpoint_files(path)
    for fname in set(tio.get_weight_map(path).values()):
        fpath = os.path.join(path, fname)
        assert tio.get_safetensors_header(fpath) == \
            jio.get_safetensors_header(fpath)
        got, want = tio.load_safetensors(fpath), jio.load_safetensors(fpath)
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    for name in list(tindex["weight_map"]) + ["x.input_global_scale",
                                              "x.weight_shape", "x.bias"]:
        assert tio.is_quantization_param(name) == \
            jio.is_quantization_param(name), name
    assert tio.get_quantization_parameter_to_path_mapping(path) == \
        jio.get_quantization_parameter_to_path_mapping(path)
    for kw in ({}, {"params_to_nest": ["weight_scale", "weight"]},
               {"params_to_nest": ["weight"], "return_unmatched_params": True}):
        assert tio.get_nested_weight_mappings(path, **kw) == \
            jio.get_nested_weight_mappings(path, **kw)
    f = tio.SafetensorsFile(os.path.join(path, tindex["weight_map"][
        "a.q_proj.weight_scale"]))
    assert f.get_shape("a.q_proj.weight_scale") == (8, 2)
    assert f.get_dtype("a.q_proj.weight_scale") == torch.bfloat16
    f.close()


def test_update_config_keeps_other_keys_and_matches_jax(tmp_path):
    cfg = tct.QuantizationConfig.model_validate(
        {"config_groups": {"W4A16": ["Linear"]}})
    jcfg = jct.QuantizationConfig.model_validate(
        {"config_groups": {"W4A16": ["Linear"]}})
    for name, fn, qc in (("t", tio.update_config, cfg),
                         ("j", jio.update_config, jcfg)):
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "config.json", "w") as f:
            json.dump({"hidden_size": 256, "model_type": "llama"}, f)
        fn(str(tmp_path / name), quantization_config=qc)
    with open(tmp_path / "t" / "config.json") as f:
        got = json.load(f)
    with open(tmp_path / "j" / "config.json") as f:
        assert json.load(f) == got
    assert got["hidden_size"] == 256
    assert got["quantization_config"]["version"] == tct.__version__
    # a transform config is written as the JAX package writes it
    from compressed_tensors_tpu.transform import TransformConfig as JTC
    from compressed_tensors_tpu_torch.transform import TransformConfig as TTC

    block = {"config_groups": {"R1": {
        "type": "random-hadamard", "apply": [
            {"targets": ["Linear"], "location": "weight_input",
             "inverse": True}]}}}
    tio.update_config(str(tmp_path / "t"), quantization_config=cfg,
                      transform_config=TTC.model_validate(block))
    jio.update_config(str(tmp_path / "j"), quantization_config=jcfg,
                      transform_config=JTC.model_validate(block))
    with open(tmp_path / "t" / "config.json") as f:
        got = json.load(f)
    with open(tmp_path / "j" / "config.json") as f:
        assert json.load(f) == got
    assert got["quantization_config"]["transform_config"] == \
        TTC.model_validate(block).model_dump(mode="json")


def test_large_tensors_read_through_native_reader(tmp_path, monkeypatch):
    """Tensors at or above PARALLEL_READ_BYTES go through the native
    parallel reader (the pure-Python read below it); both give the same
    tensor, and so does the JAX reader."""
    from compressed_tensors_tpu_torch.utils import native

    monkeypatch.setattr(tio.SafetensorsFile, "PARALLEL_READ_BYTES", 1024)
    t = torch.randn(64, 33).to(torch.bfloat16)
    tio.save_safetensors(str(tmp_path / "m.safetensors"), {"w": t,
                                                           "s": t[:2, :3]})
    calls = []
    reader = native.read_range_parallel
    monkeypatch.setattr(native, "read_range_parallel",
                        lambda *a, **k: calls.append(a) or reader(*a, **k))
    got = tio.load_safetensors(str(tmp_path / "m.safetensors"))
    assert len(calls) == 1
    assert torch.equal(got["w"], t) and torch.equal(got["s"], t[:2, :3])
    want = jio.load_safetensors(str(tmp_path / "m.safetensors"))
    np.testing.assert_array_equal(_bits(got["w"]), _bits(want["w"]))


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native library")


@needs_gxx
@pytest.mark.parametrize("num_bits", [1, 3, 4, 5, 8])
def test_native_codec_matches_jax(num_bits):
    from compressed_tensors_tpu.utils.native import (
        pack_int32_native as jpack,
    )
    from compressed_tensors_tpu_torch.ops.pack import (
        pack_to_int32,
        unpack_from_int32,
    )
    from compressed_tensors_tpu_torch.utils import native

    assert native.native_available()
    rng = np.random.default_rng(num_bits)
    lo, hi = -(1 << (num_bits - 1)), 1 << (num_bits - 1)
    vals = rng.integers(lo, hi, size=(16, 100), dtype=np.int8)
    packed = native.pack_int32_native(torch.from_numpy(vals), num_bits)
    np.testing.assert_array_equal(packed.numpy(), jpack(vals, num_bits))
    assert torch.equal(packed, pack_to_int32(torch.from_numpy(vals),
                                             num_bits))
    unpacked = native.unpack_int32_native(packed, num_bits, 100)
    np.testing.assert_array_equal(unpacked.numpy(), vals)
    assert torch.equal(unpack_from_int32(packed, num_bits, (16, 100)),
                       unpacked)


@needs_gxx
def test_native_parallel_read(tmp_path):
    from compressed_tensors_tpu_torch.utils import native

    data = np.random.default_rng(1).integers(0, 256, size=1 << 20).astype(
        np.uint8)
    path = tmp_path / "blob.bin"
    path.write_bytes(data.tobytes())
    out = native.read_range_parallel(str(path), 0, len(data), num_threads=4)
    np.testing.assert_array_equal(out.numpy(), data)
    out = native.read_range_parallel(str(path), 1000, 5000, num_threads=2)
    np.testing.assert_array_equal(out.numpy(), data[1000:6000])
    assert native.read_range_parallel("/nonexistent/file", 0, 10) is None
    assert native.BUILD_DIR.name == "native"
    assert str(native.SRC).startswith(str(native._PKG))


def test_disable_native_takes_the_python_path(monkeypatch):
    from compressed_tensors_tpu_torch.utils import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    with tflags.flag_overrides(disable_native=True):
        assert not native.native_available()
        assert native.read_range_parallel(__file__, 0, 10) is None
        assert native.pack_int32_native(torch.zeros(2, 8, dtype=torch.int8),
                                        4) is None


def test_flags_reload_from_env(monkeypatch):
    before = dict(vars(tflags.FLAGS))
    try:
        monkeypatch.setenv("CT_TORCH_ENFORCE_EAGER", "1")
        monkeypatch.setenv("CT_TORCH_W4_DENSE_M", "512")
        monkeypatch.setenv("CT_TORCH_DISABLE_NATIVE", "1")
        monkeypatch.setenv("CT_TORCH_DECODE_ATTN", "flash")
        tflags.reload_flags_from_env()
        assert tflags.FLAGS.enforce_eager is True
        assert tflags.FLAGS.w4_dense_m == 512
        assert tflags.FLAGS.disable_native is True
        assert tflags.FLAGS.decode_attn == "flash"
        for name in ("CT_TORCH_ENFORCE_EAGER", "CT_TORCH_W4_DENSE_M",
                     "CT_TORCH_DISABLE_NATIVE", "CT_TORCH_DECODE_ATTN"):
            monkeypatch.delenv(name)
        tflags.reload_flags_from_env()
        assert tflags.FLAGS.enforce_eager is False
        assert tflags.FLAGS.w4_dense_m == 0
        assert tflags.FLAGS.disable_native is False
    finally:
        tflags.set_flags(**before)
    # the JAX-only flag is not copied
    assert not hasattr(tflags.FLAGS, "pallas_interpret")
    with pytest.raises(AttributeError):
        tflags.set_flags(pallas_interpret=True)


def _w4_linear(n=256, k=256, seed=0):
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32

    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(-7, 8, (n, k), dtype=np.int8))
    scale = torch.from_numpy(rng.random((n, k // 128)).astype(np.float32)
                             * 1e-2 + 1e-3)
    scheme = tct.QuantizationScheme(targets=["Linear"], weights={
        "num_bits": 4, "strategy": "group", "group_size": 128})
    return prepare_for_kernels(QuantizedTensor(
        weight_packed=pack_to_int32(codes, 4), scale=scale, shape=(n, k),
        scheme=scheme, format="pack-quantized"))


def test_enforce_eager_and_w4_dense_m_on_the_matmul_path(monkeypatch):
    """``enforce_eager`` sends ``quantized_matmul`` (and ``llama_forward``)
    down the non-kernel path, and ``w4_dense_m`` dequantizes once at or
    above its row count; both default to off, where the kernel (its plain
    version on the CPU) runs."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul

    qt = _w4_linear()
    calls = []
    plain = w4a16_matmul.w4a16_matmul_plain
    monkeypatch.setattr(w4a16_matmul, "w4a16_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    x = torch.randn(8, 256)
    assert not tflags.FLAGS.enforce_eager and tflags.FLAGS.w4_dense_m == 0
    kernel = linear.quantized_matmul(x, qt)
    assert calls == [1]
    reference = linear.quantized_matmul(x, qt, use_kernels=False)
    assert calls == [1]
    with tflags.flag_overrides(enforce_eager=True):
        assert torch.equal(linear.quantized_matmul(x, qt), reference)
    assert calls == [1]
    dense = torch.matmul(x, linear.materialize_weight(qt, x.dtype).t())
    with tflags.flag_overrides(w4_dense_m=8):
        assert torch.equal(linear.quantized_matmul(x, qt), dense)
        assert calls == [1]
        linear.quantized_matmul(x[:7], qt)
        assert calls == [1, 1]
        with tflags.flag_overrides(w4_act="int8"):
            linear.quantized_matmul(x, qt)  # the int8 mode ignores it
    torch.testing.assert_close(kernel, reference, rtol=0, atol=1e-5)
    assert tflags.kernels_enabled(True) and not tflags.kernels_enabled(False)


def test_enforce_eager_is_logged_once(caplog):
    tlog = importlib.import_module("compressed_tensors_tpu_torch.logger")
    tlog._LOGGED_ONCE.discard(next((m for m in tlog._LOGGED_ONCE
                                    if "enforce_eager" in m), ""))
    tlog.logger.propagate = True
    with caplog.at_level(logging.WARNING, logger="compressed_tensors_tpu_torch"):
        with tflags.flag_overrides(enforce_eager=True):
            assert tflags.kernels_enabled(True) is False
            assert tflags.kernels_enabled(True) is False
    assert sum("enforce_eager" in r.getMessage() for r in caplog.records) == 1


class _ToyBackend:
    """Two toy backends and a fallback over one op, in both packages."""

    @staticmethod
    def build(backend_cls, op):
        @backend_cls.register(op, req=lambda x: x > 10, priority=5)
        def big(x):
            return ("big", x)

        @backend_cls.register(op, req=lambda x: x > 0, priority=1)
        def positive(x):
            return ("positive", x)

        @backend_cls.register(op, req=lambda x: 1 / 0, priority=9)
        def broken(x):
            return ("broken", x)

        @backend_cls.entrypoint(op)
        def fallback(x):
            return ("fallback", x)

        return fallback


def test_impl_backend_dispatch_matches_jax():
    from compressed_tensors_tpu.flags import flag_overrides as jflags
    from compressed_tensors_tpu.utils.impl_backend import (
        ImplBackend as JImplBackend,
    )
    from compressed_tensors_tpu_torch.utils.impl_backend import ImplBackend

    fns = {}
    for name, cls in (("torch", ImplBackend), ("jax", JImplBackend)):
        cls._fn_registry.clear()
        fns[name] = _ToyBackend.build(cls, f"toy_{name}")
    for x in (-3, 4, 20):
        assert fns["torch"](x) == fns["jax"](x)
    assert fns["torch"](20) == ("big", 20)
    assert ImplBackend.registered("toy_torch") == ["broken", "big",
                                                   "positive"]
    assert ImplBackend.call("positive", 50) == ("positive", 50)
    with tflags.flag_overrides(enforce_eager=True), jflags(enforce_eager=True):
        assert fns["torch"](20) == fns["jax"](20) == ("fallback", 20)
    with pytest.raises(RuntimeError, match="more than once"):
        ImplBackend.register("toy_torch", req=lambda x: True)(
            ImplBackend._fn_registry["big"])
    with pytest.raises(KeyError):
        ImplBackend.call("missing")

    @ImplBackend.register("toy_torch", req=lambda x: True,
                          priority="disable")
    def never(x):
        return ("never", x)

    assert fns["torch"](20) == ("big", 20)
    assert ImplBackend.call("never", 1) == ("never", 1)


def test_logger_version_and_metadata_match_jax(monkeypatch):
    from compressed_tensors_tpu.quantization import quant_metadata as jmeta
    from compressed_tensors_tpu_torch.quantization import (
        quant_metadata as tmeta,
    )
    from compressed_tensors_tpu_torch.version import __version__

    tlog = importlib.import_module("compressed_tensors_tpu_torch.logger")
    assert __version__ == jct.__version__ == tct.__version__
    assert tmeta.ALL_QPARAM_KEYS == jmeta.ALL_QPARAM_KEYS
    assert [t.value for t in tmeta.KVCacheScaleType] == \
        [t.value for t in jmeta.KVCacheScaleType]
    for name in ("a.k_scale", "a.weight_scale", "a.input_global_scale",
                 "a.weight", "a.weight_shape", "b.q_scale", "c.bias"):
        assert tmeta.is_quantization_param(name) == \
            jmeta.is_quantization_param(name)

    seen = []
    monkeypatch.setattr(tlog.logger, "log",
                        lambda level, msg, *a: seen.append(msg % a))
    tlog.log_once(logging.INFO, "once %d", 1)
    tlog.log_once(logging.INFO, "once %d", 1)
    tlog.log_once(logging.INFO, "once %d", 2)
    assert seen == ["once 1", "once 2"]
    monkeypatch.setenv("CT_TORCH_LOG_DISABLED", "1")
    disabled = tlog.logger.disabled
    try:
        tlog.configure_logger()
        assert tlog.logger.disabled
    finally:
        tlog.logger.disabled = disabled


def test_top_level_exports_match_jax():
    jnames = {n for n in dir(jct) if not n.startswith("_")}
    tnames = {n for n in dir(tct) if not n.startswith("_")}
    # submodule names that imports bind on the package are no exports
    modules = {"compressors", "config", "flags", "logger", "ops",
               "quantization", "utils", "version", "offload", "registry",
               "models", "engine", "modeling", "linear", "transform",
               "parallel", "distributed", "entrypoints", "interop"}
    missing = (jnames - modules) - tnames
    assert missing == NOT_YET_PORTED
    assert tct.__version__ == jct.__version__


def test_dtype_helpers_match_jax():
    """``is_float_dtype``, ``dtype_bits`` and the finfo helpers on every
    dtype both packages name: equal values, and ValueError for the
    integer and bool dtypes in both."""
    from compressed_tensors_tpu.utils import dtypes as jdt
    from compressed_tensors_tpu_torch.utils import dtypes as tdt

    names = sorted(set(jdt._NAME_TO_DTYPE) & set(tdt._NAME_TO_DTYPE))
    assert len(names) >= 17
    for name in names:
        j, t = jdt._NAME_TO_DTYPE[name], tdt._NAME_TO_DTYPE[name]
        assert tdt.is_float_dtype(t) == jdt.is_float_dtype(j), name
        assert tdt.dtype_bits(t) == jdt.dtype_bits(j), name
        for fn in ("finfo_max", "finfo_min", "finfo_eps"):
            try:
                want = getattr(jdt, fn)(j)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(tdt, fn)(t)
            else:
                assert getattr(tdt, fn)(t) == want, (name, fn)


def test_compressed_linear_is_a_raising_stub():
    from compressed_tensors_tpu_torch.linear import CompressedLinear

    with pytest.raises(NotImplementedError):
        CompressedLinear()
    with pytest.raises(NotImplementedError):
        CompressedLinear.from_linear(None)
