"""The port's quantization lifecycle (``quantization/lifecycle.py``) and
its QDQ math (``fake_quantize``, the block strategy) held against the JAX
package's on the same seeded inputs, in f32 on the CPU.

For each preset: the initialized qparams' names, shapes and dtypes are
equal; after min-max calibration the scales, zero points and global
scales are equal bit for bit; the QDQ forward agrees within 1e-6 of
max|ref| (the same f32 operations in the same order: equal in practice);
the compressed codes are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.quantization import lifecycle as jlc
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as jax_preset,
)
from compressed_tensors_tpu_torch.quantization import lifecycle as tlc
from compressed_tensors_tpu_torch.quantization import (
    QuantizationStatus,
    preset_name_to_scheme,
)
from torch_port_utils import raw_bytes, to_numpy, to_torch

PRESETS = ("W4A16", "W4A16_ASYM", "W8A8", "FP8", "FP8_DYNAMIC", "FP8_BLOCK",
           "NVFP4A16", "NVFP4", "MXFP4A16", "MXFP8", "W8A16")
N, K, ROWS = 256, 256, 8
# QDQ outputs: max|port - JAX| <= TOL_QDQ * max|JAX| (same f32 ops)
TOL_QDQ = 1e-6


FP4_PRESETS = ("NVFP4A16", "NVFP4", "MXFP4A16")


def _fp4_codes_match(js, ts, w):
    from compressed_tensors_tpu.ops.quantize import quantize as jquantize
    from compressed_tensors_tpu_torch.ops.quantize import quantize

    gs = ts.qparams.get("weight_global_scale")
    jgs = js.qparams.get("weight_global_scale")
    tcodes = quantize(torch.from_numpy(w), ts.qparams["weight_scale"], None,
                      ts.scheme.weights, global_scale=gs)
    jcodes = jquantize(jnp.asarray(w), js.qparams["weight_scale"], None,
                       js.scheme.weights, global_scale=jgs)
    np.testing.assert_array_equal(to_numpy(tcodes), np.asarray(jcodes))


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.dtype(t.dtype).name


def _inputs(seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * scale).astype(np.float32)
    x = rng.normal(size=(ROWS, K)).astype(np.float32)
    return w, x


def _both(preset, w, x):
    """Initialize, calibrate and QDQ-forward one linear in both packages;
    returns (jax state, port state, jax out, port out, initial qparams)."""
    js = jlc.initialize_module_for_quantization(
        jax_preset(preset, ["Linear"]), (N, K), weight_dtype=jnp.float32)
    ts = tlc.initialize_module_for_quantization(
        preset_name_to_scheme(preset, ["Linear"]), (N, K),
        weight_dtype=torch.float32, device="cpu")
    init = ({k: (tuple(v.shape), _dtype_name(v)) for k, v in js.qparams.items()},
            {k: (tuple(v.shape), _dtype_name(v)) for k, v in ts.qparams.items()})
    jlc.calibrate_module(js, jnp.asarray(w), sample_input=jnp.asarray(x))
    tlc.calibrate_module(ts, torch.from_numpy(w),
                         sample_input=torch.from_numpy(x))
    jout = jlc.quantized_module_forward(jnp.asarray(x), jnp.asarray(w), js)
    tout = tlc.quantized_module_forward(torch.from_numpy(x),
                                        torch.from_numpy(w), ts)
    return js, ts, np.asarray(jout), to_numpy(tout), init


@pytest.mark.parametrize("preset", PRESETS)
def test_lifecycle_matches_jax(preset):
    w, x = _inputs()
    js, ts, jout, tout, (jinit, tinit) = _both(preset, w, x)
    assert jinit == tinit

    assert ts.status == QuantizationStatus.CALIBRATION
    assert sorted(js.qparams) == sorted(ts.qparams)
    for name, jv in js.qparams.items():
        tv = ts.qparams[name]
        assert tuple(jv.shape) == tuple(tv.shape), name
        assert _dtype_name(jv) == _dtype_name(tv), name
        np.testing.assert_array_equal(raw_bytes(tv), raw_bytes(jv),
                                      err_msg=name)

    assert jout.shape == tout.shape == (ROWS, N)
    err = np.abs(tout - jout).max() / np.abs(jout).max()
    assert err <= TOL_QDQ, (preset, err)

    if preset in FP4_PRESETS:
        # no fp4 storage dtype in either package: the fp4 codecs compress
        # these (ModelCompressor); compare the E2M1 values they pack
        with pytest.raises(NotImplementedError):
            jlc.compress_quantized_weights(js, jnp.asarray(w))
        with pytest.raises(NotImplementedError):
            tlc.compress_quantized_weights(ts, torch.from_numpy(w))
        _fp4_codes_match(js, ts, w)
        return
    js, jq = jlc.compress_quantized_weights(js, jnp.asarray(w))
    ts, tq = tlc.compress_quantized_weights(ts, torch.from_numpy(w))
    assert ts.status == js.status == QuantizationStatus.COMPRESSED
    assert _dtype_name(jq) == _dtype_name(tq)
    np.testing.assert_array_equal(raw_bytes(tq), raw_bytes(jq))

    # compressed: the weight is no longer fake-quantized, on both sides
    codes = np.asarray(jq).astype(np.float32)
    jc = jlc.quantized_module_forward(jnp.asarray(x), jnp.asarray(codes), js)
    tc = tlc.quantized_module_forward(torch.from_numpy(x),
                                      torch.from_numpy(codes), ts)
    np.testing.assert_allclose(to_numpy(tc), np.asarray(jc),
                               atol=TOL_QDQ * np.abs(np.asarray(jc)).max())


def test_qdq_gate_and_module_switch():
    """The global gate and the module's own switch turn QDQ off at call
    time (the JAX package reads its gate at trace time; eager calls agree)."""
    w, x = _inputs(1)
    ts = tlc.initialize_module_for_quantization(
        preset_name_to_scheme("W4A16", ["Linear"]), (N, K),
        weight_dtype=torch.float32, device="cpu")
    tlc.calibrate_module(ts, torch.from_numpy(w))
    dense = torch.from_numpy(x) @ torch.from_numpy(w).t()
    qdq = tlc.quantized_module_forward(torch.from_numpy(x),
                                       torch.from_numpy(w), ts)
    assert not torch.equal(qdq, dense)
    tlc.disable_quantization()
    try:
        assert not tlc.quantization_enabled()
        off = tlc.quantized_module_forward(torch.from_numpy(x),
                                           torch.from_numpy(w), ts)
    finally:
        tlc.enable_quantization()
    assert torch.equal(off, dense)
    ts.enabled = False
    assert torch.equal(tlc.quantized_module_forward(
        torch.from_numpy(x), torch.from_numpy(w), ts), dense)
    ts.enabled = True
    assert torch.equal(tlc.quantized_module_forward(
        torch.from_numpy(x), torch.from_numpy(w), ts), qdq)


def test_embedding_forward_skips_output_activations():
    """``quantized_embedding_forward`` fake-quantizes the table and gathers;
    like the JAX package it leaves ``output_activations`` unapplied (the
    upstream library quantizes them: ADVICE.md:3)."""
    from compressed_tensors_tpu.quantization import (
        QuantizationScheme as JScheme,
    )
    from compressed_tensors_tpu_torch.quantization import QuantizationScheme

    rng = np.random.default_rng(2)
    table = (rng.normal(size=(64, K)) * 0.05).astype(np.float32)
    ids = rng.integers(0, 64, size=(3, 5))
    spec = dict(targets=["Embedding"],
                weights=dict(num_bits=8, type="int", symmetric=True,
                             strategy="channel"),
                output_activations=dict(num_bits=8, type="int",
                                        symmetric=True, strategy="token",
                                        dynamic=True))
    js = jlc.initialize_module_for_quantization(
        JScheme(**spec), table.shape, weight_dtype=jnp.float32)
    ts = tlc.initialize_module_for_quantization(
        QuantizationScheme(**spec), table.shape, weight_dtype=torch.float32,
        device="cpu")
    jlc.calibrate_module(js, jnp.asarray(table))
    tlc.calibrate_module(ts, torch.from_numpy(table))
    jout = np.asarray(jlc.quantized_embedding_forward(
        jnp.asarray(ids), jnp.asarray(table), js))
    tout = to_numpy(tlc.quantized_embedding_forward(
        torch.from_numpy(ids), torch.from_numpy(table), ts))
    np.testing.assert_array_equal(tout, jout)
    # the rows are the fake-quantized table's, with no output QDQ over them
    fq = to_numpy(tlc._forward_quantize(ts, torch.from_numpy(table),
                                        "weight", ts.scheme.weights))
    np.testing.assert_array_equal(tout, fq[ids])


@pytest.mark.parametrize("shape,block", [((256, 384), (128, 128)),
                                         ((200, 300), (128, 128)),
                                         ((64, 96), (32, 64))])
def test_block_strategy_matches_jax(shape, block):
    """quantize / dequantize / fake_quantize over blocks (with padding
    where the shape is no multiple of the block) and the strategy a block
    scale's shape implies, bit for bit."""
    import importlib

    from compressed_tensors_tpu.quantization import QuantizationArgs as JArgs
    from compressed_tensors_tpu_torch.ops.qparams import (
        calculate_block_padding,
    )
    from compressed_tensors_tpu_torch.quantization import QuantizationArgs

    jq = importlib.import_module("compressed_tensors_tpu.ops.quantize")
    tq = importlib.import_module("compressed_tensors_tpu_torch.ops.quantize")
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 0.1).astype(np.float32)
    spec = dict(num_bits=8, type="float", strategy="block",
                block_structure=list(block), symmetric=True)
    jargs, targs = JArgs(**spec), QuantizationArgs(**spec)
    pr, pc = calculate_block_padding(shape, block)
    rb, cb = (shape[0] + pr) // block[0], (shape[1] + pc) // block[1]
    scale = (rng.random((rb, cb)) * 1e-3 + 1e-4).astype(np.float32)

    jcodes = jq.quantize(jnp.asarray(x), jnp.asarray(scale), None, jargs)
    tcodes = tq.quantize(torch.from_numpy(x), torch.from_numpy(scale), None,
                         targs)
    np.testing.assert_array_equal(to_numpy(tcodes), np.asarray(jcodes))
    jfq = jq.fake_quantize(jnp.asarray(x), jnp.asarray(scale), None, jargs)
    tfq = tq.fake_quantize(torch.from_numpy(x), torch.from_numpy(scale),
                           None, targs)
    np.testing.assert_array_equal(to_numpy(tfq), np.asarray(jfq))

    if pr == 0 and pc == 0:  # a padded shape does not imply its block
        fp8 = jcodes.astype(jnp.float8_e4m3fn)
        inferred = tq.infer_args_from_scale_shape(shape, scale.shape)
        assert inferred.strategy == "block"
        assert list(inferred.block_structure) == list(block)
        jdq = jq.dequantize(fp8, jnp.asarray(scale))
        tdq = tq.dequantize(to_torch(fp8), torch.from_numpy(scale))
        np.testing.assert_array_equal(to_numpy(tdq), np.asarray(jdq))


@pytest.mark.parametrize("strategy,shape", [("tensor", (256, 256)),
                                            ("channel", (256, 256)),
                                            ("group", (256, 256)),
                                            ("block", (256, 256)),
                                            ("attn_head", (4, 16, 32))])
def test_expected_qparam_shapes_match_jax(strategy, shape):
    from compressed_tensors_tpu.quantization import QuantizationArgs as JArgs
    from compressed_tensors_tpu_torch.quantization import QuantizationArgs

    spec = dict(num_bits=8, type="int", strategy=strategy)
    if strategy == "group":
        spec["group_size"] = 128
    if strategy == "block":
        spec["block_structure"] = [128, 64]
    assert tlc.expected_qparam_shapes(QuantizationArgs(**spec), shape) == \
        jlc.expected_qparam_shapes(JArgs(**spec), shape)


def test_actorder_g_idx_read_once():
    """A GROUP-actorder scheme initializes g_idx to -1 (unset): the QDQ
    forward reads that on the host once per g_idx tensor, not per call;
    a g_idx set later is read again and permutes the groups as in JAX."""
    from compressed_tensors_tpu.quantization import (
        QuantizationScheme as JScheme,
    )
    from compressed_tensors_tpu_torch.quantization import QuantizationScheme

    w, x = _inputs(4)
    spec = dict(targets=["Linear"],
                weights=dict(num_bits=4, type="int", symmetric=True,
                             strategy="group", group_size=128,
                             actorder="group"))
    ts = tlc.initialize_module_for_quantization(
        QuantizationScheme(**spec), (N, K), weight_dtype=torch.float32,
        device="cpu")
    js = jlc.initialize_module_for_quantization(
        JScheme(**spec), (N, K), weight_dtype=jnp.float32)
    assert bool((ts.qparams["weight_g_idx"] == -1).all())
    tlc.calibrate_module(ts, torch.from_numpy(w))
    jlc.calibrate_module(js, jnp.asarray(w))
    reads = []
    for _ in range(3):
        tlc.quantized_module_forward(torch.from_numpy(x),
                                     torch.from_numpy(w), ts)
        reads.append(len(ts._g_idx_set))
    assert reads == [1, 1, 1]

    g_idx = np.random.default_rng(5).permutation(K) // 128
    ts.qparams["weight_g_idx"] = torch.from_numpy(g_idx.astype(np.int32))
    js.qparams["weight_g_idx"] = jnp.asarray(g_idx.astype(np.int32))
    tout = tlc.quantized_module_forward(torch.from_numpy(x),
                                        torch.from_numpy(w), ts)
    jout = jlc.quantized_module_forward(jnp.asarray(x), jnp.asarray(w), js)
    np.testing.assert_allclose(to_numpy(tout), np.asarray(jout),
                               atol=TOL_QDQ * np.abs(np.asarray(jout)).max())
