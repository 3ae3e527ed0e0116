"""Codecs and checkpoint I/O of the PyTorch port against the JAX package:
the int32 packing codec bit for bit, the format codecs' decompress, and
safetensors files read and written by both."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from compressed_tensors_tpu.compressors import get_compressor as j_codec
from compressed_tensors_tpu.ops.pack import (
    pack_to_int32 as j_pack,
    unpack_from_int32 as j_unpack,
)
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)
from compressed_tensors_tpu.utils.safetensors_io import (
    SafetensorsFile as JFile,
    save_safetensors as j_save,
)

from compressed_tensors_tpu_torch.compressors import get_compressor as t_codec
from compressed_tensors_tpu_torch.ops.pack import (
    pack_to_int32,
    unpack_from_int32,
)
from compressed_tensors_tpu_torch.quantization import (
    preset_name_to_scheme as t_preset,
)
from compressed_tensors_tpu_torch.utils.safetensors_io import (
    CheckpointReader,
    SafetensorsFile,
    save_safetensors,
)

from torch_port_utils import to_numpy, to_torch


@pytest.mark.parametrize("packed_dim", [0, 1])
@pytest.mark.parametrize("num_bits", range(1, 9))
def test_pack_unpack_bit_exact(num_bits, packed_dim):
    rng = np.random.default_rng(num_bits * 2 + packed_dim)
    lo, hi = -(1 << (num_bits - 1)), 1 << (num_bits - 1)
    for shape in [(5, 37), (2, 3, 33)]:
        v = rng.integers(lo, hi, size=shape).astype(np.int8)
        want = np.asarray(j_pack(jnp.asarray(v), num_bits, packed_dim))
        got = pack_to_int32(torch.from_numpy(v), num_bits, packed_dim)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        back = unpack_from_int32(got, num_bits, shape, packed_dim)
        np.testing.assert_array_equal(back.numpy(), v)
        # every bit pattern of the words, not only those packing produces
        words = rng.integers(-2**31, 2**31, size=want.shape,
                             dtype=np.int64).astype(np.int32)
        np.testing.assert_array_equal(
            unpack_from_int32(torch.from_numpy(words), num_bits, shape,
                              packed_dim).numpy(),
            np.asarray(j_unpack(jnp.asarray(words), num_bits, shape,
                                packed_dim)))


def _packed_state(rng, preset, n=64, k=256):
    """A pack-quantized / int-quantized module state in numpy; FP4 and MX
    states as the JAX package compresses a random weight."""
    scheme = j_preset(preset, ["Linear"])
    args = scheme.weights
    if preset in FP_FORMATS:
        from compressed_tensors_tpu.ops.qparams import (
            calculate_qparams,
            generate_gparam,
        )

        w = jnp.asarray((rng.normal(size=(n, k)) * 0.05).astype(np.float32))
        state = {"weight": w}
        if preset.startswith("NVFP4"):
            state["weight_global_scale"] = generate_gparam(w.min(), w.max())
        g = w.reshape(n, -1, args.group_size)
        state["weight_scale"] = calculate_qparams(
            g.min(-1), g.max(-1), args,
            global_scale=state.get("weight_global_scale"))[0]
        return {key: np.asarray(v) for key, v in j_codec(
            FP_FORMATS[preset]).compress(state, scheme).items()}
    if preset == "W8A8":
        return {"weight": rng.integers(-128, 128, size=(n, k)).astype(np.int8),
                "weight_scale": rng.uniform(0.001, 0.01, (n, 1)).astype(
                    np.float32)}
    g = args.group_size
    lo, hi = -(1 << (args.num_bits - 1)), 1 << (args.num_bits - 1)
    q = rng.integers(lo, hi, size=(n, k)).astype(np.int8)
    state = {
        "weight_packed": np.asarray(j_pack(jnp.asarray(q), args.num_bits)),
        "weight_scale": rng.uniform(0.001, 0.01, (n, k // g)).astype(
            np.float32),
        "weight_shape": np.asarray([n, k], np.int32),
    }
    if not args.symmetric:
        zp = rng.integers(lo, hi, size=(n, k // g)).astype(np.int8)
        state["weight_zero_point"] = np.asarray(
            j_pack(jnp.asarray(zp), args.num_bits, packed_dim=0))
    return state


FP_FORMATS = {"NVFP4A16": "nvfp4-pack-quantized",
              "MXFP4A16": "mxfp4-pack-quantized",
              "MXFP8A16": "mxfp8-quantized"}


@pytest.mark.parametrize("preset,fmt", [
    ("W4A16", "pack-quantized"), ("W4A16_ASYM", "pack-quantized"),
    ("W8A16", "pack-quantized"), ("W8A8", "int-quantized"),
    *FP_FORMATS.items(),
])
def test_decompress_matches(preset, fmt):
    state = _packed_state(np.random.default_rng(0), preset)
    want = j_codec(fmt).decompress(
        {k: jnp.asarray(v) for k, v in state.items()},
        j_preset(preset, ["Linear"]))
    got = t_codec(fmt).decompress(
        {k: to_torch(v) for k, v in state.items()},
        t_preset(preset, ["Linear"]))
    np.testing.assert_array_equal(to_numpy(got["weight"]),
                                  to_numpy(want["weight"]))


def test_safetensors_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a.weight": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
        "a.weight_packed": torch.from_numpy(
            rng.integers(-2**31, 2**31, (4, 2), dtype=np.int64).astype(
                np.int32)),
        "b.weight": torch.from_numpy(rng.uniform(-400, 400, (2, 8)).astype(
            np.float32)).to(torch.float8_e4m3fn),
        "b.weight_scale": torch.tensor([0.5], dtype=torch.float32),
        "c.empty": torch.zeros((0, 4), dtype=torch.int8),
    }
    ours = str(tmp_path / "ours.safetensors")
    save_safetensors(ours, tensors, metadata={"format": "pt"})
    jf = JFile(ours)
    arrays = {name: np.array(jf.get(name)) for name in tensors}
    jf.close()
    for name, t in tensors.items():
        assert arrays[name].shape == tuple(t.shape)
        assert arrays[name].tobytes() == t.view(torch.uint8).numpy().tobytes()

    theirs = str(tmp_path / "theirs.safetensors")
    j_save(theirs, arrays)
    tf = SafetensorsFile(theirs)
    for name, t in tensors.items():
        got = tf.get(name)
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got.view(torch.uint8), t.view(torch.uint8))
    tf.close()


def test_checkpoint_reader_groups_modules(tmp_path):
    save_safetensors(str(tmp_path / "model.safetensors"), {
        "model.layers.0.mlp.down_proj.weight_packed":
            torch.zeros((2, 2), dtype=torch.int32),
        "model.layers.0.mlp.down_proj.weight_scale": torch.ones((2, 1)),
        "model.layers.0.input_layernorm.weight": torch.ones(4),
        "lm_head.weight": torch.ones((3, 4)),
    })
    reader = CheckpointReader(str(tmp_path))
    assert reader.module_names() == [
        "model.layers.0.mlp.down_proj", "model.layers.0.input_layernorm",
        "lm_head"]
    assert sorted(reader.module_state_dict("model.layers.0.mlp.down_proj")) \
        == ["weight_packed", "weight_scale"]
    reader.close()
