"""NVFP4 / MXFP4 (and the MXFP8 codec) in the PyTorch port against the JAX
package, in f32 on the CPU.

- Codecs bit for bit: E2M1 rounding, nibble packing, the E8M0 scale codec,
  ``calculate_qparams`` with global and MX scales, ``generate_gparam`` and
  the three formats' compress.
- The fp4 matmul (the port's kernel wrapper, its plain version on the CPU)
  within 1e-5 * max|y| of the JAX Pallas kernel in interpret mode, and the
  non-kernel paths of both packages.
- Tiny NVFP4A16 checkpoints, with per-tensor global scales or one per fused
  group, loaded by both packages: the same greedy tokens, prefill logits
  within 1e-4 * max|logits|, the same ``ServingEngine`` completions dense
  and paged.
- Fusion: members with unequal global scales stay unfused in the port, so
  its output equals the JAX package's unfused output (the JAX fused
  non-kernel path applies q_proj's global scale to k and v; ROADMAP C).

Where XLA on the CPU is not exact the JAX package is not either: it takes
log2 as log(x) / log(2), so floor(log2(2^e)) comes out e - 1 for some e
(in f32: 13, 15, 26, ... and every subnormal), and it flushes subnormal
results such as 2^-127 to zero. The port computes both exactly; the
tests compare bits on the exponents XLA gets right and hold the rest to
the exact values.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.compressors import get_compressor as j_codec
from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
    greedy_generate as j_generate,
    make_step_fns as j_steps,
)
from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.ops import fp4 as j_fp4
from compressed_tensors_tpu.ops import fp4_pack as j_pack
from compressed_tensors_tpu.ops import mx as j_mx
from compressed_tensors_tpu.ops.fuse import fuse_quantized_tensors as j_fuse
from compressed_tensors_tpu.ops.linear import (
    from_compressed_state as j_from_state,
    prepare_for_kernels as j_prepare,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.ops.qparams import (
    calculate_qparams as j_qparams,
    generate_gparam as j_gparam,
)
from compressed_tensors_tpu.quantization import (
    preset_name_to_scheme as j_preset,
)

from compressed_tensors_tpu_torch.compressors import get_compressor
from compressed_tensors_tpu_torch.engine import (
    Request,
    ServingEngine,
    greedy_generate,
    make_step_fns,
)
from compressed_tensors_tpu_torch.interop import params_from_numpy
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.ops import fp4, fp4_pack, mx
from compressed_tensors_tpu_torch.ops.fuse import (
    fuse_llama_layers,
    fuse_quantized_tensors,
)
from compressed_tensors_tpu_torch.ops.linear import (
    from_compressed_state,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.ops.qparams import (
    calculate_qparams,
    generate_gparam,
)
from compressed_tensors_tpu_torch.quantization import preset_name_to_scheme

from torch_port_utils import (
    jax_params_to_numpy,
    make_tiny_fp4_checkpoint,
    to_torch,
)

FORMATS = {"NVFP4A16": "nvfp4-pack-quantized",
           "MXFP4A16": "mxfp4-pack-quantized",
           "MXFP8A16": "mxfp8-quantized"}
# exponents e whose floor(log2(2^e)) XLA computes exactly in f32
XLA_EXACT_EXP = list(range(-126, 13))


def _bits(a) -> np.ndarray:
    """The raw bits of a float tensor / array as unsigned integers."""
    if isinstance(a, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        a = a.view(ints[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cast_to_fp4_bit_exact(dtype):
    thresholds = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0],
                          np.float32)
    grid = np.concatenate([
        thresholds, np.nextafter(thresholds, 0), np.nextafter(thresholds, 9),
        np.array(fp4.FP4_VALUES, np.float32), [0.0, 7.0, 100.0, 1e-30],
        np.random.default_rng(0).uniform(0, 8, 500).astype(np.float32)])
    grid = np.concatenate([grid, -grid]).astype(np.float32)
    x = jnp.asarray(grid, getattr(jnp, dtype))
    want = j_fp4.cast_to_fp4(x)
    got = fp4.cast_to_fp4(to_torch(np.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got)[grid.size // 2 + list(grid).index(0.0)] == \
        _bits(np.array(-0.0, np.asarray(x).dtype))  # -0.0 keeps its sign


def test_fp4_pack_unpack_bit_exact():
    rng = np.random.default_rng(1)
    values = np.array(fp4.FP4_VALUES + tuple(-v for v in fp4.FP4_VALUES),
                      np.float32)
    x = rng.choice(values, size=(6, 40)).astype(np.float32)
    packed = fp4_pack.pack_fp4_to_uint8(torch.from_numpy(x))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(j_pack.pack_fp4_to_uint8(jnp.asarray(x))))
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for dtype in ("float32", "bfloat16"):
        want = j_pack.unpack_fp4_from_uint8(jnp.asarray(every), 16, 32,
                                            dtype=getattr(jnp, dtype))
        got = fp4_pack.unpack_fp4_from_uint8(torch.from_numpy(every), 16, 32,
                                             dtype=getattr(torch, dtype))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mx_scale_codecs():
    # E8M0 codes -> scales: bit for bit but code 0 (2^-127, which XLA
    # flushes to zero)
    codes = np.arange(256, dtype=np.uint8)
    want = _bits(j_mx.decompress_mx_scale(jnp.asarray(codes)))
    got = _bits(mx.decompress_mx_scale(torch.from_numpy(codes)))
    np.testing.assert_array_equal(got[1:], want[1:])
    assert mx.decompress_mx_scale(torch.tensor([0], dtype=torch.uint8)
                                  ).item() == 2.0 ** -127
    mx4 = (j_preset("MXFP4A16", ["Linear"]).weights,
           preset_name_to_scheme("MXFP4A16", ["Linear"]).weights)
    exps = np.arange(1, 256).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(mx.maybe_convert_from_mx_exp(mx4[1], torch.from_numpy(exps))),
        _bits(j_mx.maybe_convert_from_mx_exp(mx4[0], jnp.asarray(exps))))

    # scales -> codes and the exponent of rounded maxima
    e = np.array(XLA_EXACT_EXP, np.float64)
    scales = (2.0 ** e).astype(np.float32)
    np.testing.assert_array_equal(
        mx.compress_mx_scale(torch.from_numpy(scales)).numpy(),
        np.asarray(j_mx.compress_mx_scale(jnp.asarray(scales))))
    maxima = (scales * np.random.default_rng(2).uniform(1, 2, scales.size)
              ).astype(np.float32)
    for fn in ("round_to_power_2", "generate_mx_scales"):
        np.testing.assert_array_equal(
            _bits(getattr(mx, fn)(torch.from_numpy(maxima))),
            _bits(getattr(j_mx, fn)(jnp.asarray(maxima))))
    # where XLA's log2 is not exact, the port's exponents are
    every = np.arange(-149, 128, dtype=np.float64)
    np.testing.assert_array_equal(
        mx.compress_mx_scale(torch.from_numpy((2.0 ** every).astype(
            np.float32)), torch.int32).numpy(), 127 + every)
    bf = torch.from_numpy((2.0 ** np.arange(-126, 128)).astype(
        np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(
        mx.generate_mx_scales(bf).float().numpy(),
        127 + np.arange(-126, 128) - 2)


@pytest.mark.parametrize("preset", list(FORMATS))
def test_qparams_bit_exact(preset):
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(16, 128)) * 0.05).astype(np.float32)
    j_args = j_preset(preset, ["Linear"]).weights
    t_args = preset_name_to_scheme(preset, ["Linear"]).weights
    j_global = t_global = None
    if preset.startswith("NVFP4"):
        j_global = j_gparam(jnp.asarray(w.min()), jnp.asarray(w.max()))
        t_global = generate_gparam(torch.tensor(w.min()),
                                   torch.tensor(w.max()))
        np.testing.assert_array_equal(_bits(t_global), _bits(j_global))
    g = w.reshape(16, -1, j_args.group_size)
    want = j_qparams(jnp.asarray(g.min(-1)), jnp.asarray(g.max(-1)), j_args,
                     global_scale=j_global)
    got = calculate_qparams(torch.from_numpy(g.min(-1)),
                            torch.from_numpy(g.max(-1)), t_args,
                            global_scale=t_global)
    for a, b in zip(got, want):
        assert a.dtype == to_torch(np.asarray(b)).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _dense_state(rng, preset, n, k):
    """A dense module state with the JAX package's qparams (numpy)."""
    w = (rng.normal(size=(n, k)) * 0.05).astype(np.float32)
    args = j_preset(preset, ["Linear"]).weights
    state = {"weight": w}
    global_scale = None
    if preset.startswith("NVFP4"):
        global_scale = j_gparam(jnp.asarray(w.min()), jnp.asarray(w.max()))
        state["weight_global_scale"] = np.asarray(global_scale)
    g = w.reshape(n, -1, args.group_size)
    state["weight_scale"] = np.asarray(j_qparams(
        jnp.asarray(g.min(-1)), jnp.asarray(g.max(-1)), args,
        global_scale=global_scale)[0])
    return state


@pytest.mark.parametrize("preset", list(FORMATS))
def test_compress_bit_exact(preset):
    state = _dense_state(np.random.default_rng(4), preset, 24, 96)
    want = j_codec(FORMATS[preset]).compress(
        {k: jnp.asarray(v) for k, v in state.items()},
        j_preset(preset, ["Linear"]))
    got = get_compressor(FORMATS[preset]).compress(
        {k: to_torch(v) for k, v in state.items()},
        preset_name_to_scheme(preset, ["Linear"]))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))


def _both(rng, preset, n, k):
    """The same compressed linear in both packages (JAX, port)."""
    state = _dense_state(rng, preset, n, k)
    compressed = {key: np.asarray(v) for key, v in j_codec(FORMATS[preset])
                  .compress({key: jnp.asarray(v) for key, v in state.items()},
                            j_preset(preset, ["Linear"])).items()}
    jqt = j_from_state({key: jnp.asarray(v) for key, v in compressed.items()},
                       j_preset(preset, ["Linear"]))
    tqt = from_compressed_state({key: to_torch(v)
                                 for key, v in compressed.items()},
                                preset_name_to_scheme(preset, ["Linear"]))
    return jqt, tqt


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("preset,k", [("NVFP4A16", 128), ("NVFP4A16", 96),
                                      ("MXFP4A16", 128)])
def test_fp4_matmul_matches_jax_kernel(preset, k):
    rng = np.random.default_rng(5)
    jqt, tqt = _both(rng, preset, 40, k)
    x = rng.standard_normal((3, k)).astype(np.float32)
    with j_flags(pallas_interpret=True):
        want_kernel = j_matmul(jnp.asarray(x), j_prepare(jqt),
                               use_kernels=True)
    tk = prepare_for_kernels(tqt)
    assert tk.kernel_meta == ("fp4", 40, k, jqt.scheme.weights.group_size)
    assert tk.kernel_packed.dtype == torch.uint8
    got = quantized_matmul(torch.from_numpy(x), tk)
    _close(got, want_kernel, 1e-5)
    _close(quantized_matmul(torch.from_numpy(x), tqt, use_kernels=False),
           j_matmul(jnp.asarray(x), jqt, use_kernels=False), 1e-5)


def test_unequal_global_scales_stay_unfused():
    """q/k/v with their own global scales: the port keeps them apart and
    equals the JAX package's unfused output; the JAX fused non-kernel path
    applies q's global scale to all three and moves k and v."""
    rng = np.random.default_rng(6)
    pairs = [_both(rng, "NVFP4A16", n, 128) for n in (64, 32, 32)]
    x = jnp.asarray(rng.standard_normal((2, 128)).astype(np.float32))
    assert fuse_quantized_tensors([t for _, t in pairs]) is None
    unfused = np.concatenate([np.asarray(j_matmul(x, j, use_kernels=False))
                              for j, _ in pairs], -1)
    ours = torch.cat([quantized_matmul(torch.from_numpy(np.array(x)),
                                       prepare_for_kernels(t))
                      for _, t in pairs], -1)
    _close(ours, unfused, 1e-5)
    fused = np.asarray(j_matmul(x, j_fuse([j for j, _ in pairs]),
                                use_kernels=False))
    np.testing.assert_allclose(fused[:, :64], unfused[:, :64], rtol=1e-5)
    assert np.abs(fused[:, 64:] - unfused[:, 64:]).max() > \
        0.1 * np.abs(unfused).max()
    # equal global scales fuse
    for _, t in pairs:
        t.global_scale = pairs[0][1].global_scale
    fused_t = fuse_quantized_tensors([prepare_for_kernels(t)
                                      for _, t in pairs])
    assert fused_t.kernel_meta == ("fp4", 128, 128, 16)


@pytest.fixture(scope="module")
def fp4_models(tmp_path_factory):
    """name -> (JAX params fused as the case needs, JAX config, port
    params fused, port config)."""
    out = {}
    for name, fused_global in (("per-tensor", False), ("fused-global", True)):
        path = make_tiny_fp4_checkpoint(
            pathlib.Path(tmp_path_factory.mktemp(name)),
            np.random.default_rng(0), fused_global=fused_global)
        jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                         use_kernels=False)
        tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32,
                                         device="cpu")
        out[name] = (jp, jc, fuse_llama_layers(tp), tc, path)
    return out


@pytest.mark.parametrize("name", ["per-tensor", "fused-global"])
def test_nvfp4_greedy_matches_jax(fp4_models, name):
    jp, jc, tp, tc, _ = fp4_models[name]
    layer = tp["layers"][0]
    # per-tensor global scales leave q/k/v and gate/up unfused
    assert ("qkv_proj" in layer) == (name == "fused-global")
    assert ("gate_up_proj" in layer) == (name == "fused-global")
    proj = layer.get("qkv_proj") or layer["q_proj"]
    assert proj.kernel_meta[0] == "fp4"
    ids = np.random.default_rng(7).integers(0, 512, size=(2, 10))
    want = np.asarray(j_generate(jp, jc, jnp.asarray(ids, jnp.int32),
                                 max_new_tokens=6, dtype=jnp.float32,
                                 use_kernels=False))
    got = greedy_generate(tp, tc, ids, max_new_tokens=6, dtype=torch.float32,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, j_logits = j_steps(jc, 16, dtype=jnp.float32, use_kernels=False)[0](
        jp, jnp.asarray(ids, jnp.int32), 10)
    _, _, t_logits = make_step_fns(tc, 16, dtype=torch.float32,
                                   device="cpu")[0](tp, torch.from_numpy(ids),
                                                    10)
    _close(t_logits, j_logits, 1e-4)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nvfp4_serving_matches_jax(fp4_models, paged):
    jp, jc, tp, tc, _ = fp4_models["per-tensor"]
    settings = dict(max_batch=2, max_len=32, prefill_chunk=8,
                    steps_per_sync=2)
    if paged:
        settings.update(paged=True, page_size=8)
    j_eng = JEngine(jp, jc, dtype=jnp.float32, use_kernels=False, **settings)
    t_eng = ServingEngine(tp, tc, dtype=torch.float32, device="cpu",
                          **settings)
    rng = np.random.default_rng(8)
    for rid, n in enumerate((8, 3)):
        prompt = rng.integers(0, 512, size=n).tolist()
        j_eng.submit(JRequest(request_id=rid, prompt_ids=prompt,
                              max_new_tokens=5))
        t_eng.submit(Request(request_id=rid, prompt_ids=prompt,
                             max_new_tokens=5))
    want = {c.request_id: c.output_ids for c in j_eng.run()}
    got = {c.request_id: c.output_ids for c in t_eng.run()}
    assert got == want


def test_params_from_numpy_carries_global_scale(fp4_models):
    jp, _, tp, _, path = fp4_models["per-tensor"]
    carried = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    ours, _, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    for a, b in ((carried["layers"][1]["k_proj"], ours["layers"][1]["k_proj"]),
                 (carried["layers"][0]["down_proj"],
                  ours["layers"][0]["down_proj"])):
        assert a.global_scale is not None
        assert torch.equal(a.global_scale, b.global_scale)
        assert torch.equal(a.kernel_scales, b.kernel_scales)
        assert a.kernel_meta == b.kernel_meta
