"""Non-4-bit WnA16 group checkpoints (W8A16 and the other widths) and
W4A16 under ``w4_layout="e8"`` in the PyTorch port against the JAX
package, in f32 on the CPU.

- The grouped-int8 matmul (the port's ``w4_e8_matmul`` wrapper, its plain
  version on the CPU) within 1e-5 * max|y| of the JAX Pallas kernel
  ``w4_e8_matmul`` in interpret mode, and both non-kernel paths.
- 8-bit asymmetric weights stay on the non-kernel path in both packages;
  ``w4_layout="packed"`` runs the plane layout in the port
  (``tests/test_torch_w4_planes.py``) where the JAX dispatch raises.
- A tiny W8A16 (g128) checkpoint loaded by both packages: the same greedy
  tokens, prefill logits within 1e-4 * max|logits|, the same
  ``ServingEngine`` completions dense and paged.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.compressors import PackedQuantizationCompressor
from compressed_tensors_tpu.engine import (
    Request as JRequest,
    ServingEngine as JEngine,
    greedy_generate as j_generate,
    make_step_fns as j_steps,
)
from compressed_tensors_tpu.flags import flag_overrides as j_flags
from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.ops import calculate_qparams as j_qparams
from compressed_tensors_tpu.ops.linear import (
    from_compressed_state as j_from_state,
    prepare_for_kernels as j_prepare,
    quantized_matmul as j_matmul,
)
from compressed_tensors_tpu.quantization import (
    QuantizationScheme as JScheme,
)
from testing_utils import make_tiny_llama_checkpoint

from compressed_tensors_tpu_torch.engine import (
    Request,
    ServingEngine,
    greedy_generate,
    make_step_fns,
)
from compressed_tensors_tpu_torch.flags import flag_overrides
from compressed_tensors_tpu_torch.models import llama as tl
from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    from_compressed_state,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.quantization import (
    QuantizationScheme,
    preset_name_to_scheme,
)

from torch_port_utils import TORCH_TINY_CONFIG, preset_config, to_torch


def _both(rng, num_bits, group_size, symmetric, n=48, k=256):
    """A pack-quantized linear compressed by the JAX package, in both
    packages (JAX, port)."""
    weights = {"num_bits": num_bits, "type": "int", "strategy": "group",
               "group_size": group_size, "symmetric": symmetric}
    j_scheme = JScheme(targets=["Linear"], weights=weights)
    w = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    g = w.reshape(n, -1, group_size)
    scale, zp = j_qparams(jnp.asarray(g.min(-1)), jnp.asarray(g.max(-1)),
                          j_scheme.weights)
    state = {"weight": jnp.asarray(w), "weight_scale": scale}
    if not symmetric:
        state["weight_zero_point"] = zp
    compressed = PackedQuantizationCompressor.compress(state, j_scheme)
    jqt = j_from_state(compressed, j_scheme)
    tqt = from_compressed_state(
        {key: to_torch(np.asarray(v)) for key, v in compressed.items()},
        QuantizationScheme(targets=["Linear"], weights=weights))
    return jqt, tqt


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


CASES = {"W8A16-g128": (8, 128, True, "auto"),
         "W3A16-g32-asym": (3, 32, False, "auto"),
         "W4A16-e8": (4, 128, True, "e8")}


@pytest.mark.parametrize("case", list(CASES))
def test_e8_matmul_matches_jax_kernel(case):
    num_bits, group_size, symmetric, layout = CASES[case]
    rng = np.random.default_rng(num_bits)
    jqt, tqt = _both(rng, num_bits, group_size, symmetric)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    with j_flags(pallas_interpret=True, w4_layout=layout):
        jk = j_prepare(jqt)
        want_kernel = j_matmul(jnp.asarray(x), jk, use_kernels=True)
    with flag_overrides(w4_layout=layout):
        tk = prepare_for_kernels(tqt)
    assert jk.kernel_meta[0] == "w4e8"
    assert tk.kernel_meta == ("w4e8", 48, 256, group_size)
    assert tk.kernel_packed.dtype == torch.int8
    # the JAX layout is (K, N), K zero-padded to its k-tile
    np.testing.assert_array_equal(tk.kernel_packed.numpy(),
                                  np.asarray(jk.kernel_packed)[:256].T)
    _close(quantized_matmul(torch.from_numpy(x), tk), want_kernel, 1e-5)
    _close(quantized_matmul(torch.from_numpy(x), tqt, use_kernels=False),
           j_matmul(jnp.asarray(x), jqt, use_kernels=False), 1e-5)


def test_w8a16_asym_and_packed_layout():
    """8-bit asymmetric stays on the non-kernel path in both packages;
    w4_layout="packed" (and "e8" on asymmetric W4) prepares the int32
    8-plane layout, which the port's dispatch runs in ``w4_mode`` (the
    plane kernel's plain version here), while the JAX dispatch raises
    there (ROADMAP C)."""
    rng = np.random.default_rng(9)
    jqt, tqt = _both(rng, 8, 32, False, n=16, k=64)
    assert j_prepare(jqt).kernel_packed is None
    assert prepare_for_kernels(tqt).kernel_meta is None

    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    for symmetric, layout in ((True, "packed"), (False, "e8")):
        jqt, tqt = _both(rng, 4, 128, symmetric)
        with flag_overrides(w4_layout=layout):
            tk = prepare_for_kernels(tqt)
        assert tk.kernel_meta == ("w4packed", 48, 256, 128)
        assert tk.kernel_packed.shape == (1024 // 8, 48)  # K padded to 8g
        want = j_matmul(jnp.asarray(x.numpy()), jqt, use_kernels=False)
        _close(quantized_matmul(x, tk), want, 1e-5)
        _close(quantized_matmul(x, tk, use_kernels=False), want, 1e-5)
        with j_flags(pallas_interpret=True, w4_layout=layout):
            with pytest.raises(UnboundLocalError):
                j_matmul(jnp.asarray(x.numpy()), j_prepare(jqt),
                         use_kernels=True)


def test_synthetic_w8a16_pack_quantized():
    """A W8A16 pack-quantized linear drawn as the synthetic pack-quantized
    weights are (random int32 words, bf16 group scales; chip_smoke.py
    phase 8 draws its 8B model so) prepares the grouped-int8 layout; its
    kernel path equals the non-kernel path on f32 copies of the scales (on
    bf16 scales that path rounds every weight to bf16, ROADMAP C)."""
    rng = np.random.default_rng(1)
    n, k = 128, 256
    scheme = preset_name_to_scheme("W8A16", ["Linear"])
    qt = prepare_for_kernels(QuantizedTensor(
        weight_packed=torch.from_numpy(rng.integers(
            -(2**31), 2**31, size=(n, k // 4), dtype=np.int32)),
        scale=torch.from_numpy(rng.uniform(1e-3, 3e-3, (n, k // 128)).astype(
            np.float32)).to(torch.bfloat16),
        shape=(n, k), scheme=scheme, format="pack-quantized"))
    assert qt.kernel_meta == ("w4e8", 128, 256, 128)
    x = torch.randn(3, 256, generator=torch.Generator().manual_seed(0))
    y = quantized_matmul(x, qt)
    ref = quantized_matmul(x, dataclasses.replace(qt, scale=qt.scale.float()),
                           use_kernels=False)
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.fixture(scope="module")
def w8a16_models(tmp_path_factory):
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path_factory.mktemp("w8a16")),
        np.random.default_rng(0), preset_config("W8A16", "pack-quantized"),
        model_config=TORCH_TINY_CONFIG)
    jp, jc, _ = jl.load_llama_params(path, dtype=jnp.float32,
                                     use_kernels=False)
    tp, tc, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
    return jp, jc, fuse_llama_layers(tp), tc


def test_w8a16_greedy_matches_jax(w8a16_models):
    jp, jc, tp, tc = w8a16_models
    assert tp["layers"][0]["qkv_proj"].kernel_meta[0] == "w4e8"
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
def test_w8a16_serving_matches_jax(w8a16_models, paged):
    jp, jc, tp, tc = w8a16_models
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


@pytest.mark.parametrize("m", [1, 16, 17, 64, 65, 128, 300, 512])
def test_wna16_plan(m):
    """The grouped-weight kernels' launch plan at the 8B shapes and a tiny
    one: decode rows take the fewest of 16, 32 or 64 rows that hold M,
    prefill rows 128; a split is a cluster of 1-8 blocks that covers every
    64-deep k-tile and leaves no block empty."""
    from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
        wna16_design,
        wna16_plan,
    )

    for n, k in ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                 (100, 96)):
        bm, splits, per = wna16_plan(m, n, k)
        tiles = -(-k // 64)
        if wna16_design(m) == "decode":
            assert m <= 64 and bm == min(b for b in (16, 32, 64) if m <= b)
        else:
            assert m > 64 and bm == 128
        assert 1 <= splits <= min(8, tiles)
        assert (splits - 1) * per < tiles <= splits * per
