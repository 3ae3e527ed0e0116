"""The roofline arithmetic on hand-worked shapes (the byte and operation
bounds of PERF.md's kernel table, H100 SXM at 3.35 TB/s)."""

import pytest

from perfbench import roofline

# Llama-3-8B's four fused linears of one layer: qkv, o, gate_up, down
LAYER_8B = ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336))


def _layer_ms(m, act):
    total = 0.0
    for n, k in LAYER_8B:
        ops, nbytes, peak = roofline.w4a16(m, n, k, 128, act)
        total += roofline.bound_s(ops, nbytes, peak)
    return total * 1e3


def test_b1_decode_rows_are_byte_bound():
    # PERF.md row 1: 0.0372 ms (bytes) at M = 64
    assert _layer_ms(64, "bf16") == pytest.approx(0.0372, abs=5e-5)
    ops, nbytes, _ = roofline.w4a16(64, 4096, 4096, 128, "bf16")
    assert ops == 2 * 64 * 4096 * 4096
    assert nbytes == 4096 * 4096 // 2 + 32 * 4096 * 4 + 2 * 64 * 4096 * 2


def test_b2_prefill_rows_are_op_bound():
    # PERF.md row 2: 0.1129 ms (operations, int8 peak) at M = 512
    assert _layer_ms(512, "int8") == pytest.approx(0.1129, abs=1e-4)


def test_b4_chunk():
    # PERF.md row 4: one 8B chunk (S 512, H 32, KVH 8, D 128), 0.0031 ms
    ops, nbytes, peak = roofline.prefill_attention(1, 512, 32, 8, 128)
    assert ops == 4 * 32 * (512 * 513 // 2) * 128
    assert nbytes == 512 * 128 * 2 * (64 + 16)
    assert roofline.bound_s(ops, nbytes, peak) * 1e3 == pytest.approx(
        0.0031, abs=5e-5)


def test_b7_step():
    # two active rows with 100 and 300 cached tokens, one inactive
    ops, nbytes, _ = roofline.paged_decode([100, -1, 300], 32, 8, 128)
    assert ops == 4 * 32 * 128 * (400 + 2)
    assert nbytes == (2 * 2 * 128 * (64 + 16) + 2 * 2 * 16 * 128
                      + 2 * 400 * 16 * 128)


def test_model_flops():
    cfg = {"hidden_size": 4096, "intermediate_size": 12288,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "head_dim": 128, "num_hidden_layers": 36, "vocab_size": 151936}
    assert roofline.linear_params(cfg) == 4096 * 6144 + 4096 * 4096 + \
        3 * 4096 * 12288
    # one token at position 0: its linears, one (query, key) pair, a head
    f = roofline.model_flops(cfg, 1, 1, 1)
    assert f == 36 * (2 * 192937984 + 4 * 32 * 128) + 2 * 151936 * 4096
    assert roofline.causal_pairs(0, 3) == 6
    assert roofline.causal_pairs(10, 2) == 10 * 2 + 3


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::int4b::dec::decode_kernel<4>(x)", "B1"),
    ("(anonymous namespace)::int4b::pre::prefill_kernel(__nv_bfloat16 "
     "const*)", "B1"),
    ("void (anonymous namespace)::a8b::w4a8_kernel<false, true>(x)", "B2"),
    ("void ct::quantize_rows_a8b_kernel(x)", "B2"),
    ("void (anonymous namespace)::prefill_kernel<128>(x)", "B4"),
    ("void (anonymous namespace)::split_kernel<128, true, 0>(x)", "B7"),
    ("void (anonymous namespace)::split_kernel<128, false, 0>(x)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(x)", None),
])
def test_kernel_names(name, kernel):
    assert roofline.kernel_of(name) == kernel


def test_merge_pass_follows_its_split():
    merge = "void (anonymous namespace)::merge_kernel<128, false>(x)"
    assert roofline.kernel_of(merge, "B7") == "B7"
    assert roofline.kernel_of(merge, None) is None
