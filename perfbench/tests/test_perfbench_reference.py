"""The plain reference against the port's non-kernel path (f32, no
kernels, no cache) at a tiny size, and the fp8 control against it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.models import dense_gqa as model
from perfbench.reference import dense_gqa as reference
from perfbench.tests.tiny import TINY_WIDTHS

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["qwen2.5-7b-w4a16", "qwen3-8b-w4a16"]


def tiny(name):
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{name}.json").read_text())
    cfg.update(TINY_WIDTHS)
    return cfg


def _f32(raw):
    """The drawn tensors with every float leaf in f32 (the scales too, so
    that the port's dequantization, which multiplies in the scales' dtype,
    is exact as the reference's is)."""
    out = {k: v.float() for k, v in raw.items() if k != "layers"}
    out["layers"] = {}
    for name, v in raw["layers"].items():
        if isinstance(v, dict):
            v = dict(v, scales=v["scales"].float(),
                     bias=None if v["bias"] is None else v["bias"].float())
        else:
            v = v.float()
        out["layers"][name] = v
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_ports_non_kernel_path(name):
    from compressed_tensors_tpu_torch.models.llama import llama_forward

    cfg = tiny(name)
    raw = model.draw(cfg, 2**31 + 3, "cpu")
    params, config = model.serve_params(_f32(raw), cfg)
    ids = torch.randint(0, cfg["vocab_size"], (1, 40),
                        generator=torch.Generator().manual_seed(0))
    pos = torch.arange(40)[None]
    got, _ = llama_forward(params, config, ids, pos, use_kernels=False)
    want = reference.logits(cfg, raw, [ids[0].tolist()],
                            [list(range(40))], "cpu")[0]
    assert got.dtype == torch.float32
    err = (got[0] - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("name", CONFIGS)
def test_dequantize_reads_the_packed_codes(name):
    cfg = tiny(name)
    raw = model.draw(cfg, 9, "cpu")
    lin = raw["layers"]["q_proj"]
    w = reference.dequantize(lin["words"][0], lin["scales"][0], 128)
    codes = w / lin["scales"][0].float().repeat_interleave(128, dim=1)
    codes = codes.round()
    assert codes.min() >= -7 and codes.max() <= 7
    # every one of the 15 codes is drawn, with mean near 0
    assert len(torch.unique(codes)) == 15 and abs(codes.mean()) < 0.1
    # the words' nibble j is code j + 8
    nib = (lin["words"][0][0, 0].item() >> 4) & 15
    assert codes[0, 1].item() == nib - 8


def test_same_seed_same_draw():
    cfg = tiny(CONFIGS[1])
    a, b = model.draw(cfg, 77, "cpu"), model.draw(cfg, 77, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["layers"]["down_proj"]["words"],
                       b["layers"]["down_proj"]["words"])
    c = model.draw(cfg, 78, "cpu")
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("name", CONFIGS)
def test_control_reads_far_above_the_bf16_path(name):
    """At a tiny size on the CPU: the gaps of the tokens that the fp8
    control puts first are far wider than those of the port's bf16 path
    serving the same prompts."""
    from compressed_tensors_tpu_torch.engine import Request, ServingEngine

    cfg = tiny(name)
    raw = model.draw(cfg, 21, "cpu")
    params, config = model.serve_params(raw, cfg)
    eng = ServingEngine(params, config, max_batch=4, max_len=128,
                        prefill_chunk=32, paged=True, page_size=16,
                        dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(8):
        eng.submit(Request(i, rng.integers(0, 512, 40).tolist(),
                           max_new_tokens=24))
    done = eng.run()
    picked = [(c.prompt_ids, c.output_ids, 0) for c in done]
    served = check.served_gaps(reference, cfg, raw, picked, "cpu")
    ctl = check.control_gaps(reference, cfg, raw, picked, "cpu")
    assert served.size == ctl.size == 8 * 24
    assert ctl.max() > 3 * served.max()
