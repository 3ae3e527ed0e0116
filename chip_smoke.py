#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``compressed_tensors_tpu_torch`` (nvcc,
into ``build/``), holds each kernel against its plain PyTorch version at the
shapes of the main path, then drives the main path end to end: a
full-width TinyLlama-1.1B-shape W4A16 checkpoint (W8A8-int lm_head, random
weights from a seed) is written, loaded with ``load_llama_params``, fused,
and decoded greedily at batch 64 (128-token prompts, 32 new tokens). The
first step's logits are held against the same model on the non-kernel
path (``use_kernels=False``), and every kernel must have launched during
the run. Per-kernel times, bounds, plain and library times follow.

The last line of standard output is ``{"ok": true, "device": {...}}``;
any failure raises and exits non-zero. Without a CUDA device, or outside
the repository, it exits non-zero without a result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BPS = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12

BATCH, PROMPT, NEW_TOKENS = 64, 128, 32
# max|kernel - plain| <= TOL * max|plain|: bf16 output rounding (2^-8
# relative) plus a different f32 summation order
TOL_KERNEL = 1e-2
# first-step logits, kernel path vs non-kernel path over 22 layers in
# bf16: each layer rounds activations to bf16 (2^-8) on both sides, in
# other places, and the reference also rounds every dequantized weight to
# bf16 (2^-9); a few such roundings compound over the layers
TOL_E2E = 2e-2


def log(*a):
    print(*a, flush=True)


def eager_ms(fn, iters=5):
    """Median ms of one eager fn() call by CUDA events after a warm-up
    call; host time spent enqueueing counts (used for the plain versions
    and the model steps)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(calls, replays=5):
    """GPU ms per call: the calls are captured in order into one CUDA graph
    and the graph is replayed between CUDA events, so host time is left
    out. Callers rotate operands across the calls so that they add up to
    more than the 50 MB L2 and each call finds its weights cold, as on the
    main path, which reads each weight once per step."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:2]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    times = []
    for _ in range(replays):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(calls))
    return float(np.median(times))


def copies_for(nbytes):
    """How many copies of an operand of ``nbytes`` exceed L2 three times."""
    return max(2, min(32, -(-150 * 2**20 // nbytes)))


def check_close(name, got, want, tol=TOL_KERNEL):
    got, want = got.float(), want.float()
    if not (bool(got.isfinite().all()) and bool(want.isfinite().all())):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"parity {name}: max_abs_err={err:.6g} max|plain|={scale:.6g} "
        f"rel={err / max(scale, 1e-30):.3g} (limit {tol})")
    if err > tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol} * {scale})")
    return err


# --------------------------------------------------------------------- #
# inputs at the main path's shapes

def w4_inputs(rng, n, k, m, device, group=128, asym=False):
    import torch

    w = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(n, k // 8),
                                      dtype=np.int32)).to(device)
    s = torch.from_numpy((rng.uniform(size=(k // group, n)) * 0.002 + 0.001)
                         .astype(np.float32)).to(device)
    zp = (torch.from_numpy(rng.integers(-8, 8, size=(k // group, n))
                           .astype(np.float32)).to(device) if asym else None)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(
        device, torch.bfloat16)
    return x, w, s, zp


W4_SHAPES = {"qkv_proj": (2560, 2048), "o_proj": (2048, 2048),
             "gate_up_proj": (11264, 2048), "down_proj": (2048, 5632)}


def decode_inputs(rng, device, layers=22, s_pad=192):
    import torch

    B, H, KVH, D = BATCH, 32, 4, 64

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device, torch.bfloat16)

    lengths = rng.integers(PROMPT, PROMPT + NEW_TOKENS, size=B).astype(np.int32)
    lengths[[3, 17]] = -1  # inactive rows
    return (bf(B, H, D), bf(B, KVH, D), bf(B, KVH, D), bf(layers, B, KVH, s_pad, D),
            bf(layers, B, KVH, s_pad, D),
            torch.from_numpy(lengths).to(device))


# --------------------------------------------------------------------- #
# phases

def phase_device_and_build():
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import _build

    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cudnn (float32 references run in full "
        "float32)")
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")


def phase_parity():
    """Each kernel against its plain version on the card, bf16 inputs."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        prefill_attention as pa,
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    errs = {}
    e = 0.0
    for name, (n, k) in W4_SHAPES.items():
        for m in (BATCH, BATCH * PROMPT):
            x, w, s, _ = w4_inputs(rng, n, k, m, dev)
            got = w4.w4a16_matmul(x, w, s, None, n=n, k=k, group_size=128)
            want = w4.w4a16_matmul_plain(x, w, s, None, n=n, k=k,
                                         group_size=128)
            e = max(e, check_close(f"w4a16 {name} M={m}", got, want))
    x, w, s, zp = w4_inputs(rng, 2048, 2048, BATCH, dev, asym=True)
    got = w4.w4a16_matmul(x, w, s, zp, n=2048, k=2048, group_size=128)
    want = w4.w4a16_matmul_plain(x, w, s, zp, n=2048, k=2048, group_size=128)
    errs["w4a16_matmul"] = max(e, check_close("w4a16 zero-point", got, want))

    x = torch.from_numpy(rng.standard_normal((BATCH, 2048), dtype=np.float32)
                         ).to(dev, torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(32000, 2048),
                                       dtype=np.int8)).to(dev)
    ws = torch.from_numpy((rng.uniform(size=32000) * 2e-4 + 1e-4)
                          .astype(np.float32)).to(dev)
    errs["w8a8_matmul"] = check_close(
        "w8a8 lm_head", w8.w8a8_matmul(x, wq, ws, n=32000, k=2048),
        w8.w8a8_matmul_plain(x, wq, ws, n=32000, k=2048))

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, torch.bfloat16)

    q, k, v = bf(BATCH, PROMPT, 32, 64), bf(BATCH, PROMPT, 4, 64), bf(
        BATCH, PROMPT, 4, 64)
    errs["prefill_attention"] = check_close(
        "prefill_attention", pa.prefill_attention(q, k, v),
        pa.prefill_attention_plain(q, k, v))

    q, nk, nv, ck, cv, lengths = decode_inputs(rng, dev)
    ck0, cv0 = ck.clone(), cv.clone()
    ck_p, cv_p = ck.clone(), cv.clone()
    layer = 5
    out, ck_r, cv_r = da.decode_attention(q, nk, nv, ck, cv, lengths,
                                          layer=layer)
    if ck_r.data_ptr() != ck.data_ptr() or cv_r.data_ptr() != cv.data_ptr():
        raise AssertionError("decode_attention did not update in place")
    want, _, _ = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                           layer=layer)
    active = lengths >= 0
    errs["decode_attention"] = check_close(
        "decode_attention", out[active], want[active])
    if not (torch.equal(ck, ck_p) and torch.equal(cv, cv_p)):
        raise AssertionError("decode_attention cache write differs from plain")
    inactive = ~active
    if not (torch.equal(ck[:, inactive], ck0[:, inactive])
            and torch.equal(cv[:, inactive], cv0[:, inactive])):
        raise AssertionError("decode_attention touched an inactive row")
    changed = (ck != ck0).any(dim=(2, 4))  # (L, B, S_pad)
    rows = torch.nonzero(changed)
    expect = torch.stack([torch.full_like(lengths[active], layer),
                          torch.nonzero(active).reshape(-1),
                          lengths[active]], dim=1).to(rows.dtype)
    if not torch.equal(rows, expect):
        raise AssertionError("decode_attention wrote outside lengths[b]")
    log("parity decode_attention cache: in-place write at lengths[b] only, "
        "inactive rows untouched")
    return errs


def phase_end_to_end():
    import torch

    from compressed_tensors_tpu_torch.engine import (
        greedy_generate,
        make_step_fns,
    )
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        TINYLLAMA_1_1B,
        make_synthetic_llama,
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention,
        prefill_attention,
        w4a16_matmul,
        w8a8_matmul,
    )

    wrappers = {"w4a16_matmul": w4a16_matmul.w4a16_matmul,
                "w8a8_matmul": w8a8_matmul.w8a8_matmul,
                "prefill_attention": prefill_attention.prefill_attention,
                "decode_attention": decode_attention.decode_attention}

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    config = TINYLLAMA_1_1B
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    result = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        synth = make_synthetic_llama(config, "W4A16", seed=0,
                                     lm_head_preset="W8A8", device="cpu",
                                     use_kernels=False)
        save_llama_checkpoint(synth, config, tmp)
        del synth
        size = os.path.getsize(os.path.join(tmp, "model.safetensors"))
        log(f"checkpoint: {config.num_hidden_layers} layers, {size / 2**20:.0f}"
            f" MiB, written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        params, config, _ = load_llama_params(tmp, device="cuda")
        params = fuse_llama_layers(params)
        torch.cuda.synchronize()
        log(f"load + fuse: {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, config.vocab_size,
                                        size=(BATCH, PROMPT))).cuda()
    greedy_generate(params, config, ids, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()

    reset()
    t0 = time.perf_counter()
    out = greedy_generate(params, config, ids, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    run_counts = counts()
    log(f"greedy_generate: {tuple(out.shape)} in {total * 1e3:.1f} ms, "
        f"kernel launches {run_counts}")
    missing = [k for k, c in run_counts.items() if c == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if out.shape != (BATCH, PROMPT + NEW_TOKENS) or not bool(
            ((out >= 0) & (out < config.vocab_size)).all()):
        raise AssertionError("generated ids out of range")

    prefill, decode = make_step_fns(config, PROMPT + NEW_TOKENS)
    token, cache, logits = prefill(params, ids, PROMPT)
    _, _, ref_logits = make_step_fns(config, PROMPT + NEW_TOKENS,
                                     use_kernels=False)[0](params, ids, PROMPT)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    err = (logits.float() - ref_logits.float()).abs().max().item()
    scale = ref_logits.float().abs().max().item()
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
    log(f"first-step logits vs non-kernel path: max_abs_err={err:.5g} "
        f"max|ref|={scale:.5g} rel={err / scale:.4g} (limit {TOL_E2E}), "
        f"argmax agreement {agree:.3f}")
    if err > TOL_E2E * scale:
        raise AssertionError("first-step logits disagree with the "
                             "non-kernel path")

    prefill_ms = eager_ms(lambda: prefill(params, ids, PROMPT))
    reset()
    step_cache = {"token": token, "cache": cache}

    def one_step():
        t, c = decode(params, step_cache["token"], step_cache["cache"])
        step_cache["token"], step_cache["cache"] = t, c

    torch.cuda.synchronize()
    one_step()
    per_step = counts()
    # decode steps while the cache has room (one step above is spent)
    steps = NEW_TOKENS - 2
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    log(f"prefill: {prefill_ms:.2f} ms (B={BATCH}, S={PROMPT}); decode: "
        f"{decode_ms:.3f} ms/step = {BATCH / decode_ms * 1e3:.0f} tok/s; "
        f"end to end {BATCH * NEW_TOKENS / total:.0f} tok/s over "
        f"{total * 1e3:.1f} ms")
    log(f"launches per decode step: {per_step}")
    result.update(run_counts=run_counts, per_step=per_step)
    return result


def phase_timings(errs, run_counts, per_step):
    """Per-kernel time at the main path's shapes, bound, plain, library."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        prefill_attention as pa,
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    rows = []

    def bound(nbytes, ops, peak):
        t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    # W4A16: the four matmuls of one decoder layer at decode (M = 64)
    ms = plain = lib = nbytes = ops = 0.0
    for name, (n, k) in W4_SHAPES.items():
        x, w, s, _ = w4_inputs(rng, n, k, BATCH, dev)
        reps = copies_for(n * k // 2)
        ws = [w.clone() for _ in range(reps)]
        t = device_ms([lambda w=w: w4.w4a16_matmul(
            x, w, s, None, n=n, k=k, group_size=128) for w in ws])
        tp = eager_ms(lambda: w4.w4a16_matmul_plain(x, w, s, None, n=n, k=k,
                                                    group_size=128))
        del ws
        wd = w4._dequantized_weight(w, s, None, n, k, 128).to(torch.bfloat16)
        wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
        tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t()) for wd in wds])
        del wds
        b = BATCH * k * 2 + n * k // 2 + (k // 128) * n * 4 + BATCH * n * 2
        bm, by = bound(b, 2 * BATCH * n * k, PEAK_BF16)
        log(f"time w4a16_matmul {name} M={BATCH}: {t:.4f} ms, bound "
            f"{bm:.4f} ms ({by}), plain {tp:.4f} ms, torch.matmul on the "
            f"dequantized bf16 weight {tl:.4f} ms")
        ms, plain, lib = ms + t, plain + tp, lib + tl
        nbytes, ops = nbytes + b, ops + 2 * BATCH * n * k
    for name, (n, k) in W4_SHAPES.items():
        m = BATCH * PROMPT
        x, w, s, _ = w4_inputs(rng, n, k, m, dev)
        wd = w4._dequantized_weight(w, s, None, n, k, 128).to(torch.bfloat16)
        t = device_ms([lambda: w4.w4a16_matmul(x, w, s, None, n=n, k=k,
                                               group_size=128)] * 3)
        tl = device_ms([lambda: torch.matmul(x, wd.t())] * 3)
        bm, by = bound(m * k * 2 + n * k // 2 + m * n * 2, 2 * m * n * k,
                       PEAK_BF16)
        log(f"time w4a16_matmul {name} M={m} (prefill): {t:.4f} ms, bound "
            f"{bm:.4f} ms ({by}), torch.matmul bf16 {tl:.4f} ms")
    bm, by = bound(nbytes, ops, PEAK_BF16)
    rows.append(dict(name="w4a16_matmul", ms=ms, plain_ms=plain,
                     bound_ms=bm, bound_by=by, library_ms=lib,
                     shapes="qkv+o+gate_up+down of one layer, M=64"))

    # W8A8: the lm_head at M = 64 (65 MB of weight: two copies alternate)
    n, k = 32000, 2048
    x = torch.from_numpy(rng.standard_normal((BATCH, k), dtype=np.float32)
                         ).to(dev, torch.bfloat16)
    wqs = [torch.from_numpy(rng.integers(-127, 128, size=(n, k),
                                         dtype=np.int8)).to(dev)
           for _ in range(2)]
    wsc = torch.from_numpy((rng.uniform(size=n) * 2e-4 + 1e-4)
                           .astype(np.float32)).to(dev)
    t = device_ms([lambda wq=wq: w8.w8a8_matmul(x, wq, wsc, n=n, k=k)
                   for wq in wqs * 2])
    tp = eager_ms(lambda: w8.w8a8_matmul_plain(x, wqs[0], wsc, n=n, k=k))
    xq = torch.randint(-128, 128, (BATCH, k), dtype=torch.int8, device=dev)
    try:
        tl = device_ms([lambda wq=wq: torch._int_mm(xq, wq.t())
                        for wq in wqs * 2])
    except RuntimeError as exc:  # a library limit, reported, not a failure
        log(f"torch._int_mm unavailable here: {exc}")
        tl = None
    bm, by = bound(BATCH * k * 2 + n * k + n * 4 + BATCH * n * 2,
                   2 * BATCH * n * k, PEAK_INT8)
    rows.append(dict(name="w8a8_matmul", ms=t, plain_ms=tp, bound_ms=bm,
                     bound_by=by, library_ms=tl,
                     shapes="lm_head 64x2048 -> 32000"))

    # prefill attention at (B, S, H, D) = (64, 128, 32, 64), KVH 4
    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, torch.bfloat16)

    H, KVH, D = 32, 4, 64
    q, k_, v_ = bf(BATCH, PROMPT, H, D), bf(BATCH, PROMPT, KVH, D), bf(
        BATCH, PROMPT, KVH, D)
    t = device_ms([lambda: pa.prefill_attention(q, k_, v_)] * 5)
    tp = eager_ms(lambda: pa.prefill_attention_plain(q, k_, v_))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k_, v_))
    try:
        tl = device_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)] * 5)
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    pairs = PROMPT * (PROMPT + 1) // 2
    bm, by = bound(2 * (q.numel() + k_.numel() + v_.numel() + q.numel()),
                   4 * BATCH * H * D * pairs, PEAK_BF16)
    rows.append(dict(name="prefill_attention", ms=t, plain_ms=tp,
                     bound_ms=bm, bound_by=by, library_ms=tl,
                     shapes="B=64 S=128 H=32 KVH=4 D=64 causal"))

    # decode attention: one layer of the (22, 64, 4, 192, 64) cache; the
    # calls walk the 22 layers, as a decode step does
    q, nk, nv, ck, cv, lengths = decode_inputs(rng, dev)
    layers = range(ck.shape[0])
    t = device_ms([lambda i=i: da.decode_attention(q, nk, nv, ck, cv, lengths,
                                                   layer=i) for i in layers])
    tp = eager_ms(lambda: da.decode_attention_plain(q, nk, nv, ck, cv,
                                                    lengths, layer=5))
    S_pad = ck.shape[3]
    mask = (torch.arange(S_pad, device=dev)[None, :] <= lengths[:, None])
    q4 = q[:, :, None, :]
    try:
        tl = device_ms([lambda i=i: F.scaled_dot_product_attention(
            q4, ck[i], cv[i], attn_mask=mask[:, None, None, :],
            enable_gqa=True) for i in layers])
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    live = int((lengths[lengths >= 0] + 1).sum().item())
    b = (2 * live * KVH * D * 2 + (q.numel() * 2 + nk.numel() * 2) * 2)
    bm, by = bound(b, 4 * H * D * live, PEAK_BF16)
    rows.append(dict(name="decode_attention", ms=t, plain_ms=tp,
                     bound_ms=bm, bound_by=by, library_ms=tl,
                     shapes="B=64 H=32 KVH=4 D=64 S_pad=192, one layer"))

    meta = {
        "w4a16_matmul": ("compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
                         "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
        "w8a8_matmul": ("compressed_tensors_tpu_torch/csrc/w8a8_matmul.cu",
                        "compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:118"),
        "prefill_attention": (
            "compressed_tensors_tpu_torch/csrc/prefill_attention.cu",
            "compressed_tensors_tpu/ops/kernels/prefill_attention.py:141"),
        "decode_attention": (
            "compressed_tensors_tpu_torch/csrc/decode_attention.cu",
            "compressed_tensors_tpu/ops/kernels/decode_attention.py:290"),
    }
    out = []
    for r in rows:
        source, replaces = meta[r["name"]]
        log(f"kernel {r['name']} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"{per_step[r['name']]} launches per decode step, "
            f"{run_counts[r['name']]} in the greedy_generate run")
        out.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": run_counts[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import compressed_tensors_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (the "
              "compressed_tensors_tpu_torch package is missing)",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device_and_build()
    errs = phase_parity()
    e2e = phase_end_to_end()
    kernels = phase_timings(errs, e2e["run_counts"], e2e["per_step"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
