#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``compressed_tensors_tpu_torch`` (nvcc,
into ``build/``) and holds each kernel against its plain PyTorch version at
the shapes of the main paths. Then it drives two paths end to end:

- greedy decode of a full-width TinyLlama-1.1B-shape W4A16 checkpoint
  (W8A8-int lm_head, random weights from a seed), written, loaded with
  ``load_llama_params``, fused, and decoded at batch 64 (128-token prompts,
  32 new tokens), its first-step logits held against the non-kernel path
  (``use_kernels=False``);
- the continuous-batching ``ServingEngine`` at full Llama-3-8B W4A16 width
  (32 layers, random weights from a seed): 96 requests, a third of them
  sharing a 256-token prefix, through the dense engine (flash decode), the
  paged engine and the paged engine with prefix caching. Dense and paged
  completions must be equal token for token, and the prefix-cached ones
  equal them but for a few greedy near-ties after the first token (see
  ``phase_serving``); one request's first-token logits are held against
  the non-kernel path.

Every kernel of each path must have launched during that path's run.
Per-kernel times, bounds, plain and library times follow.

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
# the same at Llama-3-8B width (32 layers), where prefill rows go through
# a8b and the reference keeps bf16 activations: per-token int8 rounding
# (absmax/127) adds about 0.9% of a row's RMS to each linear's input. An
# estimate of 1.5-3% of max|logits| from that was refuted on the H100:
# two runs read 0.57%. The limit leaves 2.6x room over that reading.
TOL_E2E_8B = 1.5e-2
# a8b against its f32 plain result, per element: bf16 output rounding
# (2^-8 of |y|) plus f32 summation order (1e-4 of max|y|)
A8B_REL, A8B_ABS = 2**-8, 1e-4

# serving at Llama-3-8B width (phase 5)
SERVE = dict(max_batch=64, max_len=1024, page_size=64, prefill_chunk=512,
             steps_per_sync=4)
N_REQUESTS, SHARED_PREFIX = 96, 256
SHARE_EVERY = 3            # requests 0, 3, 6, ... begin with the prefix
SHARED_SAME_MIN = 28       # of those 32, identical with and without reuse
PROMPT_LENS, NEW_LENS = (64, 768), (16, 64)   # uniform, inclusive
W4_SHAPES_8B = {"qkv_proj": (6144, 4096), "o_proj": (4096, 4096),
                "gate_up_proj": (28672, 4096), "down_proj": (4096, 14336)}
M_CHUNK = 512              # a full prefill chunk's rows
L8, KVH8, D8, H8 = 32, 8, 128, 32
VOCAB8 = 128256


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

def check_a8b(name, x, w, s, zp, n, k):
    """a8b against its plain version, tighter than TOL_KERNEL: at these
    shapes the int8 rounding of x itself moves y by about 1% of max|y|, as
    much as that rule allows. So the kernel's quantization pass must equal
    the plain one bit for bit, and each output element must equal the
    plain f32 result within A8B_REL * |y| + A8B_ABS * max|y|. The int4b
    output on the same operands (bf16 activations, no int8 rounding) is a
    control that must fail the same check. Returns max|kernel - plain|."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    m = x.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    got = w4.w4a16_a8b_matmul(x, w, s, zp, n=n, k=k, group_size=128, xq=xq,
                              xs=xs)
    xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
    if not (torch.equal(xq, xq_p) and torch.equal(xs, xs_p)):
        raise AssertionError(
            f"{name}: quantization pass differs from plain in "
            f"{int((xq != xq_p).sum())} of {xq.numel()} values and "
            f"{int((xs != xs_p).sum())} of {m} scales")
    want = w4.w4a16_matmul_plain(x, w, s, zp, n=n, k=k, group_size=128,
                                 mode="a8b", out_dtype=torch.float32)
    scale = want.abs().max().item()
    slack = A8B_REL * want.abs() + A8B_ABS * scale

    def outside(y):
        return int(((y.float() - want).abs() > slack).sum())

    bad = outside(got)
    control = outside(w4.w4a16_matmul(x, w, s, zp, n=n, k=k, group_size=128,
                                      mode="int4b"))
    err = (got.float() - want).abs().max().item()
    log(f"parity {name}: quantization pass equal bit for bit; "
        f"max_abs_err={err:.6g} max|plain f32|={scale:.6g} "
        f"rel={err / scale:.3g}; elements outside {A8B_REL:.4g}|y| + "
        f"{A8B_ABS} max|y|: kernel {bad}, int4b control {control} of "
        f"{want.numel()}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    if not control:
        raise AssertionError(f"{name}: the check cannot tell a8b from int4b")
    return err


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


def dev_randn(gen, *shape):
    """bf16 N(0, 1) drawn on the card from a seeded generator (the 8B
    caches hold billions of values, too many to draw on the host)."""
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(torch.bfloat16)


def serving_lengths(rng, batch, inactive):
    """Decode lengths spread over 0-1000, with some rows inactive (-1)."""
    import torch

    lengths = rng.integers(0, 1001, size=batch).astype(np.int32)
    lengths[list(inactive)] = -1
    return lengths, torch.from_numpy(lengths).cuda()


def check_written(name, after, before, expect):
    """Only the (layer, row-or-page, kv head, position) entries in
    ``expect`` changed between two caches (L, X, KVH, T, D)."""
    import torch

    changed = torch.nonzero((after != before).any(dim=-1)).tolist()
    if sorted(map(tuple, changed)) != sorted(expect):
        raise AssertionError(f"{name} wrote outside the step's positions")


def phase_parity_8b(errs):
    """The kernels of the serving path against their plain versions at
    Llama-3-8B shapes, bf16 on the card; updates ``errs``."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        flash_decode as fd,
        paged_decode as pd,
        prefill_attention as pa,
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for name, (n, k) in W4_SHAPES_8B.items():
        for asym in (False, True):
            x, w, s, zp = w4_inputs(rng, n, k, M_CHUNK, dev, asym=asym)
            keep("w4a16_a8b_matmul", check_a8b(
                f"a8b {name} M={M_CHUNK}{' zero-point' if asym else ''}",
                x, w, s, zp, n, k))
        x, w, s, _ = w4_inputs(rng, n, k, BATCH, dev)
        keep("w4a16_matmul", check_close(
            f"w4a16 {name} M={BATCH} (8B)",
            w4.w4a16_matmul(x, w, s, None, n=n, k=k, group_size=128),
            w4.w4a16_matmul_plain(x, w, s, None, n=n, k=k, group_size=128)))

    x = dev_randn(gen, BATCH, 4096)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(VOCAB8, 4096),
                                       dtype=np.int8)).to(dev)
    ws = torch.from_numpy((rng.uniform(size=VOCAB8) * 2e-4 + 1e-4)
                          .astype(np.float32)).to(dev)
    keep("w8a8_matmul", check_close(
        "w8a8 lm_head 4096 -> 128256",
        w8.w8a8_matmul(x, wq, ws, n=VOCAB8, k=4096),
        w8.w8a8_matmul_plain(x, wq, ws, n=VOCAB8, k=4096)))
    del wq

    q, k, v = (dev_randn(gen, 1, M_CHUNK, h, D8) for h in (H8, KVH8, KVH8))
    keep("prefill_attention", check_close(
        "prefill_attention B=1 S=512 H=32 KVH=8 D=128",
        pa.prefill_attention(q, k, v), pa.prefill_attention_plain(q, k, v)))

    # block decode at D = 128 (two layers of a 256-position cache)
    q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H8, KVH8, KVH8))
    ck, cv = (dev_randn(gen, 2, BATCH, KVH8, 256, D8) for _ in range(2))
    lengths = torch.from_numpy(rng.integers(0, 255, BATCH).astype(
        np.int32)).to(dev)
    ck_p, cv_p = ck.clone(), cv.clone()
    out, _, _ = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1)
    want, _, _ = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                           layer=1)
    keep("decode_attention", check_close("decode_attention D=128", out, want))
    if not (torch.equal(ck, ck_p) and torch.equal(cv, cv_p)):
        raise AssertionError("decode_attention D=128 cache write differs")
    del ck, cv, ck_p, cv_p

    # flash decode on the dense engine's (32, 64, 8, 1024, 128) cache
    inactive = (3, 17, 40)
    lens_np, lengths = serving_lengths(rng, BATCH, inactive)
    active = lengths >= 0
    layer = 7
    ck, cv = (dev_randn(gen, L8, BATCH, KVH8, SERVE["max_len"], D8)
              for _ in range(2))
    ck0, cv0 = ck.clone(), cv.clone()
    out, ck_r, cv_r = fd.flash_decode_attention(q, nk, nv, ck, cv, lengths,
                                                layer=layer)
    if ck_r.data_ptr() != ck.data_ptr():
        raise AssertionError("flash_decode did not update in place")
    ck_p, cv_p = ck0.clone(), cv0.clone()
    want, _, _ = fd.flash_decode_attention_plain(q, nk, nv, ck_p, cv_p,
                                                 lengths, layer=layer)
    keep("flash_decode_attention", check_close(
        "flash_decode (32, 64, 8, 1024, 128)", out[active], want[active]))
    if out[~active].any():
        raise AssertionError("flash_decode: inactive rows must be zero")
    if not (torch.equal(ck, ck_p) and torch.equal(cv, cv_p)):
        raise AssertionError("flash_decode cache write differs from plain")
    expect = [(layer, b, h, int(lens_np[b])) for b in range(BATCH)
              for h in range(KVH8) if b not in inactive]
    check_written("flash_decode", ck, ck0, expect)
    check_written("flash_decode", cv, cv0, expect)
    log("parity flash_decode cache: in-place write at lengths[b] only, "
        "inactive rows untouched")
    del ck, cv, ck0, cv0, ck_p, cv_p

    # paged decode on the paged engine's pool, shuffled tables, rows
    # released to the null page
    pages_per_row = SERVE["max_len"] // SERVE["page_size"]
    num_pages = BATCH * pages_per_row + 1
    tables = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    tables = tables.reshape(BATCH, pages_per_row)
    tables[list(inactive)] = 0
    tables_d = torch.from_numpy(tables).to(dev)
    pk, pv = (dev_randn(gen, L8, num_pages, KVH8, SERVE["page_size"], D8)
              for _ in range(2))
    pk0, pv0 = pk.clone(), pv.clone()
    out, pk_r, _ = pd.paged_decode_attention(q, nk, nv, pk, pv, tables_d,
                                             lengths, layer=layer)
    if pk_r.data_ptr() != pk.data_ptr():
        raise AssertionError("paged_decode did not update in place")
    pk_p, pv_p = pk0.clone(), pv0.clone()
    want, _, _ = pd.paged_decode_attention_plain(
        q, nk, nv, pk_p, pv_p, tables_d, lengths, layer=layer)
    keep("paged_decode_attention", check_close(
        "paged_decode (32, 1025, 8, 64, 128)", out[active], want[active]))
    if out[~active].any():
        raise AssertionError("paged_decode: inactive rows must be zero")
    if not (torch.equal(pk, pk_p) and torch.equal(pv, pv_p)):
        raise AssertionError("paged_decode pool write differs from plain")
    page = SERVE["page_size"]
    expect = [(layer, int(tables[b, lens_np[b] // page]), h,
               int(lens_np[b] % page)) for b in range(BATCH)
              for h in range(KVH8) if b not in inactive]
    check_written("paged_decode", pk, pk0, expect)
    check_written("paged_decode", pv, pv0, expect)
    log("parity paged_decode pool: writes at tables[b, len // page] only; "
        "every other page, the null page 0 included, untouched")


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
        flash_decode,
        paged_decode,
        prefill_attention,
        w4a16_matmul,
        w8a8_matmul,
    )

    wrappers = {"w4a16_matmul": w4a16_matmul.w4a16_matmul,
                "w4a16_a8b_matmul": w4a16_matmul.w4a16_a8b_matmul,
                "w8a8_matmul": w8a8_matmul.w8a8_matmul,
                "prefill_attention": prefill_attention.prefill_attention,
                "decode_attention": decode_attention.decode_attention,
                "flash_decode_attention": flash_decode.flash_decode_attention,
                "paged_decode_attention": paged_decode.paged_decode_attention}
    # the kernels this path must launch (TinyLlama widths never select a8b,
    # and S_pad 192 selects the block decode kernel)
    needs = ("w4a16_matmul", "w8a8_matmul", "prefill_attention",
             "decode_attention")

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
    missing = [k for k in needs if run_counts[k] == 0]
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


def serving_requests():
    """96 requests drawn with numpy seed 0: prompt lengths uniform in
    64-768 (257-768 for the third that begin with the shared 256-token
    prefix, so each holds the whole prefix and a token of its own), new
    tokens uniform in 16-64."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB8, size=SHARED_PREFIX).tolist()
    reqs = []
    for i in range(N_REQUESTS):
        shared = i % SHARE_EVERY == 0
        low = SHARED_PREFIX + 1 if shared else PROMPT_LENS[0]
        n = int(rng.integers(low, PROMPT_LENS[1] + 1))
        ids = rng.integers(0, VOCAB8, size=n).tolist()
        if shared:
            ids[:SHARED_PREFIX] = prefix
        reqs.append((i, ids, int(rng.integers(NEW_LENS[0], NEW_LENS[1] + 1))))
    return reqs


def phase_serving():
    """The ServingEngine at Llama-3-8B W4A16 width: the same requests
    through the dense engine (flash decode at S_pad 1024), the paged engine
    and the paged engine with prefix caching."""
    import torch

    from compressed_tensors_tpu_torch.engine import Request, ServingEngine
    from compressed_tensors_tpu_torch.models.llama import (
        init_kv_cache,
        llama_forward,
    )
    from compressed_tensors_tpu_torch.models.synthetic import (
        LLAMA3_8B,
        make_synthetic_llama,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention,
        flash_decode,
        paged_decode,
        prefill_attention,
        w4a16_matmul,
        w8a8_matmul,
    )

    wrappers = {"w4a16_matmul": w4a16_matmul.w4a16_matmul,
                "w4a16_a8b_matmul": w4a16_matmul.w4a16_a8b_matmul,
                "w8a8_matmul": w8a8_matmul.w8a8_matmul,
                "prefill_attention": prefill_attention.prefill_attention,
                "decode_attention": decode_attention.decode_attention,
                "flash_decode_attention": flash_decode.flash_decode_attention,
                "paged_decode_attention": paged_decode.paged_decode_attention}
    config = LLAMA3_8B
    t0 = time.perf_counter()
    params = fuse_llama_layers(make_synthetic_llama(
        config, "W4A16", seed=0, lm_head_preset="W8A8", device="cuda"))
    torch.cuda.synchronize()
    log(f"Llama-3-8B W4A16 synthetic model (seed 0, fused): built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()

    # one request's first-token logits: kernel path vs non-kernel path
    rid, ids, _ = next(r for r in requests
                          if SHARED_PREFIX <= len(r[1]) <= SERVE["prefill_chunk"])
    x = torch.tensor([ids], device="cuda")
    pos = torch.arange(len(ids), device="cuda")[None]
    logits = {}
    for use_kernels in (True, False):
        cache = init_kv_cache(config, 1, len(ids), device="cuda")
        logits[use_kernels], _ = llama_forward(
            params, config, x, pos, cache, fresh_prefill=True,
            use_kernels=use_kernels, last_logit_only=True)
    got, ref = logits[True].float(), logits[False].float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite 8B logits")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    same = int(got.argmax()) == int(ref.argmax())
    log(f"8B first-token logits (request {rid}, {len(ids)} prompt tokens) "
        f"vs non-kernel path: max_abs_err={err:.5g} max|ref|={scale:.5g} "
        f"rel={err / scale:.4g} (limit {TOL_E2E_8B}), argmax "
        f"{'agrees' if same else 'differs'}")
    if err > TOL_E2E_8B * scale:
        raise AssertionError("8B first-token logits disagree with the "
                             "non-kernel path")
    del logits, got, ref

    runs = {"dense": dict(paged=False),
            "paged": dict(paged=True, prefix_caching=False),
            "paged+prefix": dict(paged=True)}
    results = {}
    for name, kw in runs.items():
        engine = ServingEngine(params, config, **SERVE, **kw)
        timing = {"prefill_s": 0.0, "chunks": 0, "decode_s": 0.0, "steps": 0}
        prefill_chunk, decode = engine._prefill_chunk, engine._decode

        def timed_prefill(*a, _f=prefill_chunk, _t=timing):
            t = time.perf_counter()
            out = _f(*a)
            torch.cuda.synchronize()
            _t["prefill_s"] += time.perf_counter() - t
            _t["chunks"] += 1
            return out

        def timed_decode(active, burst, _f=decode, _t=timing):
            before = {k: fn.launches for k, fn in wrappers.items()}
            t = time.perf_counter()
            out = _f(active, burst)  # ends in the trace's host copy
            _t["decode_s"] += time.perf_counter() - t
            _t["steps"] += burst
            _t.setdefault("per_step", {
                k: (fn.launches - before[k]) / burst
                for k, fn in wrappers.items()})
            return out

        engine._prefill_chunk, engine._decode = timed_prefill, timed_decode
        for i, ids, new in requests:
            engine.submit(Request(request_id=i, prompt_ids=ids,
                                  max_new_tokens=new))
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {k: fn.launches for k, fn in wrappers.items()}
        outs = {c.request_id: c.output_ids for c in done}
        generated = sum(len(o) for o in outs.values())
        log(f"serving {name}: {len(outs)} completions, {generated} tokens in "
            f"{wall:.2f} s ({generated / wall:.1f} tok/s); prefill "
            f"{timing['prefill_s'] * 1e3 / max(timing['chunks'], 1):.2f} ms/"
            f"chunk over {timing['chunks']} chunks; decode "
            f"{timing['decode_s'] * 1e3 / max(timing['steps'], 1):.2f} ms/"
            f"step over {timing['steps']} steps; prefix-cache hits "
            f"{engine.prefix_cache_hits}; preemptions {engine.preemptions}; "
            f"kernel launches {counts}")
        if sorted(outs) != list(range(N_REQUESTS)) or any(
                len(outs[i]) != new for i, _, new in requests):
            raise AssertionError(f"serving {name}: completions missing")
        if not all(0 <= t < VOCAB8 for o in outs.values() for t in o):
            raise AssertionError(f"serving {name}: token ids out of range")
        results[name] = dict(outs=outs, counts=counts, wall=wall,
                             hits=engine.prefix_cache_hits, **timing)
        del engine._prefill_chunk, engine._decode, engine  # frees its cache
        torch.cuda.empty_cache()

    dense, paged, prefix = (results[k]["outs"] for k in runs)

    def first_diff(a, b):
        return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)

    # paged and dense run the same chunks through decode kernels that
    # share one body: identical completions
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving paged vs dense: {N_REQUESTS - len(bad)}/{N_REQUESTS} "
        "completions identical token for token")
    if bad:
        raise AssertionError(f"serving paged and dense completions differ "
                             f"for requests {bad}")
    # with prefix caching the requests without the shared prefix run the
    # same chunks as dense: identical. Those with it prefill only their own
    # tail, as one continuation chunk over the cached pages: other row
    # counts, so _w4b8_mode may pick int4b where a dense chunk picks a8b or
    # the reverse (a difference of the size of the int8 rounding, about 1%
    # of a linear's input), and the non-kernel attention over the cache.
    # That may flip a greedy near-tie; stale or wrong pages would change
    # nearly all of them. So every first token must agree, and at least
    # SHARED_SAME_MIN of the completions in full.
    shared = list(range(0, N_REQUESTS, SHARE_EVERY))
    bad = [i for i in dense if i not in shared and prefix[i] != dense[i]]
    if bad:
        raise AssertionError(f"prefix caching changed requests {bad} that "
                             "do not share the prefix")
    differ = {i: first_diff(prefix[i], dense[i]) for i in shared
              if prefix[i] != dense[i]}
    log(f"serving paged+prefix vs dense: the {N_REQUESTS - len(shared)} "
        f"requests without the shared prefix identical; of the "
        f"{len(shared)} with it, {len(shared) - len(differ)} identical "
        f"(limit {SHARED_SAME_MIN}); first differing token of the others: "
        f"{differ}")
    if any(t == 0 for t in differ.values()):
        raise AssertionError("prefix caching changed a first token")
    if len(shared) - len(differ) < SHARED_SAME_MIN:
        raise AssertionError("prefix caching changed too many completions")
    if results["paged+prefix"]["hits"] <= 0:
        raise AssertionError("prefix caching reused no page")
    needs = {"dense": ("flash_decode_attention", "w4a16_a8b_matmul",
                       "w4a16_matmul", "w8a8_matmul", "prefill_attention"),
             "paged": ("paged_decode_attention", "w4a16_a8b_matmul",
                       "w4a16_matmul", "w8a8_matmul", "prefill_attention")}
    for name, kernels in needs.items():
        missing = [k for k in kernels if results[name]["counts"][k] == 0]
        if missing:
            raise AssertionError(f"serving {name} never launched {missing}")
    return results


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

    for r in rows:
        log(f"kernel {r['name']} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"{per_step[r['name']]} launches per decode step, "
            f"{run_counts[r['name']]} in the greedy_generate run")
    return rows


def phase_timings_8b(serving):
    """Per-kernel time at the serving path's Llama-3-8B shapes, bound,
    plain, library; the launches of each engine run beside them."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        flash_decode as fd,
        paged_decode as pd,
        prefill_attention as pa,
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []

    def bound(nbytes, ops, peak):
        t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    # W4A16 at the 8B widths: int4b at decode (M = 64), a8b at a prefill
    # chunk (M = 512); each row sums the four linears of one layer
    for name, m, mode in (("w4a16_matmul", BATCH, "int4b"),
                          ("w4a16_a8b_matmul", M_CHUNK, "a8b")):
        ms = plain = lib = nbytes = ops = 0.0
        for lin, (n, k) in W4_SHAPES_8B.items():
            x, w, s, _ = w4_inputs(rng, n, k, m, dev)
            ws = [w.clone() for _ in range(copies_for(n * k // 2))]
            t = device_ms([lambda w=w: w4.w4a16_matmul(
                x, w, s, None, n=n, k=k, group_size=128, mode=mode)
                for w in ws])
            tp = eager_ms(lambda: w4.w4a16_matmul_plain(
                x, w, s, None, n=n, k=k, group_size=128, mode=mode), iters=3)
            del ws
            wd = w4._dequantized_weight(w, s, None, n, k, 128).to(
                torch.bfloat16)
            wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
            tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                            for wd in wds])
            del wds, wd
            b = m * k * 2 + n * k // 2 + (k // 128) * n * 4 + m * n * 2
            peak = PEAK_INT8 if mode == "a8b" else PEAK_BF16
            bm, by = bound(b, 2 * m * n * k, peak)
            log(f"time {name} {lin} M={m} (8B): {t:.4f} ms, bound {bm:.4f} "
                f"ms ({by}), plain {tp:.4f} ms, torch.matmul on the "
                f"dequantized bf16 weight {tl:.4f} ms")
            ms, plain, lib = ms + t, plain + tp, lib + tl
            nbytes, ops = nbytes + b, ops + 2 * m * n * k
        bm, by = bound(nbytes, ops, PEAK_INT8 if mode == "a8b" else PEAK_BF16)
        rows.append(dict(name=name, ms=ms, plain_ms=plain, bound_ms=bm,
                         bound_by=by, library_ms=lib,
                         shapes=f"qkv+o+gate_up+down of one 8B layer, M={m}"
                         + ("; library: torch.matmul on the dequantized bf16 "
                            "weight, the nearest single call" if mode == "a8b"
                            else "")))

    # W8A8: the 8B lm_head at M = 64 (525 MB of weight: two copies)
    n, k = VOCAB8, 4096
    x = dev_randn(gen, BATCH, k)
    wqs = [torch.from_numpy(rng.integers(-127, 128, size=(n, k),
                                         dtype=np.int8)).to(dev)
           for _ in range(2)]
    wsc = torch.from_numpy((rng.uniform(size=n) * 2e-4 + 1e-4)
                           .astype(np.float32)).to(dev)
    t = device_ms([lambda wq=wq: w8.w8a8_matmul(x, wq, wsc, n=n, k=k)
                   for wq in wqs * 2])
    tp = eager_ms(lambda: w8.w8a8_matmul_plain(x, wqs[0], wsc, n=n, k=k),
                  iters=3)
    xq = torch.randint(-128, 128, (BATCH, k), dtype=torch.int8, device=dev)
    try:
        tl = device_ms([lambda wq=wq: torch._int_mm(xq, wq.t())
                        for wq in wqs * 2])
    except RuntimeError as exc:  # a library limit, reported, not a failure
        log(f"torch._int_mm unavailable here: {exc}")
        tl = None
    del wqs
    bm, by = bound(BATCH * k * 2 + n * k + n * 4 + BATCH * n * 2,
                   2 * BATCH * n * k, PEAK_INT8)
    rows.append(dict(name="w8a8_matmul", ms=t, plain_ms=tp, bound_ms=bm,
                     bound_by=by, library_ms=tl,
                     shapes="8B lm_head 64x4096 -> 128256"))

    # prefill attention of one fresh 512-token chunk at D = 128
    q, k_, v_ = (dev_randn(gen, 1, M_CHUNK, h, D8) for h in (H8, KVH8, KVH8))
    t = device_ms([lambda: pa.prefill_attention(q, k_, v_)] * 5)
    tp = eager_ms(lambda: pa.prefill_attention_plain(q, k_, v_))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k_, v_))
    try:
        tl = device_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)] * 5)
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    pairs = M_CHUNK * (M_CHUNK + 1) // 2
    bm, by = bound(2 * (2 * q.numel() + k_.numel() + v_.numel()),
                   4 * H8 * D8 * pairs, PEAK_BF16)
    rows.append(dict(name="prefill_attention", ms=t, plain_ms=tp,
                     bound_ms=bm, bound_by=by, library_ms=tl,
                     shapes="8B chunk B=1 S=512 H=32 KVH=8 D=128 causal"))

    # flash and paged decode: one decode step's 32 layers at batch 64
    lens_np, lengths = serving_lengths(rng, BATCH, ())
    q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H8, KVH8, KVH8))
    live = int((lens_np + 1).sum())
    b = 2 * live * KVH8 * D8 * 2 + (q.numel() + 2 * nk.numel()) * 2 * 2
    bm, by = bound(b, 4 * H8 * D8 * live, PEAK_BF16)
    ck, cv = (dev_randn(gen, L8, BATCH, KVH8, SERVE["max_len"], D8)
              for _ in range(2))
    t = device_ms([lambda i=i: fd.flash_decode_attention(
        q, nk, nv, ck, cv, lengths, layer=i) for i in range(L8)])
    tp = eager_ms(lambda: fd.flash_decode_attention_plain(
        q, nk, nv, ck, cv, lengths, layer=0))
    mask = (torch.arange(SERVE["max_len"], device=dev)[None, :]
            <= lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    try:
        tl = device_ms([lambda i=i: F.scaled_dot_product_attention(
            q4, ck[i], cv[i], attn_mask=mask, enable_gqa=True)
            for i in range(L8)])
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    rows.append(dict(name="flash_decode_attention", ms=t, plain_ms=tp,
                     bound_ms=bm, bound_by=by, library_ms=tl,
                     shapes="8B dense cache (32, 64, 8, 1024, 128), one "
                     "layer, lengths 0-1000; library: SDPA with GQA and a "
                     "mask of the live prefix over S_pad"))
    del ck, cv

    page = SERVE["page_size"]
    per_row = SERVE["max_len"] // page
    num_pages = BATCH * per_row + 1
    tables = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(
        np.int32).reshape(BATCH, per_row)).to(dev)
    pk, pv = (dev_randn(gen, L8, num_pages, KVH8, page, D8) for _ in range(2))
    t = device_ms([lambda i=i: pd.paged_decode_attention(
        q, nk, nv, pk, pv, tables, lengths, layer=i) for i in range(L8)])
    tp = eager_ms(lambda: pd.paged_decode_attention_plain(
        q, nk, nv, pk, pv, tables, lengths, layer=0))
    gathered = [(pk[i][tables.long()].permute(0, 2, 1, 3, 4).reshape(
        BATCH, KVH8, per_row * page, D8), pv[i][tables.long()].permute(
        0, 2, 1, 3, 4).reshape(BATCH, KVH8, per_row * page, D8))
        for i in range(4)]
    try:
        tl = device_ms([lambda g=g: F.scaled_dot_product_attention(
            q4, g[0], g[1], attn_mask=mask, enable_gqa=True)
            for g in gathered * (L8 // 4)])
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    del gathered, pk, pv
    rows.append(dict(name="paged_decode_attention", ms=t, plain_ms=tp,
                     bound_ms=bm, bound_by=by, library_ms=tl,
                     shapes="8B pool (32, 1025, 8, 64, 128), shuffled "
                     "tables, one layer, lengths 0-1000; library: SDPA over "
                     "a copy gathered beforehand into a contiguous cache"))

    for r in rows:
        counts = {run: res["counts"][r["name"]]
                  for run, res in serving.items()}
        steps = {run: res.get("per_step", {}).get(r["name"])
                 for run, res in serving.items()}
        log(f"kernel {r['name']} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}; launches "
            f"per decode step {steps}, per serving run {counts}")
    return rows


KERNEL_META = {
    "w4a16_matmul": ("compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
                     "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w4a16_a8b_matmul": (
        "compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w8a8_matmul": ("compressed_tensors_tpu_torch/csrc/w8a8_matmul.cu",
                    "compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:118"),
    "prefill_attention": (
        "compressed_tensors_tpu_torch/csrc/prefill_attention.cu",
        "compressed_tensors_tpu/ops/kernels/prefill_attention.py:141"),
    "decode_attention": (
        "compressed_tensors_tpu_torch/csrc/decode_attention.cu",
        "compressed_tensors_tpu/ops/kernels/decode_attention.py:290"),
    "flash_decode_attention": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/flash_decode.py:317"),
    "paged_decode_attention": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/paged_decode.py:310"),
}


def kernel_report(errs, rows, run_counts, serving):
    """The kernels line: one entry per kernel, at the newest (8B) shapes
    where the serving path runs it; launches summed over the main paths'
    runs, with the split by run beside them."""
    by_name = {r["name"]: r for r in rows}  # later (8B) rows win
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        r = by_name[name]
        by_path = {"greedy_generate": run_counts[name]}
        by_path.update({f"serving {run}": res["counts"][name]
                        for run, res in serving.items()})
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shapes": r["shapes"],
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
    phase_parity_8b(errs)
    log(f"phases 1-2 done at {time.perf_counter() - t_start:.1f} s")
    e2e = phase_end_to_end()
    rows = phase_timings(errs, e2e["run_counts"], e2e["per_step"])
    log(f"phases 3-4 (TinyLlama) done at {time.perf_counter() - t_start:.1f} s")
    serving = phase_serving()
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    rows += phase_timings_8b(serving)
    kernels = kernel_report(errs, rows, e2e["run_counts"], serving)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
