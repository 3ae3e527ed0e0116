#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``compressed_tensors_tpu_torch`` (nvcc,
into ``build/``) and holds each kernel against its plain PyTorch version at
the shapes of the main paths (the W4A16 ``int4b`` kernel also over a grid
of row counts, widths, depths, groups and K splits that reaches both of
its designs at every split, by the a8b rule). Then it drives these paths
end to end:

- greedy decode of a full-width TinyLlama-1.1B-shape W4A16 checkpoint
  (W8A8-int lm_head, random weights from a seed), written, loaded with
  ``load_llama_params``, fused, and decoded at batch 64 (128-token prompts,
  32 new tokens), its first-step logits held against the non-kernel path
  (``use_kernels=False``);
- the continuous-batching ``ServingEngine`` at full Llama-3-8B W4A16 width
  (32 layers, codes uniform in [-7, 7] drawn on the card from a seed): one
  request's first-token logits by depth against the non-kernel path with
  every W4 linear at bf16 activations, and at the serving default (a8b
  prefill rows) against the same model with the W4 matmuls through their
  plain versions, each with a planted-fault control that must fail every
  check; 96 requests, a third of them sharing a 256-token prefix, through
  the dense engine (flash decode), the paged engine and the paged engine
  with prefix caching. Dense and paged completions must be equal token for
  token; the cached prefix pages must equal a fresh prefill's bit for bit;
  the prefix-cached first-token logits, with every W4 linear at bf16
  activations, are held to the depth rule against a fresh dense prefill at
  1 and 32 layers, and a stale-pages control must fail it in every
  request; the prefix-cached completions are counted, and held to the
  prefix rule (equal but for a few greedy near-ties after the first token)
  on the JAX package's draw of the same model (see ``phase_serving``);
- Llama-3-8B FP8 W8A8 with an FP8 KV cache (BASELINE config 3: fp8 e4m3
  per-channel weights with dynamic per-token fp8 activations, a W8A8-int
  lm_head, k_scale = v_scale = 0.03 in every layer): the same requests
  through the dense and the paged engine with an fp8 cache, equal token for
  token, ``greedy_generate`` at batch 64 through the scaled block decode
  kernel, and one request's first-token logits against the non-kernel
  path;
- Llama-3-8B NVFP4A16 built on the card (E2M1 weights in groups of 16
  with e4m3 scales and one global scale per fused group, W8A8-int
  lm_head): the fp4 kernel held against its plain version (NVFP4 and
  MXFP4) at the 8B linear shapes (and, in phase 2, both kernels of
  ``csrc/wna16_matmul.cu`` at every row count the paths give, each design
  and K split), the same requests through the dense and
  the paged engine, equal token for token, ``greedy_generate`` at batch
  64, and the first-token logits against the non-kernel path by depth;
- Llama-3-8B W8A16 g128 (pack-quantized, W8A8-int lm_head): the
  grouped-int8 kernel held against its plain version (W8A16 and W4A16
  under ``w4_layout="e8"``), ``greedy_generate`` at batch 64, the requests
  through the paged engine, and the logits by depth;
- Qwen2.5-7B-Instruct-AWQ kind (W4A16 with zero points, a bf16 qkv bias)
  and Qwen3-8B W4A16 (per-head q/k norms) at full width, built on the card,
  under ``w4_layout="packed"``: the int32 8-plane kernel held against its
  plain version in modes int4, a8 and mat at both models' shapes, the
  attention kernels at 7 query heads per kv head, the logits by depth
  (Qwen3's mode a8 against its plain a8 path, since int8 activations are
  no part of the non-kernel path), Qwen2.5's requests dense and paged in
  mode int4 (equal token for token)
  and once more under ``w4_layout="auto"`` (counted against them), and
  ``greedy_generate`` at batch 64 in modes mat (Qwen2.5) and a8 (Qwen3);
- Llama-3-8B 2:4 sparse-24-bitmask + INT4 (BASELINE config 4) built on
  the card through the sparse codec and ``prepare_for_kernels``, each
  linear's kernel words equal to its masked codes' bit for bit: the
  codec on the card against the CPU, the logits by depth against the
  non-kernel path over the sparse leaves, the requests dense and paged
  (identical, with phase 5's B1/B2 launch counts), and a TinyLlama-shape
  2:4 checkpoint written, loaded and decoded at batch 64 with the tokens
  of the W4A16 model of the same codes;
- TinyLlama W8A8-int in every linear and the lm_head (BASELINE config 2)
  written, loaded and decoded at batch 64, its first-step logits held
  against B3's plain version with a rolled-channel-scales control;
- config 5's per-layer W4A16/W8A8 mix at Llama-3-8B width (16 layers of
  each): the logits by depth against the model run through the kernels'
  plain versions, ``greedy_generate`` at batch 64 and the requests
  through the paged engine, with the launches of B1/B2 and B3 counted
  per layer kind;
- Qwen3-30B-A3B W4A16 g128 (MoE: 128 experts of width 768, 8 a token,
  48 layers) built on the card, every expert linear one expert-batched
  launch (B1e; B2e under w4_act="int8", B9e under w4_layout="e8", each
  held against its plain version over a grid of Qwen and Mixtral expert
  shapes first): its MoE blocks on the reference run's inputs, the
  routing flips at one layer counted, the logits by depth against the
  non-kernel path with the rolled-scales control, the requests dense and
  paged (identical, 96 B1 + 144 B1e launches a decode step),
  ``greedy_generate`` at batch 64, and a 2-layer checkpoint written and
  read back with identical greedy tokens;
- DeepSeek-V2-Lite W4A16 g64 (MLA: 16 heads over one latent head of
  K 576 / V 512, layer 0 dense, 26 layers of 64 experts of width 1408, 6
  a token, with 2 shared experts) built on the card, its absorbed decode
  through the latent-head kernels (B5-L on the slab, B7-L on pages, each
  held against its plain version over a grid of cache types, widths, head
  counts and lengths first, and B1e at group 64): the routing flips at the
  first MoE layer counted, the decode-step logits by depth against the
  non-kernel (non-absorbed) path with two planted faults (rolled group
  scales, the softmax scale of the latent width) that must fail every
  check, an fp8 latent cache against the plain versions with a
  saturating-scales control, the requests dense and paged on the fp8
  latent cache and on a bf16 one (identical, 161 B1 + 78 B1e + 1 B3 + 27
  latent launches a decode step), ``greedy_generate`` at batch 64, and a
  2-layer DeepSeek V2 checkpoint written and read back with identical
  greedy tokens;
- DeepSeek-V2 W4A16 g64 at full width (128 heads, q_lora_rank 1536, 160
  experts of width 1536) cut to 3 layers, built on the card: its
  decode-step logits at 1 and 3 layers against B5-L's, B1's and B1e's
  plain versions with the softmax-scale control, 64 requests dense and
  paged (identical, one latent launch a layer a decode step);
- the PTQ lifecycle and save path (phase 16): a dense bf16 Llama-3-8B
  drawn on the card, quantized with ``apply_quantization_config``,
  calibrated (``calibrate_module``, min-max) and compressed on the card,
  saved with ``ModelCompressor.save_checkpoint`` in 2 GiB shards and
  served from that checkpoint through ``load_llama_params``: W4A16 g128
  with a W8A8-int lm_head at full depth (codes and qparams equal to the
  CPU's, decompressed weights equal to the fake-quantized ones, the
  hidden state entering the lm_head by depth against the QDQ model with
  the rolled-scales control, greedy and the 96 requests dense and paged,
  identical, with B1/B2/B3's launches counted); FP8 W8A8 with k/v scales
  calibrated from the dense model's cache (equal to the CPU's), its
  first-token and decode-step logits on an fp8 cache against the QDQ
  model on a bf16 cache with a saturating-scales control, greedy; and
  MXFP4A16 through B8, its logits against the QDQ model with the
  rolled-scales control, greedy (the first model run of B8's MXFP4
  path); the W4A16 checkpoint planned with a 3 GiB device budget
  (``dispatch_plan``), streamed by ``stream_modules`` (every tensor equal
  to ``CheckpointReader``'s), its host-planned tensors onloaded from a
  pinned ``HostCache`` and from a ``DiskCache`` adopting the shards; the
  first 4 layers' calibrated states compressed by
  ``compress_state_parallel`` over two processes of this script on the one
  card (gloo; equal to ``compress_state``), and ``init_dist`` on NCCL at
  world size 1 in a process of its own;
- the transforms (phase 17): ``hadamard_matrix`` at four real widths
  checked exact on the card; the same dense Llama-3-8B rotated by
  SpinQuant's R1 + R2 fused in float64 on the card (layer 0 and the
  lm_head within one bf16 ulp of the CPU's fusion), its function kept in
  float32 at 1 and 32 layers with two controls that must fail, then
  quantized to W4A16 with a W8A8-int lm_head, saved with its
  ``transform_config``, served from that checkpoint as phase 16's W4A16
  arm is, its first-token logits read against the dense model beside
  the unrotated W4A16 model's; a copy with an online transform refused
  at load; the checkpoint dequantized by ``CompressedTensorsDequantizer``
  through ``convert_checkpoint`` on the card, layer 0 and the lm_head
  equal to the CPU's conversion byte for byte;
- the converters (phase 18): an AutoAWQ GEMM checkpoint of Qwen2.5-7B's
  widths and a ModelOpt NVFP4 checkpoint of Llama-3-8B's (4 layers each,
  written from codes drawn on the card) converted by
  ``convert_checkpoint``, every tensor held against a twin written
  directly, served through B1/B10 (greedy tokens equal to the twin's,
  dense = paged) and B8 (by the depth rule against its plain version);
  the CT dequantizer's ``process`` and the FP8-block dequantizer; and the
  two opt-in kernel paths no other phase runs: phase 6's FP8 model at 4
  layers under ``fp8_transcode="always"`` (int8 weights and cache) and
  W4A16 under ``w4_layout="e8"``, each held against its
  plain versions by depth, greedy, the FP8 one served dense and paged;
- parallelism (phase 19): a one-process mesh serving phase 5's requests
  as the unsharded engine; config 5's mix at Llama-3-70B width sharded at
  tp = 2 in one process, each shard's B1/B2/B3 call against its plain
  version; the mix cut to 4 of 80 layers, written once, and served at
  tp = 2 by two processes on the card (gloo over CUDA tensors);
- data parallelism (phase 20): four processes, started with phase 19,
  serving 19c's checkpoint and requests at dp = 2 x tp = 2, dense, paged
  and prefix-cached, identical to 19c's tp = 2, with a prefix page that
  one dp block wrote and the other read.

Every kernel of each path must have launched during that path's run.
Per-kernel times, bounds, plain and library times follow.

The last line of standard output is ``{"ok": true, "device": {...}}``;
any failure raises and exits non-zero. Without a CUDA device, or outside
the repository, it exits non-zero without a result.
"""

import contextlib
import dataclasses
import functools
import json
import os
import shutil
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
PEAK_FP8 = 1979e12

BATCH, PROMPT, NEW_TOKENS = 64, 128, 32
# max|kernel - plain| <= TOL * max|plain|: bf16 output rounding (2^-8
# relative) plus a different f32 summation order
TOL_KERNEL = 1e-2
# first-step logits, kernel path vs non-kernel path over 22 layers in
# bf16: each layer rounds activations to bf16 (2^-8) on both sides, in
# other places, and the reference also rounds every dequantized weight to
# bf16 (2^-9); a few such roundings compound over the layers
TOL_E2E = 2e-2
# the 8B and Qwen models at every depth (phases 5, 7-10): max|kernel -
# non-kernel| of the first-token logits within this share of max|ref|,
# unless the relative RMS error stays within FLOOR_RATIO x the one-ulp
# spread (``logits_rule_failures``); also the limit at one layer through
# a bf16 lm_head. Prefill rows go through a8b at 8B W4A16 width, whose
# per-token int8 rounding adds about 0.9% of a row's RMS to each linear's
# input and is no part of the non-kernel path: on the H100 it stood 3.17%
# of max|ref| from that path at one layer, against 1.34% with every W4
# linear at bf16 activations, so phase 5 holds the bf16 arm to the
# non-kernel path and a8b to its plain version.
TOL_E2E_8B = 1.5e-2
# a8b against its f32 plain result, per element: bf16 output rounding
# (2^-8 of |y|) plus f32 summation order (1e-4 of max|y|); the fp8 W8A8
# kernel is held to the same rule
A8B_REL, A8B_ABS = 2**-8, 1e-4
# first-token logits of the FP8 W8A8 + FP8 KV model at Llama-3-8B width
# against the non-kernel path (phase 6), as relative RMS error
# |a - b| / |b| over the vocabulary. Every linear rounds its input to fp8
# e4m3 per token (steps of 2^-4 to 2^-3 of a value), so a tiny upstream
# difference flips some roundings by a full step, and the random model
# amplifies that layer by layer: a one-ulp bf16 change to 64 embedding
# values of one prompt token moves the non-kernel path's own logits by
# several percent after one layer and by tens of percent after 32 (phase
# 6 prints the sweep). The first run's limit of 5% of max|logits| at full
# depth was refuted that way. So the kernel path is held to that
# sensitivity: at one layer (full width) within TOL_FP8_DEPTH1, where a
# wrong layout, scale or cache read moves the logits by O(1); at full
# depth within FLOOR_RATIO times the non-kernel path's own spread
# under that perturbation.
TOL_FP8_DEPTH1 = 0.25
FLOOR_RATIO = 3.0
# the NVFP4 and W8A16 models (phases 7-8) at one layer: max|kernel -
# non-kernel| of the first-token logits over max|ref|. Four H100 runs
# read 1.42-1.65%; the limit leaves 1.8x room over that.
TOL_WNA16_DEPTH1 = 3e-2
DEPTHS = (1, 2, 4, 8, 16, 32)
KV_SCALE = 0.03            # k_scale = v_scale of every layer, bench.py:320

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


# kernel name -> (module under ops/kernels, wrapper, launch counter)
COUNTERS = {
    "w4a16_matmul": ("w4a16_matmul", "w4a16_matmul", "launches"),
    "w4a16_a8b_matmul": ("w4a16_matmul", "w4a16_a8b_matmul", "launches"),
    "w8a8_matmul": ("w8a8_matmul", "w8a8_matmul", "launches"),
    "w8a8_matmul_fp8": ("w8a8_matmul", "w8a8_matmul", "fp8_launches"),
    "prefill_attention": ("prefill_attention", "prefill_attention",
                          "launches"),
    "decode_attention": ("decode_attention", "decode_attention", "launches"),
    "decode_attention_scaled": ("decode_attention", "decode_attention",
                                "scaled_launches"),
    "flash_decode_attention": ("flash_decode", "flash_decode_attention",
                               "launches"),
    "flash_decode_attention_scaled": ("flash_decode",
                                      "flash_decode_attention",
                                      "scaled_launches"),
    "paged_decode_attention": ("paged_decode", "paged_decode_attention",
                               "launches"),
    "paged_decode_attention_scaled": ("paged_decode",
                                      "paged_decode_attention",
                                      "scaled_launches"),
    "w4a16_fp4_matmul": ("w4a16_matmul", "w4a16_fp4_matmul", "launches"),
    "w4_e8_matmul": ("w4a16_matmul", "w4_e8_matmul", "launches"),
    "w4a16_planes_int4": ("w4a16_matmul", "w4a16_planes_matmul",
                          "int4_launches"),
    "w4a16_planes_a8": ("w4a16_matmul", "w4a16_planes_matmul",
                        "a8_launches"),
    "w4a16_planes_mat": ("w4a16_matmul", "w4a16_planes_matmul",
                         "mat_launches"),
    "w4a16_experts_matmul": ("w4a16_matmul", "w4a16_experts_matmul",
                             "launches"),
    "w4a16_a8b_experts_matmul": ("w4a16_matmul", "w4a16_a8b_experts_matmul",
                                 "launches"),
    "w4_e8_experts_matmul": ("w4a16_matmul", "w4_e8_experts_matmul",
                             "launches"),
    # MLA's latent head: B5-L on the slab, B7-L on pages
    "decode_attention_latent": ("decode_attention", "decode_attention",
                                "latent_launches"),
    "paged_decode_attention_latent": ("paged_decode",
                                      "paged_decode_attention",
                                      "latent_launches"),
}


def _counter(name):
    import importlib

    module, fn, attr = COUNTERS[name]
    mod = importlib.import_module(
        f"compressed_tensors_tpu_torch.ops.kernels.{module}")
    return getattr(mod, fn), attr


def reset_counts():
    for name in COUNTERS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(*_counter(name)) for name in COUNTERS}


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

def a8b_case(x, w, s, zp, n, k, group=128):
    """One a8b case against its plain version: (max|kernel - plain f32|,
    elements outside the a8b rule for the kernel, for the int4b control,
    max|plain f32|); raises if the kernel's quantization pass differs from
    the plain one."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    m = x.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    kw = dict(n=n, k=k, group_size=group)
    got = w4.w4a16_a8b_matmul(x, w, s, zp, xq=xq, xs=xs, **kw)
    xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
    if not (torch.equal(xq, xq_p) and torch.equal(xs, xs_p)):
        raise AssertionError(
            f"a8b M={m} N={n} K={k} g={group}: quantization pass differs "
            f"from plain in {int((xq != xq_p).sum())} of {xq.numel()} "
            f"values and {int((xs != xs_p).sum())} of {m} scales")
    want = w4.w4a16_matmul_plain(x, w, s, zp, mode="a8b",
                                 out_dtype=torch.float32, **kw)
    scale = want.abs().max().item()
    slack = A8B_REL * want.abs() + A8B_ABS * scale

    def outside(y):
        return int(((y.float() - want).abs() > slack).sum())

    control = outside(w4.w4a16_matmul(x, w, s, zp, mode="int4b", **kw))
    return (got.float() - want).abs().max().item(), outside(got), control, \
        scale


def check_a8b(name, x, w, s, zp, n, k):
    """a8b against its plain version, tighter than TOL_KERNEL: at these
    shapes the int8 rounding of x itself moves y by about 1% of max|y|, as
    much as that rule allows. So the kernel's quantization pass must equal
    the plain one bit for bit, and each output element must equal the
    plain f32 result within A8B_REL * |y| + A8B_ABS * max|y|. The int4b
    output on the same operands (bf16 activations, no int8 rounding) is a
    control that must fail the same check. Returns max|kernel - plain|."""
    err, bad, control, scale = a8b_case(x, w, s, zp, n, k)
    log(f"parity {name}: quantization pass equal bit for bit; "
        f"max_abs_err={err:.6g} max|plain f32|={scale:.6g} "
        f"rel={err / scale:.3g}; elements outside {A8B_REL:.4g}|y| + "
        f"{A8B_ABS} max|y|: kernel {bad}, int4b control {control} of "
        f"{x.shape[0] * n}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    if not control:
        raise AssertionError(f"{name}: the check cannot tell a8b from int4b")
    return err


def int4b_case(x, w, s, zp, n, k, group=128):
    """One int4b case (mode ``int4b`` of ``w4a16_matmul``) against its plain
    f32 version: (max|kernel - plain f32|, elements outside the a8b rule,
    max|plain f32|). Exact integer weights and f32 sums leave the bf16
    output rounding and the f32 summation order, which the rule allows."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kw = dict(n=n, k=k, group_size=group)
    got = w4.w4a16_matmul(x, w, s, zp, **kw).float()
    want = w4.w4a16_matmul_plain(x, w, s, zp, out_dtype=torch.float32, **kw)
    if not bool(got.isfinite().all()):
        raise AssertionError(f"int4b M={x.shape[0]} N={n} K={k} g={group}: "
                             "non-finite output")
    scale = want.abs().max().item()
    diff = (got - want).abs()
    bad = int((diff > A8B_REL * want.abs() + A8B_ABS * scale).sum())
    return diff.max().item(), bad, scale


def check_int4b(name, x, w, s, zp, n, k, group=128):
    """int4b against its plain f32 version by the a8b rule (every element
    within A8B_REL * |y| + A8B_ABS * max|y|); returns max|kernel - plain|."""
    err, bad, scale = int4b_case(x, w, s, zp, n, k, group)
    log(f"parity {name}: max_abs_err={err:.6g} max|plain f32|={scale:.6g} "
        f"rel={err / scale:.3g}; elements outside {A8B_REL:.4g}|y| + "
        f"{A8B_ABS} max|y|: {bad} of {x.shape[0] * n}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
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
    log(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cudnn (float32 references run in full "
        "float32)")
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serialized = {}
    resources = kernel_resources(_build.ptxas_report(REDESIGNED, serialized))
    serialized = kernel_resources(serialized)
    for name, (regs, spill) in resources.items():
        log(f"resources {name}: {regs} registers, {spill} bytes spilled"
            + (f", wgmmas serialized ({', '.join(serialized[name])})"
               if name in serialized else ""))
    log(f"ptxas report of {', '.join(REDESIGNED)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return resources, serialized


# the sources of the kernels redesigned for Hopper, whose registers and
# spills the script reports
REDESIGNED = ("prefill_attention.cu", "w4a16_planes.cu", "wna16_matmul.cu",
              "w8a8_matmul.cu", "paged_decode.cu", "w4a16_matmul.cu",
              "decode_attention.cu", "mla_decode.cu")
CACHE_NAMES = ("bf16", "e4m3", "int8")    # ct::CacheKind order


def kernel_resources(report):
    """ptxas's {mangled name: (registers, spill bytes)} of the redesigned
    kernels under readable names."""
    import re

    from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
        PLANE_MODES,
    )

    out = {}
    for mangled, value in report.items():
        m = re.search(r"(w8a8_decode|w8a8_prefill|quantize_rows)_kernelILb"
                      r"([01])E(?:Li(\d+)E)?E", mangled)
        if m:
            name = {"quantize_rows": "w8a8_quantize"}.get(m.group(1),
                                                          m.group(1))
            rows = f", BM={m.group(3)}" if m.group(3) else ""
            out[f"{name}<{'fp8' if m.group(2) == '1' else 'int8'}{rows}>"] = \
                value
            continue
        m = re.search(r"int4b3(?:dec13decode_kernelILi(\d)EE|pre14prefill_kernel)",
                      mangled)
        if m:
            out["w4a16_int4b_prefill<128 x 192>" if m.group(1) is None else
                f"w4a16_int4b_decode<BM={16 * int(m.group(1))}>"] = value
            continue
        m = re.search(r"w4a8_kernelILb([01])ELb([01])EE", mangled)
        if m:
            out[f"w4a16_a8b<{'group % 128 = 64' if m.group(1) == '1' else 'group % 128 = 0'}"
                f"{', 4-byte scale copies' if m.group(2) == '0' else ''}>"] = value
            continue
        m = re.search(r"block_decode_kernelILi(\d+)ELi(\d)ELb([01])EE", mangled)
        if m:
            out[f"block_decode<D={m.group(1)}, {CACHE_NAMES[int(m.group(2))]}, "
                f"{'scores' if m.group(3) == '1' else 'recompute'}>"] = value
            continue
        m = re.search(r"latent_kernelILb([01])ELi(\d)ELi(\d)ELi(\d)EE", mangled)
        if m:
            width = (f"K {64 * int(m.group(3))}, " if m.group(3) != "0"
                     else "")
            out[f"latent_decode<{'paged' if m.group(1) == '1' else 'dense'}, "
                f"{CACHE_NAMES[int(m.group(2))]}, {width}{m.group(4)} "
                "chunks>"] = value
            continue
        m = re.search(r"latent_merge_kernelILb([01])EE", mangled)
        if m:
            out[f"latent_merge<{'scaled' if m.group(1) == '1' else 'bf16'}>"] \
                = value
            continue
        m = re.search(r"split_kernelILi(\d+)ELb([01])ELi(\d)EE", mangled)
        if m:
            out[f"decode_split<D={m.group(1)}, "
                f"{'paged' if m.group(2) == '1' else 'dense'}, "
                f"{CACHE_NAMES[int(m.group(3))]}>"] = value
            continue
        m = re.search(r"merge_kernelILi(\d+)ELb([01])EE", mangled)
        if m:
            out[f"decode_merge<D={m.group(1)}"
                f"{', scaled' if m.group(2) == '1' else ''}>"] = value
            continue
        m = re.search(r"wna16_(decode|prefill)_wgmma_kernelIN\w*?(Fp4|Int8)"
                      r"(?:ILb([01])EE)?E(?:Li(\d+)E)?", mangled)
        if m:
            weight = {None: "fp4", "1": "int8", "0": "int8, any group"}[
                m.group(3)]
            out[f"wna16_{m.group(1)}<{weight}, BM={m.group(4) or 128}>"] = value
            continue
        m = re.search(r"(prefill_kernel|planes_kernel)I((?:Li\d+E)+)E", mangled)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(2))]
        if m.group(1) == "prefill_kernel":
            name = f"prefill_attention<D={args[0]}>"
        else:
            mode, bm, g, passes = args
            name = (f"w4a16_planes<{PLANE_MODES[mode]}, BM={bm}, g={g}, "
                    f"passes={passes}>")
        out[name] = value
    return dict(sorted(out.items()))


def phase_parity():
    """Each kernel against its plain version on the card, bf16 inputs."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        prefill_attention as pa,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    errs = {}
    e = 0.0
    for name, (n, k) in W4_SHAPES.items():
        for m in (BATCH, BATCH * PROMPT):
            x, w, s, _ = w4_inputs(rng, n, k, m, dev)
            e = max(e, check_int4b(f"w4a16 {name} M={m}", x, w, s, None, n,
                                   k))
    x, w, s, zp = w4_inputs(rng, 2048, 2048, BATCH, dev, asym=True)
    errs["w4a16_matmul"] = max(e, check_int4b("w4a16 zero-point", x, w, s,
                                              zp, 2048, 2048))

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
    parity_grids(errs)

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


# the shape grids of tests/test_torch_cuda_kernels.py for the kernels
# redesigned for Hopper: B4 over ragged and whole tiles, GQA folds that do
# not divide a tile, both head widths; B10 at every row count the main
# paths give, N not a multiple of its 128-column tile, K_orig below K_pad,
# with and without zero points
PREFILL_GRID = dict(S=(65, 70, 128, 512, 1000), rep=(1, 4, 7, 8), D=(64, 128),
                    B=(1, 3))
PLANES_GRID = dict(M=(1, 64, 100, 512),
                   shapes=((200, 448, 32, False), (328, 1984, 128, True)))
# B8 and B9 at every row count the main paths give (decode rows 1 and 64,
# 128-row prefill tiles above), N not a multiple of the 128-column tile,
# fp4 K a multiple of 32 but not of the 64-deep k-tile (1056), groups 16,
# 32 and 128, and a K split over a cluster that cuts a group (1152 / 128)
WNA16_GRID = dict(M=(1, 64, 65, 127, 128, 300, 512),
                  shapes=((200, 1056, 16), (328, 2048, 32), (136, 1152, 128)))
# B3 (int8 and fp8) at every row count the paths give (decode rows 1-64,
# 128-row prefill tiles above), N not a multiple of the 128-column tile,
# K from one 64-deep tail to 14336, 1280 (10 k-tiles) cut unevenly by a
# cluster split
W8A8_GRID = dict(M=(1, 16, 63, 64, 65, 128, 300, 512),
                 shapes=((200, 64), (328, 1280), (136, 14336)))
# B2 (a8b) at every row count the paths give (decode rows under
# w4_act="int8", ragged serving chunks of 256-512 rows, 1024), N not a
# multiple of the 128-column tile (198 also not of 4: 4-byte scale copies
# and a scalar store), K 4096 and 14336 and 1344 (10.5 k-tiles, cut unevenly
# by a split), groups 64 and 128 and channel-wise (1344: an odd multiple of
# 64), with and without zero points
A8B_GRID = dict(M=(1, 64, 65, 256, 300, 512, 1024),
                shapes=((200, 4096, 64, False), (328, 14336, 128, True),
                        (198, 1344, 1344, True), (136, 1344, 1344, False)))
# B1 (int4b) at every row count the paths give (decode rows 1, 7 and 64;
# 128-row prefill tiles from 65, serving chunks of 255 and 512 rows), N not
# a multiple of either design's column tile (200) and the TinyLlama and 8B
# widths, K an odd multiple of 64 (1344) and 14336, groups 64, 128 and
# channel-wise, with and without zero points; one 8192-row TinyLlama
# prefill; and N = 200 with K of 1-13 k-tiles at a decode and a prefill
# row count, which reach every K split the plan can choose in each design
INT4B_GRID = dict(M=(1, 7, 64, 65, 255, 512),
                  shapes=((200, 1344, 64, True), (200, 1344, 1344, False),
                          (2560, 2048, 128, False), (11264, 2048, 128, True),
                          (4096, 14336, 128, False), (6144, 4096, 4096, True)),
                  prefill=(8192, 11264, 2048, 128, False),
                  splits=((7, 65), (200, 64, True), range(1, 14)))
# B6/B7 on every cache type: lengths 0, 1, 63-65, each side of a split
# boundary (``SPLIT_TILES`` * 64) and S_pad - 1, an inactive row; the GQA
# folds of the models and the extremes, both head widths
DECODE_GRID = dict(rep=(1, 4, 7, 8, 16), D=(64, 128),
                   cache=("bf16", "fp8", "int8"), KVH=2)
# B5 (block decode) on every cache type with per-tensor and per-kv-head
# scales: the GQA folds and both head widths as above, S_pad 64, 192 and
# 511 (form "scores") and 700 (form "recompute": its scores do not fit in
# shared memory, decode_attn="block" only), lengths 0, 1, 63-65 (past a
# 64-position cache: a full row, nothing written), S_pad - 1, an inactive
# row
BLOCK_DECODE_GRID = dict(rep=(1, 4, 7, 8, 16), D=(64, 128),
                         cache=("bf16", "fp8", "int8"),
                         S_pad=(64, 192, 511, 700), KVH=2)


def parity_grids(errs):
    """B4, B10, B8 and B9 against their plain versions over
    ``PREFILL_GRID``, ``PLANES_GRID`` and ``WNA16_GRID`` (B4 within
    TOL_KERNEL * max|plain| per case, the others by the a8b rule), and the
    grids of B1, B2, B3 and B5-B7, one summary line per kernel."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        prefill_attention as pa,
        w4a16_matmul as w4,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    worst, cases = 0.0, 0
    for S, rep, D, B in itertools.product(*PREFILL_GRID.values()):
        q, k, v = (dev_randn(gen, B, S, h, D) for h in (2 * rep, 2, 2))
        got = pa.prefill_attention(q, k, v).float()
        want = pa.prefill_attention_plain(q, k, v).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not (bool(got.isfinite().all()) and rel <= TOL_KERNEL):
            raise AssertionError(f"prefill_attention B={B} S={S} rep={rep} "
                                 f"D={D}: {rel} of max|plain|")
        worst, cases = max(worst, rel), cases + 1
        errs["prefill_attention"] = max(errs["prefill_attention"],
                                        (got - want).abs().max().item())
    log(f"parity prefill_attention over {cases} shapes (S, rep, B, D of "
        f"{PREFILL_GRID}): max error {worst:.4g} of max|plain| (limit "
        f"{TOL_KERNEL})")
    parity_grid_w8a8(errs, gen)
    parity_grid_int4b(errs, gen)
    parity_grid_a8b(errs, gen)
    parity_grid_decode(errs, gen)
    parity_grid_block_decode(errs, gen)
    outside, cases = 0, 0
    for (n, k, g, asym), m in itertools.product(PLANES_GRID["shapes"],
                                                PLANES_GRID["M"]):
        k_pad, tk = w4.padded_k(k, g), w4.choose_k_tile(k, g)
        u = torch.randint(0, 16, (n, k_pad), generator=gen, device="cuda",
                          dtype=torch.int32)
        u[:, k:] = 8
        words = w4.repack_w4_for_kernel(u, 4, k_pad, tk)
        s = torch.rand((k_pad // g, n), generator=gen, device="cuda") \
            * 2e-3 + 1e-3
        s[-(-k // g):] = 0
        zp = (torch.randint(-8, 8, (k_pad // g, n), generator=gen,
                            device="cuda").float() if asym else None)
        x = dev_randn(gen, m, k)
        for mode in w4.PLANE_MODES:
            kw = dict(n=n, k=k_pad, group_size=g, mode=mode)
            got = w4.w4a16_planes_matmul(x, words, s, zp, **kw).float()
            want = w4.w4a16_planes_matmul_plain(x, words, s, zp,
                                                out_dtype=torch.float32, **kw)
            diff = (got - want).abs()
            outside += int((diff > A8B_REL * want.abs()
                            + A8B_ABS * want.abs().max()).sum())
            cases += 1
            name = f"w4a16_planes_{mode}"
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
    log(f"parity w4a16_planes over {cases} cases (3 modes x M "
        f"{PLANES_GRID['M']} x (N, K, g, zero points) "
        f"{PLANES_GRID['shapes']}): {outside} elements outside the a8b rule")
    if outside:
        raise AssertionError(f"w4a16_planes: {outside} elements outside the "
                             "a8b rule")
    parity_grid_wna16(errs, gen)


def parity_grid_wna16(errs, gen):
    """B8 (fp4 codes) and B9 (int8) against their plain versions over
    ``WNA16_GRID`` by the a8b rule, with the design and K split each case
    ran (``wna16_plan``): both designs, splits in both, and splits that cut
    a group in both must occur."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    outside, cases, seen = 0, 0, set()
    for (n, k, g), m in itertools.product(WNA16_GRID["shapes"],
                                          WNA16_GRID["M"]):
        x = dev_randn(gen, m, k)
        codes = torch.randint(0, 256, (n, k // 2), generator=gen,
                              device="cuda", dtype=torch.uint8)
        w8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        s = torch.rand((k // g, n), generator=gen, device="cuda") * 2e-3 \
            + 1e-3
        kw = dict(n=n, k=k, group_size=g)
        for name, weight, run, plain, wt in (
                ("w4a16_fp4_matmul", "fp4", w4.w4a16_fp4_matmul,
                 w4.w4a16_fp4_matmul_plain, codes),
                ("w4_e8_matmul", "int8", w4.w4_e8_matmul,
                 w4.w4_e8_matmul_plain, w8)):
            got = run(x, wt, s, **kw).float()
            want = plain(x, wt, s, out_dtype=torch.float32, **kw)
            diff = (got - want).abs()
            outside += int((diff > A8B_REL * want.abs()
                            + A8B_ABS * want.abs().max()).sum())
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
            _, splits, per = w4.wna16_plan(m, n, k)
            design = w4.wna16_design(m)
            seen |= {design} | ({(design, "split")} if splits > 1 else set()) \
                | ({(design, "cut")} if splits > 1 and per * 64 % g else set())
            cases += 1
    log(f"parity w4a16_fp4_matmul and w4_e8_matmul over {cases} cases (M "
        f"{WNA16_GRID['M']} x (N, K, g) {WNA16_GRID['shapes']}; designs, "
        f"cluster splits and groups cut by a split reached: {sorted(seen, key=str)}): "
        f"{outside} elements outside the a8b rule")
    if outside:
        raise AssertionError(f"wna16: {outside} elements outside the a8b "
                             "rule")
    if len(seen) < 6:
        raise AssertionError(f"wna16 grid reached only {seen}")


def parity_grid_w8a8(errs, gen):
    """B3, int8 and fp8, against its plain version over ``W8A8_GRID``: the
    quantized rows and their scales equal bit for bit, every output
    element within the a8b rule; the designs, cluster splits and uneven
    splits (``w8a8_plan``) each case reached must cover both designs."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    outside, cases, seen = 0, 0, set()
    for (n, k), m in itertools.product(W8A8_GRID["shapes"], W8A8_GRID["M"]):
        x = dev_randn(gen, m, k)
        for name, (w, s) in (
                ("w8a8_matmul", (torch.randint(
                    -127, 128, (n, k), generator=gen, device="cuda",
                    dtype=torch.int8), torch.rand(
                    (n,), generator=gen, device="cuda") * 2e-4 + 1e-4)),
                ("w8a8_matmul_fp8", fp8_weight(gen, n, k))):
            xq = torch.empty((m, k), dtype=w.dtype, device="cuda")
            xs = torch.empty((m,), dtype=torch.float32, device="cuda")
            got = w8.w8a8_matmul(x, w, s, n=n, k=k, xq=xq, xs=xs).float()
            xq_p, xs_p = w8.quantize_rows_plain(x, w.dtype)
            if not (torch.equal(xq.view(torch.uint8), xq_p.view(torch.uint8))
                    and torch.equal(xs, xs_p)):
                raise AssertionError(f"{name} M={m} N={n} K={k}: quantized "
                                     "rows differ from plain")
            want = w8.w8a8_matmul_plain(x, w, s, n=n, k=k,
                                        out_dtype=torch.float32)
            diff = (got - want).abs()
            outside += int((diff > A8B_REL * want.abs()
                            + A8B_ABS * want.abs().max()).sum())
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
            cases += 1
        bm, splits, per = w8.w8a8_plan(m, n, k)
        design = "decode" if bm <= 64 else "prefill"
        seen |= {design} | ({(design, "split")} if splits > 1 else set()) \
            | ({(design, "uneven")} if splits * per != -(-k // 128) else set())
    log(f"parity w8a8_matmul (int8 and fp8) over {cases} cases (M "
        f"{W8A8_GRID['M']} x (N, K) {W8A8_GRID['shapes']}; designs and "
        f"cluster splits reached: {sorted(seen, key=str)}): quantized rows "
        f"equal bit for bit, {outside} elements outside the a8b rule")
    if outside:
        raise AssertionError(f"w8a8: {outside} elements outside the a8b rule")
    if not {"decode", "prefill", ("decode", "split"),
            ("decode", "uneven")} <= seen:
        raise AssertionError(f"w8a8 grid reached only {seen}")


def parity_grid_a8b(errs, gen):
    """B2 (mode a8b) against its plain version over ``A8B_GRID``: the
    quantized rows and their scales equal bit for bit, every output element
    within the a8b rule, and the int4b control on the same operands outside
    it; the K splits each case ran (``a8b_plan``) must include an uneven
    one."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    worst, cases, bad, seen = 0.0, 0, 0, set()
    for (n, k, g, asym), m in itertools.product(A8B_GRID["shapes"],
                                                A8B_GRID["M"]):
        w = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        s = torch.rand((k // g, n), generator=gen, device="cuda") * 2e-3 \
            + 1e-3
        zp = (torch.randint(-8, 8, (k // g, n), generator=gen,
                            device="cuda").float() if asym else None)
        x = dev_randn(gen, m, k)
        err, out, control, scale = a8b_case(x, w, s, zp, n, k, g)
        if out or not control:
            raise AssertionError(
                f"a8b M={m} N={n} K={k} g={g} zero points {asym}: {out} "
                f"elements outside the a8b rule, int4b control {control}")
        errs["w4a16_a8b_matmul"] = max(errs.get("w4a16_a8b_matmul", 0.0), err)
        worst, cases = max(worst, err / scale), cases + 1
        splits, per = w4.a8b_plan(m, n, k)
        seen |= {"split"} if splits > 1 else set()
        seen |= {"uneven"} if splits * per * 128 > -(-k // 128) * 128 else set()
        bad += out
    log(f"parity w4a16_a8b_matmul over {cases} cases (M {A8B_GRID['M']} x "
        f"(N, K, g, zero points) {A8B_GRID['shapes']}; K splits reached: "
        f"{sorted(seen)}): quantized rows equal bit for bit, {bad} elements "
        f"outside the a8b rule (max error {worst:.4g} of max|plain|), the "
        "int4b control outside it in every case")
    if seen != {"split", "uneven"}:
        raise AssertionError(f"a8b grid reached only {seen}")


def parity_grid_int4b(errs, gen):
    """B1 (mode int4b) against its plain f32 version over ``INT4B_GRID`` by
    the a8b rule, each case through the design and K split ``int4b_plan``
    picks; both designs must be reached at every split the plan can choose
    (1-8 blocks of a cluster)."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    (ms, (n_s, g_s, zp_s), tiles_s) = INT4B_GRID["splits"]
    cases = list(itertools.product(INT4B_GRID["shapes"], INT4B_GRID["M"]))
    cases.append((INT4B_GRID["prefill"][1:], INT4B_GRID["prefill"][0]))
    cases += [((n_s, 64 * t, g_s, zp_s), m)
              for t, m in itertools.product(tiles_s, ms)]
    worst, bad, seen = 0.0, 0, set()
    for (n, k, g, asym), m in cases:
        w = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        s = torch.rand((k // g, n), generator=gen, device="cuda") * 2e-3 \
            + 1e-3
        zp = (torch.randint(-8, 8, (k // g, n), generator=gen,
                            device="cuda").float() if asym else None)
        x = dev_randn(gen, m, k)
        err, out, scale = int4b_case(x, w, s, zp, n, k, g)
        if out:
            raise AssertionError(
                f"int4b M={m} N={n} K={k} g={g} zero points {asym}: {out} "
                "elements outside the a8b rule")
        errs["w4a16_matmul"] = max(errs.get("w4a16_matmul", 0.0), err)
        worst, bad = max(worst, err / scale), bad + out
        _, splits, _ = w4.int4b_plan(m, n, k)
        seen.add((w4.int4b_design(m), splits))
        del w, s, zp, x
    torch.cuda.empty_cache()
    want = {(design, sp) for design in ("decode", "prefill")
            for sp in range(1, 9)}
    log(f"parity w4a16_matmul (int4b) over {len(cases)} cases (M "
        f"{INT4B_GRID['M']} x (N, K, g, zero points) {INT4B_GRID['shapes']}, "
        f"M, N, K = {INT4B_GRID['prefill'][:3]}, N = {n_s} with K of 1-13 "
        f"k-tiles at M {ms}; designs and K splits reached: {sorted(seen)}): "
        f"{bad} elements outside the a8b rule (max error {worst:.4g} of "
        "max|plain|)")
    if not want <= seen:
        raise AssertionError(f"int4b grid missed {sorted(want - seen)}")


def parity_grid_decode(errs, gen):
    """B6 and B7 against their plain versions over ``DECODE_GRID``: one
    batch of rows at every grid length on the slab cache and, through
    shuffled page tables, on the pool; outputs within TOL_KERNEL of both
    plain orders (one softmax, and the kernel's split order), inactive rows
    zero, cache bytes equal to the plain version's and changed at the
    step's positions only."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.models.llama import _quantize_to_cache
    from compressed_tensors_tpu_torch.ops.kernels import (
        flash_decode as fd,
        paged_decode as pd,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    kvh, page = DECODE_GRID["KVH"], 64
    rng = np.random.default_rng(13)
    worst, cases, spans = 0.0, 0, {}
    for rep, D, cache in itertools.product(*(DECODE_GRID[k] for k in (
            "rep", "D", "cache"))):
        dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
                 "int8": torch.int8}[cache]
        span = fd.SPLIT_TILES[dtype.itemsize] * fd.CHUNK
        spans[cache], s_pad = span, span + 192
        lens = [0, 1, 63, 64, 65, span - 1, span, span + 1, s_pad - 1, -1]
        B, P = len(lens), s_pad // page
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        active = lengths >= 0
        sc = CACHE_SCALES.get(cache)
        ks = vs = None if sc is None else torch.tensor([sc], device="cuda")

        def make(shape):
            return (dev_randn(gen, *shape) if sc is None
                    else dev_cache(gen, shape, dtype, sc))

        q, nk, nv = (dev_randn(gen, B, h, D) for h in (kvh * rep, kvh, kvh))
        tables = rng.permutation(np.arange(1, B * P + 1)).astype(
            np.int32).reshape(B, P)
        tables[~active.cpu().numpy()] = 0
        tables_d = torch.from_numpy(tables).cuda()
        nk_c = _quantize_to_cache(nk, ks, dtype, head_axis=1)
        nv_c = _quantize_to_cache(nv, vs, dtype, head_axis=1)
        for name, shape, kernel, plain, view, at in (
                ("flash_decode_attention", (2, B, kvh, s_pad, D),
                 lambda k, v: fd.flash_decode_attention(
                     q, nk, nv, k, v, lengths, layer=1, k_scale=ks,
                     v_scale=vs),
                 lambda k, v: fd.flash_decode_attention_plain(
                     q, nk, nv, k, v, lengths, layer=1, k_scale=ks,
                     v_scale=vs),
                 lambda c: c[1], lambda b: (b, lens[b])),
                ("paged_decode_attention", (2, B * P + 1, kvh, page, D),
                 lambda k, v: pd.paged_decode_attention(
                     q, nk, nv, k, v, tables_d, lengths, layer=1,
                     k_scale=ks, v_scale=vs),
                 lambda k, v: pd.paged_decode_attention_plain(
                     q, nk, nv, k, v, tables_d, lengths, layer=1,
                     k_scale=ks, v_scale=vs),
                 lambda c: byte_view(c[1])[tables_d.long()].permute(
                     0, 2, 1, 3, 4).reshape(B, kvh, s_pad, D).view(c.dtype),
                 lambda b: (int(tables[b, lens[b] // page]),
                            lens[b] % page))):
            ck, cv = make(shape), make(shape)
            ck0, cv0 = ck.clone(), cv.clone()
            split_want = fd.attend_plain(q, nk_c, nv_c, view(ck0), view(cv0),
                                         lengths, ks, vs, split=span).float()
            got = kernel(ck, cv)[0].float()
            ck_p, cv_p = ck0.clone(), cv0.clone()
            want = plain(ck_p, cv_p)[0].float()
            label = f"{name} rep={rep} D={D} {cache}"
            for ref in (want, split_want):
                rel = ((got[active] - ref[active]).abs().max()
                       / ref[active].abs().max()).item()
                if not (bool(got.isfinite().all()) and rel <= TOL_KERNEL):
                    raise AssertionError(f"{label}: {rel} of max|plain|")
                worst = max(worst, rel)
            if got[~active].any():
                raise AssertionError(f"{label}: inactive rows must be zero")
            if not (torch.equal(byte_view(ck), byte_view(ck_p))
                    and torch.equal(byte_view(cv), byte_view(cv_p))):
                raise AssertionError(f"{label}: cache bytes differ from plain")
            expect = [(1, *at(b)[:1], h, at(b)[1]) for b in range(B)
                      for h in range(kvh) if lens[b] >= 0]
            check_written(label, ck, ck0, expect)
            check_written(label, cv, cv0, expect)
            key = name + ("" if sc is None else "_scaled")
            errs[key] = max(errs.get(key, 0.0),
                            (got[active] - want[active]).abs().max().item())
            cases += 1
    log(f"parity flash/paged decode over {cases} cases (rep, D, cache of "
        f"{DECODE_GRID}, lengths 0, 1, 63-65, each side of the split "
        f"{spans} and S_pad - 1 (S_pad = split + 192), one inactive): max "
        "error "
        f"{worst:.4g} of max|plain| against the one-softmax and the split "
        f"plain orders (limit {TOL_KERNEL}); cache bytes equal, written at "
        "the step's positions only")


def parity_grid_block_decode(errs, gen):
    """B5 against its plain version over ``BLOCK_DECODE_GRID``: outputs
    within TOL_KERNEL of max|plain| in every case, inactive rows zero, cache
    bytes equal to the plain version's and changed at lengths[b] only (rows
    below S_pad); both forms of ``block_decode_form`` must run."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    kvh = BLOCK_DECODE_GRID["KVH"]
    worst, cases, forms = 0.0, 0, set()
    for rep, D, cache, s_pad in itertools.product(*(BLOCK_DECODE_GRID[k] for k
                                                    in ("rep", "D", "cache",
                                                        "S_pad"))):
        dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
                 "int8": torch.int8}[cache]
        lens = [0, 1, 63, 64, 65, s_pad - 1, -1]
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        active = lengths >= 0
        sc = CACHE_SCALES.get(cache)
        scale_sets = [(None, None)] if sc is None else [
            (torch.tensor([sc], device="cuda"),) * 2,
            (torch.tensor([sc, 0.8 * sc], device="cuda").reshape(kvh, 1, 1),
             torch.tensor([sc, 1.25 * sc], device="cuda").reshape(kvh, 1, 1))]
        q, nk, nv = (dev_randn(gen, B, h, D) for h in (kvh * rep, kvh, kvh))
        for ks, vs in scale_sets:
            shape = (2, B, kvh, s_pad, D)
            ck, cv = ((dev_randn(gen, *shape) if sc is None
                       else dev_cache(gen, shape, dtype, sc)) for _ in range(2))
            ck0, cv0 = ck.clone(), cv.clone()
            got = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1,
                                      k_scale=ks, v_scale=vs)[0].float()
            ck_p, cv_p = ck0.clone(), cv0.clone()
            want = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                             layer=1, k_scale=ks,
                                             v_scale=vs)[0].float()
            label = (f"decode_attention rep={rep} D={D} {cache} S_pad={s_pad}"
                     + ("" if ks is None else f" {ks.numel()} scale(s)"))
            err = (got[active] - want[active]).abs().max().item()
            rel = err / want[active].abs().max().item()
            if not (bool(got.isfinite().all()) and rel <= TOL_KERNEL):
                raise AssertionError(f"{label}: {rel} of max|plain|")
            if got[~active].any():
                raise AssertionError(f"{label}: inactive rows must be zero")
            if not (torch.equal(byte_view(ck), byte_view(ck_p))
                    and torch.equal(byte_view(cv), byte_view(cv_p))):
                raise AssertionError(f"{label}: cache bytes differ from plain")
            expect = [(1, b, h, lens[b]) for b in range(B) for h in range(kvh)
                      if 0 <= lens[b] < s_pad]
            check_written(label, ck, ck0, expect)
            check_written(label, cv, cv0, expect)
            key = "decode_attention" + ("" if sc is None else "_scaled")
            errs[key] = max(errs.get(key, 0.0), err)
            worst, cases = max(worst, rel), cases + 1
            forms.add(da.block_decode_form(s_pad))
    log(f"parity decode_attention over {cases} cases (rep, D, cache, S_pad "
        f"of {BLOCK_DECODE_GRID}, per-tensor and per-head scales, lengths 0, "
        f"1, 63-65, S_pad - 1, one inactive; forms {sorted(forms)}): max "
        f"error {worst:.4g} of max|plain| (limit {TOL_KERNEL}); cache bytes "
        "equal, written at lengths[b] only")
    if forms != {"scores", "recompute"}:
        raise AssertionError(f"block decode grid ran only {forms}")


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

    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    changed = torch.nonzero(
        (byte_view(after) != byte_view(before)).any(dim=-1)).tolist()
    if sorted(map(tuple, changed)) != sorted(expect):
        raise AssertionError(f"{name} wrote outside the step's positions")


def bound(nbytes, ops, peak):
    """(ms, what bounds it): the larger of the bytes at HBM_BPS and the
    operations at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def serving_tables(rng, inactive=()):
    """Page tables of the paged engine's full-residency pool: the pages
    1..NP-1 shuffled over the rows, ``inactive`` rows on the null page 0;
    returns (tables (B, P) int32 numpy, number of pool pages)."""
    per_row = SERVE["max_len"] // SERVE["page_size"]
    num_pages = BATCH * per_row + 1
    tables = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    tables = tables.reshape(BATCH, per_row)
    tables[list(inactive)] = 0
    return tables, num_pages


def check_serving_decode(errs, rng, q, nk, nv, make, label, ks=None,
                         vs=None):
    """Flash decode on the dense engine's (32, 64, KVH, 1024, 128) cache
    and paged decode on the paged engine's pool against their plain versions,
    with three rows inactive (released to the null page): outputs within
    TOL_KERNEL, inactive rows zero, the caches updated in place, their
    bytes equal to the plain version's and changed at the step's positions
    only. ``make(shape)`` builds a cache; with scales ``ks``/``vs`` the
    errors go to the ``_scaled`` counters' names in ``errs``."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        flash_decode as fd,
        paged_decode as pd,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    kvh = nk.shape[1]
    inactive = (3, 17, 40)
    lens_np, lengths = serving_lengths(rng, BATCH, inactive)
    active = lengths >= 0
    layer, page = 7, SERVE["page_size"]
    tables, num_pages = serving_tables(rng, inactive)
    tables_d = torch.from_numpy(tables).cuda()
    scales = dict(layer=layer, k_scale=ks, v_scale=vs)
    cases = {
        "flash_decode_attention": (
            (L8, BATCH, kvh, SERVE["max_len"], D8),
            lambda k, v: fd.flash_decode_attention(q, nk, nv, k, v, lengths,
                                                   **scales),
            lambda k, v: fd.flash_decode_attention_plain(
                q, nk, nv, k, v, lengths, **scales),
            lambda b: (b, int(lens_np[b]))),
        "paged_decode_attention": (
            (L8, num_pages, kvh, page, D8),
            lambda k, v: pd.paged_decode_attention(q, nk, nv, k, v, tables_d,
                                                   lengths, **scales),
            lambda k, v: pd.paged_decode_attention_plain(
                q, nk, nv, k, v, tables_d, lengths, **scales),
            lambda b: (int(tables[b, lens_np[b] // page]),
                       int(lens_np[b] % page))),
    }
    for name, (shape, kernel, plain, at) in cases.items():
        ck, cv = make(shape), make(shape)
        ck0, cv0 = ck.clone(), cv.clone()
        out, ck_r, cv_r = kernel(ck, cv)
        if ck_r.data_ptr() != ck.data_ptr() or cv_r.data_ptr() != cv.data_ptr():
            raise AssertionError(f"{name} did not update in place")
        ck_p, cv_p = ck0.clone(), cv0.clone()
        want, _, _ = plain(ck_p, cv_p)
        key = name + ("" if ks is None else "_scaled")
        errs[key] = max(errs.get(key, 0.0), check_close(
            f"{name} {label} {shape}", out[active], want[active]))
        if out[~active].any():
            raise AssertionError(f"{name}: inactive rows must be zero")
        if not (torch.equal(byte_view(ck), byte_view(ck_p))
                and torch.equal(byte_view(cv), byte_view(cv_p))):
            raise AssertionError(f"{name} {label} write differs from plain")
        expect = [(layer, at(b)[0], h, at(b)[1]) for b in range(BATCH)
                  for h in range(kvh) if b not in inactive]
        check_written(name, ck, ck0, expect)
        check_written(name, cv, cv0, expect)
        del ck, cv, ck0, cv0, ck_p, cv_p
    log(f"parity flash/paged decode, {label}: cache bytes equal to the plain "
        "version's, written at lengths[b] only; inactive rows and the null "
        "page 0 untouched")
    torch.cuda.empty_cache()


def time_serving_decode(rng, q, nk, nv, make, label, ks=None, vs=None,
                        widen=None):
    """Device ms of flash decode over the dense engine's cache and paged
    decode over its pool (shuffled tables) for one layer, the calls
    walking the 32 layers as a decode step does, at lengths 0-1000; bound,
    plain ms, and SDPA with GQA and a mask of the live prefix over the
    bf16 cache (``widen`` dequantizes a quantized one; the pool's pages
    gathered beforehand). Returns {kernel name: row}."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        flash_decode as fd,
        paged_decode as pd,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    widen = widen or (lambda c: c)
    H, kvh = q.shape[1], nk.shape[1]
    lens_np, lengths = serving_lengths(rng, BATCH, ())
    tables, num_pages = serving_tables(rng)
    tables_d = torch.from_numpy(tables).cuda()
    page, per_row = SERVE["page_size"], tables.shape[1]
    mask = (torch.arange(SERVE["max_len"], device="cuda")[None, :]
            <= lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    scales = dict(k_scale=ks, v_scale=vs)
    suffix = "" if ks is None else "_scaled"
    rows = {}
    for name, shape in (
            ("flash_decode_attention", (L8, BATCH, kvh, SERVE["max_len"], D8)),
            ("paged_decode_attention", (L8, num_pages, kvh, page, D8))):
        ck, cv = make(shape), make(shape)
        live = int((lens_np + 1).sum())
        b = (2 * live * kvh * D8 * ck.element_size()
             + (q.numel() + 2 * nk.numel()) * 2 * 2)
        bm, by = bound(b, 4 * H * D8 * live, PEAK_BF16)
        if name == "flash_decode_attention":
            t = device_ms([lambda i=i: fd.flash_decode_attention(
                q, nk, nv, ck, cv, lengths, layer=i, **scales)
                for i in range(L8)])
            tp = eager_ms(lambda: fd.flash_decode_attention_plain(
                q, nk, nv, ck, cv, lengths, layer=0, **scales))
            keys = [widen(ck[i]) for i in range(4)]
            values = [widen(cv[i]) for i in range(4)]
            how = "mask of the live prefix over S_pad"
        else:
            t = device_ms([lambda i=i: pd.paged_decode_attention(
                q, nk, nv, ck, cv, tables_d, lengths, layer=i, **scales)
                for i in range(L8)])
            tp = eager_ms(lambda: pd.paged_decode_attention_plain(
                q, nk, nv, ck, cv, tables_d, lengths, layer=0, **scales))

            def gathered(pool, i):
                return widen(byte_view(pool[i])[tables_d.long()].permute(
                    0, 2, 1, 3, 4).reshape(BATCH, kvh, per_row * page, D8)
                    .view(pool.dtype))

            keys = [gathered(ck, i) for i in range(4)]
            values = [gathered(cv, i) for i in range(4)]
            how = "a copy gathered beforehand into a contiguous cache"
        try:
            tl = device_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask, enable_gqa=True)
                for k, v in zip(keys * (L8 // 4), values * (L8 // 4))])
        except (RuntimeError, TypeError) as exc:
            log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
            tl = None
        del ck, cv, keys, values
        torch.cuda.empty_cache()
        rows[name + suffix] = dict(
            ms=t, plain_ms=tp, bound_ms=bm, bound_by=by, library_ms=tl,
            shapes=f"{label} {shape}, one layer, lengths 0-1000; library: "
            f"SDPA over the cache in bf16 ({how})")
    return rows


def phase_parity_8b(errs):
    """The kernels of the serving path against their plain versions at
    Llama-3-8B shapes, bf16 on the card; updates ``errs``."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        prefill_attention as pa,
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
        for m in (BATCH, M_CHUNK):
            x, w, s, _ = w4_inputs(rng, n, k, m, dev)
            keep("w4a16_matmul", check_int4b(f"w4a16 {name} M={m} (8B)", x,
                                             w, s, None, n, k))

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

    check_serving_decode(errs, rng, q, nk, nv,
                         lambda shape: dev_randn(gen, *shape), "bf16 cache")


def tiny_greedy(params, config, label, kinds=(), plain=None):
    """Phase 3's run on ``params`` (fused): greedy_generate at batch 64
    (128-token prompts, numpy seed 0, 32 new tokens) after a warm-up, its
    launches, the launches of one decode step, prefill ms and decode
    ms/step; the first-step logits against the non-kernel path, or with
    ``plain`` (a context manager factory) against the kernel path run
    inside it (the distance to the non-kernel path printed beside it),
    within TOL_E2E * max|ref|, and with ``kinds`` the same check with the
    kernel scales of those layouts rolled (``rolled_group_scales``), which
    must fail it. Returns the tokens, the counts and the times."""
    import torch

    from compressed_tensors_tpu_torch.engine import (
        greedy_generate,
        make_step_fns,
    )

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, config.vocab_size,
                                        size=(BATCH, PROMPT))).cuda()
    greedy_generate(params, config, ids, max_new_tokens=2)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, config, ids, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    if out.shape != (BATCH, PROMPT + NEW_TOKENS) or not bool(
            ((out >= 0) & (out < config.vocab_size)).all()):
        raise AssertionError(f"{label} greedy_generate: ids out of range")
    prefill, decode = make_step_fns(config, PROMPT + NEW_TOKENS)
    token, cache, logits = prefill(params, ids, PROMPT)
    nk = make_step_fns(config, PROMPT + NEW_TOKENS, use_kernels=False)[0](
        params, ids, PROMPT)[2].float()
    ref = nk
    if plain is not None:
        with plain():
            ref = prefill(params, ids, PROMPT)[2].float()
    scale = ref.abs().max().item()
    err = (logits.float() - ref).abs().max().item() / scale
    log(f"{label} first-step logits vs "
        f"{'non-kernel' if plain is None else 'plain'} path: max {err:.4g} "
        f"of max|ref| {scale:.4g} (limit {TOL_E2E}); vs the non-kernel "
        f"path max {(logits.float() - nk).abs().max().item() / scale:.4g}, "
        f"argmax agreement "
        f"{(logits.argmax(-1) == nk.argmax(-1)).float().mean().item():.3f}")
    if not bool(torch.isfinite(logits).all()) or err > TOL_E2E:
        raise AssertionError(f"{label} first-step logits disagree with the "
                             "non-kernel path")
    if kinds:
        with rolled_group_scales(params, kinds):
            bad = prefill(params, ids, PROMPT)[2].float()
        bad_err = (bad - ref).abs().max().item() / scale
        log(f"{label} control, {'/'.join(kinds)} kernel scales rolled by "
            f"one: max {bad_err:.4g} of max|ref|")
        if bad_err <= TOL_E2E:
            raise AssertionError(f"{label} logits check accepted the planted "
                                 "fault (scales rolled by one)")
    prefill_ms = eager_ms(lambda: prefill(params, ids, PROMPT))
    state = {"token": token, "cache": cache}

    def one_step():
        state["token"], state["cache"] = decode(params, state["token"],
                                                state["cache"])

    torch.cuda.synchronize()
    reset_counts()
    one_step()
    per_step = read_counts()
    steps = NEW_TOKENS - 2
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    log(f"{label} greedy_generate: {tuple(out.shape)} in {total * 1e3:.1f} "
        f"ms; prefill {prefill_ms:.2f} ms (B={BATCH}, S={PROMPT}); decode "
        f"{decode_ms:.3f} ms/step = {BATCH / decode_ms * 1e3:.0f} tok/s; "
        f"kernel launches {counts}; per decode step {per_step}")
    return dict(out=out, counts=counts, per_step=per_step, wall=total,
                prefill_ms=prefill_ms, decode_ms=decode_ms)


def phase_end_to_end():
    import torch

    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        TINYLLAMA_1_1B,
        make_synthetic_llama,
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    # the kernels this path must launch (TinyLlama widths never select a8b,
    # and S_pad 192 selects the block decode kernel)
    needs = ("w4a16_matmul", "w8a8_matmul", "prefill_attention",
             "decode_attention")

    config = TINYLLAMA_1_1B
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
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

    res = tiny_greedy(params, config, "TinyLlama W4A16")
    missing = [k for k in needs if res["counts"][k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return dict(run_counts=res["counts"], per_step=res["per_step"])


def serving_requests(vocab=VOCAB8):
    """96 requests drawn with numpy seed 0: prompt lengths uniform in
    64-768 (257-768 for the third that begin with the shared 256-token
    prefix, so each holds the whole prefix and a token of its own), new
    tokens uniform in 16-64, token ids below ``vocab``."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=SHARED_PREFIX).tolist()
    reqs = []
    for i in range(N_REQUESTS):
        shared = i % SHARE_EVERY == 0
        low = SHARED_PREFIX + 1 if shared else PROMPT_LENS[0]
        n = int(rng.integers(low, PROMPT_LENS[1] + 1))
        ids = rng.integers(0, vocab, size=n).tolist()
        if shared:
            ids[:SHARED_PREFIX] = prefix
        reqs.append((i, ids, int(rng.integers(NEW_LENS[0], NEW_LENS[1] + 1))))
    return reqs


def serve_requests(params, config, requests, name, keep=False, **kw):
    """The requests through one ServingEngine run (``SERVE`` settings plus
    ``kw``): the completions, the kernel launches of the run and per decode
    step, and host-clock times (prefill per chunk, synchronized; decode
    per step, each burst ending in the trace's host copy); with ``keep``
    also the engine itself, its cache as the run left it."""
    import torch

    from compressed_tensors_tpu_torch.engine import Request, ServingEngine

    engine = ServingEngine(params, config, **SERVE, **kw)
    timing = {"prefill_s": 0.0, "chunks": 0, "decode_s": 0.0, "steps": 0,
              "chunk_rows": []}
    prefill_chunk, decode = engine._prefill_chunk, engine._decode

    def timed_prefill(*a):
        t = time.perf_counter()
        out = prefill_chunk(*a)
        torch.cuda.synchronize()
        timing["prefill_s"] += time.perf_counter() - t
        timing["chunks"] += 1
        timing["chunk_rows"].append(len(a[1]))  # (slot, piece, start)
        return out

    def timed_decode(active, burst):
        before = read_counts()
        t = time.perf_counter()
        out = decode(active, burst)  # ends in the trace's host copy
        timing["decode_s"] += time.perf_counter() - t
        timing["steps"] += burst
        after = read_counts()
        timing.setdefault("per_step", {
            k: (after[k] - before[k]) / burst for k in after})
        return out

    engine._prefill_chunk, engine._decode = timed_prefill, timed_decode
    for i, ids, new in requests:
        engine.submit(Request(request_id=i, prompt_ids=ids,
                              max_new_tokens=new))
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
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
    if sorted(outs) != sorted(i for i, _, _ in requests) or any(
            len(outs[i]) != new for i, _, new in requests):
        raise AssertionError(f"serving {name}: completions missing")
    if not all(0 <= t < config.vocab_size for o in outs.values()
               for t in o):
        raise AssertionError(f"serving {name}: token ids out of range")
    out = dict(outs=outs, counts=counts, wall=wall,
               hits=engine.prefix_cache_hits, **timing)
    del engine._prefill_chunk, engine._decode
    if keep:
        out["engine"] = engine
    del engine  # frees its cache unless kept
    torch.cuda.empty_cache()
    return out


def probe_request(requests):
    """The request whose first-token logits the logits checks read: the
    first one whose prompt fits one prefill chunk and holds the prefix."""
    return next(r for r in requests
                if SHARED_PREFIX <= len(r[1]) <= SERVE["prefill_chunk"])


def first_token_logits(params, config, ids, depth, use_kernels, label,
                       cache_dtype=None):
    """f32 first-token logits of the prompt ``ids`` through the first
    ``depth`` layers (full width), the KV cache checked for NaN."""
    return ptq_logits(params, config, ids, depth, use_kernels,
                      cache_dtype=cache_dtype, label=label)[0]


def rel_rms(a, b):
    return ((a - b).norm() / b.norm()).item()


def logits_by_depth(params, config, requests, label, cache_dtype=None,
                    fault=None, depths=DEPTHS, plain=None, ref_params=None):
    """One request's first-token logits through the first d layers (full
    width) for each d in DEPTHS: the kernel path, the reference, and the
    non-kernel path with one bf16 ulp up on 64 embedding values of one
    prompt token (that path's own spread). The reference is the non-kernel
    path, or with ``plain`` (a context manager factory) the kernel path run
    inside it, every matmul of some kernel through that kernel's plain
    version; the distance to the non-kernel path is printed beside it.
    Returns ``(sweep, faulty)``: sweep is {d: (relative RMS error kernel vs
    reference, relative RMS of the perturbed non-kernel logits,
    max|kernel - reference| / max|reference|)}; faulty is the same for the
    kernel path run inside the context manager ``fault`` (a planted
    fault), or {} without one. ``ref_params`` (sharing ``params``'
    embedding table) runs the non-kernel path in place of ``params``."""
    rid, ids, _ = probe_request(requests)
    n = len(ids)
    ref_name = "non-kernel path" if plain is None else "plain path"

    def logits(depth, use_kernels):
        return first_token_logits(
            params if use_kernels or ref_params is None else ref_params,
            config, ids, depth, use_kernels, label, cache_dtype)

    emb, tok = params["embed_tokens"], ids[n // 3]
    row = emb[tok].clone()
    sweep, refs = {}, {}
    for depth in depths:
        got = logits(depth, True)
        nk = logits(depth, False)
        if plain is None:
            ref = nk
        else:
            with plain():
                ref = logits(depth, True)
        refs[depth] = ref
        emb[tok, :64] = (row[:64].float() * (1 + 2**-7)).to(emb.dtype)
        moved = logits(depth, False)
        emb[tok] = row
        top = ref.abs().max().item()
        sweep[depth] = (rel_rms(got, ref), rel_rms(moved, nk),
                        (got - ref).abs().max().item() / top)
        versus = ("" if plain is None else
                  f"; vs the non-kernel path rel_rms={rel_rms(got, nk):.4g} "
                  f"(max {(got - nk).abs().max().item() / nk.abs().max().item():.4g}"
                  f" of max|ref|), argmax {int(nk.argmax())}")
        log(f"{label} first-token logits (request {rid}), {depth} of "
            f"{config.num_hidden_layers} layers: kernel vs {ref_name} "
            f"rel_rms={sweep[depth][0]:.4g} (max abs "
            f"{(got - ref).abs().max().item():.4g} of max|ref| {top:.4g}, "
            f"{sweep[depth][2]:.4g}); non-kernel path under the perturbation "
            f"rel_rms={sweep[depth][1]:.4g}; argmax kernel "
            f"{int(got.argmax())} reference {int(ref.argmax())}{versus}")
    faulty = {}
    if fault is not None:
        with fault:
            for depth, ref in refs.items():
                bad = logits(depth, True)
                faulty[depth] = (rel_rms(bad, ref), sweep[depth][1],
                                 (bad - ref).abs().max().item()
                                 / ref.abs().max().item())
    return sweep, faulty


GROUP_KINDS = ("w4a16", "fp4", "w4e8", "w4packed")


@contextlib.contextmanager
def rolled_group_scales(params, kinds=GROUP_KINDS):
    """A planted kernel fault: the kernel scales of every W4 (int4 words or
    int32 planes), fp4 and grouped-int8 decoder linear (MoE expert stacks
    included) rolled by one group, so that each
    group is read with its neighbour's scale (an off-by-one group index);
    with "w8a8" in ``kinds`` also every W8A8 decoder linear's per-channel
    scales by one channel; undone on exit. The non-kernel path reads the
    checkpoint's scales and is not touched."""
    from compressed_tensors_tpu_torch.ops.linear import QuantizedTensor

    linears = [qt for layer in params["layers"] for qt in layer.values()]
    linears += [qt for layer in params["layers"] if "moe" in layer
                for qt in layer["moe"]["experts"].values()]
    # stacked experts' (E, K/g, N) scales roll along their group dim
    scales = [(qt.kernel_scales, max(qt.kernel_scales.dim() - 2, 0))
              for qt in linears
              if isinstance(qt, QuantizedTensor) and qt.kernel_meta
              and qt.kernel_meta[0] in kinds]
    for s, dim in scales:
        s.copy_(s.roll(1, dim))
    try:
        yield
    finally:
        for s, dim in scales:
            s.copy_(s.roll(-1, dim))


def logits_rule_failures(sweep):
    """Phases 7-8's logits rule on a ``logits_by_depth`` sweep; returns
    what it fails. At one layer max|kernel - non-kernel| within
    TOL_WNA16_DEPTH1 * max|ref|; at every depth within TOL_E2E_8B *
    max|ref|, or the relative RMS error within FLOOR_RATIO times the
    non-kernel path's own spread under the one-ulp perturbation."""
    out = []
    if sweep[1][2] > TOL_WNA16_DEPTH1:
        out.append(f"one layer: {sweep[1][2]:.4g} of max|ref| > "
                   f"{TOL_WNA16_DEPTH1}")
    for depth, (err, spread, top) in sweep.items():
        if top > TOL_E2E_8B and err > FLOOR_RATIO * spread:
            out.append(f"{depth} layers: {top:.4g} of max|ref| > "
                       f"{TOL_E2E_8B} and rel_rms {err:.4g} > {FLOOR_RATIO} "
                       f"x the spread {spread:.4g}")
    return out


def spread_rule_failures(sweep):
    """The spread arm of ``logits_rule_failures`` alone: at every depth
    the relative RMS error within FLOOR_RATIO times the reference's own
    spread under the one-ulp perturbation."""
    return [f"{depth} layers: rel_rms {err:.4g} > {FLOOR_RATIO} x the "
            f"spread {spread:.4g}"
            for depth, (err, spread, _) in sweep.items()
            if err > FLOOR_RATIO * spread]


def check_logits_by_depth(params, config, requests, label, depths=DEPTHS,
                          plain=None, ref_params=None, kinds=GROUP_KINDS):
    """The logits checks of phases 5 and 7-10.

    - The rule of ``logits_rule_failures``. Its spread arm is for a random
      model that amplifies a one-ulp bf16 difference: on the H100 the
      NVFP4 model's logits stood 6.5% of max|ref| apart at full depth and
      1.65% at one layer (argmax agreeing), 1.2-1.4x the perturbation
      spread at every depth.
    - A control that the rule must fail: the same sweep with the kernel
      path's group scales rolled by one group (``rolled_group_scales``):
      every check of the rule must fail.
    - With ``plain``, the reference of all of these is the kernel path
      with the matmuls of some kernels through their plain versions
      (``logits_by_depth``), not the non-kernel path; with ``ref_params``
      the non-kernel path runs on those params (the sparse model's sparse
      leaves). ``kinds`` names the kernel layouts whose scales the control
      rolls (``rolled_group_scales``).
    - At one layer, the lm_head swapped on both paths for its dequantized
      bf16 weight: within TOL_E2E_8B * max|ref| (0.89-0.92% read on the
      H100). The W8A8-int lm_head's non-kernel path (as the JAX
      package's) keeps each token's activation scale in bf16 and its
      kernel in f32, so the two heads round the same input to different
      int8 values; the bf16 head reads the decoder layer's difference
      alone.

    Returns the sweep."""
    import torch

    sweep, faulty = logits_by_depth(params, config, requests, label,
                                    fault=rolled_group_scales(params, kinds),
                                    depths=depths, plain=plain,
                                    ref_params=ref_params)
    failures = logits_rule_failures(sweep)
    if failures:
        raise AssertionError(f"{label} logits: {'; '.join(failures)}")
    log(f"{label} logits: within {TOL_WNA16_DEPTH1} of max|ref| at one "
        f"layer, and at every depth within {TOL_E2E_8B} of max|ref| or "
        f"{FLOOR_RATIO}x the perturbation spread (rel_rms / spread: "
        + ", ".join(f"{d}: {e / max(s, 1e-30):.3g}"
                    for d, (e, s, _) in sweep.items())
        + ")")
    caught = logits_rule_failures(faulty)
    log(f"{label} control, {'/'.join(kinds)} scales rolled by one group "
        "(one channel for w8a8) in the kernel layouts: " + ", ".join(
            f"{d}: rel_rms {e:.4g} (max {t:.4g} of max|ref|)"
            for d, (e, _, t) in faulty.items())
        + f"; the rule fails {len(caught)} of its {len(sweep) + 1} checks")
    if len(caught) < len(sweep) + 1:
        raise AssertionError(f"{label} logits rule accepted the planted "
                             "fault (group scales rolled by one group) in "
                             f"{len(sweep) + 1 - len(caught)} checks")

    lm = params["lm_head"]
    head = (lm.weight.to(torch.float32) * lm.scale.to(torch.float32)).to(
        torch.bfloat16)
    _, ids, _ = probe_request(requests)
    got = first_token_logits(dict(params, lm_head=head), config, ids, 1, True,
                             label)
    with plain() if plain is not None else contextlib.nullcontext():
        ref = first_token_logits(
            dict(params if ref_params is None or plain is not None
                 else ref_params, lm_head=head),
            config, ids, 1, plain is not None, label)
    del head
    torch.cuda.empty_cache()
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    log(f"{label} first-token logits at one layer through a bf16 lm_head "
        f"(the W8A8 head dequantized): kernel vs "
        f"{'plain' if plain is not None else 'non-kernel'} path max "
        f"{err:.4g} of max|ref|, rel_rms {rel_rms(got, ref):.4g} (limit "
        f"{TOL_E2E_8B}; {sweep[1][2]:.4g} through the W8A8 head)")
    if err > TOL_E2E_8B:
        raise AssertionError(f"{label} logits at one layer through a bf16 "
                             "lm_head disagree with the non-kernel path")
    return sweep


def greedy_8b(params, config, label, vocab=VOCAB8, **kw):
    """greedy_generate at batch 64 (128-token prompts of ids below
    ``vocab``, numpy seed 0, 32 new tokens) after a warm-up; its launches,
    wall time and tokens."""
    import torch

    from compressed_tensors_tpu_torch.engine import greedy_generate

    rng = np.random.default_rng(0)
    gids = torch.from_numpy(rng.integers(0, vocab, size=(BATCH, PROMPT))).cuda()
    greedy_generate(params, config, gids, max_new_tokens=2, **kw)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, config, gids, max_new_tokens=NEW_TOKENS,
                          **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    log(f"{label} greedy_generate: {tuple(out.shape)} at batch {BATCH} in "
        f"{total * 1e3:.1f} ms ({BATCH * NEW_TOKENS / total:.0f} tok/s "
        f"end to end), kernel launches {counts}")
    if out.shape != (BATCH, PROMPT + NEW_TOKENS) or not bool(
            ((out >= 0) & (out < config.vocab_size)).all()):
        raise AssertionError(f"{label} greedy_generate: ids out of range")
    return dict(counts=counts, wall=total, tokens=out)


def check_prefix_caching(dense, prefix, hits, label, rule=True):
    """Prefix-cached completions against dense ones. With prefix caching
    the requests without the shared prefix run the same chunks as dense:
    identical. Those with it prefill only their own tail, as one
    continuation chunk over the cached pages: other row counts, so
    _w4b8_mode may pick int4b where a dense chunk picks a8b or the reverse
    (a difference of the size of the int8 rounding, about 1% of a linear's
    input), and the non-kernel attention over the cache. That may flip a
    greedy near-tie; stale or wrong pages would change nearly all of them.
    With ``rule``, every first token must agree, and at least
    SHARED_SAME_MIN of the completions in full; without it the counts are
    recorded."""
    def first_diff(a, b):
        return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)

    shared = list(range(0, N_REQUESTS, SHARE_EVERY))
    bad = [i for i in dense if i not in shared and prefix[i] != dense[i]]
    if bad:
        raise AssertionError(f"{label}: prefix caching changed requests "
                             f"{bad} that do not share the prefix")
    differ = {i: first_diff(prefix[i], dense[i]) for i in shared
              if prefix[i] != dense[i]}
    limit = f"limit {SHARED_SAME_MIN}" if rule else "recorded, no limit"
    log(f"{label} paged+prefix vs dense: the {N_REQUESTS - len(shared)} "
        f"requests without the shared prefix identical; of the "
        f"{len(shared)} with it, {len(shared) - len(differ)} identical "
        f"({limit}), {sum(t == 0 for t in differ.values())} with another "
        f"first token; first differing token of the others: {differ}")
    if hits <= 0:
        raise AssertionError(f"{label}: prefix caching reused no page")
    if not rule:
        return
    if any(t == 0 for t in differ.values()):
        raise AssertionError(f"{label}: prefix caching changed a first token")
    if len(shared) - len(differ) < SHARED_SAME_MIN:
        raise AssertionError(f"{label}: prefix caching changed too many "
                             "completions")


def prefix_cache_readings(params, config, requests, dense, prefix, engine,
                          label):
    """What prefix caching changes for the requests that share the prefix,
    read after the prefix-cached run (``engine``, its pool as the run left
    it). For each such request:

    - its prompt prefilled afresh on a dense cache in ``prefill_chunk``
      pieces, as the dense engine runs it: the first-token logits, and the
      first SHARED_PREFIX positions of the cache, which must equal the
      cached prefix pages bit for bit in every layer (k and v);
    - its tail prefilled over the cached prefix pages as one continuation
      chunk, as the prefix-cached engine runs it: the first-token logits.

    Each recomputation must give its engine's first token. Printed for
    each request whose first token changed: the dense top-2 margin beside
    the change of the two tokens' logit difference and max|prefix-cached -
    dense|, with a summary over all of them. A first token that changes
    over equal pages is a greedy near-tie when the margin lies below that
    change. On the H100 the pages were equal in all 32 requests and the 4
    changed first tokens had margins of 1-4 bf16 ulps of their logits.
    These serving-default readings carry no limit: they mix the cache path
    with the tail's other chunking, whose row count sends the tail to
    int4b where the dense chunk took a8b (a difference of the size of the
    int8 rounding). ``prefix_logits_rule`` holds the cache path alone to a
    limit, with every W4 linear at bf16 activations."""
    import torch

    from compressed_tensors_tpu_torch.models.llama import (
        KVCache,
        PagedKVCache,
        init_kv_cache,
        llama_forward,
    )
    from compressed_tensors_tpu_torch.ops.linear import _w4b8_mode

    chunk, page = SERVE["prefill_chunk"], engine.cache.page_size
    n_pre = SHARED_PREFIX // page
    pids = [engine._prefix_index[d] for d in engine._page_digests(
        requests[0][1][:SHARED_PREFIX], page)]
    pool_k, pool_v = engine.cache.k, engine.cache.v
    L, _, kvh, _, hd = pool_k.shape

    def pages(pool):  # (L, KVH, SHARED_PREFIX, D)
        return pool[:, pids].permute(0, 2, 1, 3, 4).reshape(
            L, kvh, SHARED_PREFIX, hd)

    cached = (pages(pool_k), pages(pool_v))
    table = torch.tensor(
        [pids + list(engine._free_pages)[:engine._tables.shape[1] - n_pre]],
        dtype=torch.int32, device="cuda")

    def forward(ids, start, cache):
        logits, _ = llama_forward(
            params, config, torch.tensor([ids], device="cuda"),
            torch.arange(start, start + len(ids), device="cuda")[None],
            cache, fresh_prefill=start == 0, last_logit_only=True)
        return logits.float().reshape(-1)

    def at(i):
        return torch.tensor([i], dtype=torch.int32, device="cuda")

    rows, page_diff, unequal = [], 0.0, []
    for rid, ids, _ in requests:
        if rid % SHARE_EVERY:
            continue
        cache = init_kv_cache(config, 1, SERVE["max_len"], device="cuda")
        for start in range(0, len(ids), chunk):
            got_d = forward(ids[start:start + chunk], start,
                            KVCache(k=cache.k, v=cache.v, lengths=at(start)))
        diff = max((c[:, 0, :, :SHARED_PREFIX].float() - p.float())
                   .abs().max().item() for c, p in zip((cache.k, cache.v),
                                                       cached))
        page_diff = max(page_diff, diff)
        if diff:
            unequal.append(rid)
        del cache
        got_p = forward(ids[SHARED_PREFIX:], SHARED_PREFIX, PagedKVCache(
            k=pool_k, v=pool_v, tables=table, lengths=at(SHARED_PREFIX)))
        top2 = got_d.topk(2)
        a, b = int(got_d.argmax()), int(got_p.argmax())
        rows.append(dict(
            rid=rid, n=len(ids), a=a, b=b,
            same=(a == dense[rid][0], b == prefix[rid][0]),
            margin=(top2.values[0] - top2.values[1]).item(),
            moved=((got_d[a] - got_d[b]) - (got_p[a] - got_p[b])).item(),
            max_diff=(got_p - got_d).abs().max().item(),
            rel=(got_p - got_d).abs().max().item()
            / got_d.abs().max().item(),
            mode=_w4b8_mode(len(ids) - SHARED_PREFIX, 4096, 4096)))
    for r in rows:
        if r["a"] != r["b"]:
            log(f"{label} request {r['rid']} ({r['n']} prompt tokens; its "
                f"{r['n'] - SHARED_PREFIX}-row tail {r['mode']}, the dense "
                f"chunk a8b): first token dense {r['a']}, prefix-cached "
                f"{r['b']}; dense top-2 margin {r['margin']:.4g}, the "
                f"two tokens' difference moved by {r['moved']:.4g}; "
                f"max|prefix-cached - dense| {r['max_diff']:.4g} "
                f"({r['rel']:.4g} of max|dense|)")
    rel = sorted(r["rel"] for r in rows)
    margins = sorted(r["margin"] for r in rows)
    log(f"{label} prefix readings over the {len(rows)} requests with the "
        f"prefix: recomputed first tokens equal to the dense engine's "
        f"{sum(r['same'][0] for r in rows)}, to the prefix-cached engine's "
        f"{sum(r['same'][1] for r in rows)}; first tokens changed "
        f"{sum(r['a'] != r['b'] for r in rows)}; max|prefix-cached - dense| "
        f"/ max|dense| min {rel[0]:.4g} median {rel[len(rel) // 2]:.4g} max "
        f"{rel[-1]:.4g}; dense top-2 margin min {margins[0]:.4g} median "
        f"{margins[len(margins) // 2]:.4g}, below max|prefix-cached - "
        f"dense| in {sum(r['margin'] < r['max_diff'] for r in rows)}; cached "
        f"prefix pages against each fresh prefill's: {len(rows) - len(unequal)}"
        f" of {len(rows)} equal bit for bit (max|diff| {page_diff:.4g})")
    if unequal:
        raise AssertionError(f"{label}: the cached prefix pages differ from "
                             f"a fresh prefill's for requests {unequal}")
    if not all(all(r["same"]) for r in rows):
        raise AssertionError(f"{label}: a prefill over the cached pages or a "
                             "fresh one gave another first token than its "
                             "engine")


def prefix_logits_rule(params, config, requests, sweep):
    """The prefix-caching logits rule, to be run with every W4 linear at
    bf16 activations (``w4_act="bf16"``), so that both sides run int4b
    whatever their row counts. For each request that shares the prefix,
    at 1 layer and at all of them:

    - prefix-cached: the SHARED_PREFIX tokens prefilled into pages of a
      ``PagedKVCache`` (once per depth), then the tail prefilled as one
      continuation chunk over those pages;
    - dense: the whole prompt prefilled fresh on a dense cache in
      ``prefill_chunk`` pieces;
    - their first-token logits held to ``logits_rule_failures`` (one layer
      within TOL_WNA16_DEPTH1 of max|dense|; each depth within TOL_E2E_8B
      of max|dense| or relative RMS within FLOOR_RATIO x the one-ulp
      spread of ``sweep``, phase 5's sweep on the same model at bf16
      activations).

    Control: the tail over pages written from the prefix rolled by one
    position, as a stale cache entry holds them, must fail the rule in
    every request (pages reordered would not: keys are cached after RoPE
    and the tail sees every prefix position). Raises if a request fails
    the rule or the control passes one."""
    import torch

    from compressed_tensors_tpu_torch.models.llama import (
        KVCache,
        PagedKVCache,
        init_kv_cache,
        init_paged_kv_cache,
        llama_forward,
    )

    chunk, page = SERVE["prefill_chunk"], SERVE["page_size"]
    n_pre, p_max = SHARED_PREFIX // page, SERVE["max_len"] // page
    prefix = requests[0][1][:SHARED_PREFIX]
    stale = prefix[-1:] + prefix[:-1]
    # pool pages: 0 null, then the prefix's, the stale prefix's, the tail's
    fresh_pages = list(range(1, 1 + n_pre))
    stale_pages = list(range(1 + n_pre, 1 + 2 * n_pre))
    tail_pages = list(range(1 + 2 * n_pre, 1 + 2 * n_pre + p_max - n_pre))
    depths = (1, config.num_hidden_layers)
    shared = [r for r in requests if r[0] % SHARE_EVERY == 0]

    def at(i):
        return torch.tensor([i], dtype=torch.int32, device="cuda")

    def forward(p, cfg, ids, start, cache):
        logits, _ = llama_forward(
            p, cfg, torch.tensor([ids], device="cuda"),
            torch.arange(start, start + len(ids), device="cuda")[None],
            cache, fresh_prefill=start == 0, last_logit_only=True)
        return logits.float().reshape(-1)

    readings = {"cached": {}, "stale": {}}  # rid -> {depth: reading}
    for depth in depths:
        cfg = dataclasses.replace(config, num_hidden_layers=depth)
        p = dict(params, layers=params["layers"][:depth])
        pool = init_paged_kv_cache(cfg, 1, SERVE["max_len"],
                                   num_pages=1 + 2 * n_pre + len(tail_pages),
                                   page_size=page, device="cuda")

        def paged(pages, start):
            return PagedKVCache(k=pool.k, v=pool.v, lengths=at(start),
                                tables=torch.tensor([pages + tail_pages],
                                                    dtype=torch.int32,
                                                    device="cuda"))

        for pages, ids in ((fresh_pages, prefix), (stale_pages, stale)):
            forward(p, cfg, ids, 0, paged(pages, 0))
        spread = sweep[depth][1]
        for rid, ids, _ in shared:
            cache = init_kv_cache(cfg, 1, SERVE["max_len"], device="cuda")
            for start in range(0, len(ids), chunk):
                dense = forward(p, cfg, ids[start:start + chunk], start,
                                KVCache(k=cache.k, v=cache.v,
                                        lengths=at(start)))
            del cache
            top = dense.abs().max().item()
            for name, pages in (("cached", fresh_pages),
                                ("stale", stale_pages)):
                got = forward(p, cfg, ids[SHARED_PREFIX:], SHARED_PREFIX,
                              paged(pages, SHARED_PREFIX))
                readings[name].setdefault(rid, {})[depth] = (
                    rel_rms(got, dense), spread,
                    (got - dense).abs().max().item() / top)
        del pool
        torch.cuda.empty_cache()

    failed = {name: {rid: logits_rule_failures(r) for rid, r in
                     readings[name].items()} for name in readings}
    for depth in depths:
        for name in readings:
            tops = sorted(r[depth][2] for r in readings[name].values())
            ratios = sorted(r[depth][0] / max(r[depth][1], 1e-30)
                            for r in readings[name].values())
            log(f"prefix rule (bf16 activations), {name} pages vs dense, "
                f"{depth} layers over {len(shared)} requests: max|diff| / "
                f"max|dense| min {tops[0]:.4g} median "
                f"{tops[len(tops) // 2]:.4g} max {tops[-1]:.4g}; rel_rms / "
                f"spread ({sweep[depth][1]:.4g}) min {ratios[0]:.4g} median "
                f"{ratios[len(ratios) // 2]:.4g} max {ratios[-1]:.4g}")
    log("prefix rule control, stale pages (the prefix rolled by one "
        "position), checks failed by request: " + "; ".join(
            f"{rid}: {', '.join(c.split(':')[0] for c in f) or 'none'}"
            for rid, f in failed["stale"].items()))
    bad = {rid: f for rid, f in failed["cached"].items() if f}
    caught = sum(bool(f) for f in failed["stale"].values())
    log(f"prefix rule: {len(shared) - len(bad)} of {len(shared)} requests "
        f"within the rule (limits {TOL_WNA16_DEPTH1} at one layer, "
        f"{TOL_E2E_8B} or {FLOOR_RATIO}x the spread at each depth); the "
        f"stale-pages control fails it in {caught} of {len(shared)}")
    if bad:
        raise AssertionError(f"prefix rule: requests {sorted(bad)} fail it: "
                             f"{bad}")
    if caught < len(shared):
        raise AssertionError("prefix rule accepted stale pages in "
                             f"{len(shared) - caught} requests")


def phase_serving():
    """The ServingEngine at Llama-3-8B W4A16 width.

    The model is ``w4a16_llama`` (codes uniform in [-7, 7], built on the
    card). Its first-token logits by depth, with the rolled-scales control,
    which must fail every check: with every W4 linear at bf16 activations
    (int4b, the non-kernel path's arithmetic) against the non-kernel path,
    and, as the serving default prefills the probe's rows through a8b
    (int8 activations, no part of the non-kernel path), that path against
    the same model with B1/B2 through their plain versions (its distance to
    the non-kernel path printed beside it). Then the requests through the
    dense engine (flash decode at S_pad 1024), the paged engine (identical
    to dense) and the paged engine with prefix caching, whose completions
    are counted and whose pages and first-token logits are read against
    fresh dense prefills (``prefix_cache_readings``: the pages must be
    equal). The prefix rule, whose premise is that only a few greedy
    near-ties flip, runs where it was set: the same requests dense and
    prefix-cached on the JAX package's draw (``make_synthetic_llama``:
    random words), whose logits lean on one direction and leave few
    near-ties; on the [-7, 7] model most completions with the prefix part
    from dense after a few tokens (3 of 32 identical on the H100). On
    that model the prefix-cached first-token logits are held instead to
    the depth rule at bf16 activations, with a stale-pages control
    (``prefix_logits_rule``)."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.synthetic import (
        LLAMA3_8B,
        make_synthetic_llama,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = LLAMA3_8B
    t0 = time.perf_counter()
    params = fuse_llama_layers(w4a16_llama(config, 0, asym=False))
    torch.cuda.synchronize()
    log(f"Llama-3-8B W4A16 model (built on the card from seed 0, codes "
        f"uniform in [-7, 7], fused): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()

    with flag_overrides(w4_act="bf16"):
        sweep = check_logits_by_depth(params, config, requests,
                                      "8B W4A16 bf16")
    check_logits_by_depth(params, config, requests, "8B W4A16 a8b",
                          plain=plain_w4)

    runs = {"dense": dict(paged=False),
            "paged": dict(paged=True, prefix_caching=False),
            "paged+prefix": dict(paged=True)}
    results = {name: serve_requests(params, config, requests, name,
                                    keep=name == "paged+prefix", **kw)
               for name, kw in runs.items()}
    dense, paged, prefix = (results[k]["outs"] for k in runs)

    # paged and dense run the same chunks through decode kernels that
    # share one body: identical completions
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving paged vs dense: {N_REQUESTS - len(bad)}/{N_REQUESTS} "
        "completions identical token for token")
    if bad:
        raise AssertionError(f"serving paged and dense completions differ "
                             f"for requests {bad}")
    check_prefix_caching(dense, prefix, results["paged+prefix"]["hits"],
                         "serving", rule=False)
    engine = results["paged+prefix"].pop("engine")
    prefix_cache_readings(params, config, requests, dense, prefix, engine,
                          "serving")
    del engine
    with flag_overrides(w4_act="bf16"):
        prefix_logits_rule(params, config, requests, sweep)
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = fuse_llama_layers(make_synthetic_llama(
        config, "W4A16", seed=0, lm_head_preset="W8A8", device="cuda"))
    torch.cuda.synchronize()
    log(f"Llama-3-8B W4A16, the JAX package's draw (random words, seed 0, "
        f"fused): {time.perf_counter() - t0:.1f} s")
    for name, kw in (("dense (JAX draw)", dict(paged=False)),
                     ("paged+prefix (JAX draw)", dict(paged=True))):
        results[name] = serve_requests(params, config, requests, name, **kw)
    check_prefix_caching(results["dense (JAX draw)"]["outs"],
                         results["paged+prefix (JAX draw)"]["outs"],
                         results["paged+prefix (JAX draw)"]["hits"],
                         "serving (JAX draw)")
    del params
    torch.cuda.empty_cache()
    base = ("w4a16_a8b_matmul", "w4a16_matmul", "w8a8_matmul",
            "prefill_attention")
    check_launched(results, {"dense": base + ("flash_decode_attention",),
                             "paged": base + ("paged_decode_attention",)})
    return results


def prefill_row(q, k, v, shapes):
    """B4's device ms on q (B, S, H, D), k/v (B, S, KVH, D), causal, beside
    its bound (the causal half of QK^T and P.V at the bf16 peak, or q, k, v
    read and the output written once), its plain version and SDPA with
    GQA."""
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        prefill_attention as pa,
    )

    B, S, H, D = q.shape
    t = device_ms([lambda: pa.prefill_attention(q, k, v)] * 5)
    tp = eager_ms(lambda: pa.prefill_attention_plain(q, k, v))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    try:
        tl = device_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)] * 5)
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    bm, by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                   4 * B * H * D * (S * (S + 1) // 2), PEAK_BF16)
    return dict(name="prefill_attention", ms=t, plain_ms=tp, bound_ms=bm,
                bound_by=by, library_ms=tl, shapes=shapes)


def phase_timings(errs, run_counts, per_step):
    """Per-kernel time at the main path's shapes, bound, plain, library."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    rows = []

    # W4A16: the four matmuls of one decoder layer at decode (M = 64) and
    # at the prefill of 64 prompts of 128 tokens (M = 8192)
    b1 = {f"TinyLlama M={m}": int4b_layer_row(rng, W4_SHAPES, m, "TinyLlama")
          for m in (BATCH, BATCH * PROMPT)}
    rows.append(dict(name="w4a16_matmul", **b1[f"TinyLlama M={BATCH}"]))

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
    rows.append(prefill_row(bf(BATCH, PROMPT, H, D), bf(BATCH, PROMPT, KVH, D),
                            bf(BATCH, PROMPT, KVH, D),
                            "B=64 S=128 H=32 KVH=4 D=64 causal"))

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
    return rows, b1


def int4b_layer_row(rng, shapes, m, label, note=""):
    """Device ms of B1 (mode int4b) over one layer's four linears at M
    rows (each linear's weight in copies larger than L2, so each call finds
    it cold), bound, plain ms, and ``torch.matmul`` on the dequantized bf16
    weight; one line per linear. Returns the layer's row."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    dev = torch.device("cuda")
    ms = plain = lib = nbytes = ops = 0.0
    for lin, (n, k) in shapes.items():
        x, w, s, _ = w4_inputs(rng, n, k, m, dev)
        ws = [w.clone() for _ in range(copies_for(n * k // 2))]
        t = device_ms([lambda w=w: w4.w4a16_matmul(
            x, w, s, None, n=n, k=k, group_size=128) for w in ws])
        tp = eager_ms(lambda: w4.w4a16_matmul_plain(
            x, w, s, None, n=n, k=k, group_size=128), iters=3)
        del ws
        wd = w4._dequantized_weight(w, s, None, n, k, 128).to(torch.bfloat16)
        wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
        tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t()) for wd in wds])
        del wds, wd
        b = m * k * 2 + n * k // 2 + (k // 128) * n * 4 + m * n * 2
        bm, by = bound(b, 2 * m * n * k, PEAK_BF16)
        _, splits, per = w4.int4b_plan(m, n, k)
        log(f"time w4a16_matmul {lin} M={m} ({label}, {w4.int4b_design(m)} "
            f"design, {splits} split(s) of {per} k-tiles): {t:.4f} ms, bound "
            f"{bm:.4f} ms ({by}), plain {tp:.4f} ms, torch.matmul on the "
            f"dequantized bf16 weight {tl:.4f} ms")
        ms, plain, lib = ms + t, plain + tp, lib + tl
        nbytes, ops = nbytes + b, ops + 2 * m * n * k
        torch.cuda.empty_cache()
    bm, by = bound(nbytes, ops, PEAK_BF16)
    log(f"w4a16_matmul one {label} layer M={m}: {ms:.4f} ms, bound {bm:.4f} "
        f"ms ({by}), torch.matmul {lib:.4f} ms: {ms / lib:.3f}x")
    return dict(ms=ms, plain_ms=plain, bound_ms=bm, bound_by=by,
                library_ms=lib,
                shapes=f"qkv+o+gate_up+down of one {label} layer, M={m}{note}; "
                "library: torch.matmul on the dequantized bf16 weight")


def phase_timings_8b(serving):
    """Per-kernel time at the serving path's Llama-3-8B shapes, bound,
    plain, library; the launches of each engine run beside them."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        w4a16_matmul as w4,
        w8a8_matmul as w8,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []

    # W4A16 at the 8B widths: int4b at decode (M = 64) and at a prefill
    # chunk under w4_act="bf16" (M = 512), a8b at prefill chunks (M = 512,
    # and 256, the least rows that select it); each row sums the four
    # linears of one layer, a8b with its two passes timed apart beside it
    b1 = {f"8B M={BATCH}": int4b_layer_row(rng, W4_SHAPES_8B, BATCH, "8B"),
          f"8B M={M_CHUNK}": int4b_layer_row(rng, W4_SHAPES_8B, M_CHUNK, "8B",
                                             " (w4_act=\"bf16\")")}
    rows.append(dict(name="w4a16_matmul", **b1[f"8B M={BATCH}"]))
    a8b = {}
    name = "w4a16_a8b_matmul"
    for m in (M_CHUNK, 256):
        ms = plain = lib = nbytes = ops = quant = gemm = 0.0
        for lin, (n, k) in W4_SHAPES_8B.items():
            x, w, s, _ = w4_inputs(rng, n, k, m, dev)
            ws = [w.clone() for _ in range(copies_for(n * k // 2))]
            t = device_ms([lambda w=w: w4.w4a16_matmul(
                x, w, s, None, n=n, k=k, group_size=128, mode="a8b")
                for w in ws])
            tp = eager_ms(lambda: w4.w4a16_matmul_plain(
                x, w, s, None, n=n, k=k, group_size=128, mode="a8b"),
                iters=3)
            tq, tg = a8b_parts_ms(x, ws, s, n, k)
            quant, gemm = quant + tq, gemm + tg
            parts = f" = quantize pass {tq:.4f} + GEMM {tg:.4f} (each alone)"
            del ws
            wd = w4._dequantized_weight(w, s, None, n, k, 128).to(
                torch.bfloat16)
            wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
            tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                            for wd in wds])
            del wds, wd
            b = m * k * 2 + n * k // 2 + (k // 128) * n * 4 + m * n * 2
            bm, by = bound(b, 2 * m * n * k, PEAK_INT8)
            log(f"time {name} {lin} M={m} (8B): {t:.4f} ms{parts}, bound "
                f"{bm:.4f} ms ({by}), plain {tp:.4f} ms, torch.matmul on the "
                f"dequantized bf16 weight {tl:.4f} ms")
            ms, plain, lib = ms + t, plain + tp, lib + tl
            nbytes, ops = nbytes + b, ops + 2 * m * n * k
        bm, by = bound(nbytes, ops, PEAK_INT8)
        row = dict(name=name, ms=ms, plain_ms=plain, bound_ms=bm,
                   bound_by=by, library_ms=lib,
                   shapes=f"qkv+o+gate_up+down of one 8B layer, M={m}; "
                   "library: torch.matmul on the dequantized bf16 weight, "
                   "the nearest single call")
        row.update(quantize_ms=quant, gemm_ms=gemm)
        log(f"w4a16_a8b_matmul one 8B layer M={m}: {ms:.4f} ms = "
            f"quantize passes {quant:.4f} + GEMMs {gemm:.4f} (each "
            f"alone); torch.matmul {lib:.4f}: {ms / lib:.3f}x, GEMM alone "
            f"{gemm / lib:.3f}x")
        a8b[f"M={m}"] = row

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
    tq, tg = w8a8_parts_ms(x, wqs * 2, wsc, n, k)
    xq, _ = w8.quantize_rows_plain(x, torch.int8)
    try:
        tl = device_ms([lambda wq=wq: torch._int_mm(xq, wq.t())
                        for wq in wqs * 2])
    except RuntimeError as exc:  # a library limit, reported, not a failure
        log(f"torch._int_mm unavailable here: {exc}")
        tl = None
    del wqs
    bm, by = bound(BATCH * k * 2 + n * k + n * 4 + BATCH * n * 2,
                   2 * BATCH * n * k, PEAK_INT8)
    log(f"time w8a8_matmul lm_head M={BATCH} (8B): {t:.4f} ms = quantize "
        f"pass {tq:.4f} + GEMM {tg:.4f} (each alone); torch._int_mm on the "
        f"quantized rows {tl}: GEMM alone {tg / tl if tl else 0:.3f}x, with "
        f"the quantize pass {t / tl if tl else 0:.3f}x")
    rows.append(dict(name="w8a8_matmul", ms=t, plain_ms=tp, bound_ms=bm,
                     bound_by=by, library_ms=tl, quantize_ms=tq, gemm_ms=tg,
                     shapes="8B lm_head 64x4096 -> 128256; library: "
                     "torch._int_mm on the quantized rows, beside gemm_ms"))

    # prefill attention of one fresh 512-token chunk at D = 128, at the 8B
    # (32 heads over 8) and the Qwen2.5-7B (28 over 4) head counts
    prefill = {}
    for label, (H, KVH) in (("8B", (H8, KVH8)), ("Qwen2.5-7B", (28, 4))):
        prefill[f"{label} chunk"] = prefill_row(
            *(dev_randn(gen, 1, M_CHUNK, h, D8) for h in (H, KVH, KVH)),
            f"{label} chunk B=1 S=512 H={H} KVH={KVH} D=128 causal")
    rows.append(prefill["8B chunk"])
    r = prefill["Qwen2.5-7B chunk"]
    log(f"kernel prefill_attention [{r['shapes']}]: {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} "
        f"ms, library {r['library_ms']}")

    # flash and paged decode: one decode step's 32 layers at batch 64, at
    # the 8B (32 heads over 8) and the Qwen2.5-7B (28 over 4) head counts
    decode = {}
    for label, (H, KVH) in (("8B", (H8, KVH8)), ("Qwen2.5-7B", (28, 4))):
        q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H, KVH, KVH))
        for name, row in time_serving_decode(
                rng, q, nk, nv, lambda shape: dev_randn(gen, *shape),
                f"{label} bf16 cache").items():
            decode.setdefault(name, {})[label] = row
            if label == "8B":
                rows.append(dict(name=name, **row))
            else:
                log(f"kernel {name} [{row['shapes']}]: {row['ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.4f} ms, library "
                    f"{row['library_ms']}")

    for r in rows + list(a8b.values()) + [
            dict(name="w4a16_matmul", **b1[f"8B M={M_CHUNK}"])]:
        counts = {run: res["counts"][r["name"]]
                  for run, res in serving.items()}
        steps = {run: res.get("per_step", {}).get(r["name"])
                 for run, res in serving.items()}
        log(f"kernel {r['name']} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}; launches "
            f"per decode step {steps}, per serving run {counts}")
    return rows, prefill, decode, a8b, b1


def a8b_parts_ms(x, ws, s, n, k, group=128):
    """Device ms of B2's two passes on their own at ``a8b_plan``'s plan:
    the row-quantize pass of x, and the GEMM from the quantized rows over
    the packed weight copies ``ws`` (L2 cold). Returns (quantize ms, GEMM
    ms)."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    lib = _build.load()
    m = x.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    splits, per = w4.a8b_plan(m, n, k)

    def quantize():
        _build.check(lib.ct_w4a16_a8b_quantize(
            x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
            torch.cuda.current_stream().cuda_stream), "a8b quantize")

    def gemm(w):
        _build.check(lib.ct_w4a16_a8b_gemm(
            xq.data_ptr(), xs.data_ptr(), w.data_ptr(), s.data_ptr(), None,
            y.data_ptr(), m, n, k, group, splits, per,
            torch.cuda.current_stream().cuda_stream), "a8b gemm")

    tq = device_ms([quantize] * 8)
    tg = device_ms([lambda w=w: gemm(w) for w in ws])
    return tq, tg


def w8a8_parts_ms(x, ws, s, n, k):
    """Device ms of B3's two passes on their own at ``w8a8_plan``'s plan:
    the row-quantize pass of x, and the GEMM from the quantized rows over
    the weight copies ``ws`` (L2 cold). Returns (quantize ms, GEMM ms)."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    lib = _build.load()
    m, fp8 = x.shape[0], int(ws[0].dtype == torch.float8_e4m3fn)
    xq = torch.empty((m, k), dtype=ws[0].dtype, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    bm, splits, per = w8.w8a8_plan(m, n, k)

    def quantize():
        _build.check(lib.ct_w8a8_quantize(
            x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, fp8,
            torch.cuda.current_stream().cuda_stream), "w8a8 quantize")

    def gemm(w):
        _build.check(lib.ct_w8a8_gemm(
            xq.data_ptr(), xs.data_ptr(), w.data_ptr(), s.data_ptr(),
            y.data_ptr(), m, n, k, fp8, bm, splits, per,
            torch.cuda.current_stream().cuda_stream), "w8a8 gemm")

    tq = device_ms([quantize] * 8)
    tg = device_ms([lambda w=w: gemm(w) for w in ws])
    return tq, tg


def check_w8a8_fp8(name, x, w, s, n, k):
    """The fp8 W8A8 kernel against its plain version, by the a8b rule: the
    quantization pass (e4m3 rows and their scales) equal bit for bit, and
    each output element within A8B_REL * |y| + A8B_ABS * max|y| of the f32
    plain result. The bf16 product without the fp8 activation rounding is
    a control that must fail the same rule. Returns max|kernel - plain|."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    m = x.shape[0]
    xq = torch.empty((m, k), dtype=w.dtype, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    got = w8.w8a8_matmul(x, w, s, n=n, k=k, xq=xq, xs=xs)
    xq_p, xs_p = w8.quantize_rows_plain(x, w.dtype)
    same_q = xq.view(torch.uint8) == xq_p.view(torch.uint8)
    if not (bool(same_q.all()) and torch.equal(xs, xs_p)):
        raise AssertionError(
            f"{name}: quantization pass differs from plain in "
            f"{int((~same_q).sum())} of {xq.numel()} values and "
            f"{int((xs != xs_p).sum())} of {m} scales")
    want = w8.w8a8_matmul_plain(x, w, s, n=n, k=k, out_dtype=torch.float32)
    scale = want.abs().max().item()
    slack = A8B_REL * want.abs() + A8B_ABS * scale

    def outside(y):
        return int(((y.float() - want).abs() > slack).sum())

    bad = outside(got)
    control = outside((x.float() @ w.float().t()) * s[None, :])
    err = (got.float() - want).abs().max().item()
    log(f"parity {name}: quantization pass equal bit for bit; "
        f"max_abs_err={err:.6g} max|plain f32|={scale:.6g} "
        f"rel={err / scale:.3g}; elements outside {A8B_REL:.4g}|y| + "
        f"{A8B_ABS} max|y|: kernel {bad}, bf16-activation control "
        f"{control} of {want.numel()}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    if not control:
        raise AssertionError(f"{name}: the check cannot tell fp8 "
                             "activations from bf16 ones")
    return err


def fp8_weight(gen, n, k):
    """(N, K) fp8 e4m3 weight as the synthetic model draws it (N(0, 100^2)
    clipped to +-440), on the card, and (N,) f32 scales."""
    import torch

    w = (torch.randn((n, k), generator=gen, device="cuda") * 100).clamp_(
        -440, 440).to(torch.float8_e4m3fn)
    s = torch.rand((n,), generator=gen, device="cuda") * 2e-4 + 1e-4
    return w, s


def dev_cache(gen, shape, dtype, scale):
    """A quantized cache (L, ...) of N(0, 1) draws divided by ``scale``,
    in fp8 e4m3 or int8, filled layer by layer on the card."""
    import torch

    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    out = torch.empty(shape, dtype=dtype, device="cuda")
    for i in range(shape[0]):
        x = torch.randn(shape[1:], generator=gen, device="cuda") / scale
        if dtype == torch.int8:
            x = x.round_().clamp_(-128, 127)
        byte_view(out)[i] = byte_view(x.to(dtype))
    return out


CACHE_SCALES = {"fp8": KV_SCALE, "int8": KV_SCALE * 448 / 127}


def phase_parity_fp8(errs):
    """The kernels of the FP8 path against their plain versions at
    Llama-3-8B shapes on the card: fp8 W8A8 at the four linears (M = 64 and
    512), and block (per-tensor and per-head scales), flash and paged
    decode on fp8 and int8 caches; updates ``errs``."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    def same(a, b):
        return torch.equal(byte_view(a), byte_view(b))

    for lin, (n, k) in W4_SHAPES_8B.items():
        w, s = fp8_weight(gen, n, k)
        for m in (BATCH, M_CHUNK):
            keep("w8a8_matmul_fp8", check_w8a8_fp8(
                f"w8a8 fp8 {lin} M={m}", dev_randn(gen, m, k), w, s, n, k))
        del w

    q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H8, KVH8, KVH8))
    for cache, dtype in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
        sc = CACHE_SCALES[cache]
        per_tensor = (torch.tensor([sc], device=dev),
                      torch.tensor([sc * 1.5], device=dev))
        per_head = (torch.linspace(sc, 2 * sc, KVH8, device=dev).reshape(
            KVH8, 1, 1), torch.linspace(2 * sc, sc, KVH8, device=dev).reshape(
            KVH8, 1, 1))

        # block decode: two layers of a 256-position cache
        blens = torch.from_numpy(rng.integers(0, 255, BATCH).astype(
            np.int32)).to(dev)
        for label, (ks, vs) in (("per-tensor", per_tensor),
                                ("per-head", per_head)):
            ck, cv = (dev_cache(gen, (2, BATCH, KVH8, 256, D8), dtype, sc)
                      for _ in range(2))
            ck_p, cv_p = ck.clone(), cv.clone()
            out, _, _ = da.decode_attention(q, nk, nv, ck, cv, blens, layer=1,
                                            k_scale=ks, v_scale=vs)
            want, _, _ = da.decode_attention_plain(
                q, nk, nv, ck_p, cv_p, blens, layer=1, k_scale=ks,
                v_scale=vs)
            keep("decode_attention_scaled", check_close(
                f"decode_attention {cache} cache, {label} scales", out,
                want))
            if not (same(ck, ck_p) and same(cv, cv_p)):
                raise AssertionError(f"decode_attention {cache} cache write "
                                     "differs from plain")
            del ck, cv, ck_p, cv_p

        check_serving_decode(
            errs, rng, q, nk, nv,
            lambda shape, dtype=dtype, sc=sc: dev_cache(gen, shape, dtype, sc),
            f"{cache} cache", *per_tensor)


def fp8_synthetic_llama(config):
    """Llama FP8_DYNAMIC in ``make_synthetic_llama``'s layout and with its
    distributions, drawn on the card from seed 0 (that function's numpy
    draw on the host takes about 4 s a layer at 8B width): fp8 e4m3
    weights N(0, 100^2) clipped to +-440 with channel scales in [1e-4,
    3e-4], the embedding N(0, 0.02^2), a W8A8-int lm_head (codes in
    [-127, 127]), norms at one; fused, k_scale = v_scale = KV_SCALE in
    every layer; each linear prepared under the ``fp8_transcode`` flag in
    force."""
    import torch

    from compressed_tensors_tpu_torch.config import CompressionFormat
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    NH, KVH, D = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    fp8 = preset_name_to_scheme("FP8_DYNAMIC", ["Linear"])

    def scales(n):
        return torch.rand((n, 1), generator=gen, device="cuda") * 2e-4 + 1e-4

    def linear(n, k):
        w = (torch.randn((n, k), generator=gen, device="cuda") * 100).clamp_(
            -440, 440).to(torch.float8_e4m3fn)
        return prepare_for_kernels(QuantizedTensor(
            weight=w, scale=scales(n), shape=(n, k), scheme=fp8,
            format=CompressionFormat.float_quantized.value))

    def ones():
        return torch.ones((H,), dtype=torch.bfloat16, device="cuda")

    params = {
        "embed_tokens": (torch.randn((V, H), generator=gen, device="cuda")
                         * 0.02).to(torch.bfloat16),
        "norm": ones(),
        "layers": [dict(
            q_proj=linear(NH * D, H), k_proj=linear(KVH * D, H),
            v_proj=linear(KVH * D, H), o_proj=linear(H, NH * D),
            input_layernorm=ones(), post_attention_layernorm=ones(),
            gate_proj=linear(I, H), up_proj=linear(I, H),
            down_proj=linear(H, I),
            k_scale=torch.tensor([KV_SCALE], device="cuda"),
            v_scale=torch.tensor([KV_SCALE], device="cuda"))
            for _ in range(config.num_hidden_layers)],
        "lm_head": prepare_for_kernels(QuantizedTensor(
            weight=torch.randint(-127, 128, (V, H), generator=gen,
                                 device="cuda", dtype=torch.int8),
            scale=scales(V), shape=(V, H),
            scheme=preset_name_to_scheme("W8A8", ["lm_head"]),
            format=CompressionFormat.int_quantized.value)),
    }
    return fuse_llama_layers(params)


def phase_fp8():
    """Phase 6: Llama-3-8B FP8 W8A8 with an FP8 KV cache (BASELINE config
    3): first-token logits against the non-kernel path, the serving
    requests through the dense and the paged engine with an fp8 cache, and
    greedy_generate at batch 64 (S_pad 192: the block decode kernel)."""
    import torch

    from compressed_tensors_tpu_torch.models.llama import (
        init_kv_cache,
        llama_forward,
    )
    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B

    fp8 = torch.float8_e4m3fn
    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fp8_synthetic_llama(config)
    torch.cuda.synchronize()
    log(f"Llama-3-8B FP8_DYNAMIC synthetic model (drawn on the card, seed 0, "
        f"fused, W8A8-int "
        f"lm_head, k_scale = v_scale = {KV_SCALE}): built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()

    # one request's first chunk: the range its K/V take on the fp8 lattice
    # (from a bf16 cache, which holds them unscaled), then its first-token
    # logits with an fp8 cache, kernel path against non-kernel path
    rid, ids, _ = probe_request(requests)
    n = len(ids)
    x = torch.tensor([ids], device="cuda")
    pos = torch.arange(n, device="cuda")[None]
    cache = init_kv_cache(config, 1, n, device="cuda")
    llama_forward(params, config, x, pos, cache, fresh_prefill=True,
                  last_logit_only=True)
    k_max = cache.k[:, :, :, :n].float().abs().max().item() / KV_SCALE
    v_max = cache.v[:, :, :, :n].float().abs().max().item() / KV_SCALE
    log(f"fp8 KV range of request {rid} ({n} tokens): largest |k|/k_scale "
        f"{k_max:.1f}, |v|/v_scale {v_max:.1f} (e4m3 overflows to NaN above "
        "464)")
    sweep, _ = logits_by_depth(params, config, requests, "FP8 8B",
                               cache_dtype=fp8)
    full = config.num_hidden_layers
    if sweep[1][0] > TOL_FP8_DEPTH1:
        raise AssertionError(f"FP8 8B logits at one layer disagree with the "
                             f"non-kernel path ({sweep[1][0]:.4g} > "
                             f"{TOL_FP8_DEPTH1})")
    if sweep[full][0] > FLOOR_RATIO * sweep[full][1]:
        raise AssertionError(f"FP8 8B logits at full depth: {sweep[full][0]:.4g}"
                             f" > {FLOOR_RATIO} x the non-kernel path's "
                             f"own spread {sweep[full][1]:.4g}")
    log(f"FP8 8B logits: within {TOL_FP8_DEPTH1} at one layer and within "
        f"{FLOOR_RATIO}x the perturbation spread at {full} layers")

    runs = {"fp8 dense": dict(paged=False, cache_dtype=fp8),
            "fp8 paged": dict(paged=True, prefix_caching=False,
                              cache_dtype=fp8)}
    results = {name: serve_requests(params, config, requests, name, **kw)
               for name, kw in runs.items()}
    dense, paged = (results[k]["outs"] for k in runs)
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving fp8 paged vs fp8 dense: {N_REQUESTS - len(bad)}/"
        f"{N_REQUESTS} completions identical token for token")
    if bad:
        raise AssertionError(f"fp8 serving: paged and dense completions "
                             f"differ for requests {bad}")

    results["fp8 greedy_generate"] = greedy_8b(params, config, "fp8",
                                               cache_dtype=fp8)
    base = ("w8a8_matmul_fp8", "w8a8_matmul", "prefill_attention")
    check_launched(results, {
        "fp8 dense": base + ("flash_decode_attention_scaled",),
        "fp8 paged": base + ("paged_decode_attention_scaled",),
        "fp8 greedy_generate": base + ("decode_attention_scaled",)})
    return results


def phase_timings_fp8():
    """Per-kernel time of the FP8 path's kernels at Llama-3-8B shapes:
    fp8 W8A8 (the four linears of one layer at M = 64 and 512), the block
    decode on bf16, fp8 and int8 caches, and the scaled flash and paged
    decode on fp8 and int8 caches (one layer, rotating over the 32);
    bound, plain, library. Returns {kernel name: {cache or M: row}}."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}

    rows["w8a8_matmul_fp8"] = {}
    for m in (BATCH, M_CHUNK):
        ms = plain = nbytes = ops = quant = gemm = 0.0
        lib = 0.0
        for lin, (n, k) in W4_SHAPES_8B.items():
            x = dev_randn(gen, m, k)
            w, s = fp8_weight(gen, n, k)
            ws = [w.clone() for _ in range(copies_for(n * k))]
            t = device_ms([lambda w=w: w8.w8a8_matmul(x, w, s, n=n, k=k)
                           for w in ws])
            tp = eager_ms(lambda: w8.w8a8_matmul_plain(x, w, s, n=n, k=k),
                          iters=3)
            tq, tg = w8a8_parts_ms(x, ws, s, n, k)
            xq, xs = w8.quantize_rows_plain(x, w.dtype)
            try:
                tl = device_ms([lambda w=w: torch._scaled_mm(
                    xq, w.t(), scale_a=xs[:, None], scale_b=s[None, :],
                    out_dtype=torch.bfloat16) for w in ws])
            except (RuntimeError, TypeError) as exc:
                log(f"torch._scaled_mm with row-wise scales unavailable: "
                    f"{exc}")
                tl = None
            del ws, w
            b = m * k * 2 + n * k + n * 4 + m * n * 2
            bm, by = bound(b, 2 * m * n * k, PEAK_FP8)
            log(f"time w8a8_matmul_fp8 {lin} M={m} (8B): {t:.4f} ms = "
                f"quantize pass {tq:.4f} + GEMM {tg:.4f} (each alone), bound "
                f"{bm:.4f} ms ({by}), plain {tp:.4f} ms, torch._scaled_mm "
                f"(row-wise scales, activations quantized beforehand) {tl}")
            ms, plain, nbytes, ops = ms + t, plain + tp, nbytes + b, \
                ops + 2 * m * n * k
            quant, gemm = quant + tq, gemm + tg
            lib = None if lib is None or tl is None else lib + tl
        bm, by = bound(nbytes, ops, PEAK_FP8)
        log(f"w8a8_matmul_fp8 one 8B layer M={m}: {ms:.4f} ms = quantize "
            f"passes {quant:.4f} + GEMMs {gemm:.4f} (each alone); "
            f"torch._scaled_mm {lib}: GEMM alone "
            f"{gemm / lib if lib else 0:.3f}x, with the quantize pass "
            f"{ms / lib if lib else 0:.3f}x")
        rows["w8a8_matmul_fp8"][m] = dict(
            ms=ms, plain_ms=plain, bound_ms=bm, bound_by=by, library_ms=lib,
            quantize_ms=quant, gemm_ms=gemm,
            shapes=f"qkv+o+gate_up+down of one 8B layer, M={m}; library: "
            "torch._scaled_mm with row-wise scales on activations quantized "
            "beforehand, beside gemm_ms")

    q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H8, KVH8, KVH8))
    # block decode: greedy_generate's (32, 64, 8, 192, 128) cache at
    # lengths 128-159, in bf16 too
    lens_np = rng.integers(PROMPT, PROMPT + NEW_TOKENS, BATCH).astype(np.int32)
    rows["decode_attention"] = {"8B bf16": block_decode_row(
        q, nk, nv, lambda shape: dev_randn(gen, *shape), lens_np, None,
        None, lambda c: c, "8B bf16 cache")}
    for name in ("decode_attention_scaled", "flash_decode_attention_scaled",
                 "paged_decode_attention_scaled"):
        rows[name] = {}
    for cache, dtype in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
        sc = CACHE_SCALES[cache]
        ks, vs = (torch.tensor([sc], device=dev) for _ in range(2))

        def make(shape, dtype=dtype, sc=sc):
            return dev_cache(gen, shape, dtype, sc)

        def widen(c, sc=sc):  # the cache dequantized to bf16
            return (c.float() * sc).to(torch.bfloat16)

        rows["decode_attention_scaled"][cache] = block_decode_row(
            q, nk, nv, make, lens_np, ks, vs, widen, f"8B {cache} cache")

        for name, row in time_serving_decode(
                rng, q, nk, nv, make, f"8B {cache} cache", ks, vs,
                widen).items():
            rows[name][cache] = row

    for name, by_variant in rows.items():
        for variant, r in by_variant.items():
            log(f"kernel {name} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    return rows


def block_decode_row(q, nk, nv, make, lens_np, ks, vs, widen, label):
    """B5's device ms on one layer of greedy_generate's 8B cache (32, 64, 8,
    192, 128) made by ``make`` at lengths ``lens_np``, the calls walking the
    32 layers, beside its bound (the live cache bytes once, q, the new rows
    and the output), its plain version and SDPA with GQA over the cache
    widened to bf16 (``widen``)."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
    )

    s_pad = 192
    lengths = torch.from_numpy(lens_np).to(q.device)
    ck, cv = (make((L8, BATCH, KVH8, s_pad, D8)) for _ in range(2))
    t = device_ms([lambda i=i: da.decode_attention(
        q, nk, nv, ck, cv, lengths, layer=i, k_scale=ks, v_scale=vs)
        for i in range(L8)])
    tp = eager_ms(lambda: da.decode_attention_plain(
        q, nk, nv, ck, cv, lengths, layer=0, k_scale=ks, v_scale=vs))
    mask = (torch.arange(s_pad, device=q.device)[None, :]
            <= lengths[:, None])[:, None, None, :]
    keys = [widen(ck[i]) for i in range(4)] * (L8 // 4)
    values = [widen(cv[i]) for i in range(4)] * (L8 // 4)
    try:
        tl = device_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)
            for k, v in zip(keys, values)])
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention with GQA unavailable: {exc}")
        tl = None
    live = int((lens_np + 1).sum())
    bm, by = bound(2 * live * KVH8 * D8 * ck.element_size()
                   + (q.numel() + 2 * nk.numel()) * 2 * 2,
                   4 * H8 * D8 * live, PEAK_BF16)
    del ck, cv, keys, values
    return dict(ms=t, plain_ms=tp, bound_ms=bm, bound_by=by, library_ms=tl,
                shapes=f"{label} (32, 64, 8, 192, 128), one layer, lengths "
                "128-159; library: SDPA over the cache in bf16")


# --------------------------------------------------------------------- #
# phases 7-8: NVFP4 / MXFP4 (B8) and grouped-int8 WnA16 (B9)

FP4_GROUPS = {"nvfp4": 16, "mxfp4": 32}   # format -> group size
E8_BITS = {"w8a16": 8, "w4 e8": 4}        # weights -> bits (group 128)
NVFP4_GROUPS = ({"q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv"},
                {"o_proj": "o"}, {"gate_proj": "gu", "up_proj": "gu"},
                {"down_proj": "down"})


def fp4_operands(gen, n, k, group):
    """(N, K/2) uint8 E2M1 codes and (K/g, N) f32 kernel scales as the
    fp4 prepare leaves them, drawn on the card: NVFP4 (g16) e4m3 scales
    over a global scale for max|w| = 0.1, MXFP4 (g32) powers of two."""
    import torch

    codes = torch.randint(0, 256, (n, k // 2), generator=gen, device="cuda",
                          dtype=torch.uint8)
    if group == 16:
        e4m3 = (torch.rand((k // group, n), generator=gen, device="cuda")
                * 400 + 16).to(torch.float8_e4m3fn)
        scales = e4m3.float() / torch.full((1, 1), 2688.0 / 0.1,
                                           device="cuda")
    else:
        scales = torch.exp2(torch.randint(
            -10, -6, (k // group, n), generator=gen, device="cuda").float())
    return codes, scales


def e8_operands(gen, n, k, bits):
    """(N, K) int8 values of a ``bits``-bit symmetric weight and (K/128,
    N) f32 scales (the weights about as large as the W4A16 model's)."""
    import torch

    w8 = torch.randint(-(1 << (bits - 1)), 1 << (bits - 1), (n, k),
                       generator=gen, device="cuda", dtype=torch.int8)
    scales = (torch.rand((k // 128, n), generator=gen, device="cuda") * 2e-3
              + 1e-3) / (1 << (bits - 4))
    return w8, scales


def wna16_ops(kernel, fmt, n, k, gen):
    """(weight, scales, kernel(x, w, s), plain(x, w, s) in f32, dequantized
    bf16 weight(w, s), checkpoint bytes the bound counts) for one linear of
    B8 or B9."""
    import torch

    from compressed_tensors_tpu_torch.ops.fp4_pack import (
        unpack_fp4_from_uint8,
    )
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    if kernel == "w4a16_fp4_matmul":
        g = FP4_GROUPS[fmt]
        w, s = fp4_operands(gen, n, k, g)
        run, plain = w4.w4a16_fp4_matmul, w4.w4a16_fp4_matmul_plain

        def dense(w, s):
            return (unpack_fp4_from_uint8(w, n, k, torch.float32)
                    * s.t().repeat_interleave(g, 1)).to(torch.bfloat16)

        # codes plus one e4m3 or E8M0 byte per group
        nbytes = n * k // 2 + n * k // g
    else:
        g, bits = 128, E8_BITS[fmt]
        w, s = e8_operands(gen, n, k, bits)
        run, plain = w4.w4_e8_matmul, w4.w4_e8_matmul_plain

        def dense(w, s):
            return (w.float() * s.t().repeat_interleave(g, 1)).to(
                torch.bfloat16)

        # the checkpoint's packed bits plus bf16 group scales (W4 under
        # e8 reads twice that, the bound stays the packed bytes)
        nbytes = n * k * bits // 8 + n * k // g * 2
    kw = dict(n=n, k=k, group_size=g)
    return (w, s, lambda x, w, s: run(x, w, s, **kw),
            lambda x, w, s: plain(x, w, s, out_dtype=torch.float32, **kw),
            dense, nbytes)


def check_rule(name, got, want):
    """A kernel output against its f32 plain result by the a8b rule:
    every element within A8B_REL * |y| + A8B_ABS * max|y| (bf16 output
    rounding, f32 summation order; the kernel rounds each weight exactly
    as its plain version does). Returns max|kernel - plain|."""
    if not (bool(got.float().isfinite().all())
            and bool(want.isfinite().all())):
        raise AssertionError(f"{name}: non-finite values")
    scale = want.abs().max().item()
    diff = (got.float() - want).abs()
    bad = int((diff > A8B_REL * want.abs() + A8B_ABS * scale).sum())
    err = diff.max().item()
    log(f"parity {name}: max_abs_err={err:.6g} max|plain f32|={scale:.6g} "
        f"rel={err / scale:.3g}; elements outside {A8B_REL:.4g}|y| + "
        f"{A8B_ABS} max|y|: {bad} of {want.numel()}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    return err


def parity_wna16(errs, kernel, fmts):
    """B8 or B9 against its plain version at the four 8B linear shapes, at
    M = 64 and 512, for each of ``fmts``; updates ``errs``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    for lin, (n, k) in W4_SHAPES_8B.items():
        for fmt in fmts:
            w, s, run, plain, _, _ = wna16_ops(kernel, fmt, n, k, gen)
            for m in (BATCH, M_CHUNK):
                x = dev_randn(gen, m, k)
                errs[kernel] = max(errs.get(kernel, 0.0), check_rule(
                    f"{kernel} {fmt} {lin} M={m}", run(x, w, s),
                    plain(x, w, s)))
            del w, s
        torch.cuda.empty_cache()


def timings_wna16(kernel, fmts):
    """Device ms of B8 or B9 over the four linears of one 8B layer at
    M = 64 and 512 for each of ``fmts``, bound, plain ms, and torch.matmul
    on the dequantized bf16 weight. The timed calls rotate over copies of
    the weight and its scales together, so each call reads both cold.
    Returns {"<fmt> M=<m>": row}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for fmt in fmts:
        for m in (BATCH, M_CHUNK):
            ms = plain_ms = lib = nbytes = ops = 0.0
            for lin, (n, k) in W4_SHAPES_8B.items():
                x = dev_randn(gen, m, k)
                w, s, run, plain, dense, wbytes = wna16_ops(kernel, fmt, n,
                                                            k, gen)
                pairs = [(w.clone(), s.clone()) for _ in range(copies_for(
                    w.numel() * w.element_size()
                    + s.numel() * s.element_size()))]
                t = device_ms([lambda w=w, s=s: run(x, w, s)
                               for w, s in pairs])
                tp = eager_ms(lambda: plain(x, w, s), iters=3)
                del pairs
                wd = dense(w, s)
                wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
                tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                                for wd in wds])
                del wds, wd, w, s
                b = m * k * 2 + wbytes + m * n * 2
                bm, by = bound(b, 2 * m * n * k, PEAK_BF16)
                log(f"time {kernel} {fmt} {lin} M={m} (8B): {t:.4f} ms, "
                    f"bound {bm:.4f} ms ({by}), plain {tp:.4f} ms, "
                    f"torch.matmul on the dequantized bf16 weight {tl:.4f} ms")
                ms, plain_ms, lib = ms + t, plain_ms + tp, lib + tl
                nbytes, ops = nbytes + b, ops + 2 * m * n * k
            bm, by = bound(nbytes, ops, PEAK_BF16)
            rows[f"{fmt} M={m}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bm, bound_by=by,
                library_ms=lib, shapes=f"{fmt}: qkv+o+gate_up+down of one 8B "
                f"layer, M={m}; bound from the checkpoint's bytes; library: "
                "torch.matmul on the dequantized bf16 weight")
            torch.cuda.empty_cache()
    return rows


def card_w4_codes(gen, n, k, g=128):
    """Symmetric W4 codes uniform in [-7, 7] and bf16 group scales in
    [1e-3, 3e-3], drawn on the card (codes first), as every symmetric W4
    model of this script draws them."""
    import torch

    codes = torch.randint(-7, 8, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
    scale = torch.rand((n, k // g), generator=gen, device="cuda") * 2e-3 \
        + 1e-3
    return codes, scale.to(torch.bfloat16)


def card_w8a8(gen, n, k, scheme):
    """A W8A8-int linear drawn on the card as ``card_llama``'s lm_head:
    int8 weights in [-127, 127], (N, 1) f32 scales in [1e-4, 3e-4]."""
    import torch

    from compressed_tensors_tpu_torch.config import CompressionFormat
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )

    return prepare_for_kernels(QuantizedTensor(
        weight=torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                             dtype=torch.int8),
        scale=torch.rand((n, 1), generator=gen, device="cuda") * 2e-4 + 1e-4,
        shape=(n, k), scheme=scheme,
        format=CompressionFormat.int_quantized.value))


def card_llama(config, make_linear, gen):
    """Llama params built on the card from ``gen``: N(0, 0.02^2) bf16
    embeddings, unit norms, a W8A8-int lm_head (int8 weights, (V, 1) f32
    scales in [1e-4, 3e-4], as the synthetic models draw it) and the
    decoder linears from ``make_linear(layer_index)`` (a dict)."""
    import torch

    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    H, V = config.hidden_size, config.vocab_size

    def ones():
        return torch.ones((H,), dtype=torch.bfloat16, device="cuda")

    params = {"embed_tokens": (torch.randn((V, H), generator=gen,
                                           device="cuda") * 0.02).to(
                  torch.bfloat16),
              "norm": ones(), "layers": []}
    for i in range(config.num_hidden_layers):
        params["layers"].append(dict(make_linear(i), input_layernorm=ones(),
                                     post_attention_layernorm=ones()))
    params["lm_head"] = card_w8a8(gen, V, H, preset_name_to_scheme(
        "W8A8", ["lm_head"]))
    return params


def linear_shapes(config):
    """(N, K) of each decoder linear, unfused."""
    H, I = config.hidden_size, config.intermediate_size
    q, kv = (config.num_attention_heads * config.head_dim,
             config.num_key_value_heads * config.head_dim)
    return {"q_proj": (q, H), "k_proj": (kv, H), "v_proj": (kv, H),
            "o_proj": (H, q), "gate_proj": (I, H), "up_proj": (I, H),
            "down_proj": (H, I)}


def nvfp4_llama(config, seed):
    """Llama-3-8B NVFP4A16 built on the card: bf16 N(0, 0.02^2) weights,
    one global scale per fused group (q/k/v, gate/up; the others alone)
    from generate_gparam, group min/max -> calculate_qparams, compressed
    by NVFP4PackedCompressor (the dense weights are dropped)."""
    import torch

    from compressed_tensors_tpu_torch.compressors import NVFP4PackedCompressor
    from compressed_tensors_tpu_torch.ops.linear import (
        from_compressed_state,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.qparams import (
        calculate_qparams,
        generate_gparam,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("NVFP4A16", ["Linear"])
    scheme.format = "nvfp4-pack-quantized"
    args = scheme.weights
    shapes = linear_shapes(config)

    def layer(_):
        out = {}
        for group in NVFP4_GROUPS:
            ws = {name: (torch.randn(shapes[name], generator=gen,
                                     device="cuda") * 0.02).to(torch.bfloat16)
                  for name in group}
            gs = generate_gparam(
                torch.stack([w.min() for w in ws.values()]).min().float(),
                torch.stack([w.max() for w in ws.values()]).max().float())
            for name, w in ws.items():
                g = w.float().reshape(w.shape[0], -1, args.group_size)
                scale, _ = calculate_qparams(g.amin(-1), g.amax(-1), args,
                                             global_scale=gs)
                state = NVFP4PackedCompressor.compress(
                    {"weight": w, "weight_scale": scale,
                     "weight_global_scale": gs}, scheme)
                out[name] = prepare_for_kernels(
                    from_compressed_state(state, scheme))
            del ws
        return out

    return card_llama(config, layer, gen)


def w8a16_llama(config, seed):
    """Llama-3-8B W8A16 g128 (pack-quantized) built on the card, drawn as
    the synthetic pack-quantized models draw theirs: random int32 words
    and bf16 group scales in [1e-3, 3e-3], here divided by 16 so that the
    8-bit weights are about as large as the W4A16 model's; a W8A8-int
    lm_head."""
    import torch

    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W8A16", ["Linear"])
    scheme.format = "pack-quantized"
    g = scheme.weights.group_size

    def linear(n, k):
        words = torch.randint(-(2**31), 2**31, (n, k // 4), generator=gen,
                              device="cuda", dtype=torch.int32)
        scale = (torch.rand((n, k // g), generator=gen, device="cuda")
                 * 2e-3 + 1e-3) * 0.0625
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=words, scale=scale.to(torch.bfloat16),
            shape=(n, k), scheme=scheme, format=scheme.format))

    return card_llama(config, lambda _: {
        name: linear(*shape) for name, shape in linear_shapes(config).items()},
        gen)


def check_launched(results, needs):
    """Every kernel in ``needs[run]`` launched during that run."""
    for name, kernels in needs.items():
        missing = [k for k in kernels if results[name]["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{name} never launched {missing}")


def phase_nvfp4(errs):
    """Phase 7 (B8): the fp4 kernel against its plain version (NVFP4 and
    MXFP4 at the 8B shapes), then Llama-3-8B NVFP4A16 built on the card,
    fused: first-token logits against the non-kernel path, the serving
    requests through the dense and paged engines (identical), and
    greedy_generate at batch 64."""
    import torch

    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    parity_wna16(errs, "w4a16_fp4_matmul", FP4_GROUPS)
    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fuse_llama_layers(nvfp4_llama(config, seed=0))
    torch.cuda.synchronize()
    fused = params["layers"][0]
    if not ("qkv_proj" in fused and "gate_up_proj" in fused):
        raise AssertionError("NVFP4 members sharing a global scale did not "
                             "fuse")
    log(f"Llama-3-8B NVFP4A16 model (built on the card from seed 0, fused, "
        f"W8A8-int lm_head): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    check_logits_by_depth(params, config, requests, "NVFP4 8B")
    runs = {"nvfp4 dense": dict(paged=False),
            "nvfp4 paged": dict(paged=True, prefix_caching=False)}
    results = {name: serve_requests(params, config, requests, name, **kw)
               for name, kw in runs.items()}
    dense, paged = (results[k]["outs"] for k in runs)
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving nvfp4 paged vs dense: {N_REQUESTS - len(bad)}/{N_REQUESTS} "
        "completions identical token for token")
    if bad:
        raise AssertionError(f"nvfp4 serving: paged and dense completions "
                             f"differ for requests {bad}")
    results["nvfp4 greedy_generate"] = greedy_8b(params, config, "nvfp4")
    base = ("w4a16_fp4_matmul", "w8a8_matmul", "prefill_attention")
    check_launched(results, {
        "nvfp4 dense": base + ("flash_decode_attention",),
        "nvfp4 paged": base + ("paged_decode_attention",),
        "nvfp4 greedy_generate": base + ("decode_attention",)})
    return results


def phase_w8a16(errs):
    """Phase 8 (B9): the grouped-int8 kernel against its plain version
    (W8A16 g128 and W4A16 under w4_layout="e8" at the 8B shapes), then
    Llama-3-8B W8A16: first-token logits against the non-kernel path,
    greedy_generate at batch 64 and the serving requests through the paged
    engine."""
    import torch

    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    parity_wna16(errs, "w4_e8_matmul", E8_BITS)
    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fuse_llama_layers(w8a16_llama(config, seed=0))
    torch.cuda.synchronize()
    log(f"Llama-3-8B W8A16 g128 model (pack-quantized, built on the card "
        f"from seed 0, fused, W8A8-int lm_head): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    check_logits_by_depth(params, config, requests, "W8A16 8B")
    results = {"w8a16 greedy_generate": greedy_8b(params, config, "w8a16"),
               "w8a16 paged": serve_requests(params, config, requests,
                                             "w8a16 paged", paged=True,
                                             prefix_caching=False)}
    base = ("w4_e8_matmul", "w8a8_matmul", "prefill_attention")
    check_launched(results, {
        "w8a16 greedy_generate": base + ("decode_attention",),
        "w8a16 paged": base + ("paged_decode_attention",)})
    return results


# --------------------------------------------------------------------- #
# phases 9-10: the int32 8-plane W4A16 modes (B10) on Qwen2.5-7B (AWQ
# kind, zero points) and Qwen3-8B (GPTQ kind), w4_layout="packed"

# published configs (config.json of Qwen/Qwen2.5-7B-Instruct and
# Qwen/Qwen3-8B); model_type sets the qkv bias (qwen2) and the q/k norm
# (qwen3) as in both packages' LlamaConfig.from_dict
QWEN25_7B = dict(model_type="qwen2", vocab_size=152064, hidden_size=3584,
                 intermediate_size=18944, num_hidden_layers=28,
                 num_attention_heads=28, num_key_value_heads=4, head_dim=128,
                 rope_theta=1e6, rms_norm_eps=1e-6,
                 max_position_embeddings=32768, tie_word_embeddings=False)
QWEN3_8B = dict(model_type="qwen3", vocab_size=151936, hidden_size=4096,
                intermediate_size=12288, num_hidden_layers=36,
                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                rope_theta=1e6, rms_norm_eps=1e-6,
                max_position_embeddings=40960, tie_word_embeddings=False)
QWEN25_DEPTHS = (1, 2, 4, 8, 16, 28)
QWEN3_DEPTHS = (1, 2, 4, 8, 16, 36)
QKV_BIAS_STD = 0.5   # Qwen2 q/k/v bias: about the size of the projections
QK_NORM_STD = 0.1    # Qwen3 q/k norm weights: 1 + N(0, 0.1^2)


def fused_shapes(config):
    """(N, K) of each fused decoder linear."""
    H, I = config.hidden_size, config.intermediate_size
    q, kv = (config.num_attention_heads * config.head_dim,
             config.num_key_value_heads * config.head_dim)
    return {"qkv_proj": (q + 2 * kv, H), "o_proj": (H, q),
            "gate_up_proj": (2 * I, H), "down_proj": (H, I)}


def plane_operands(gen, n, k, asym, group=128):
    """A W4 linear in the plane layout, drawn on the card as the W4A16
    model is: random codes, (K/g, N) scales in [1e-3, 3e-3] (and zero
    points in [-8, 7]), K padded to 8 groups as prepare does. Returns
    (words, scales, zp, K_pad)."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    k_pad, tk = w4.padded_k(k, group), w4.choose_k_tile(k, group)
    u = torch.randint(0, 16, (n, k_pad), generator=gen, device="cuda",
                      dtype=torch.int32)
    u[:, k:] = 8
    words = w4.repack_w4_for_kernel(u, 4, k_pad, tk)
    del u
    scales = torch.rand((k_pad // group, n), generator=gen,
                        device="cuda") * 2e-3 + 1e-3
    scales[k // group:] = 0
    zp = (torch.randint(-8, 8, (k_pad // group, n), generator=gen,
                        device="cuda").float() if asym else None)
    return words, scales, zp, k_pad


def parity_planes(errs, config, asym, label):
    """B10 against its plain version at the fused linear shapes of
    ``config``, in every mode at M = 1, 64, 100 and 512, by the a8b rule;
    in mode a8 the quantization pass equal to the plain one bit for bit."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    gen = torch.Generator(device="cuda").manual_seed(9)
    for lin, (n, k) in fused_shapes(config).items():
        words, s, zp, k_pad = plane_operands(gen, n, k, asym)
        for m in PLANES_GRID["M"]:
            x = dev_randn(gen, m, k)
            for mode in w4.PLANE_MODES:
                name = f"w4a16_planes_{mode}"
                kw = dict(n=n, k=k_pad, group_size=128, mode=mode)
                scratch = {}
                if mode == "a8":
                    scratch = dict(
                        xq=torch.empty((m, k), dtype=torch.int8,
                                       device="cuda"),
                        xs=torch.empty((m,), dtype=torch.float32,
                                       device="cuda"))
                got = w4.w4a16_planes_matmul(x, words, s, zp, **kw,
                                             **scratch)
                if mode == "a8":
                    xq, xs = w4.quantize_rows_a8b_plain(x)
                    if not (torch.equal(scratch["xq"], xq)
                            and torch.equal(scratch["xs"], xs)):
                        raise AssertionError(f"{name} {lin}: quantization "
                                             "pass differs from plain")
                want = w4.w4a16_planes_matmul_plain(
                    x, words, s, zp, out_dtype=torch.float32, **kw)
                errs[name] = max(errs.get(name, 0.0), check_rule(
                    f"{name} {label} {lin} M={m}", got, want))
                del got, want
        del words, s, zp
        torch.cuda.empty_cache()


def parity_rep7(errs):
    """The attention kernels at Qwen2.5-7B's 7 query heads per kv head (H
    = 28, KVH = 4, D = 128) against their plain versions: prefill over
    one 512-token chunk, block decode, flash and paged decode over the
    serving engines' caches."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        prefill_attention as pa,
    )

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    H, KVH = 28, 4

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    q, k, v = (dev_randn(gen, 1, M_CHUNK, h, D8) for h in (H, KVH, KVH))
    keep("prefill_attention", check_close(
        "prefill_attention B=1 S=512 H=28 KVH=4 D=128",
        pa.prefill_attention(q, k, v), pa.prefill_attention_plain(q, k, v)))
    q, nk, nv = (dev_randn(gen, BATCH, h, D8) for h in (H, KVH, KVH))
    ck, cv = (dev_randn(gen, 2, BATCH, KVH, 256, D8) for _ in range(2))
    lengths = torch.from_numpy(rng.integers(0, 255, BATCH).astype(
        np.int32)).cuda()
    ck_p, cv_p = ck.clone(), cv.clone()
    out, _, _ = da.decode_attention(q, nk, nv, ck, cv, lengths, layer=1)
    want, _, _ = da.decode_attention_plain(q, nk, nv, ck_p, cv_p, lengths,
                                           layer=1)
    keep("decode_attention", check_close("decode_attention H=28 KVH=4",
                                         out, want))
    if not (torch.equal(ck, ck_p) and torch.equal(cv, cv_p)):
        raise AssertionError("decode_attention H=28 cache write differs")
    del ck, cv, ck_p, cv_p
    check_serving_decode(errs, rng, q, nk, nv,
                         lambda shape: dev_randn(gen, *shape),
                         "bf16 cache, H=28 KVH=4")


def w4a16_llama(config, seed, asym):
    """A Llama, Qwen2 or Qwen3 model at full width built on the card as
    ``w8a16_llama`` draws its model, as W4A16 g128 pack-quantized with
    bf16 group scales
    in [1e-3, 3e-3]: with ``asym`` (W4A16_ASYM, the AWQ kind) random int32
    words and zero points in [-8, 7] packed along dim 0; symmetric (the
    GPTQ kind) codes q uniform in [-7, 7]; the qkv bias (qwen2) in bf16
    N(0, QKV_BIAS_STD^2), the q/k norm weights (qwen3) 1 + N(0,
    QK_NORM_STD^2); a W8A8-int lm_head. Each linear is prepared in the
    layout the ``w4_layout`` flag names.

    Symmetric codes leave out -8: random words give q a mean of -0.5 (a
    tenth of its spread), which over K = 4096 inputs turns every linear's
    output toward the all-ones direction; on the H100 such a random
    Qwen3-8B kept one argmax at every depth, and group scales rolled by
    one group moved its logits by 1-4% (against 75% for Qwen2.5, whose zero
    points cancel that mean), too little for the control. Phase 5's
    Llama-3-8B used to draw such words (``make_synthetic_llama``, the JAX
    package's draw, which the CPU tests keep)."""
    import torch

    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W4A16_ASYM" if asym else "W4A16",
                                   ["Linear"])
    scheme.format = "pack-quantized"
    g = scheme.weights.group_size

    def linear(n, k, bias):
        if asym:
            words = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen,
                                  device="cuda", dtype=torch.int32)
            scale = (torch.rand((n, k // g), generator=gen, device="cuda")
                     * 2e-3 + 1e-3).to(torch.bfloat16)
        else:
            codes, scale = card_w4_codes(gen, n, k, g)
            words = pack_to_int32(codes, 4)
        zp = (pack_to_int32(torch.randint(
            -8, 8, (n, k // g), generator=gen, device="cuda",
            dtype=torch.int8), 4, packed_dim=0) if asym else None)
        b = ((torch.randn((n,), generator=gen, device="cuda") * QKV_BIAS_STD)
             .to(torch.bfloat16) if bias else None)
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=words, scale=scale, zero_point=zp, bias=b,
            shape=(n, k), scheme=scheme, format=scheme.format))

    def layer(_):
        out = {name: linear(*shape, bias=config.attention_bias
                            and name in ("q_proj", "k_proj", "v_proj"))
               for name, shape in linear_shapes(config).items()}
        if config.qk_norm:
            for name in ("q_norm", "k_norm"):
                out[name] = (1 + QK_NORM_STD * torch.randn(
                    (config.head_dim,), generator=gen, device="cuda")).to(
                        torch.bfloat16)
        return out

    return card_llama(config, layer, gen)


def reprepared(params, w4_layout):
    """The same checkpoint fields with every decoder linear's kernel layout
    rebuilt under ``w4_layout``."""
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )

    return dict(params, layers=[
        {name: (prepare_for_kernels(qt, w4_layout=w4_layout)
                if isinstance(qt, QuantizedTensor) else qt)
         for name, qt in layer.items()} for layer in params["layers"]])


def build_qwen(spec, seed, asym, label):
    """``w4a16_llama`` under w4_layout="packed", fused; checks that every
    decoder linear took the plane layout."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = LlamaConfig.from_dict(spec)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with flag_overrides(w4_layout="packed"):
        params = fuse_llama_layers(w4a16_llama(config, seed, asym))
    torch.cuda.synchronize()
    kinds = {qt.kernel_meta[0] for layer in params["layers"]
             for qt in layer.values() if hasattr(qt, "kernel_meta")}
    if kinds != {"w4packed"} or "qkv_proj" not in params["layers"][0]:
        raise AssertionError(f"{label}: decoder linears prepared as {kinds}")
    log(f"{label} model (built on the card from seed {seed}, "
        f"w4_layout=\"packed\", fused, W8A8-int lm_head): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return params, config


def phase_qwen25(errs):
    """Phase 9: B10 against its plain version at Qwen2.5-7B shapes (zero
    points) and the attention kernels at 7 query heads per kv head; then
    Qwen2.5-7B-Instruct-AWQ kind (W4A16 asymmetric g128, bf16 qkv bias)
    under w4_layout="packed": first-token logits by depth in modes int4
    (with the rolled-scales control) and mat, the serving requests dense
    and paged in mode int4 (identical), greedy_generate at batch 64 in
    mode mat, and the requests once more under w4_layout="auto" (B1
    int4b), whose completions are counted against the packed ones."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.config import LlamaConfig

    parity_planes(errs, LlamaConfig.from_dict(QWEN25_7B), True, "qwen2.5")
    parity_rep7(errs)
    params, config = build_qwen(QWEN25_7B, 0, True, "Qwen2.5-7B AWQ-kind")
    requests = serving_requests()
    results = {}
    with flag_overrides(w4_mode="int4"):
        check_logits_by_depth(params, config, requests, "Qwen2.5 int4",
                              depths=QWEN25_DEPTHS)
        for name, kw in (("qwen2.5 dense", dict(paged=False)),
                         ("qwen2.5 paged", dict(paged=True,
                                                prefix_caching=False))):
            results[name] = serve_requests(params, config, requests, name,
                                           **kw)
    dense, paged = (results[k]["outs"] for k in ("qwen2.5 dense",
                                                 "qwen2.5 paged"))
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving qwen2.5 paged vs dense: {N_REQUESTS - len(bad)}/"
        f"{N_REQUESTS} completions identical token for token")
    if bad:
        raise AssertionError(f"qwen2.5 serving: paged and dense completions "
                             f"differ for requests {bad}")
    with flag_overrides(w4_mode="mat"):
        sweep, _ = logits_by_depth(params, config, requests, "Qwen2.5 mat",
                                   depths=QWEN25_DEPTHS)
        failures = logits_rule_failures(sweep)
        if failures:
            raise AssertionError(f"Qwen2.5 mat logits: {'; '.join(failures)}")
        results["qwen2.5 greedy_generate"] = greedy_8b(params, config,
                                                       "qwen2.5 mat")
    auto = reprepared(params, "auto")
    del params
    torch.cuda.empty_cache()
    results["qwen2.5 dense auto"] = serve_requests(
        auto, config, requests, "qwen2.5 dense, w4_layout=auto", paged=False)
    same = sum(results["qwen2.5 dense auto"]["outs"][i] == dense[i]
               for i in dense)
    log(f"serving qwen2.5 dense under w4_layout=\"auto\" (int4b) vs "
        f"\"packed\" (B10 int4): {same}/{N_REQUESTS} completions identical "
        "(recorded, not a limit)")
    del auto
    base = ("w8a8_matmul", "prefill_attention")
    check_launched(results, {
        "qwen2.5 dense": base + ("w4a16_planes_int4", "flash_decode_attention"),
        "qwen2.5 paged": base + ("w4a16_planes_int4", "paged_decode_attention"),
        "qwen2.5 greedy_generate": base + ("w4a16_planes_mat",
                                           "decode_attention"),
        "qwen2.5 dense auto": base + ("w4a16_matmul",)})
    results["qwen2.5 dense auto"]["identical"] = same
    return results


@contextlib.contextmanager
def plain_w4():
    """Every int4-word W4 matmul of the model (B1 int4b, B2 a8b) through
    its kernel's plain version on the card, in the mode the dispatcher
    picks; undone on exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kernel = linear.w4a16_matmul
    linear.w4a16_matmul = w4.w4a16_matmul_plain
    try:
        yield
    finally:
        linear.w4a16_matmul = kernel


@contextlib.contextmanager
def plain_w8a8():
    """Every W8A8 matmul of the model (B3, int8 and fp8) through its
    kernel's plain version on the card; undone on exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    kernel = linear.w8a8_matmul
    linear.w8a8_matmul = w8.w8a8_matmul_plain
    try:
        yield
    finally:
        linear.w8a8_matmul = kernel


@contextlib.contextmanager
def plain_w4_w8a8():
    """``plain_w4`` and ``plain_w8a8`` together."""
    with plain_w4(), plain_w8a8():
        yield


@contextlib.contextmanager
def plain_planes():
    """Every plane-layout matmul of the model through the plane kernel's
    plain version on the card, in the same mode; undone on exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kernel = linear.w4a16_planes_matmul
    linear.w4a16_planes_matmul = w4.w4a16_planes_matmul_plain
    try:
        yield
    finally:
        linear.w4a16_planes_matmul = kernel


def phase_qwen3(errs):
    """Phase 10: B10 against its plain version at Qwen3-8B shapes
    (symmetric), then Qwen3-8B W4A16 g128 (the GPTQ kind, q/k norms)
    under w4_layout="packed": first-token logits by depth in mode int4
    against the non-kernel path (with the rolled-scales control), in mode
    a8 against the plain a8 path, and
    greedy_generate at batch 64 in mode a8."""
    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.config import LlamaConfig

    parity_planes(errs, LlamaConfig.from_dict(QWEN3_8B), False, "qwen3")
    params, config = build_qwen(QWEN3_8B, 0, False, "Qwen3-8B W4A16")
    requests = serving_requests()
    with flag_overrides(w4_mode="int4"):
        check_logits_by_depth(params, config, requests, "Qwen3 int4",
                              depths=QWEN3_DEPTHS)
    # mode a8 rounds every linear's input to int8 per row (absmax / 127),
    # which the non-kernel path does not: on the H100 that alone moved the
    # random Qwen3-8B's first-token logits 4.6% of max|ref| at one layer
    # and 4-6% relative RMS at every depth, about 4x the one-ulp spread. So
    # a8 is held by the logits rule against the same arithmetic, every
    # plane matmul through its plain version in mode a8
    with flag_overrides(w4_mode="a8"):
        sweep, _ = logits_by_depth(params, config, requests, "Qwen3 a8",
                                   depths=QWEN3_DEPTHS, plain=plain_planes)
    failures = logits_rule_failures(sweep)
    if failures:
        raise AssertionError(f"Qwen3 a8 logits against the plain a8 path: "
                             f"{'; '.join(failures)}")
    with flag_overrides(w4_mode="a8"):
        results = {"qwen3 greedy_generate": greedy_8b(params, config,
                                                      "qwen3 a8")}
    check_launched(results, {"qwen3 greedy_generate": (
        "w4a16_planes_a8", "w8a8_matmul", "prefill_attention",
        "decode_attention")})
    return results


def timings_planes():
    """Device ms of B10 over the four fused linears of one Qwen2.5-7B
    layer (zero points) at M = 64 and 512 in each mode, bound, plain ms,
    and torch.matmul on the dequantized bf16 weight. The timed calls
    rotate over copies of the words, scales and zero points together.
    Returns {kernel name: {"M=<m>": row}}."""
    import torch

    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {f"w4a16_planes_{mode}": {} for mode in w4.PLANE_MODES}
    sums = {}
    for lin, (n, k) in fused_shapes(LlamaConfig.from_dict(QWEN25_7B)).items():
        words, s, zp, k_pad = plane_operands(gen, n, k, True)
        # the checkpoint: 4-bit codes, bf16 group scales, 4-bit zero points
        ckpt = n * k // 2 + n * k // 128 * 2 + n * k // 128 // 2
        copies = [(words.clone(), s.clone(), zp.clone()) for _ in range(
            copies_for(words.numel() * 4 + 2 * s.numel() * 4))]
        wd = ((w4._plane_codes(words, 128).float() - 8
               - zp.repeat_interleave(128, 0)) * s.repeat_interleave(128, 0)
              )[:k].t().to(torch.bfloat16).contiguous()
        wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
        for m in (BATCH, M_CHUNK):
            x = dev_randn(gen, m, k)
            tl = device_ms([lambda wd=wd: torch.matmul(x, wd.t())
                            for wd in wds])
            for mode in w4.PLANE_MODES:
                kw = dict(n=n, k=k_pad, group_size=128, mode=mode)
                t = device_ms([lambda c=c: w4.w4a16_planes_matmul(
                    x, *c, **kw) for c in copies])
                tp = eager_ms(lambda: w4.w4a16_planes_matmul_plain(
                    x, words, s, zp, **kw), iters=3)
                peak = PEAK_INT8 if mode == "a8" else PEAK_BF16
                b = m * k * 2 + ckpt + m * n * 2
                bm, by = bound(b, 2 * m * n * k, peak)
                log(f"time w4a16_planes_{mode} qwen2.5 {lin} M={m}: "
                    f"{t:.4f} ms, bound {bm:.4f} ms ({by}), plain {tp:.4f} "
                    f"ms, torch.matmul on the dequantized bf16 weight "
                    f"{tl:.4f} ms")
                acc = sums.setdefault((mode, m), [0.0] * 5)
                for i, v in enumerate((t, tp, tl, b, 2 * m * n * k)):
                    acc[i] += v
        del copies, wds, wd, words, s, zp
        torch.cuda.empty_cache()
    for (mode, m), (t, tp, tl, b, ops) in sums.items():
        bm, by = bound(b, ops, PEAK_INT8 if mode == "a8" else PEAK_BF16)
        rows[f"w4a16_planes_{mode}"][f"M={m}"] = dict(
            ms=t, plain_ms=tp, bound_ms=bm, bound_by=by, library_ms=tl,
            shapes=f"qkv+o+gate_up+down of one Qwen2.5-7B layer (zero "
            f"points), M={m}; bound from the checkpoint's bytes; library: "
            "torch.matmul on the dequantized bf16 weight")
    return rows


# --------------------------------------------------------------------- #
# phases 11-13: Llama-3-8B 2:4 sparse-24-bitmask + INT4 (BASELINE config
# 4), TinyLlama W8A8-int in every linear (config 2) and the per-layer
# W4A16/W8A8 mix of config 5 at Llama-3-8B width

def sparse24_llama(config, seed):
    """Llama-3-8B 2:4 + INT4 drawn on the card: each linear's codes drawn
    as ``w4a16_llama``'s symmetric model draws them (``card_w4_codes``),
    masked with the port's ``get_24_bytemasks``, compressed with
    ``Sparse24BitMaskCompressor`` beside the bf16 group scales (the
    naive-quantized stack of config 4's checkpoints), then
    ``from_compressed_state`` -> ``prepare_for_kernels``. Each linear's
    kernel words must equal ``pack_to_int32`` of its masked dense codes,
    bit for bit, as it is built. Returns (params in the kernel layout,
    the same model with every decoder linear keeping only its sparse
    leaves: the non-kernel path's reference, sharing the embedding table,
    norms and lm_head)."""
    import torch

    from compressed_tensors_tpu_torch.compressors import (
        Sparse24BitMaskCompressor,
    )
    from compressed_tensors_tpu_torch.ops.bitmask import get_24_bytemasks
    from compressed_tensors_tpu_torch.ops.linear import (
        from_compressed_state,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W4A16", ["Linear"])
    scheme.format = "naive-quantized"
    sparse_layers = []

    def layer(_):
        kernel, sparse = {}, {}
        for name, (n, k) in linear_shapes(config).items():
            codes, scale = card_w4_codes(gen, n, k)
            masked = torch.where(get_24_bytemasks(codes), codes,
                                 torch.zeros_like(codes))
            del codes
            state = Sparse24BitMaskCompressor.compress(
                {"weight": masked, "weight_scale": scale}, scheme)
            sparse[name] = from_compressed_state(state, scheme)
            kernel[name] = prepare_for_kernels(sparse[name])
            if (kernel[name].kernel_meta[0] != "w4a16"
                    or not torch.equal(kernel[name].kernel_packed,
                                       pack_to_int32(masked, 4))):
                raise AssertionError(
                    f"sparse 8B layer {len(sparse_layers)} {name}: kernel "
                    "words differ from the masked dense codes' words")
        sparse_layers.append(sparse)
        return kernel

    params = card_llama(config, layer, gen)
    ref = dict(params, layers=[
        dict(sparse, input_layernorm=kl["input_layernorm"],
             post_attention_layernorm=kl["post_attention_layernorm"])
        for sparse, kl in zip(sparse_layers, params["layers"])])
    return params, ref


def sparse24_codec_on_card(gen, config):
    """``sparse24_compress`` / ``_decompress`` on the card against the same
    calls on the CPU, bit for bit, over one 8B layer's seven linears (the
    codes drawn as ``card_w4_codes`` draws them); the device ms of
    ``get_24_bytemasks``, ``sparse24_compress`` and ``sparse24_decompress``
    at the gate_proj shape (the load scatters with the last)."""
    import torch

    from compressed_tensors_tpu_torch.ops.bitmask import (
        get_24_bytemasks,
        sparse24_compress,
        sparse24_decompress,
    )

    n, k = linear_shapes(config)["gate_proj"]
    codes, _ = card_w4_codes(gen, n, k)
    vals, mask = sparse24_compress(codes)
    log(f"sparse-24 codec at ({n}, {k}) on the card: get_24_bytemasks "
        f"{eager_ms(lambda: get_24_bytemasks(codes)):.3f} ms, "
        f"sparse24_compress {eager_ms(lambda: sparse24_compress(codes)):.3f}"
        f" ms, sparse24_decompress "
        f"{eager_ms(lambda: sparse24_decompress(vals, mask, (n, k))):.3f} "
        "ms")
    del codes, vals, mask
    for name, (n, k) in linear_shapes(config).items():
        codes, _ = card_w4_codes(gen, n, k)
        cuda_vals, cuda_mask = sparse24_compress(codes)
        cpu_vals, cpu_mask = sparse24_compress(codes.cpu())
        dense = sparse24_decompress(cuda_vals, cuda_mask, (n, k))
        same = (torch.equal(cuda_vals.cpu(), cpu_vals)
                and torch.equal(cuda_mask.cpu(), cpu_mask)
                and torch.equal(dense.cpu(), sparse24_decompress(
                    cpu_vals, cpu_mask, (n, k))))
        if not same:
            raise AssertionError(f"sparse-24 codec on the card differs from "
                                 f"the CPU at {name} ({n}, {k})")
    log("sparse-24 codec on the card: compress and decompress of one 8B "
        "layer's seven linears equal the CPU's bit for bit")


def dense_codes_twin(params):
    """The W4A16 model built from the same codes as a 2:4 sparse synthetic
    model: each sparse linear's codes scattered dense and packed as
    pack-quantized words beside its scales (kernel layout built)."""
    import dataclasses as dc

    from compressed_tensors_tpu_torch.config import CompressionFormat
    from compressed_tensors_tpu_torch.ops.bitmask import sparse24_decompress
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32

    def twin(qt):
        if not isinstance(qt, QuantizedTensor) or qt.sparse_values is None:
            return qt
        codes = sparse24_decompress(qt.sparse_values, qt.sparse_bitmask,
                                    qt.shape)
        return prepare_for_kernels(dc.replace(
            qt, sparse_values=None, sparse_bitmask=None,
            weight_packed=pack_to_int32(codes, 4),
            format=CompressionFormat.pack_quantized.value))

    return dict(params, layers=[{k: twin(v) for k, v in layer.items()}
                                for layer in params["layers"]],
                lm_head=prepare_for_kernels(params["lm_head"]))


def sparse24_checkpoint_path():
    """A TinyLlama-shape 2:4 + INT4 checkpoint (``make_synthetic_llama``
    with sparsity="2:4", W8A8-int lm_head) written with
    ``save_llama_checkpoint``, loaded with ``load_llama_params``, and run
    greedy at batch 64 beside the W4A16 model built from the same codes
    (``dense_codes_twin``): the kernel words must be equal and the tokens
    identical."""
    import torch

    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        TINYLLAMA_1_1B,
        make_synthetic_llama,
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = TINYLLAMA_1_1B
    t0 = time.perf_counter()
    synth = make_synthetic_llama(config, "W4A16", seed=0,
                                 lm_head_preset="W8A8", sparsity="2:4",
                                 use_kernels=False, device="cuda")
    twin = dense_codes_twin(synth)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        save_llama_checkpoint(synth, config, tmp)
        del synth
        size = os.path.getsize(os.path.join(tmp, "model.safetensors"))
        with open(os.path.join(tmp, "config.json")) as f:
            sparsity = json.load(f)["quantization_config"]["sparsity_config"]
        params, config, _ = load_llama_params(tmp, device="cuda")
    log(f"TinyLlama 2:4 + INT4 checkpoint: {size / 2**20:.0f} MiB, "
        f"sparsity_config {sparsity}; drawn, written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for i, (a, b) in enumerate(zip(params["layers"], twin["layers"])):
        for name, qt in a.items():
            if hasattr(qt, "kernel_packed") and not (
                    qt.kernel_meta[0] == "w4a16"
                    and torch.equal(qt.kernel_packed, b[name].kernel_packed)):
                raise AssertionError(f"TinyLlama 2:4 layer {i} {name}: "
                                     "kernel words differ from the W4A16 "
                                     "twin's")
    sparse = tiny_greedy(fuse_llama_layers(params), config, "TinyLlama 2:4")
    dense = tiny_greedy(fuse_llama_layers(twin), config,
                        "TinyLlama W4A16 twin")
    same = bool(torch.equal(sparse["out"], dense["out"]))
    log(f"TinyLlama 2:4 checkpoint vs its W4A16 twin: greedy tokens "
        f"{'identical' if same else 'DIFFERENT'} at batch {BATCH}")
    if not same:
        raise AssertionError("the 2:4 checkpoint's greedy tokens differ "
                             "from the W4A16 model of the same codes")
    return sparse


def phase_sparse24(serving):
    """Phase 11: BASELINE config 4, Llama-3-8B 2:4 sparse-24-bitmask + INT4
    at full width and depth (``sparse24_llama``, the kernel words checked
    against the masked codes as it is built), fused; the codec on the card
    against the CPU; first-token logits by depth with every W4 linear at
    bf16 activations against the non-kernel path through the sparse
    leaves (the depth rule and its rolled-scales control); the 96
    requests dense and paged (identical), whose B1/B2 launches must equal
    phase 5's (``serving``) as every request runs to its max_new_tokens;
    then the TinyLlama checkpoint path (``sparse24_checkpoint_path``)."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sparse24_codec_on_card(torch.Generator(device="cuda").manual_seed(11),
                           config)
    log(f"sparse-24 codec check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, ref = sparse24_llama(config, seed=0)
    params = fuse_llama_layers(params)
    torch.cuda.synchronize()
    log(f"Llama-3-8B 2:4 + INT4 model (built on the card from seed 0, codes "
        f"in [-7, 7] masked 2:4, compressed, prepared, kernel words equal "
        f"to the masked codes' in all {7 * config.num_hidden_layers} "
        f"linears, fused): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    t0 = time.perf_counter()
    with flag_overrides(w4_act="bf16"):
        check_logits_by_depth(params, config, requests, "8B 2:4 bf16",
                              ref_params=ref)
    log(f"8B 2:4 logits checks: {time.perf_counter() - t0:.1f} s")
    del ref
    torch.cuda.empty_cache()
    runs = {"sparse24 dense": ("dense", dict(paged=False)),
            "sparse24 paged": ("paged", dict(paged=True,
                                             prefix_caching=False))}
    results = {name: serve_requests(params, config, requests, name, **kw)
               for name, (_, kw) in runs.items()}
    dense, paged = (results[k]["outs"] for k in runs)
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"serving sparse24 paged vs dense: {N_REQUESTS - len(bad)}/"
        f"{N_REQUESTS} completions identical token for token")
    if bad:
        raise AssertionError(f"sparse24 serving: paged and dense completions "
                             f"differ for requests {bad}")
    for name, (w4_run, _) in runs.items():
        got = {k: results[name]["counts"][k]
               for k in ("w4a16_matmul", "w4a16_a8b_matmul")}
        want = {k: serving[w4_run]["counts"][k] for k in got}
        log(f"{name} B1/B2 launches {got}; phase 5 W4A16 {w4_run} {want}")
        if got != want:
            raise AssertionError(f"{name}: B1/B2 launches {got} differ from "
                                 f"phase 5's {w4_run} run {want}")
    del params
    torch.cuda.empty_cache()
    results["sparse24 TinyLlama greedy_generate"] = sparse24_checkpoint_path()
    base = ("w4a16_a8b_matmul", "w4a16_matmul", "w8a8_matmul",
            "prefill_attention")
    check_launched(results, {
        "sparse24 dense": base + ("flash_decode_attention",),
        "sparse24 paged": base + ("paged_decode_attention",),
        "sparse24 TinyLlama greedy_generate": (
            "w4a16_matmul", "w8a8_matmul", "prefill_attention",
            "decode_attention")})
    return results


def phase_w8a8_tiny():
    """Phase 12: BASELINE config 2, TinyLlama W8A8-int in every linear and
    the lm_head (``make_synthetic_llama(preset="W8A8")``), written with
    ``save_llama_checkpoint``, loaded, fused and run as phase 3: greedy at
    batch 64, and 22 x 4 + 1 B3 int8 launches a decode step. The
    first-step logits are held to TOL_E2E against the same model with B3
    through its plain version (``plain_w8a8``), with the per-channel
    weight scales rolled by one channel as the control, and their
    distance to the non-kernel path is printed: that path (the JAX
    package's) rounds each token's activation scale to bf16 before
    quantizing, the kernel keeps it in f32, so codes on a rounding
    boundary part by a step, and the two stood 6.2% of max|ref| apart on
    the H100 (``PERF.md``, PR 11)."""
    import torch

    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        TINYLLAMA_1_1B,
        make_synthetic_llama,
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = TINYLLAMA_1_1B
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        synth = make_synthetic_llama(config, "W8A8", seed=0,
                                     lm_head_preset="W8A8", device="cpu",
                                     use_kernels=False)
        save_llama_checkpoint(synth, config, tmp)
        del synth
        params, config, _ = load_llama_params(tmp, device="cuda")
    params = fuse_llama_layers(params)
    torch.cuda.synchronize()
    log(f"TinyLlama W8A8-int checkpoint (every linear and the lm_head): "
        f"written, loaded and fused in {time.perf_counter() - t0:.1f} s")
    res = tiny_greedy(params, config, "TinyLlama W8A8", kinds=("w8a8",),
                      plain=plain_w8a8)
    want = 4 * config.num_hidden_layers + 1
    if res["per_step"]["w8a8_matmul"] != want or any(
            res["per_step"][k] for k in ("w4a16_matmul", "w4a16_a8b_matmul")):
        raise AssertionError(f"TinyLlama W8A8: {res['per_step']} launches a "
                             f"decode step, expected {want} of B3 int8 and "
                             "no W4")
    log(f"TinyLlama W8A8: {want} B3 int8 launches a decode step (22 x 4 + 1)")
    results = {"w8a8 TinyLlama greedy_generate": res}
    check_launched(results, {"w8a8 TinyLlama greedy_generate": (
        "w8a8_matmul", "prefill_attention", "decode_attention")})
    return results


def mixed_llama(config, seed, presets=("W4A16", "W8A8")):
    """Llama-3-8B with per-layer schemes drawn on the card: layer i takes
    ``presets[i % 2]``, W4A16 as ``w4a16_llama``'s symmetric model (codes
    in [-7, 7], pack-quantized g128), W8A8-int as ``card_w8a8``; a
    W8A8-int lm_head."""
    import torch

    from compressed_tensors_tpu_torch.config import CompressionFormat
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    schemes = {p: preset_name_to_scheme(p, ["Linear"]) for p in presets}

    def linear(preset, n, k):
        if preset == "W8A8":
            return card_w8a8(gen, n, k, schemes[preset])
        codes, scale = card_w4_codes(gen, n, k)
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=pack_to_int32(codes, 4), scale=scale, shape=(n, k),
            scheme=schemes[preset],
            format=CompressionFormat.pack_quantized.value))

    def layer(i):
        preset = presets[i % len(presets)]
        return {name: linear(preset, n, k)
                for name, (n, k) in linear_shapes(config).items()}

    return card_llama(config, layer, gen)


def phase_mixed():
    """Phase 13: config 5's per-layer W4A16/W8A8 mix at Llama-3-8B width
    and depth (``mixed_llama``, 16 layers of each), fused: first-token
    logits by depth at the serving default against the same model with
    B1/B2 and B3 through their plain versions (``plain_w4_w8a8``; phase
    5's depth rule, the control rolling the W4 group scales and the W8A8
    channel scales, the distance to the non-kernel path printed: its W8A8
    activations round with bf16 scales, see ``phase_w8a8_tiny``), greedy
    at batch 64 and the 96 requests through the paged engine, with B1 in
    the W4A16 layers and B3 int8 in the W8A8 layers and the lm_head: 64 +
    65 launches a decode step."""
    import torch

    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.linear import _w4b8_mode

    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fuse_llama_layers(mixed_llama(config, seed=0))
    torch.cuda.synchronize()
    kinds = [{qt.kernel_meta[0] for qt in layer.values()
              if hasattr(qt, "kernel_meta")} for layer in params["layers"]]
    if kinds != [{"w4a16"}, {"w8a8"}] * (config.num_hidden_layers // 2):
        raise AssertionError(f"mixed 8B: kernel layouts by layer {kinds}")
    log(f"Llama-3-8B mixed W4A16/W8A8 model (built on the card from seed 0, "
        f"even layers W4A16, odd W8A8, fused): {time.perf_counter() - t0:.1f}"
        f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    check_logits_by_depth(params, config, requests, "8B mixed",
                          plain=plain_w4_w8a8, kinds=GROUP_KINDS + ("w8a8",))
    results = {"mixed greedy_generate": greedy_8b(params, config, "mixed"),
               "mixed paged": serve_requests(params, config, requests,
                                             "mixed paged", paged=True,
                                             prefix_caching=False)}
    # a decode step: B1 in the 4 fused linears of each W4A16 layer, B3
    # int8 in those of each W8A8 layer and the lm_head; greedy's prefill
    # (8192 rows) runs B2 in place of B1 where its dispatch picks a8b (all
    # four at 8B widths)
    half = config.num_hidden_layers // 2
    step = {"w4a16_matmul": 4 * half, "w4a16_a8b_matmul": 0,
            "w8a8_matmul": 4 * half + 1}
    got = {k: results["mixed paged"]["per_step"][k] for k in step}
    log(f"mixed paged: launches a decode step {got} (expected {step})")
    decode_steps = NEW_TOKENS - 1
    prefill_b2 = half * sum(
        _w4b8_mode(BATCH * PROMPT, *qt.kernel_meta[1:3]) == "a8b"
        for qt in params["layers"][0].values() if hasattr(qt, "kernel_meta"))
    expect = {"w4a16_matmul": step["w4a16_matmul"] * NEW_TOKENS - prefill_b2,
              "w4a16_a8b_matmul": prefill_b2,
              "w8a8_matmul": step["w8a8_matmul"] * NEW_TOKENS}
    counts = results["mixed greedy_generate"]["counts"]
    total = {k: counts[k] for k in expect}
    log(f"mixed greedy_generate: launches {total} over its prefill and "
        f"{decode_steps} decode steps (expected {expect})")
    if got != step or total != expect:
        raise AssertionError(f"mixed 8B launches: a paged decode step {got}, "
                             f"greedy {total}")
    del params
    torch.cuda.empty_cache()
    base = ("w4a16_matmul", "w8a8_matmul", "prefill_attention")
    check_launched(results, {
        "mixed greedy_generate": base + ("w4a16_a8b_matmul",
                                         "decode_attention"),
        "mixed paged": base + ("w4a16_a8b_matmul",
                               "paged_decode_attention")})
    return results


def w8a8_layer_row(gen, shapes, m, label):
    """Device ms of B3 int8 over one layer's four fused linears at M rows
    (each weight in copies larger than L2), its two passes alone beside
    it, bound, plain ms, and ``torch._int_mm`` on rows quantized
    beforehand (the GEMM's library counterpart); one line per linear."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, quantize_ms=0.0,
               gemm_ms=0.0)
    nbytes = ops = 0
    for lin, (n, k) in shapes.items():
        x = dev_randn(gen, m, k)
        ws = [torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                            dtype=torch.int8)
              for _ in range(copies_for(n * k))]
        s = torch.rand((n,), generator=gen, device="cuda") * 2e-4 + 1e-4
        t = device_ms([lambda w=w: w8.w8a8_matmul(x, w, s, n=n, k=k)
                       for w in ws])
        tq, tg = w8a8_parts_ms(x, ws, s, n, k)
        tp = eager_ms(lambda: w8.w8a8_matmul_plain(x, ws[0], s, n=n, k=k),
                      iters=3)
        xq, _ = w8.quantize_rows_plain(x, torch.int8)
        tl = device_ms([lambda w=w: torch._int_mm(xq, w.t()) for w in ws])
        b = m * k * 2 + n * k + n * 4 + m * n * 2
        bm, by = bound(b, 2 * m * n * k, PEAK_INT8)
        log(f"time w8a8_matmul {lin} M={m} ({label}): {t:.4f} ms = quantize "
            f"pass {tq:.4f} + GEMM {tg:.4f} (each alone), bound {bm:.4f} ms "
            f"({by}), plain {tp:.4f} ms, torch._int_mm on the quantized rows "
            f"{tl:.4f} ms")
        for key, v in (("ms", t), ("plain_ms", tp), ("library_ms", tl),
                       ("quantize_ms", tq), ("gemm_ms", tg)):
            tot[key] += v
        nbytes, ops = nbytes + b, ops + 2 * m * n * k
        del ws
        torch.cuda.empty_cache()
    bm, by = bound(nbytes, ops, PEAK_INT8)
    log(f"w8a8_matmul one {label} layer M={m}: {tot['ms']:.4f} ms (GEMMs "
        f"{tot['gemm_ms']:.4f}), bound {bm:.4f} ms ({by}), torch._int_mm "
        f"{tot['library_ms']:.4f} ms: {tot['ms'] / tot['library_ms']:.3f}x, "
        f"GEMMs alone {tot['gemm_ms'] / tot['library_ms']:.3f}x")
    return dict(bound_ms=bm, bound_by=by, **tot,
                shapes=f"qkv+o+gate_up+down of one {label} layer, M={m}; "
                "library: torch._int_mm on the quantized rows, beside "
                "gemm_ms")


def timings_w8a8_int8():
    """B3 int8 at the linear shapes of phases 12-13: one TinyLlama layer at
    M = 64 and 8192 (greedy decode and the 64 x 128-token prefill), one 8B
    layer at M = 64 and 512 (decode rows and a prefill chunk)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for label, shapes, ms in (("TinyLlama", W4_SHAPES,
                               (BATCH, BATCH * PROMPT)),
                              ("8B", W4_SHAPES_8B, (BATCH, M_CHUNK))):
        for m in ms:
            rows[f"{label} M={m}"] = w8a8_layer_row(gen, shapes, m, label)
    return rows


# --------------------------------------------------------------------- #
# phase 14: MoE, Qwen3-30B-A3B W4A16 (the expert-batched B1e/B2e/B9e)

# Qwen/Qwen3-30B-A3B's published config.json (cited, not fetched): 48
# layers, every one MoE (decoder_sparse_step 1, no mlp_only_layers), 128
# routed experts of width 768, 8 a token, no shared expert
QWEN3_30B_A3B = dict(model_type="qwen3_moe", vocab_size=151936,
                     hidden_size=2048, intermediate_size=6144,
                     num_hidden_layers=48, num_attention_heads=32,
                     num_key_value_heads=4, head_dim=128, rope_theta=1e6,
                     rms_norm_eps=1e-6, max_position_embeddings=40960,
                     tie_word_embeddings=False, num_experts=128,
                     num_experts_per_tok=8, moe_intermediate_size=768,
                     norm_topk_prob=True)
MOE_DEPTHS = (1, 48)
MOE_FEW = (1, 4)                  # the int8 and e8 arms' depths
MOE_BLOCK_LAYERS = (0, 1, 23, 47)  # MoE blocks held on the reference input
# one MoE block (route, three expert linears, combine) against the
# non-kernel path on the same input: the kernel path keeps every weight
# exact in f32 where that path rounds each to bf16 (2^-9), and the two
# round the gate and up outputs to bf16 at other points; 2e-2 of max|ref|
# is several times that, and far below a wrong scale or expert (O(1))
TOL_MOE_BLOCK = 2e-2
# Mixtral-8x7B's experts (E, N = intermediate, K = hidden)
MIXTRAL_EXPERTS = (8, 14336, 4096)
# the MoE call rows: C of one decode step at batch 64 (8), a 512-row
# serving chunk (40), greedy's 64 x 128-token prefill (640), and around
# the decode/prefill designs' edge (1, 64, 65)
MOE_C = (1, 8, 40, 64, 65, 640)


def card_expert_codes(gen, e, n, k, g=128):
    """``card_w4_codes`` for E stacked experts: (E, N, K) codes in [-7, 7]
    and (E, N, K/g) bf16 scales, drawn on the card."""
    import torch

    codes = torch.randint(-7, 8, (e, n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
    scale = torch.rand((e, n, k // g), generator=gen, device="cuda") * 2e-3 \
        + 1e-3
    return codes, scale.to(torch.bfloat16)


def moe_llama(config, seed):
    """A Qwen3-MoE model at full width and depth built on the card from
    ``seed``, as ``w4a16_llama`` draws its symmetric W4A16 g128
    pack-quantized model: the attention linears and every expert with
    codes in [-7, 7] and bf16 group scales in [1e-3, 3e-3], experts stacked
    (E, N, K) with their stacked kernel layouts; the router
    N(0, 0.02^2) in bf16 (as the synthetic models draw it); q/k norm
    weights 1 + N(0, QK_NORM_STD^2); a W8A8-int lm_head. Unfused."""
    import torch

    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W4A16", ["Linear"])
    scheme.format = "pack-quantized"
    H, E = config.hidden_size, config.num_local_experts
    Im = config.moe_intermediate_size

    def linear(n, k):
        codes, scale = card_w4_codes(gen, n, k)
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=pack_to_int32(codes, 4), scale=scale, shape=(n, k),
            scheme=scheme, format=scheme.format))

    def experts(n, k):
        codes, scale = card_expert_codes(gen, E, n, k)
        words = pack_to_int32(codes, 4)
        del codes
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=words, scale=scale, shape=(E, n, k), scheme=scheme,
            format=scheme.format))

    def layer(_):
        shapes = linear_shapes(config)
        out = {name: linear(*shapes[name])
               for name in ("q_proj", "k_proj", "v_proj", "o_proj")}
        for name in ("q_norm", "k_norm"):
            out[name] = (1 + QK_NORM_STD * torch.randn(
                (config.head_dim,), generator=gen, device="cuda")).to(
                    torch.bfloat16)
        out["moe"] = {
            "router": (torch.randn((E, H), generator=gen, device="cuda")
                       * 0.02).to(torch.bfloat16),
            "experts": {"gate_proj": experts(Im, H),
                        "up_proj": experts(Im, H),
                        "down_proj": experts(H, Im)}}
        return out

    return card_llama(config, layer, gen)


def expert_layers(params):
    """Every stacked expert linear of the model."""
    return [qt for layer in params["layers"] if "moe" in layer
            for qt in layer["moe"]["experts"].values()]


@contextlib.contextmanager
def plain_w4_moe():
    """``plain_w4`` with B1e/B2e too: every int4-word W4 matmul, 2-D and
    expert-batched, through its plain version on the card; undone on
    exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kernel = linear.w4a16_experts_matmul
    linear.w4a16_experts_matmul = w4.w4a16_matmul_plain
    try:
        with plain_w4():
            yield
    finally:
        linear.w4a16_experts_matmul = kernel


@contextlib.contextmanager
def plain_e8():
    """Every grouped-int8 matmul (B9 and B9e) through its plain version on
    the card; undone on exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kernels = linear.w4_e8_matmul, linear.w4_e8_experts_matmul
    linear.w4_e8_matmul = linear.w4_e8_experts_matmul = w4.w4_e8_matmul_plain
    try:
        yield
    finally:
        linear.w4_e8_matmul, linear.w4_e8_experts_matmul = kernels


@contextlib.contextmanager
def moe_inputs():
    """Records the input of every MoE block run inside it, in call order."""
    from compressed_tensors_tpu_torch.models import moe as moe_mod

    seen, orig = [], moe_mod.moe_mlp

    def recording(layer, x, config, *a, **kw):
        seen.append(x.detach().clone())
        return orig(layer, x, config, *a, **kw)

    moe_mod.moe_mlp = recording
    try:
        yield seen
    finally:
        moe_mod.moe_mlp = orig


def expert_operands(gen, e, c, n, k, asym, bits=4, g=128):
    """Stacked expert operands drawn on the card: x (E, C, K) bf16, random
    int4 words (E, N, K/8) (or int8 (E, N, K) for bits 8), (E, K/g, N)
    scales in [1e-3, 3e-3] (and zero points in [-8, 7])."""
    import torch

    if bits == 4:
        w = torch.randint(-(2**31), 2**31, (e, n, k // 8), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    else:
        w = torch.randint(-128, 128, (e, n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
    s = torch.rand((e, k // g, n), generator=gen, device="cuda") * 2e-3 \
        + 1e-3
    zp = (torch.randint(-8, 8, (e, k // g, n), generator=gen,
                        device="cuda").float() if asym else None)
    return dev_randn(gen, e, c, k), w, s, zp


def parity_experts(errs):
    """B1e, B2e and B9e against their plain f32 versions by the a8b rule
    (every element within A8B_REL * |y| + A8B_ABS * max|y|), one launch a
    call: Qwen3-30B-A3B's gate/up (E 128, N 768, K 2048) and down (N
    2048, K 768) at every C of ``MOE_C``, with zero points at C = 8 and 640;
    Mixtral-8x7B's experts at C = 24 (B1e, B9e) and 320 (B2e); N not a
    multiple of the column tile (200) with zero points; B2e's quantization
    pass bit for bit."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    gen = torch.Generator(device="cuda").manual_seed(14)
    E, I, H = 128, 768, 2048
    qwen = [(E, c, n, k, False) for n, k in ((I, H), (H, I)) for c in MOE_C]
    qwen += [(E, c, I, H, True) for c in (8, 640)]
    ragged = [(16, c, 200, 768, True) for c in (8, 65)]
    me, mn, mk = MIXTRAL_EXPERTS
    cases = {
        "w4a16_experts_matmul": qwen + ragged + [(me, 24, mn, mk, False)],
        "w4a16_a8b_experts_matmul": [(me, 320, mn, mk, False),
                                     (me, 320, mn, mk, True),
                                     (E, 8, I, H, False), (E, 640, I, H, True),
                                     (E, 640, H, I, False)] + ragged,
        "w4_e8_experts_matmul": [(E, c, n, k, False) for n, k in ((I, H),
                                                                  (H, I))
                                 for c in (1, 8, 40, 65, 640)]
        + [(16, 8, 200, 768, False), (me, 24, mn, mk, False)],
    }
    for name, grid in cases.items():
        worst, seen = 0.0, set()
        for e, c, n, k, asym in grid:
            bits = 8 if name == "w4_e8_experts_matmul" else 4
            x, w, s, zp = expert_operands(gen, e, c, n, k, asym, bits)
            kw = dict(n=n, k=k, group_size=128)
            before = getattr(w4, name).launches
            if name == "w4a16_experts_matmul":
                got = w4.w4a16_experts_matmul(x, w, s, zp, **kw)
                want = w4.w4a16_matmul_plain(x, w, s, zp,
                                             out_dtype=torch.float32, **kw)
                _, splits, _ = w4.int4b_plan(c, n, k, e)
                seen.add((w4.int4b_design(c), splits))
            elif name == "w4a16_a8b_experts_matmul":
                xq = torch.empty((e, c, k), dtype=torch.int8, device="cuda")
                xs = torch.empty((e, c), dtype=torch.float32, device="cuda")
                got = w4.w4a16_a8b_experts_matmul(x, w, s, zp, xq=xq, xs=xs,
                                                  **kw)
                xq_p, xs_p = w4.quantize_rows_a8b_plain(x)
                if not (torch.equal(xq, xq_p) and torch.equal(xs, xs_p)):
                    raise AssertionError(f"{name} E={e} C={c}: the "
                                         "quantization pass differs")
                want = w4.w4a16_matmul_plain(x, w, s, zp, mode="a8b",
                                             out_dtype=torch.float32, **kw)
                seen.add(w4.a8b_plan(c, n, k, e)[0])
            else:
                got = w4.w4_e8_experts_matmul(x, w, s, **kw)
                want = w4.w4_e8_matmul_plain(x, w, s, out_dtype=torch.float32,
                                             **kw)
                _, splits, _ = w4.wna16_plan(c, n, k, e)
                seen.add((w4.wna16_design(c), splits))
            if getattr(w4, name).launches != before + 1:
                raise AssertionError(f"{name}: not one launch a call")
            got = got.float()
            if not bool(got.isfinite().all()):
                raise AssertionError(f"{name} E={e} C={c}: non-finite")
            scale = want.abs().max().item()
            diff = (got - want).abs()
            bad = int((diff > A8B_REL * want.abs() + A8B_ABS * scale).sum())
            if bad:
                raise AssertionError(
                    f"{name} E={e} C={c} N={n} K={k} zero points {asym}: "
                    f"{bad} elements outside the a8b rule")
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
            worst = max(worst, diff.max().item() / scale)
            del x, w, s, zp, got, want
        torch.cuda.empty_cache()
        log(f"parity {name} over {len(grid)} cases (E, C, N, K, zero "
            f"points) {grid}: 0 elements outside the a8b rule, max error "
            f"{worst:.4g} of max|plain|; plans reached "
            f"{sorted(seen, key=str)}")


def kept_experts(h, router, config):
    """The last token's (expert, kept) pairs when the rows ``h`` (T, H) are
    routed and dispatched as ``moe_mlp`` does, and its gap between the
    k-th and (k+1)-th router probability."""
    import torch

    from compressed_tensors_tpu_torch.models import moe as moe_mod

    T = h.shape[0]
    E, k = config.num_local_experts, config.num_experts_per_tok
    _, top_i = moe_mod._route(h, router, config)
    C = moe_mod.moe_capacity(T, E, k)
    sort_idx, rows = moe_mod.dispatch_rows(top_i, E, C)
    slot_rows = torch.empty_like(rows)
    slot_rows[sort_idx] = rows
    kept = (slot_rows < E * C).reshape(T, k)[-1].tolist()
    probs = torch.softmax(h[-1:].float() @ router.float().t(), dim=-1)[0]
    top = probs.topk(k + 1).values
    return (set(zip(top_i[-1].tolist(), kept)),
            (top[k - 1] - top[k]).item())


def routing_flips(params, config, requests, moe_layer=0,
                  label="Qwen3-30B-A3B"):
    """At one MoE layer (the first, ``moe_layer``, and the layers before
    it), each request's first-token logits on the kernel path (every W4
    linear at bf16 activations) against the non-kernel path, with the last
    token's routing read on both: a request whose last token takes other
    experts, or keeps other slots, is a routing flip (an f32 ulp at a
    router near-tie; through one MoE layer only the last token's own MoE
    output reaches its logits). Prints each flip's gap between the k-th
    and (k+1)-th router probability, holds the rest to TOL_WNA16_DEPTH1 of
    max|ref| and returns the flipped request ids. Behind a leading dense
    layer (``moe_layer`` > 0) that is no longer one layer, and the rest
    are held to the depth rule of ``logits_rule_failures`` instead: within
    TOL_E2E_8B of max|ref|, or the relative RMS error within FLOOR_RATIO
    times the request's own spread (the non-kernel path with one bf16 ulp
    up on 64 embedding values of one prompt token)."""
    router = params["layers"][moe_layer]["moe"]["router"]
    depth = moe_layer + 1
    emb = params["embed_tokens"]
    flips, worst, outside = {}, (0.0, None), []
    for rid, ids, _ in requests:
        with moe_inputs() as seen:
            got = first_token_logits(params, config, ids, depth, True, "moe")
            ref = first_token_logits(params, config, ids, depth, False, "moe")
        (mine, _), (theirs, gap) = (kept_experts(seen[i][0], router, config)
                                    for i in (0, 1))
        if mine != theirs:
            flips[rid] = gap
            continue
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, (err, rid), key=lambda t: t[0])
        if moe_layer and err > TOL_E2E_8B:
            tok = ids[len(ids) // 3]
            row = emb[tok].clone()
            emb[tok, :64] = (row[:64].float() * (1 + 2**-7)).to(emb.dtype)
            moved = first_token_logits(params, config, ids, depth, False,
                                       "moe")
            emb[tok] = row
            ratio = rel_rms(got, ref) / max(rel_rms(moved, ref), 1e-30)
            if ratio > FLOOR_RATIO:
                outside.append((rid, err, ratio))
    log(f"{label} routing at one MoE layer (depth {depth}) over "
        f"{len(requests)} requests: "
        f"{len(flips)} routing flips (the last token's experts or kept slots "
        "differ between the kernel and non-kernel paths), each with its "
        "gap between the k-th and (k+1)-th router probability: "
        + (", ".join(f"request {r}: {g:.3g}" for r, g in flips.items())
           or "none")
        + f"; the others' first-token logits within {worst[0]:.4g} of "
        f"max|ref| (request {worst[1]}; limit "
        + (f"{TOL_WNA16_DEPTH1})" if not moe_layer else
           f"{TOL_E2E_8B} or {FLOOR_RATIO}x the spread: outside "
           f"{outside})"))
    failed = outside if moe_layer else worst[0] > TOL_WNA16_DEPTH1
    if failed:
        raise AssertionError(f"{label} one-MoE-layer logits without a "
                             "routing flip disagree with the non-kernel "
                             "path")
    return set(flips)


def moe_block_checks(params, config, ids):
    """Each MoE block of ``MOE_BLOCK_LAYERS`` on its input from the
    non-kernel reference run of the prompt ``ids`` (the routing then the
    same on every path, the same router code on the same input): the
    kernel path against the kernels' plain versions within TOL_KERNEL of
    max|plain|, and against the non-kernel path within TOL_MOE_BLOCK;
    the expert group scales rolled by one group must fail the latter."""
    import torch

    from compressed_tensors_tpu_torch.models.moe import moe_mlp

    with moe_inputs() as seen:
        first_token_logits(params, config, ids,
                           config.num_hidden_layers, False, "moe")
    for i in MOE_BLOCK_LAYERS:
        layer, h = params["layers"][i], seen[i]
        got = moe_mlp(layer, h, config)
        with plain_w4_moe():
            plain = moe_mlp(layer, h, config)
        ref = moe_mlp(layer, h, config, use_kernels=False)
        check_close(f"Qwen3-30B-A3B MoE block {i} ({h.shape[1]} tokens), "
                    "kernel vs plain", got, plain)
        err = check_close(f"Qwen3-30B-A3B MoE block {i}, kernel vs "
                          "non-kernel path", got, ref, TOL_MOE_BLOCK)
        scales = [qt.kernel_scales for qt in layer["moe"]["experts"].values()]
        for s in scales:
            s.copy_(s.roll(1, 1))
        bad = moe_mlp(layer, h, config)
        for s in scales:
            s.copy_(s.roll(-1, 1))
        miss = (bad.float() - ref.float()).abs().max().item() / \
            ref.float().abs().max().item()
        log(f"Qwen3-30B-A3B MoE block {i} control, expert group scales "
            f"rolled by one group: {miss:.4g} of max|ref| (limit "
            f"{TOL_MOE_BLOCK}; {err / ref.float().abs().max().item():.4g} "
            "unrolled)")
        if miss <= TOL_MOE_BLOCK:
            raise AssertionError(f"MoE block {i}: the check accepted rolled "
                                 "expert group scales")
    del seen
    torch.cuda.empty_cache()


def moe_reprepared(params, layers, w4_layout):
    """The first ``layers`` layers with every decoder linear's and expert
    stack's kernel layout rebuilt under ``w4_layout``."""
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_experts_for_kernels,
    )

    def bare(qt):
        return dataclasses.replace(qt, kernel_packed=None, kernel_scales=None,
                                   kernel_zp=None, kernel_perm=None,
                                   kernel_meta=None)

    out = reprepared(dict(params, layers=params["layers"][:layers]),
                     w4_layout)
    for layer in out["layers"]:
        layer["moe"] = dict(layer["moe"], experts={
            name: prepare_experts_for_kernels(bare(qt), w4_layout)
            for name, qt in layer["moe"]["experts"].items()})
        if any(not isinstance(qt, QuantizedTensor) or qt.kernel_meta is None
               for qt in layer["moe"]["experts"].values()):
            raise AssertionError(f"experts without a {w4_layout} layout")
    return out


def moe_checkpoint_round_trip(raw, config):
    """The first 2 layers of the unfused model written by
    ``save_llama_checkpoint`` (one linear per expert, Qwen naming) and
    read back by ``load_llama_params``: greedy tokens at batch 64 equal
    to the in-memory model's."""
    import torch

    from compressed_tensors_tpu_torch.engine import greedy_generate
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    cfg = dataclasses.replace(config, num_hidden_layers=2)
    two = dict(raw, layers=raw["layers"][:2])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        save_llama_checkpoint(two, cfg, tmp)
        size = os.path.getsize(os.path.join(tmp, "model.safetensors"))
        loaded, lcfg, _ = load_llama_params(tmp, device="cuda")
    log(f"Qwen3-30B-A3B 2-layer checkpoint: {size / 2**20:.0f} MiB, written "
        f"and loaded in {time.perf_counter() - t0:.1f} s (config: "
        f"{lcfg.num_local_experts} experts, top {lcfg.num_experts_per_tok}, "
        f"q/k norms {lcfg.qk_norm})")
    if lcfg != cfg:
        raise AssertionError(f"the checkpoint's config reads back as {lcfg}")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, VOCAB8, size=(BATCH, PROMPT)))
    outs = [greedy_generate(fuse_llama_layers(p), cfg, ids, max_new_tokens=16)
            for p in (two, loaded)]
    same = bool(torch.equal(*outs))
    log(f"Qwen3-30B-A3B 2-layer checkpoint vs the model in memory: greedy "
        f"tokens {'identical' if same else 'DIFFERENT'} at batch {BATCH}")
    if not same:
        raise AssertionError("the MoE checkpoint's greedy tokens differ from "
                             "the model it was written from")


def phase_moe(errs):
    """Phase 14: MoE. B1e/B2e/B9e against their plain versions
    (``parity_experts``); Qwen3-30B-A3B W4A16 g128 at full width and depth
    built on the card (``moe_llama``), fused: the MoE blocks on the
    reference run's inputs (``moe_block_checks``), the routing flips at one
    layer over the 96 prompts (``routing_flips``), first-token logits by
    depth (1 and 48 layers) at bf16 activations against the non-kernel
    path with the rolled-scales control (experts included), the model
    under w4_act="int8" (B2/B2e) and its first layers under
    w4_layout="e8" (B9/B9e) against their plain versions; the 96 requests
    dense and paged (identical), 96 B1 + 144 B1e launches a decode step
    and no other W4 launch, ``greedy_generate`` at batch 64; the 2-layer
    checkpoint round trip."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    parity_experts(errs)
    config = LlamaConfig.from_dict(QWEN3_30B_A3B)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    raw = moe_llama(config, seed=0)
    params = fuse_llama_layers(raw)
    torch.cuda.synchronize()
    kinds = {qt.kernel_meta[0] for qt in expert_layers(params)}
    if kinds != {"w4a16"} or "qkv_proj" not in params["layers"][0]:
        raise AssertionError(f"Qwen3-30B-A3B: experts prepared as {kinds}")
    log(f"Qwen3-30B-A3B W4A16 model (built on the card from seed 0, "
        f"{config.num_hidden_layers} layers of {config.num_local_experts} "
        f"experts, fused attention, W8A8-int lm_head): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    with flag_overrides(w4_act="bf16"):
        flips = routing_flips(params, config, requests)
        steady = [r for r in requests if r[0] not in flips]
        moe_block_checks(params, config, probe_request(steady)[1])
        check_logits_by_depth(params, config, steady, "Qwen3-30B-A3B bf16",
                              depths=MOE_DEPTHS)
    # int8 activations (B2 and B2e at every W4 linear) and the grouped-int8
    # layout (B9 and B9e) are no part of the non-kernel path: each is held
    # by the logits rule against the same model with those kernels through
    # their plain versions; their launches count as runs of their own
    results = {}
    for label, layout, act, plain, kernel in (
            ("int8", None, "int8", plain_w4_moe, "w4a16_a8b_experts_matmul"),
            ("e8", "e8", "auto", plain_e8, "w4_e8_experts_matmul")):
        model = (params if layout is None else
                 moe_reprepared(params, max(MOE_FEW), layout))
        reset_counts()
        with flag_overrides(w4_act=act):
            sweep, _ = logits_by_depth(model, config, steady,
                                       f"Qwen3-30B-A3B {label}",
                                       depths=MOE_FEW, plain=plain)
        counts = read_counts()
        results[f"moe {label} logits"] = {"counts": counts}
        launched = counts[kernel]
        failures = logits_rule_failures(sweep)
        log(f"Qwen3-30B-A3B {label}: {kernel} launched {launched} times")
        if failures or not launched:
            raise AssertionError(f"Qwen3-30B-A3B {label} against its plain "
                                 f"path: {'; '.join(failures)} ({kernel} "
                                 f"launched {launched} times)")
        del model
        torch.cuda.empty_cache()
    results["moe dense"] = serve_requests(params, config, requests,
                                          "moe dense")
    results["moe paged"] = serve_requests(params, config, requests,
                                          "moe paged", paged=True,
                                          prefix_caching=False)
    same = sum(results["moe dense"]["outs"][i] == results["moe paged"][
        "outs"][i] for i in range(N_REQUESTS))
    log(f"Qwen3-30B-A3B serving: paged = dense in {same} of {N_REQUESTS} "
        "completions")
    if same != N_REQUESTS:
        raise AssertionError("Qwen3-30B-A3B paged completions differ from "
                             "dense")
    L = config.num_hidden_layers
    step = {"w4a16_matmul": 2 * L, "w4a16_experts_matmul": 3 * L,
            "w8a8_matmul": 1}
    for run in ("moe dense", "moe paged"):
        got = {k: v for k, v in results[run]["per_step"].items()
               if v and k.startswith(("w4", "w8a8"))}
        log(f"{run}: W4/W8A8 launches a decode step {got} (expected {step})")
        if got != step:
            raise AssertionError(f"{run}: a decode step launched {got}")
    results["moe greedy_generate"] = greedy_8b(params, config, "Qwen3-30B-A3B")
    del params
    torch.cuda.empty_cache()
    moe_checkpoint_round_trip(raw, config)
    del raw
    torch.cuda.empty_cache()
    base = ("w4a16_matmul", "w4a16_experts_matmul", "w8a8_matmul",
            "prefill_attention")
    check_launched(results, {
        "moe dense": base + ("flash_decode_attention",),
        "moe paged": base + ("paged_decode_attention",),
        "moe greedy_generate": base + ("decode_attention",)})
    return results


def experts_row(gen, name, e, c, n, k, label, g=128):
    """Device ms of one expert-batched launch (operands in copies larger
    than L2; groups of ``g``), bound, plain ms and ``torch.matmul`` on the
    (E, C, K) rows and the dequantized bf16 (E, K, N) weights."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    bits = 8 if name == "w4_e8_experts_matmul" else 4
    x, w, s, _ = expert_operands(gen, e, c, n, k, False, bits, g)
    kw = dict(n=n, k=k, group_size=g)
    fn = getattr(w4, name)
    wbytes = e * n * k * bits // 8
    ws = [(w.clone(), s.clone()) for _ in range(copies_for(wbytes))]
    t = device_ms([lambda w=w, s=s: fn(x, w, s, **kw) if bits == 8
                   else fn(x, w, s, None, **kw) for w, s in ws])
    plain = (w4.w4_e8_matmul_plain if bits == 8 else
             functools.partial(w4.w4a16_matmul_plain,
                               mode="a8b" if "a8b" in name else "int4b"))
    tp = eager_ms(lambda: plain(x, w, s, **kw) if bits == 8
                  else plain(x, w, s, None, **kw), iters=3)
    del ws
    wd = (w.float() * w4._group_scales(s, g) if bits == 8 else
          w4._dequantized_weight(w, s, None, n, k, g)).to(
              torch.bfloat16).transpose(1, 2)
    wds = [wd.clone() for _ in range(copies_for(wd.numel() * 2))]
    tl = device_ms([lambda wd=wd: torch.matmul(x, wd) for wd in wds])
    del wds, wd
    b = e * (c * k * 2 + c * n * 2 + (k // g) * n * 4) + wbytes
    bm, by = bound(b, 2 * e * c * n * k,
                   PEAK_INT8 if "a8b" in name else PEAK_BF16)
    log(f"time {name} {label} (E={e}, C={c}, N={n}, K={k}): {t:.4f} ms, "
        f"bound {bm:.4f} ms ({by}), plain {tp:.4f} ms, torch.matmul on the "
        f"dequantized bf16 weights {tl:.4f} ms ({t / tl:.3f}x)")
    del x, w, s
    torch.cuda.empty_cache()
    return dict(ms=t, plain_ms=tp, bound_ms=bm, bound_by=by, library_ms=tl,
                shapes=f"{label}: E={e}, C={c}, N={n}, K={k}, g{g}; library: "
                "torch.matmul on the (E, C, K) rows and the dequantized bf16 "
                "(E, K, N) weights")


def timings_moe():
    """B1e at Qwen3-30B-A3B's gate (C = 8, 40, 640) and down (C = 8), B2e
    at Mixtral-8x7B's experts (C = 320), B9e at the Qwen gate (C = 8)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(15)
    E, I, H = 128, 768, 2048
    rows = {"w4a16_experts_matmul": {}, "w4a16_a8b_experts_matmul": {},
            "w4_e8_experts_matmul": {}}
    for c in (8, 40, 640):
        rows["w4a16_experts_matmul"][f"gate C={c}"] = experts_row(
            gen, "w4a16_experts_matmul", E, c, I, H, "Qwen3-30B-A3B gate")
    rows["w4a16_experts_matmul"]["down C=8"] = experts_row(
        gen, "w4a16_experts_matmul", E, 8, H, I, "Qwen3-30B-A3B down")
    rows["w4a16_a8b_experts_matmul"]["Mixtral C=320"] = experts_row(
        gen, "w4a16_a8b_experts_matmul", *MIXTRAL_EXPERTS[:1], 320,
        *MIXTRAL_EXPERTS[1:], "Mixtral-8x7B experts")
    rows["w4_e8_experts_matmul"]["gate C=8"] = experts_row(
        gen, "w4_e8_experts_matmul", E, 8, I, H, "Qwen3-30B-A3B gate")
    return rows


# --------------------------------------------------------------------- #
# phase 15: MLA, DeepSeek-V2-Lite W4A16 (the latent-head B5-L/B7-L)

# deepseek-ai/DeepSeek-V2-Lite's published config.json (cited, not
# fetched): 27 layers of MLA with 16 heads (kv_lora_rank 512, nope 128,
# rope 64, v 128, a dense q_proj), layer 0 a dense MLP of 10944
# (first_k_dense_replace 1), the others 64 routed experts of width 1408, 6
# a token without renormalisation (norm_topk_prob false; n_group =
# topk_group = 1) and 2 shared experts (shared_experts.* of width 2816)
V2_LITE = dict(model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
               intermediate_size=10944, num_hidden_layers=27,
               num_attention_heads=16, num_key_value_heads=16,
               q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128, rope_theta=10000.0,
               rms_norm_eps=1e-6, max_position_embeddings=163840,
               tie_word_embeddings=False, n_routed_experts=64,
               num_experts_per_tok=6, moe_intermediate_size=1408,
               first_k_dense_replace=1, norm_topk_prob=False)
# W4A16 groups of 64: 10944 = 85.5 x 128, so a group of 128 leaves layer
# 0's down_proj without a kernel layout; 64 divides every K of the model
MLA_GROUP = 64
# group scales of the projections that form the attention scores (q_proj,
# kv_a_proj_with_mqa, kv_b_proj): this factor times the [1e-3, 3e-3] of
# the other linears, about what a trained model's W4 groups of 64 hold
# (absmax / 7 of N(0, 0.02^2) weights). At 1x the scores' RMS after the
# 1/sqrt(192) scale is about 0.1: the softmax is nearly uniform, and no
# logits check sees the softmax (a CPU rehearsal at small width moved the
# decode-step logits 0.7% of max|ref| under a softmax scale of
# 1/sqrt(576)). At 5x the score RMS is about 3, a peaked softmax.
MLA_QK_SCALE = 5.0
MLA_DEPTHS = (1, 27)
MLA_FEW = (1, 4)           # the fp8 latent cache arm's depths
MLA_STEPS = 4              # decode steps whose logits are held
# B5-L/B7-L grids: (K, V) widths of V2-Lite and a narrow pair, S_pad of
# greedy_generate's cache and of the serving engine's
LATENT_WIDTHS = ((576, 512), (128, 64))
LATENT_SPADS = (192, 1024)
# query heads: one head, 16 and 20 (one head block of the kernels, rows
# padded to 64) and DeepSeek-V2's 128 (two head blocks)
LATENT_REPS = (1, 16, 20, 128)
# B1e at V2-Lite's experts, group 64: (E, C, N, K) at a decode step's C
# (batch 64, 6 of 64 experts: 8), a 512-row serving chunk's (64) and
# greedy's 64 x 128-token prefill (960)
V2_EXPERT_CASES = [(64, c, n, k) for n, k in ((1408, 2048), (2048, 1408))
                   for c in (8, 64, 960)]


def parity_latent(errs):
    """B5-L and B7-L against their plain versions on every cache type, at
    the (K, V) widths of ``LATENT_WIDTHS``, the query heads of
    ``LATENT_REPS``, S_pad of ``LATENT_SPADS``; lengths 0, 1, 15-17 and
    63-65 (each side of a 16-position tile), S_pad - 1 and an inactive
    row; on the slab and through shuffled page tables. Every element
    within the a8b rule of the plain version's f32 result in the kernels'
    order plus that version's bound on the probabilities' bf16 roundings
    (``LATENT_FLIP_REL``: a probability near a rounding midpoint may round
    the other way on the kernel's f32 scores), at the schedule's default
    ranges (``latent_ranges``: about a segment a tile here) and at 2
    ranges (segments of many tiles, one row cut and merged); above 16
    heads the output also equal bit for bit to the kernel's launches on
    each group of 16 heads alone over the same ranges; the outputs within
    TOL_KERNEL of the one-softmax plain version; inactive rows zero; cache
    bytes equal to the plain version's and changed at the step's
    positions only. Then B1e at V2-Lite's expert shapes in groups of 64
    by the a8b rule (one launch a call)."""
    import itertools

    import torch

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        paged_decode as pd,
        w4a16_matmul as w4,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    gen = torch.Generator(device="cuda").manual_seed(16)
    rng = np.random.default_rng(16)
    page, worst, cases, flipped = 64, 0.0, 0, 0
    dtypes = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
              "int8": torch.int8}
    for cache, (dk, dv), rep, s_pad in itertools.product(
            dtypes, LATENT_WIDTHS, LATENT_REPS, LATENT_SPADS):
        dtype = dtypes[cache]
        lens = sorted({n for n in (0, 1, 15, 16, 17, 63, 64, 65, s_pad - 1)
                       if n < s_pad}) + [-1]
        B, P = len(lens), s_pad // page
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        active = lengths >= 0
        sc = CACHE_SCALES.get(cache)
        ks = vs = (None if sc is None
                   else torch.tensor([sc], device="cuda"))
        kw = dict(layer=1, k_scale=ks, v_scale=vs, true_d=dk // 3)

        def make(shape):
            return (dev_randn(gen, *shape) if sc is None
                    else dev_cache(gen, shape, dtype, sc))

        q = dev_randn(gen, B, rep, dk)
        nk, nv = dev_randn(gen, B, 1, dk), dev_randn(gen, B, 1, dv)
        tables = rng.permutation(np.arange(1, B * P + 1)).astype(
            np.int32).reshape(B, P)
        tables[~active.cpu().numpy()] = 0
        tables_d = torch.from_numpy(tables).cuda()
        args = (kw["layer"], ks, vs, kw["true_d"])
        ranges = da.latent_ranges(rep, "cuda")
        for name, shapes, kernel, plain, at in (
                ("decode_attention_latent",
                 ((2, B, 1, s_pad, dk), (2, B, 1, s_pad, dv)),
                 lambda k, v, q=q, r=ranges: da._latent_decode(
                     q, nk, nv, k, v, lengths, *args, ranges=r),
                 lambda k, v, **o: da.latent_decode_attention_plain(
                     q, nk, nv, k, v, lengths, **kw, **o),
                 lambda b: (b, lens[b])),
                ("paged_decode_attention_latent",
                 ((2, B * P + 1, 1, page, dk),
                  (2, B * P + 1, 1, page, dv)),
                 lambda k, v, q=q, r=ranges: pd._latent_paged_decode(
                     q, nk, nv, k, v, tables_d, lengths, *args, ranges=r),
                 lambda k, v, **o: pd.paged_decode_attention_plain(
                     q, nk, nv, k, v, tables_d, lengths, **kw, **o),
                 lambda b: (int(tables[b, lens[b] // page]),
                            lens[b] % page))):
            ck, cv = make(shapes[0]), make(shapes[1])
            ck0, cv0 = ck.clone(), cv.clone()
            before = getattr(*_counter(name))
            got = kernel(ck, cv)[0]
            if getattr(*_counter(name)) != before + 1:
                raise AssertionError(f"{name}: not one launch a call")
            got = got.float()
            ordered, flip = plain(ck0.clone(), cv0.clone(),
                                  kernel_order=True, out_dtype=torch.float32,
                                  flip_rel=da.LATENT_FLIP_REL)[0]
            ck_p, cv_p = ck0.clone(), cv0.clone()
            want = plain(ck_p, cv_p)[0].float()
            label = (f"{name} K={dk} V={dv} rep={rep} {cache} "
                     f"S_pad={s_pad}")
            if not bool(got.isfinite().all()):
                raise AssertionError(f"{label}: non-finite output")
            diff = (got[active] - ordered[active]).abs()
            rule = (A8B_REL * ordered[active].abs()
                    + A8B_ABS * ordered[active].abs().max())
            bad = int((diff > rule + flip[active]).sum())
            flipped += int((diff > rule).sum())
            rel = ((got[active] - want[active]).abs().max()
                   / want[active].abs().max()).item()
            if rep > 16:
                groups = torch.cat([
                    kernel(ck0.clone(), cv0.clone(),
                           q=q[:, h0:h0 + 16].contiguous())[0]
                    for h0 in range(0, rep, 16)], dim=1)
                if not torch.equal(got, groups.float()):
                    raise AssertionError(f"{label}: differs from the "
                                         "kernel on each group of 16 "
                                         "heads")
            # 2 ranges: long segments, a row cut between them and merged
            got2 = kernel(ck0.clone(), cv0.clone(), r=2)[0].float()
            ordered2, flip2 = plain(ck0.clone(), cv0.clone(),
                                    kernel_order=True, ranges=2,
                                    out_dtype=torch.float32,
                                    flip_rel=da.LATENT_FLIP_REL)[0]
            diff2 = (got2[active] - ordered2[active]).abs()
            bad += int((diff2 > A8B_REL * ordered2[active].abs()
                        + A8B_ABS * ordered2[active].abs().max()
                        + flip2[active]).sum())
            if bad or rel > TOL_KERNEL:
                raise AssertionError(f"{label}: {bad} elements outside "
                                     "the a8b rule with its probability "
                                     f"roundings, {rel} of max|plain|")
            if got[~active].any():
                raise AssertionError(f"{label}: inactive rows must be "
                                     "zero")
            if not (torch.equal(byte_view(ck), byte_view(ck_p))
                    and torch.equal(byte_view(cv), byte_view(cv_p))):
                raise AssertionError(f"{label}: cache bytes differ from "
                                     "plain")
            expect = [(1, *at(b)[:1], 0, at(b)[1]) for b in range(B)
                      if lens[b] >= 0]
            check_written(label, ck, ck0, expect)
            check_written(label, cv, cv0, expect)
            key = name
            errs[key] = max(errs.get(key, 0.0), (
                got[active] - want[active]).abs().max().item())
            worst, cases = max(worst, rel), cases + 1
            del ck, cv, ck0, cv0, ck_p, cv_p
        torch.cuda.empty_cache()
    log(f"parity B5-L/B7-L over {cases} cases (cache bf16/fp8/int8, (K, V) "
        f"{LATENT_WIDTHS}, rep {LATENT_REPS}, S_pad {LATENT_SPADS}, lengths "
        "0, 1, 15-17, 63-65, S_pad - 1, one inactive; slab and shuffled "
        "pages): every element within the a8b rule plus the plain "
        "version's bound on its probabilities' bf16 roundings (flip_rel "
        f"{da.LATENT_FLIP_REL}) against the kernels' order at the default "
        f"ranges and at 2, {flipped} of them outside the a8b rule alone "
        "(default ranges); above 16 heads every output equal bit for bit "
        "to the kernel on each group of 16 heads over the same ranges; max "
        f"error {worst:.4g} of max|plain| against one softmax "
        f"(limit {TOL_KERNEL}); cache bytes equal, written at the step's "
        "positions only")

    worst = 0.0
    for e, c, n, k in V2_EXPERT_CASES:
        x, w, s, _ = expert_operands(gen, e, c, n, k, False, g=MLA_GROUP)
        kw = dict(n=n, k=k, group_size=MLA_GROUP)
        before = w4.w4a16_experts_matmul.launches
        got = w4.w4a16_experts_matmul(x, w, s, None, **kw).float()
        if w4.w4a16_experts_matmul.launches != before + 1:
            raise AssertionError("w4a16_experts_matmul: not one launch a call")
        want = w4.w4a16_matmul_plain(x, w, s, None, out_dtype=torch.float32,
                                     **kw)
        diff = (got - want).abs()
        bad = int((diff > A8B_REL * want.abs()
                   + A8B_ABS * want.abs().max()).sum())
        if bad or not bool(got.isfinite().all()):
            raise AssertionError(f"w4a16_experts_matmul g{MLA_GROUP} E={e} "
                                 f"C={c} N={n} K={k}: {bad} elements outside "
                                 "the a8b rule")
        errs["w4a16_experts_matmul"] = max(
            errs.get("w4a16_experts_matmul", 0.0), diff.max().item())
        worst = max(worst, diff.max().item() / want.abs().max().item())
        del x, w, s, got, want
    torch.cuda.empty_cache()
    log(f"parity w4a16_experts_matmul at group {MLA_GROUP} over "
        f"{V2_EXPERT_CASES} (E, C, N, K): 0 elements outside the a8b rule, "
        f"max error {worst:.4g} of max|plain|")


def mla_llama(config, seed):
    """A DeepSeek-V2 model (V2-Lite, or V2 at the depth of ``config``)
    built on the card from ``seed``, as ``moe_llama`` draws its MoE model:
    symmetric W4A16 g64 pack-quantized linears with codes in [-7, 7] and
    bf16 group scales in [1e-3, 3e-3] (those of q_proj, or q_b_proj where
    the config has a q_lora_rank, kv_a_proj_with_mqa and kv_b_proj times
    ``MLA_QK_SCALE``; the MLA projections (q_a_proj, q_a_layernorm and
    q_b_proj for a q_lora_rank), layer 0's dense MLP, the 2 shared experts
    (n_shared_experts in both published configs) and the stacked (E, N, K)
    routed experts, each with its kernel
    layout but kv_b_proj, kept in checkpoint layout and dequantized once
    into ``w_kb``/``w_vb`` as the loader does), the interleaved-rope rows
    already in the engine's half layout, the router N(0, 0.02^2) in bf16,
    every norm at one, a W8A8-int lm_head. Unfused."""
    import torch

    from compressed_tensors_tpu_torch.models.mla import kv_b_weights
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W4A16", ["Linear"])
    scheme = scheme.model_copy(update={
        "format": "pack-quantized",
        "weights": scheme.weights.model_copy(
            update={"group_size": MLA_GROUP})})
    H, E, h = config.hidden_size, config.num_local_experts, \
        config.num_attention_heads
    r, rope = config.kv_lora_rank, config.qk_rope_head_dim
    nope, vd = config.qk_nope_head_dim, config.v_head_dim

    def linear(n, k, kernels=True, scale_by=1.0):
        codes, scale = card_w4_codes(gen, n, k, MLA_GROUP)
        if scale_by != 1.0:
            scale = (scale.float() * scale_by).to(torch.bfloat16)
        qt = QuantizedTensor(weight_packed=pack_to_int32(codes, 4),
                             scale=scale, shape=(n, k), scheme=scheme,
                             format=scheme.format)
        return prepare_for_kernels(qt) if kernels else qt

    def experts(n, k):
        codes, scale = card_expert_codes(gen, E, n, k, MLA_GROUP)
        words = pack_to_int32(codes, 4)
        del codes
        return prepare_for_kernels(QuantizedTensor(
            weight_packed=words, scale=scale, shape=(E, n, k), scheme=scheme,
            format=scheme.format))

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device="cuda")

    def mlp(width):
        return {"gate_proj": linear(width, H), "up_proj": linear(width, H),
                "down_proj": linear(H, width)}

    def layer(i):
        qk, qa = MLA_QK_SCALE, config.q_lora_rank
        if qa:
            out = {"q_a_proj": linear(qa, H), "q_a_layernorm": ones(qa),
                   "q_b_proj": linear(h * (nope + rope), qa, scale_by=qk)}
        else:
            out = {"q_proj": linear(h * (nope + rope), H, scale_by=qk)}
        out.update({"kv_a_proj_with_mqa": linear(r + rope, H, scale_by=qk),
                    "kv_a_layernorm": ones(r),
                    "kv_b_proj": linear(h * (nope + vd), r, kernels=False,
                                        scale_by=qk),
                    "o_proj": linear(H, h * vd)})
        out["w_kb"], out["w_vb"] = kv_b_weights(out, config, torch.bfloat16)
        if config.layer_is_moe(i):
            Im = config.moe_intermediate_size
            out["moe"] = {
                "router": (torch.randn((E, H), generator=gen, device="cuda")
                           * 0.02).to(torch.bfloat16),
                "experts": {"gate_proj": experts(Im, H),
                            "up_proj": experts(Im, H),
                            "down_proj": experts(H, Im)},
                "shared_expert": mlp(2 * Im)}
        else:
            out.update(mlp(config.intermediate_size))
        return out

    return card_llama(config, layer, gen)


def mla_step_logits(params, config, ids, steps, depth, use_kernels, label,
                    cache_dtype=None, check=True):
    """f32 logits (len(steps), V) of decode steps through the first
    ``depth`` layers (full width): the prompt ``ids`` prefilled (the
    non-absorbed form on either path), then the tokens ``steps`` fed one a
    step (the absorbed decode through B5-L on the kernel path); with
    ``check`` (off for a planted fault's runs) the latent cache checked
    for NaN."""
    return ptq_logits(params, config, ids, depth, use_kernels, steps,
                      cache_dtype=cache_dtype, check=check, label=label)[1:]


def mla_logits_by_depth(params, config, ids, steps, label, depths,
                        cache_dtype=None, plain=None, faults=()):
    """``logits_by_depth`` on the decode steps' logits (``mla_step_logits``)
    in place of the first token's: per depth (relative RMS error kernel vs
    reference, the non-kernel path's spread under one bf16 ulp up on 64
    embedding values of one prompt token, max|kernel - reference| /
    max|reference|). The reference is the non-kernel path, or with
    ``plain`` the kernel path inside that context manager. ``faults``:
    (name, context manager factory) pairs, each planted fault's sweep of
    the kernel path against the same references (a non-finite reading
    counts as infinite). Returns (sweep, {name: sweep})."""
    emb, tok = params["embed_tokens"], ids[len(ids) // 3]
    row = emb[tok].clone()
    ref_name = "non-kernel path" if plain is None else "plain path"

    def run(depth, use_kernels, check=True):
        return mla_step_logits(params, config, ids, steps, depth, use_kernels,
                               label, cache_dtype, check)

    def finite(x):
        return x if np.isfinite(x) else float("inf")

    sweep, refs = {}, {}
    for depth in depths:
        got, nk = run(depth, True), run(depth, False)
        if plain is None:
            ref = nk
        else:
            with plain():
                ref = run(depth, True)
        refs[depth] = ref
        emb[tok, :64] = (row[:64].float() * (1 + 2**-7)).to(emb.dtype)
        moved = run(depth, False)
        emb[tok] = row
        top = ref.abs().max().item()
        sweep[depth] = (rel_rms(got, ref), rel_rms(moved, nk),
                        (got - ref).abs().max().item() / top)
        log(f"{label} decode-step logits ({len(steps)} steps after a "
            f"{len(ids)}-token prompt), {depth} of {config.num_hidden_layers}"
            f" layers: kernel vs {ref_name} rel_rms={sweep[depth][0]:.4g} "
            f"(max {sweep[depth][2]:.4g} of max|ref| {top:.4g}); non-kernel "
            f"path under the perturbation rel_rms={sweep[depth][1]:.4g}; "
            f"argmax kernel {got.argmax(-1).tolist()} reference "
            f"{ref.argmax(-1).tolist()}")
    faulty = {}
    for name, fault in faults:
        faulty[name] = {}
        with fault():
            for depth, ref in refs.items():
                bad = run(depth, True, check=False)
                faulty[name][depth] = (
                    finite(rel_rms(bad, ref)), sweep[depth][1],
                    finite((bad - ref).abs().max().item()
                           / ref.abs().max().item()))
    return sweep, faulty


@contextlib.contextmanager
def latent_scale_of_dk():
    """A planted kernel fault: the latent decode kernels run with the
    softmax scale 1/sqrt(Dk) of the latent K width (576) in place of
    1/sqrt(qk_nope + qk_rope) (192); undone on exit."""
    from compressed_tensors_tpu_torch.models import mla

    kernels = mla.decode_attention, mla.paged_decode_attention

    def wrong(kernel):
        def run(*a, **kw):
            return kernel(*a, **dict(kw, true_d=None))
        return run

    mla.decode_attention, mla.paged_decode_attention = map(wrong, kernels)
    try:
        yield
    finally:
        mla.decode_attention, mla.paged_decode_attention = kernels


@contextlib.contextmanager
def plain_latent_w4():
    """B5-L (in its kernels' order), B1 and B1e through their plain
    versions on the card; undone on exit."""
    from compressed_tensors_tpu_torch.models import mla
    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
    )

    kernel = mla.decode_attention

    def plain(q, nk, nv, ck, cv, lengths, **kw):
        return da.latent_decode_attention_plain(q, nk, nv, ck, cv, lengths,
                                                kernel_order=True, **kw)

    mla.decode_attention = plain
    try:
        with plain_w4_moe():
            yield
    finally:
        mla.decode_attention = kernel


def check_mla_logits(params, config, ids, steps):
    """The decode-step logits rule (``logits_rule_failures``) at
    ``MLA_DEPTHS``, kernel path against the non-kernel path, with two
    planted faults that must fail every check: the group scales rolled by
    one group (expert stacks included) and the latent kernels' softmax
    scale of true_d = Dk."""
    faults = (("group scales rolled by one group",
               lambda: rolled_group_scales(params)),
              ("softmax scale 1/sqrt(Dk)", latent_scale_of_dk))
    sweep, faulty = mla_logits_by_depth(params, config, ids, steps,
                                        "V2-Lite bf16", MLA_DEPTHS,
                                        faults=faults)
    check_mla_rule("V2-Lite decode-step logits", sweep, faulty)


def mla_checkpoint_round_trip(raw, config):
    """The first 2 layers of the unfused model (layer 0 dense, layer 1
    MoE) written by ``save_llama_checkpoint`` (a DeepSeek V2 checkpoint,
    rope rows interleaved) and read back by ``load_llama_params``: greedy
    tokens at batch 64 equal to the in-memory model's."""
    import torch

    from compressed_tensors_tpu_torch.engine import greedy_generate
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    cfg = dataclasses.replace(config, num_hidden_layers=2)
    two = dict(raw, layers=raw["layers"][:2])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        save_llama_checkpoint(two, cfg, tmp)
        size = os.path.getsize(os.path.join(tmp, "model.safetensors"))
        loaded, lcfg, _ = load_llama_params(tmp, device="cuda")
    log(f"V2-Lite 2-layer checkpoint: {size / 2**20:.0f} MiB, written and "
        f"loaded in {time.perf_counter() - t0:.1f} s (config: MLA "
        f"{lcfg.is_mla}, rope interleaved {lcfg.rope_interleaved}, "
        f"{lcfg.num_local_experts} experts, top {lcfg.num_experts_per_tok})")
    if lcfg != cfg:
        raise AssertionError(f"the checkpoint's config reads back as {lcfg}")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, config.vocab_size,
                                        size=(BATCH, PROMPT)))
    outs = [greedy_generate(fuse_llama_layers(p), cfg, ids, max_new_tokens=16)
            for p in (two, loaded)]
    same = bool(torch.equal(*outs))
    log(f"V2-Lite 2-layer checkpoint vs the model in memory: greedy tokens "
        f"{'identical' if same else 'DIFFERENT'} at batch {BATCH}")
    if not same:
        raise AssertionError("the MLA checkpoint's greedy tokens differ from "
                             "the model it was written from")


def phase_mla(errs):
    """Phase 15: MLA. B5-L/B7-L and B1e at group 64 against their plain
    versions (``parity_latent``); DeepSeek-V2-Lite W4A16 g64 at full width
    and depth built on the card (``mla_llama``), fused: the routing flips
    at the first MoE layer over the 96 prompts (``routing_flips``), the
    decode-step logits by depth (1 and 27 layers) at bf16 activations
    against the non-kernel path with two planted faults
    (``check_mla_logits``), an fp8 latent cache against the model run
    through B5-L's, B1's and B1e's plain versions at 1 and 4 layers with
    the k/v scales / 16 as a control that must fail every check; the 96
    requests dense and paged (identical) on the fp8 latent cache and on a
    bf16 one (``serve_mla``: 161 B1 + 78 B1e + 1 B3 + 27 latent launches a
    decode step and no GQA decode launch), ``greedy_generate`` at batch
    64; the 2-layer checkpoint round trip."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    parity_latent(errs)
    config = LlamaConfig.from_dict(V2_LITE)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    raw = mla_llama(config, seed=0)
    params = fuse_llama_layers(raw)
    torch.cuda.synchronize()
    log(f"DeepSeek-V2-Lite W4A16 g{MLA_GROUP} model (built on the card from "
        f"seed 0, {config.num_hidden_layers} MLA layers, layer 0 dense, "
        f"{config.num_local_experts} experts of {config.moe_intermediate_size}"
        f" + shared {2 * config.moe_intermediate_size}, W8A8-int lm_head): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    kinds = {qt.kernel_meta[0] for qt in expert_layers(params)}
    if kinds != {"w4a16"} or "gate_up_proj" not in params["layers"][0]:
        raise AssertionError(f"V2-Lite: experts prepared as {kinds}")
    requests = serving_requests(config.vocab_size)
    step_rng = np.random.default_rng(15)
    steps = step_rng.integers(0, config.vocab_size, size=MLA_STEPS).tolist()
    with flag_overrides(w4_act="bf16"):
        flips = routing_flips(params, config, requests, moe_layer=1,
                              label="V2-Lite")
        steady = [r for r in requests if r[0] not in flips]
        ids = probe_request(steady)[1]
        check_mla_logits(params, config, ids, steps)

    # the fp8 latent cache (k_scale = v_scale per tensor) against the
    # model run through the plain versions of B5-L, B1 and B1e, with the
    # k/v scales / 16 as the control; then served (ROADMAP C3)
    fp8 = dict(params, layers=[
        dict(layer, k_scale=torch.tensor([KV_SCALE], device="cuda"),
             v_scale=torch.tensor([KV_SCALE], device="cuda"))
        for layer in params["layers"]])
    cache8 = dict(cache_dtype=torch.float8_e4m3fn)
    reset_counts()
    sweep, faulty = mla_logits_by_depth(
        fp8, config, ids, steps, "V2-Lite fp8 cache", MLA_FEW,
        plain=plain_latent_w4, faults=(("k/v scales / 16", lambda:
                                        kv_scales_times(fp8, 1 / 16)),),
        **cache8)
    counts = read_counts()
    log(f"V2-Lite fp8 latent cache: decode_attention latent launches "
        f"{counts['decode_attention_latent']}")
    check_mla_rule("V2-Lite fp8 latent cache", sweep, faulty)
    if not counts["decode_attention_latent"]:
        raise AssertionError("V2-Lite fp8 latent cache: no B5-L launch")
    results = {"mla fp8 logits": {"counts": counts}}
    results.update(serve_mla(fp8, config, requests, "mla fp8", **cache8))
    del fp8

    results.update(serve_mla(params, config, requests, "mla"))
    results["mla greedy_generate"] = greedy_8b(params, config, "V2-Lite",
                                               vocab=config.vocab_size)
    del params
    torch.cuda.empty_cache()
    mla_checkpoint_round_trip(raw, config)
    del raw
    torch.cuda.empty_cache()
    base = ("w4a16_matmul", "w4a16_experts_matmul", "w8a8_matmul")
    check_launched(results, {
        "mla fp8 logits": ("decode_attention_latent",),
        "mla dense": base + ("decode_attention_latent",),
        "mla paged": base + ("paged_decode_attention_latent",),
        "mla fp8 dense": base + ("decode_attention_latent",),
        "mla fp8 paged": base + ("paged_decode_attention_latent",),
        "mla greedy_generate": base + ("decode_attention_latent",)})
    return results


def check_mla_rule(label, sweep, faulty):
    """The decode-step logits rule (``logits_rule_failures``) held by
    ``sweep``, and failed in every check by each planted fault of
    ``faulty``."""
    failures = logits_rule_failures(sweep)
    if failures:
        raise AssertionError(f"{label} against its plain path: "
                             f"{'; '.join(failures)}")
    log(f"{label}: within {TOL_WNA16_DEPTH1} of max|ref| at one layer, and "
        f"at every depth within {TOL_E2E_8B} of max|ref| or {FLOOR_RATIO}x "
        "the perturbation spread (rel_rms / spread: "
        + ", ".join(f"{d}: {e / max(sp, 1e-30):.3g}"
                    for d, (e, sp, _) in sweep.items()) + ")")
    for name, bad in faulty.items():
        caught = logits_rule_failures(bad)
        log(f"{label} control, {name}: " + ", ".join(
            f"{d}: rel_rms {e:.4g} (max {t:.4g} of max|ref|)"
            for d, (e, _, t) in bad.items())
            + f"; the rule fails {len(caught)} of its {len(sweep) + 1} checks")
        if len(caught) < len(sweep) + 1:
            raise AssertionError(f"{label}: the rule accepted the planted "
                                 f"fault ({name}) in "
                                 f"{len(sweep) + 1 - len(caught)} checks")


def mla_step_launches(config, latent):
    """The launches a decode step of an MLA model makes: B1 in q_proj (or
    q_a_proj and q_b_proj), kv_a_proj_with_mqa and o_proj of every layer,
    the fused gate_up and down of the dense layers and the 3 unfused
    shared-expert linears of the MoE layers; B1e in the 3 expert linears
    of each MoE layer; B3 in the lm_head; one ``latent`` launch a layer."""
    q = 2 if config.q_lora_rank else 1
    dense = config.first_k_dense_replace
    moe = config.num_hidden_layers - dense
    return {"w4a16_matmul": (q + 4) * dense + (q + 5) * moe,
            "w4a16_experts_matmul": 3 * moe, "w8a8_matmul": 1,
            latent: config.num_hidden_layers}


def serve_mla(params, config, requests, label, **kw):
    """The requests through the dense and the paged engine (``kw`` to
    both): paged identical to dense token for token (one decode body), a
    decode step launching ``mla_step_launches`` and no GQA decode kernel.
    Returns {"<label> dense": ..., "<label> paged": ...}."""
    results = {f"{label} dense": serve_requests(
        params, config, requests, f"{label} dense", **kw)}
    results[f"{label} paged"] = serve_requests(
        params, config, requests, f"{label} paged", paged=True,
        prefix_caching=False, **kw)
    dense, paged = (results[f"{label} {r}"]["outs"] for r in ("dense",
                                                             "paged"))
    same = sum(dense[i] == paged[i] for i in dense)
    log(f"{label} serving: paged = dense in {same} of {len(dense)} "
        "completions")
    if same != len(dense):
        raise AssertionError(f"{label}: paged completions differ from dense")
    gqa = ("decode_attention", "decode_attention_scaled",
           "flash_decode_attention", "flash_decode_attention_scaled",
           "paged_decode_attention", "paged_decode_attention_scaled")
    for run, latent in (("dense", "decode_attention_latent"),
                        ("paged", "paged_decode_attention_latent")):
        step = mla_step_launches(config, latent)
        got = {k: v for k, v in results[f"{label} {run}"]["per_step"].items()
               if v and (k.startswith(("w4", "w8a8")) or k in gqa
                         or k.endswith("_latent"))}
        log(f"{label} {run}: launches a decode step {got} (expected {step})")
        if got != step:
            raise AssertionError(f"{label} {run}: a decode step launched "
                                 f"{got}")
    return results


# deepseek-ai/DeepSeek-V2's published config.json (cited, not fetched):
# MLA with 128 heads (q_lora_rank 1536, kv_lora_rank 512, nope 128, rope
# 64, v 128), hidden 5120, layer 0 a dense MLP of 12288
# (first_k_dense_replace 1), the other layers 160 routed experts of width
# 1536, 6 a token (norm_topk_prob false), and 2 shared experts; vocab
# 102400. Cut from 60 layers to 3 (layer 0 dense, layers 1-2 MoE): the 60
# at W4A16 g64 would need about 118 GB, one card holds 80. Neither package
# reads its grouped routing (n_group 8, topk_group 3),
# routed_scaling_factor (16) or YaRN rope_scaling.
V2 = dict(V2_LITE, hidden_size=5120, intermediate_size=12288,
          num_hidden_layers=3, num_attention_heads=128,
          num_key_value_heads=128, q_lora_rank=1536, n_routed_experts=160,
          moe_intermediate_size=1536)
V2_DEPTHS = (1, 3)
V2_REQUESTS = 64


def phase_mla_v2():
    """Phase 15b: DeepSeek-V2 at 128 query heads (ROADMAP B-v), full width,
    3 layers, W4A16 g64 built on the card (``mla_llama``), fused: the
    decode-step logits at 1 and 3 layers against the model run through
    B5-L's (in its kernels' order), B1's and B1e's plain versions by the
    depth rule, the latent kernels' softmax scale 1/sqrt(576) for
    1/sqrt(192) as the control that must fail every check; 64 requests
    dense and paged (identical) with ``mla_step_launches`` a decode step."""
    import torch

    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = LlamaConfig.from_dict(V2)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fuse_llama_layers(mla_llama(config, seed=2))
    torch.cuda.synchronize()
    log(f"DeepSeek-V2 W4A16 g{MLA_GROUP} model (built on the card from seed "
        f"2, {config.num_hidden_layers} MLA layers of "
        f"{config.num_attention_heads} heads, q_lora_rank "
        f"{config.q_lora_rank}, layer 0 dense, {config.num_local_experts} "
        f"experts of {config.moe_intermediate_size} + shared "
        f"{2 * config.moe_intermediate_size}, W8A8-int lm_head): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests(config.vocab_size)[:V2_REQUESTS]
    steps = np.random.default_rng(16).integers(
        0, config.vocab_size, size=MLA_STEPS).tolist()
    ids = probe_request(requests)[1]
    reset_counts()
    sweep, faulty = mla_logits_by_depth(
        params, config, ids, steps, "V2 bf16", V2_DEPTHS,
        plain=plain_latent_w4,
        faults=(("softmax scale 1/sqrt(Dk)", latent_scale_of_dk),))
    counts = read_counts()
    check_mla_rule("V2 decode-step logits", sweep, faulty)
    results = {"v2 logits": {"counts": counts}}
    results.update(serve_mla(params, config, requests, "v2"))
    del params
    torch.cuda.empty_cache()
    log(f"phase 15b (DeepSeek-V2, 128 heads) wall "
        f"{time.perf_counter() - t0:.1f} s ({card()})")
    base = ("w4a16_matmul", "w4a16_experts_matmul", "w8a8_matmul")
    check_launched(results, {
        "v2 logits": ("decode_attention_latent",),
        "v2 dense": base + ("decode_attention_latent",),
        "v2 paged": base + ("paged_decode_attention_latent",)})
    return results


def latent_row(gen, rng, name, cache, s_pad, label, h=16):
    """Device ms of B5-L (``s_pad`` S_pad, lengths 128-159 at 192 or 0-1000
    at 1024) or B7-L (the paged engine's pool through shuffled tables,
    lengths 0-1000) on one layer of a 27-layer latent cache at batch 64
    with ``h`` query heads (V2-Lite's 16, V2's 128),
    the calls walking the layers as a decode step does, beside its bound
    (the live cache bytes read once at 3.35 TB/s, q, the new rows and the
    output), its plain version and SDPA on the same operands (the one
    latent head expanded by ``enable_gqa``, the cache widened to bf16 and,
    for the pool, gathered beforehand; a mask of the live prefix)."""
    import torch
    import torch.nn.functional as F

    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        paged_decode as pd,
    )
    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    L, dk, dv = 27, 576, 512
    dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}[cache]
    sc = CACHE_SCALES.get(cache)
    ks = vs = None if sc is None else torch.tensor([sc], device="cuda")
    widen = ((lambda c: c) if sc is None else
             (lambda c: (c.float() * sc).to(torch.bfloat16)))
    q = dev_randn(gen, BATCH, h, dk)
    nk, nv = dev_randn(gen, BATCH, 1, dk), dev_randn(gen, BATCH, 1, dv)
    if s_pad == 192:
        lens_np = rng.integers(PROMPT, PROMPT + NEW_TOKENS,
                               size=BATCH).astype(np.int32)
    else:
        lens_np, _ = serving_lengths(rng, BATCH, ())
    lengths = torch.from_numpy(lens_np).cuda()
    kw = dict(k_scale=ks, v_scale=vs, true_d=192)

    def make(shape):
        return (dev_randn(gen, *shape) if sc is None
                else dev_cache(gen, shape, dtype, sc))

    if name == "decode_attention_latent":
        ck, cv = make((L, BATCH, 1, s_pad, dk)), make((L, BATCH, 1, s_pad, dv))
        t = device_ms([lambda i=i: da.decode_attention(
            q, nk, nv, ck, cv, lengths, layer=i, **kw) for i in range(L)])
        tp = eager_ms(lambda: da.latent_decode_attention_plain(
            q, nk, nv, ck, cv, lengths, layer=0, **kw))
        keys = [widen(ck[i]) for i in range(3)]
        values = [widen(cv[i]) for i in range(3)]
        how = "a mask of the live prefix over S_pad"
    else:
        tables, num_pages = serving_tables(rng)
        tables_d = torch.from_numpy(tables).cuda()
        page = SERVE["page_size"]
        ck = make((L, num_pages, 1, page, dk))
        cv = make((L, num_pages, 1, page, dv))
        t = device_ms([lambda i=i: pd.paged_decode_attention(
            q, nk, nv, ck, cv, tables_d, lengths, layer=i, **kw)
            for i in range(L)])
        tp = eager_ms(lambda: pd.paged_decode_attention_plain(
            q, nk, nv, ck, cv, tables_d, lengths, layer=0, **kw))

        def gathered(pool, i):
            return widen(byte_view(pool[i])[tables_d.long()].permute(
                0, 2, 1, 3, 4).reshape(BATCH, 1, -1, pool.shape[-1])
                .view(pool.dtype))

        keys = [gathered(ck, i) for i in range(3)]
        values = [gathered(cv, i) for i in range(3)]
        s_pad = keys[0].shape[2]
        how = "the pages gathered beforehand into a contiguous cache"
    mask = (torch.arange(s_pad, device="cuda")[None, :]
            <= lengths[:, None])[:, None, None, :]
    try:
        tl = device_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True,
            scale=192 ** -0.5)
            for k, v in zip(keys * (L // 3), values * (L // 3))])
    except (RuntimeError, TypeError) as exc:
        log(f"scaled_dot_product_attention at K {dk}, V {dv} unavailable: "
            f"{exc}")
        tl = None
    live = int((lens_np + 1).sum())
    nbytes = (live * (dk + dv) * ck.element_size()
              + (q.numel() + nk.numel() + nv.numel() + BATCH * h * dv) * 2)
    bm, by = bound(nbytes, 2 * h * (dk + dv) * live, PEAK_BF16)
    del ck, cv, keys, values
    torch.cuda.empty_cache()
    log(f"time {name} {label}: {t:.4f} ms, bound {bm:.4f} ms ({by}), plain "
        f"{tp:.4f} ms, SDPA {tl if tl is None else round(tl, 4)} ms")
    return dict(ms=t, plain_ms=tp, bound_ms=bm, bound_by=by, library_ms=tl,
                shapes=f"{label}: B={BATCH}, h={h}, K={dk}, V={dv}, one layer "
                f"of {L}; library: SDPA over the cache in bf16 ({how})")


def timings_mla():
    """B5-L on bf16 and fp8 caches at S_pad 192 and 1024, B7-L on bf16 and
    fp8 pools (V2-Lite's 16 heads), both on bf16 at V2's 128 heads, and
    B1e at V2-Lite's gate and down at group 64 (C = 8)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(17)
    rng = np.random.default_rng(17)
    rows = {"decode_attention_latent": {}, "paged_decode_attention_latent": {}}
    for cache in ("bf16", "fp8"):
        for s_pad in LATENT_SPADS:
            rows["decode_attention_latent"][f"{cache} S_pad={s_pad}"] = \
                latent_row(gen, rng, "decode_attention_latent", cache, s_pad,
                           f"V2-Lite {cache} slab S_pad {s_pad}")
        rows["paged_decode_attention_latent"][cache] = latent_row(
            gen, rng, "paged_decode_attention_latent", cache, 1024,
            f"V2-Lite {cache} pool, lengths 0-1000")
    rows["decode_attention_latent"]["bf16 V2 h128 S_pad=1024"] = latent_row(
        gen, rng, "decode_attention_latent", "bf16", 1024,
        "V2 (128 heads) bf16 slab S_pad 1024", h=128)
    rows["paged_decode_attention_latent"]["bf16 V2 h128"] = latent_row(
        gen, rng, "paged_decode_attention_latent", "bf16", 1024,
        "V2 (128 heads) bf16 pool, lengths 0-1000", h=128)
    b1e = {}
    for label, n, k in (("gate", 1408, 2048), ("down", 2048, 1408)):
        b1e[f"V2-Lite {label} C=8 g64"] = experts_row(
            gen, "w4a16_experts_matmul", 64, 8, n, k, f"V2-Lite {label}",
            g=MLA_GROUP)
    return rows, b1e


# --------------------------------------------------------------------------- #
# phase 16: the PTQ lifecycle and save path on the card

# the arms' recipes, as a checkpoint's quantization_config gives them (preset
# names over targets): A is BASELINE config 1's, B config 3's
PTQ_W4 = {"config_groups": {"W4A16": ["Linear"], "W8A8": ["lm_head"]},
          "quant_method": "compressed-tensors"}
PTQ_FP8 = {"config_groups": {"FP8_DYNAMIC": ["Linear"]},
           "kv_cache_scheme": {"num_bits": 8, "type": "float",
                               "strategy": "tensor", "symmetric": True,
                               "dynamic": False},
           "quant_method": "compressed-tensors"}
PTQ_MXFP4 = {"config_groups": {"MXFP4A16": ["Linear"]}, "ignore": ["lm_head"],
             "quant_method": "compressed-tensors"}
PTQ_FEW = (1, 4)              # arms B and C: 4 layers at full width
PTQ_SHARD_BYTES = 2 * 1024**3
PTQ_CALIB = (64, 128)         # arm B's KV calibration: prompts x tokens
PTQ_STEPS = 4                 # arm B's decode steps whose logits are held
# the dense weights: N(0, s^2) with s uniform in PTQ_SPREAD, drawn per 32
# columns of a row (weight RMS 0.0092, phase 5's), so that neighbouring
# quantization groups' calibrated scales differ as phase 5's drawn scales
# do and the rolled-scales control reads a fault
PTQ_SPREAD = (6e-3, 1.2e-2)
PTQ_SUBMODULE = {"q_proj": "self_attn", "k_proj": "self_attn",
                 "v_proj": "self_attn", "o_proj": "self_attn",
                 "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}
# the W4 kernels that a W4A16 decode step must not launch
OTHER_W4 = ("w4a16_a8b_matmul", "w4a16_fp4_matmul", "w4_e8_matmul",
            "w4a16_planes_int4", "w4a16_planes_a8", "w4a16_planes_mat",
            "w4a16_experts_matmul", "w4a16_a8b_experts_matmul",
            "w4_e8_experts_matmul")


@functools.lru_cache(maxsize=None)
def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def same_bits(a, b):
    """Equal dtype, shape and bytes (floats through an integer view)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a.cpu(), b.cpu()))


def ptq_dense_llama(config, seed, device="cuda"):
    """A dense bf16 Llama drawn from ``seed`` in checkpoint naming:
    {module name: weight} for the embedding (N(0, 0.02^2)), every decoder
    linear and the lm_head (``PTQ_SPREAD``), and the unit norms as extra
    tensors {tensor name: weight}."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    H, V = config.hidden_size, config.vocab_size
    lo, hi = PTQ_SPREAD

    def draw(n, k):
        s = torch.rand((n, k // 32, 1), generator=gen, device=device) \
            * (hi - lo) + lo
        return (torch.randn((n, k // 32, 32), generator=gen, device=device)
                * s).reshape(n, k).to(torch.bfloat16)

    weights = {"model.embed_tokens": (torch.randn(
        (V, H), generator=gen, device=device) * 0.02).to(torch.bfloat16)}
    ones = torch.ones((H,), dtype=torch.bfloat16, device=device)
    extra = {"model.norm.weight": ones}
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}"
        for name, (n, k) in linear_shapes(config).items():
            weights[f"{p}.{PTQ_SUBMODULE[name]}.{name}"] = draw(n, k)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            extra[f"{p}.{norm}.weight"] = ones
    weights["lm_head"] = draw(V, H)
    return weights, extra


def first_layers(tensors, depth):
    """The tensors of the embedding, the head, the final norm and the
    first ``depth`` decoder layers."""
    return {n: t for n, t in tensors.items()
            if not n.startswith("model.layers.")
            or int(n.split(".")[2]) < depth}


def dense_qt(w):
    from compressed_tensors_tpu_torch.ops.linear import QuantizedTensor

    return QuantizedTensor(weight=w, shape=tuple(w.shape), format="dense")


def ptq_params(weights, extra, config, linear):
    """Unfused Llama params of the port from checkpoint-named tensors, each
    linear from ``linear(module name)``."""
    params = {"embed_tokens": weights["model.embed_tokens"],
              "norm": extra["model.norm.weight"],
              "lm_head": linear("lm_head"), "layers": []}
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}"
        layer = {name: linear(f"{p}.{sub}.{name}")
                 for name, sub in PTQ_SUBMODULE.items()}
        for norm in ("input_layernorm", "post_attention_layernorm"):
            layer[norm] = extra[f"{p}.{norm}.weight"]
        params["layers"].append(layer)
    return params


def qdq_weight(state, w):
    """The weight the QDQ forward (``quantized_module_forward`` at status
    CALIBRATION) multiplies by: ``fake_quantize`` with the module's
    calibrated qparams."""
    from compressed_tensors_tpu_torch.ops.quantize import fake_quantize

    q = state.qparams
    return fake_quantize(w, q["weight_scale"], q.get("weight_zero_point"),
                         state.scheme.weights,
                         global_scale=q.get("weight_global_scale"))


def ptq_calibrate(weights, recipe, config, device="cuda"):
    """``apply_quantization_config`` over the model's module graph (the
    attention modules named for a kv_cache_scheme), then min-max
    ``calibrate_module`` of every matched linear on its weight, where the
    weights lie. Returns (module graph, QuantizationConfig, states)."""
    from compressed_tensors_tpu_torch.compressors import (
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.quantization import QuantizationConfig
    from compressed_tensors_tpu_torch.quantization import lifecycle

    modules = module_graph_from_names(list(weights))
    qconfig = QuantizationConfig.model_validate(recipe)
    states = lifecycle.apply_quantization_config(
        modules, {n: tuple(w.shape) for n, w in weights.items()}, qconfig,
        kv_module_names=[f"model.layers.{i}.self_attn"
                         for i in range(config.num_hidden_layers)],
        device=device)
    for name, state in states.items():
        if name in weights:
            lifecycle.calibrate_module(state, weights[name])
    return modules, qconfig, states


def llama_config_json(config):
    """config.json's model widths, as the tests' checkpoints write them."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": config.vocab_size,
            "hidden_size": config.hidden_size,
            "intermediate_size": config.intermediate_size,
            "num_hidden_layers": config.num_hidden_layers,
            "num_attention_heads": config.num_attention_heads,
            "num_key_value_heads": config.num_key_value_heads,
            "head_dim": config.head_dim, "rms_norm_eps": config.rms_norm_eps,
            "rope_theta": config.rope_theta,
            "max_position_embeddings": config.max_position_embeddings,
            "tie_word_embeddings": False}


def ptq_save(path, weights, extra, states, modules, qconfig, config, label,
             device="cuda", transform_config=None):
    """config.json with the widths, then ``ModelCompressor.save_checkpoint``
    of the dense weights with their calibrated qparams (the codecs
    quantize and pack them on the card; each tensor is copied to the host
    once) in shards of ``PTQ_SHARD_BYTES``; the index and the
    quantization config come with it, and the ``transform_config`` where
    one is given (checked to read back as its ``model_dump``). Returns the
    shard count."""
    import torch

    from compressed_tensors_tpu_torch.compressors import ModelCompressor
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        get_weight_map,
    )

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(llama_config_json(config), f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ModelCompressor(quantization_config=qconfig,
                    transform_config=transform_config).save_checkpoint(
        path, {n: {"weight": w, **(states[n].qparams if n in states else {})}
               for n, w in weights.items()},
        modules, extra_tensors=extra, max_shard_bytes=PTQ_SHARD_BYTES)
    seconds = time.perf_counter() - t0
    if transform_config is not None:
        with open(os.path.join(path, "config.json")) as f:
            block = json.load(f)["quantization_config"]["transform_config"]
        if block != transform_config.model_dump(mode="json"):
            raise AssertionError(f"{label}: config.json's transform_config "
                                 f"reads back as {block}")
        log(f"{label}: config.json holds the transform_config block, equal "
            f"to TransformConfig.model_dump(mode=\"json\") "
            f"({sorted(block['config_groups'])})")
    shards = sorted(set(get_weight_map(path).values()))
    size = sum(os.path.getsize(os.path.join(path, f)) for f in shards)
    log(f"{label}: save_checkpoint {size / 1e9:.3f} GB in {len(shards)} "
        f"shards in {seconds:.2f} s ({size / 1e9 / seconds:.2f} GB/s; "
        f"{card()})")
    return len(shards)


def ptq_load(path, config, label, device="cuda"):
    """``load_llama_params`` (run compressed, kernel layouts) and fusion,
    timed; the config read back must be the model's."""
    import torch

    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, lcfg, _ = load_llama_params(path, device=device)
    params = fuse_llama_layers(params)
    torch.cuda.synchronize()
    log(f"{label}: load_llama_params and fusion in "
        f"{time.perf_counter() - t0:.2f} s ({card()})")
    if lcfg != config:
        raise AssertionError(f"{label}: the checkpoint's config reads back "
                             f"as {lcfg}")
    return params


def ptq_logits(params, config, ids, depth, use_kernels, steps=(),
               cache_dtype=None, device="cuda", check=True, label="model"):
    """f32 logits through the first ``depth`` layers (full width): the
    prompt ``ids`` prefilled (row 0: its last position), then each token of
    ``steps`` decoded (one row each); with ``check`` the cache and the
    logits checked for NaN (a planted fault's run may give them)."""
    import torch

    from compressed_tensors_tpu_torch.models.llama import (
        init_kv_cache,
        llama_forward,
    )

    n = len(ids)
    cfg = dataclasses.replace(config, num_hidden_layers=depth)
    p = dict(params, layers=params["layers"][:depth])
    cache = init_kv_cache(cfg, 1, n + len(steps), cache_dtype=cache_dtype,
                          device=device)
    logits, cache = llama_forward(
        p, cfg, torch.tensor([ids], device=device),
        torch.arange(n, device=device)[None], cache, fresh_prefill=True,
        use_kernels=use_kernels, last_logit_only=True)
    out = [logits.float().reshape(-1)]
    for tok in steps:
        logits, cache = llama_forward(
            p, cfg, torch.tensor([[tok]], device=device),
            cache.lengths[:, None], cache, use_kernels=use_kernels)
        out.append(logits.float().reshape(-1))
    out = torch.stack(out)
    if check:
        nans = int(cache.k.float().isnan().sum()
                   + cache.v.float().isnan().sum())
        if nans:  # an fp8 cache overflows to NaN
            raise AssertionError(f"{label} KV cache: {nans} NaN values")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite {label} logits at depth "
                                 f"{depth}")
    return out


@contextlib.contextmanager
def one_ulp(emb, tok):
    """One bf16 ulp up on 64 embedding values of token ``tok``: the
    perturbation whose effect on the reference is its own spread."""
    row = emb[tok].clone()
    emb[tok, :64] = (row[:64].float() * (1 + 2**-7)).to(emb.dtype)
    try:
        yield
    finally:
        emb[tok] = row


def fp8_rule_failures(sweep):
    """Phase 6's FP8 rule on a sweep, held at every depth; returns what it
    fails: relative RMS error within TOL_FP8_DEPTH1 at one layer, and at
    every depth within FLOOR_RATIO times the reference's own spread under
    the one-ulp perturbation. (Every linear rounds its input to fp8 per
    token, so a one-ulp difference anywhere upstream flips codes by a full
    fp8 step: a max-error limit of 3% at one layer cannot hold between
    two paths that are not bit-identical; PERF.md section 6 has the
    readings.)"""
    out = []
    if sweep[1][0] > TOL_FP8_DEPTH1:
        out.append(f"one layer: rel_rms {sweep[1][0]:.4g} > {TOL_FP8_DEPTH1}")
    for depth, (err, spread, _) in sweep.items():
        if not err <= FLOOR_RATIO * spread:
            out.append(f"{depth} layers: rel_rms {err:.4g} > {FLOOR_RATIO} "
                       f"x the spread {spread:.4g}")
    return out


def ptq_depth_rule(label, depths, run, perturb, fault, control,
                   views=None, rule=logits_rule_failures,
                   ref_name="QDQ reference"):
    """The depth rule of phases 5 and 7-15 (``logits_rule_failures``) on
    readings of ``run(depth, test, check)`` (f32 logits of the test path,
    or of the reference; ``check`` off for the planted fault's run), each
    view of them (``views``: name -> picker) held alone: per depth the
    relative RMS error, the reference's own relative RMS under
    ``perturb`` (a context manager factory) and max|test - ref| /
    max|ref|. The test path inside ``fault`` (a planted fault) must fail
    every check of the rule in every view; a non-finite reading of it
    counts as infinitely far. ``rule`` is the depth rule
    (``logits_rule_failures``) or phase 6's FP8 rule
    (``fp8_rule_failures``). Returns the launch counts read before the
    planted fault's runs."""
    views = views or {"": lambda t: t}
    sweeps = {v: ({}, {}) for v in views}
    refs = {}
    for depth in depths:
        got, ref = run(depth, True), run(depth, False)
        with perturb():
            moved = run(depth, False)
        refs[depth] = ref
        for v, pick in views.items():
            g, r, m = pick(got), pick(ref), pick(moved)
            top = r.abs().max().item()
            sweeps[v][0][depth] = (rel_rms(g, r), rel_rms(m, r),
                                   (g - r).abs().max().item() / top)
            err, spread, rel = sweeps[v][0][depth]
            log(f"{label}{v}, {depth} layers: test vs {ref_name} rel_rms "
                f"{err:.4g}, max {rel:.4g} of max|ref| {top:.4g}; the "
                f"reference under one ulp rel_rms {spread:.4g}; argmax test "
                f"{g.argmax(-1).tolist()} reference {r.argmax(-1).tolist()}")
    counts = read_counts()
    with fault:
        for depth, ref in refs.items():
            bad = run(depth, True, False)
            for v, pick in views.items():
                b, r = pick(bad), pick(ref)
                err, rel = rel_rms(b, r), ((b - r).abs().max().item()
                                           / r.abs().max().item())
                sweeps[v][1][depth] = (
                    err if np.isfinite(err) else float("inf"),
                    sweeps[v][0][depth][1],
                    rel if np.isfinite(rel) else float("inf"))
    for v, (sweep, faulty) in sweeps.items():
        failures = rule(sweep)
        if failures:
            raise AssertionError(f"{label}{v}: {'; '.join(failures)}")
        caught = rule(faulty)
        log(f"{label}{v}: " + (
            f"within {TOL_WNA16_DEPTH1} of max|ref| at one layer, and at "
            f"every depth within {TOL_E2E_8B} of max|ref| or "
            if rule is logits_rule_failures else
            f"rel_rms within {TOL_FP8_DEPTH1} at one layer, and at every "
            "depth within ") + f"{FLOOR_RATIO}x the spread (rel_rms / spread: "
            + ", ".join(f"{d}: {e / max(s, 1e-30):.3g}"
                        for d, (e, s, _) in sweep.items())
            + f"); control ({control}): " + ", ".join(
                f"{d}: rel_rms {e:.4g} (max {t:.4g} of max|ref|)"
                for d, (e, _, t) in faulty.items())
            + f"; the rule fails {len(caught)} of its {len(sweep) + 1} "
            "checks")
        if len(caught) < len(sweep) + 1:
            raise AssertionError(f"{label}{v}: the rule accepted the planted "
                                 f"fault ({control}) in "
                                 f"{len(sweep) + 1 - len(caught)} checks")
    return counts


def ptq_card_vs_cpu(label, weights, states, codes, names):
    """Check 1: the named modules calibrated and compressed again on the
    CPU from the same bf16 weights: every qparam and the integer codes
    before packing equal the card's bit for bit."""
    from compressed_tensors_tpu_torch.quantization import lifecycle

    t0 = time.perf_counter()
    for name in names:
        state, w = states[name], weights[name].cpu()
        cpu = lifecycle.initialize_module_for_quantization(
            state.scheme, tuple(w.shape), device="cpu")
        lifecycle.calibrate_module(cpu, w)
        _, q = lifecycle.compress_quantized_weights(cpu, w)
        bad = [k for k in state.qparams
               if not same_bits(state.qparams[k], cpu.qparams.get(k))]
        if sorted(state.qparams) != sorted(cpu.qparams) or bad or \
                not same_bits(codes[name], q):
            raise AssertionError(f"{label} {name}: the card's calibration or "
                                 f"codes differ from the CPU's ({bad or 'codes'})")
    log(f"{label}: {len(names)} modules ({', '.join(names)}) calibrated and "
        "compressed on the CPU from the same weights: qparams and codes "
        f"equal the card's bit for bit ({time.perf_counter() - t0:.1f} s)")


def ptq_check_saved(label, path, weights, extra, states, names, shards,
                    locals_of, device="cuda"):
    """Check 2: ``ModelCompressor.from_pretrained(path).load_checkpoint(path,
    run_compressed=False)`` decompresses the named modules to weights equal
    bit for bit to ``fake_quantize`` of the dense weights with the
    calibrated qparams (up to the sign of zero: a negative weight whose
    code rounds to 0 fake-quantizes to -0.0 and decompresses from the
    stored integer 0 as +0.0); ``get_weight_map`` names every tensor of
    the shards, and they are every tensor the model holds
    (``locals_of(module) -> local names``), in at least 3 shards."""
    import torch

    from compressed_tensors_tpu_torch.compressors import ModelCompressor
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        get_safetensors_header,
        get_weight_map,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = ModelCompressor.from_pretrained(path)
    dec, _ = mc.load_checkpoint(path, run_compressed=False, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in names:
        got = dec[name]["weight"]
        want = qdq_weight(states[name], weights[name])
        if not (bool(torch.equal(got, want))
                and same_bits(got + 0.0, want + 0.0)):
            raise AssertionError(f"{label} {name}: decompressed weight is not "
                                 "the fake-quantized one")
    del dec
    torch.cuda.empty_cache()
    weight_map = get_weight_map(path)
    files = sorted(set(weight_map.values()))
    held = {k: f for f in files
            for k in get_safetensors_header(os.path.join(path, f))}
    expected = set(extra) | {f"{m}.{k}" for m in weights
                             for k in locals_of(m)}
    if held != weight_map or set(weight_map) != expected or \
            len(files) != shards or shards < 3:
        raise AssertionError(
            f"{label}: weight map of {len(weight_map)} tensors over "
            f"{len(files)} shards; missing {sorted(expected - set(weight_map))[:5]}, "
            f"unexpected {sorted(set(weight_map) - expected)[:5]}")
    log(f"{label}: load_checkpoint(run_compressed=False) in {seconds:.2f} s "
        f"({card()}); {', '.join(names)} decompressed equal fake_quantize "
        f"of the dense weights bit for bit; get_weight_map names all "
        f"{len(weight_map)} tensors over {len(files)} shards")


def exact_qdq(state, w):
    """(weight, state) for a QDQ reference in f32: the weight's codes as
    the codec computes them, times the scales in f32 (no bf16 rounding of
    the product), and a copy of ``state`` with f32 scales, under which
    fake quantization leaves that weight as it is."""
    import torch

    from compressed_tensors_tpu_torch.ops.quantize import dequantize, quantize
    from compressed_tensors_tpu_torch.quantization import lifecycle

    q, args = state.qparams, state.scheme.weights
    codes = quantize(w, q["weight_scale"], q.get("weight_zero_point"), args,
                     dtype=args.storage_dtype())
    f32 = {k: v.float() if v.is_floating_point() else v for k, v in q.items()}
    return (dequantize(codes, f32["weight_scale"], f32.get("weight_zero_point"),
                       args, dtype=torch.float32),
            lifecycle.ModuleQuantState(scheme=state.scheme, status=state.status,
                                       qparams=f32))


@contextlib.contextmanager
def qdq_linears(states):
    """The reference's linears (dense QuantizedTensors keyed by id in
    ``states``) run ``quantized_module_forward`` at status CALIBRATION:
    the input quantized per the scheme (given in f32, the dtype the W8A8
    kernels keep activation scales in), the weight fake-quantized, one
    f32 product; the result back in the activations' dtype."""
    from compressed_tensors_tpu_torch.models import llama
    from compressed_tensors_tpu_torch.quantization import lifecycle

    matmul = llama.quantized_matmul

    def qdq_matmul(x, qt, use_kernels=True):
        state = states.get(id(qt))
        if state is None:
            return matmul(x, qt, use_kernels)
        return lifecycle.quantized_module_forward(
            x.float(), qt.weight, state).to(x.dtype)

    llama.quantized_matmul = qdq_matmul
    try:
        yield
    finally:
        llama.quantized_matmul = matmul


@contextlib.contextmanager
def kv_scales_times(params, factor):
    """A planted fault: every layer's k_scale and v_scale times
    ``factor`` (1/16 saturates an fp8 cache); undone on exit."""
    scales = [layer[k] for layer in params["layers"]
              for k in ("k_scale", "v_scale")]
    saved = [s.clone() for s in scales]
    for s in scales:
        s.mul_(factor)
    try:
        yield
    finally:
        for s, old in zip(scales, saved):
            s.copy_(old)


def check_w4_serving(label, results, config):
    """Arm A's launches: a decode step runs B1 in the 4 fused linears of
    each layer and B3 once (the lm_head), and no other W4 kernel; prefill
    chunks of 256 rows or more run B2 in all 4 (N and K >= 4096 at 8B
    width), the shorter ones B1."""
    per_layer = 4 * config.num_hidden_layers
    for run in ("dense", "paged"):
        res = results[f"{label} {run}"]
        step = res["per_step"]
        got = {k: step[k] for k in ("w4a16_matmul", "w8a8_matmul") + OTHER_W4}
        want = dict.fromkeys(got, 0)
        want.update(w4a16_matmul=per_layer, w8a8_matmul=1)
        big = sum(rows >= 256 for rows in res["chunk_rows"])
        log(f"{label} {run}: launches a decode step {got}; B2 launches "
            f"{res['counts']['w4a16_a8b_matmul']} over {big} of "
            f"{len(res['chunk_rows'])} prefill chunks with >= 256 rows")
        if got != want or \
                res["counts"]["w4a16_a8b_matmul"] != per_layer * big or big == 0:
            raise AssertionError(f"{label} {run}: launches a decode step "
                                 f"{got} (expected {want}), B2 "
                                 f"{res['counts']['w4a16_a8b_matmul']}")


def ptq_arm_w4(dense, extra, config, requests, path, device="cuda",
               label="ptq w4a16", transform_config=None, after=None):
    """Arm A: BASELINE config 1's recipe (W4A16 g128 symmetric on every
    decoder linear, W8A8-int on the lm_head) over the full-depth model:
    apply, min-max calibrate and compress every module on the card (the
    codes and qparams of layer 0 and the lm_head against the CPU's, check
    1), save in 2 GiB shards, decompress (check 2), load with
    ``load_llama_params`` and fuse; the hidden state entering the lm_head
    held to the depth rule against the QDQ model, every W4 linear at bf16
    activations (check 3; the W8A8 head's activation scales part from the
    QDQ path's by the known rounding, so the head is held to B3's plain
    version bit for bit and its QDQ distance printed); greedy and the 96
    requests dense and paged (check 4). A ``transform_config`` is saved
    with the checkpoint; ``after(params)`` runs on the served params before
    they are dropped."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.ops.linear import quantized_matmul
    from compressed_tensors_tpu_torch.quantization import lifecycle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    modules, qconfig, states = ptq_calibrate(dense, PTQ_W4, config, device)
    held = [f"model.layers.0.{sub}.{name}"
            for name, sub in PTQ_SUBMODULE.items()] + ["lm_head"]
    codes = {}
    for name, state in states.items():
        # on a copy: the states stay at CALIBRATION for the QDQ reference
        _, q = lifecycle.compress_quantized_weights(
            dataclasses.replace(state), dense[name])
        if name in held:
            codes[name] = q
    torch.cuda.synchronize()
    log(f"{label}: apply_quantization_config, calibrate_module and "
        f"compress_quantized_weights over {len(states)} linears of "
        f"{config.num_hidden_layers} layers in "
        f"{time.perf_counter() - t0:.2f} s ({card()})")
    ptq_card_vs_cpu(label, dense, states, codes, held)
    del codes
    shards = ptq_save(path, dense, extra, states, modules, qconfig, config,
                      label, device, transform_config)
    ptq_check_saved(
        label, path, dense, extra, states, held, shards,
        lambda m: (("weight",) if m == "model.embed_tokens" else
                   ("weight", "weight_scale") if m == "lm_head" else
                   ("weight_packed", "weight_scale", "weight_shape")),
        device)
    params = ptq_load(path, config, label, device)
    qdq = {n: dense_qt(qdq_weight(states[n], dense[n])) for n in states}
    ref = ptq_params(dense, extra, config, qdq.__getitem__)
    eye = torch.eye(config.hidden_size, dtype=torch.bfloat16, device=device)
    _, ids, _ = probe_request(requests)

    def hidden(depth, test, check=True):
        with flag_overrides(w4_act="bf16"):
            return ptq_logits(dict(params if test else ref, lm_head=eye),
                              config, ids, depth, test, device=device,
                              check=check)

    ptq_depth_rule(f"{label} hidden state entering the lm_head", DEPTHS,
                   hidden, lambda: one_ulp(ref["embed_tokens"],
                                           ids[len(ids) // 3]),
                   rolled_group_scales(params, ("w4a16",)),
                   "group scales rolled by one group")
    h = hidden(config.num_hidden_layers, True)[0].to(torch.bfloat16)[None]
    got = quantized_matmul(h, params["lm_head"])
    with plain_w8a8():
        want = quantized_matmul(h, params["lm_head"])
    qdq_head = lifecycle.quantized_module_forward(h, dense["lm_head"],
                                                  states["lm_head"])
    top = qdq_head.float().abs().max().item()
    log(f"{label} lm_head on the full-depth hidden state: B3 vs its plain "
        f"version max |diff| {(got - want).float().abs().max().item():.4g}; "
        f"vs the QDQ lm_head (activation scales in bf16) max "
        f"{(got - qdq_head).float().abs().max().item() / top:.4g} of "
        f"max|ref| {top:.4g}, argmax B3 {int(got.argmax())} QDQ "
        f"{int(qdq_head.argmax())}")
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: the lm_head's B3 launch differs from "
                             "its plain version")
    del ref, qdq, eye
    results = {f"{label} {run}": serve_requests(
        params, config, requests, f"{label} {run}", paged=run == "paged",
        **({"prefix_caching": False} if run == "paged" else {}))
        for run in ("dense", "paged")}
    dense_out, paged_out = (results[f"{label} {r}"]["outs"]
                            for r in ("dense", "paged"))
    bad = [i for i in dense_out if paged_out[i] != dense_out[i]]
    log(f"{label} serving paged vs dense: {N_REQUESTS - len(bad)}/"
        f"{N_REQUESTS} completions identical token for token ({card()})")
    if bad:
        raise AssertionError(f"{label} serving: paged and dense completions "
                             f"differ for requests {bad}")
    check_w4_serving(label, results, config)
    results[f"{label} greedy_generate"] = greedy_8b(params, config, label)
    served = []
    for run in ("dense", "paged"):
        res = results[f"{label} {run}"]
        tokens = sum(len(out) for out in res["outs"].values())
        served.append(f"{run} {tokens / res['wall']:.1f} tok/s, "
                      f"{res['decode_s'] * 1e3 / max(res['steps'], 1):.2f} "
                      "ms a decode step")
    log(f"{label} served from its own checkpoint: {'; '.join(served)}; "
        f"greedy_generate "
        f"{results[f'{label} greedy_generate']['wall'] * 1e3:.1f} ms "
        f"({card()})")
    if after is not None:
        after(params)
    base = ("w4a16_matmul", "w4a16_a8b_matmul", "w8a8_matmul",
            "prefill_attention")
    check_launched(results, {
        f"{label} dense": base + ("flash_decode_attention",),
        f"{label} paged": base + ("paged_decode_attention",),
        f"{label} greedy_generate": base + ("decode_attention",)})
    return results


def ptq_arm_fp8(dense, extra, config, requests, path, device="cuda"):
    """Arm B: FP8_DYNAMIC on every linear and the lm_head with an fp8
    per-tensor static kv_cache_scheme (BASELINE config 3's recipe) over 4
    layers: the k/v scales calibrated (``calibrate_kv_scales``, each row
    up to its length) from the post-RoPE K/V rows that 64 prompts of 128
    tokens leave in a bf16 cache of the dense model, equal bit for bit to
    the CPU's from the same rows; saved beside the weights, loaded, and
    the first-token and decode-step logits on the fp8 cache held to the
    depth rule at 1 and 4 layers against the QDQ model on a bf16 cache
    (k/v scales / 16, which saturate the cache, must fail it); greedy on
    the fp8 cache through B3 fp8 and the scaled decode kernel."""
    import torch

    from compressed_tensors_tpu_torch.modeling import attention
    from compressed_tensors_tpu_torch.models.llama import (
        init_kv_cache,
        llama_forward,
    )

    label = "ptq fp8"
    modules, qconfig, states = ptq_calibrate(dense, PTQ_FP8, config, device)
    plain = ptq_params(dense, extra, config, lambda n: dense_qt(dense[n]))
    B, S = PTQ_CALIB
    gen = np.random.default_rng(2)
    ids = torch.from_numpy(gen.integers(0, config.vocab_size, (B, S))).to(
        device)
    cache = init_kv_cache(config, B, S, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = llama_forward(plain, config, ids,
                             torch.arange(S, device=device)[None].expand(B, S),
                             cache, fresh_prefill=True, last_logit_only=True)
    kv = {}
    for i in range(config.num_hidden_layers):
        rows = (cache.k[i].transpose(1, 2), cache.v[i].transpose(1, 2))
        card_state = attention.calibrate_kv_scales(
            attention.initialize_hooked_kv_cache(qconfig.kv_cache_scheme,
                                                 device=device),
            *rows, lengths=cache.lengths)
        cpu_state = attention.calibrate_kv_scales(
            attention.initialize_hooked_kv_cache(qconfig.kv_cache_scheme,
                                                 device="cpu"),
            *(r.cpu() for r in rows), lengths=cache.lengths.cpu())
        for key in ("k_scale", "v_scale"):
            if not same_bits(getattr(card_state, key),
                             getattr(cpu_state, key)):
                raise AssertionError(f"{label} layer {i} {key}: card "
                                     "and CPU calibrations differ")
            kv[f"model.layers.{i}.self_attn.{key}"] = getattr(card_state,
                                                              key)
    torch.cuda.synchronize()
    log(f"{label}: k/v scales of {config.num_hidden_layers} layers "
        f"calibrated from {B} x {S}-token prompts in "
        f"{time.perf_counter() - t0:.2f} s, equal to the CPU's bit for bit: "
        + ", ".join(f"{k.split('.')[2]}.{k[-7:]} {float(v):.4g}"
                    for k, v in kv.items()))
    del cache, plain
    shards = ptq_save(path, dense, {**extra, **kv}, states, modules, qconfig,
                      config, label, device)
    params = ptq_load(path, config, label, device)
    kinds = {qt.kernel_meta[0] for layer in params["layers"]
             for qt in layer.values() if getattr(qt, "kernel_meta", None)}
    if kinds != {"w8a8"} or params["lm_head"].kernel_meta[0] != "w8a8":
        raise AssertionError(f"{label}: kernel layouts {kinds}")
    # the reference's linears in f32 (``exact_qdq``): at bf16 the QDQ
    # product's rounding (2^-9) flips fp8 activation codes downstream, and
    # a random fp8 model spreads each flip (phase 6)
    exact = {n: exact_qdq(states[n], w) for n, w in dense.items()
             if n in states}
    ref_linears = {n: dense_qt(w) for n, (w, _) in exact.items()}
    ref = ptq_params(dense, extra, config, ref_linears.__getitem__)
    qdq = {id(qt): exact[n][1] for n, qt in ref_linears.items()}
    _, prompt, _ = probe_request(requests)
    steps = requests[1][1][:PTQ_STEPS]

    def logits(depth, test, check=True):
        if test:
            return ptq_logits(params, config, prompt, depth, True, steps,
                              cache_dtype=torch.float8_e4m3fn, device=device,
                              check=check)
        # attention through the same kernels on a bf16 cache: the
        # non-kernel attention's other summation order flips fp8
        # activation codes downstream as well
        with qdq_linears(qdq):
            return ptq_logits(ref, config, prompt, depth, True, steps,
                              device=device)

    ptq_depth_rule(f"{label} ({shards} shards)", PTQ_FEW, logits,
                   lambda: one_ulp(ref["embed_tokens"],
                                   prompt[len(prompt) // 3]),
                   kv_scales_times(params, 1 / 16),
                   "k/v scales / 16: values past the fp8 range",
                   views={" first-token logits": lambda t: t[:1],
                          " decode-step logits": lambda t: t[1:]},
                   rule=fp8_rule_failures)
    results = {f"{label} greedy_generate": greedy_8b(
        params, config, label, cache_dtype=torch.float8_e4m3fn)}
    check_launched(results, {f"{label} greedy_generate": (
        "w8a8_matmul_fp8", "prefill_attention", "decode_attention_scaled")})
    return results


def ptq_arm_mxfp4(dense, extra, config, requests, path, device="cuda"):
    """Arm C: MXFP4A16 (E8M0 group-32 scales from ``calculate_qparams``' MX
    branch) on every decoder linear, a bf16 lm_head, over 4 layers: saved
    through the MXFP4 codec, loaded (B8's fp4 layout), the first-token
    logits held to the depth rule at 1 and 4 layers against the QDQ
    model (group scales rolled by one group must fail it), greedy through
    B8."""
    label = "ptq mxfp4"
    modules, qconfig, states = ptq_calibrate(dense, PTQ_MXFP4, config, device)
    shards = ptq_save(path, dense, extra, states, modules, qconfig, config,
                      label, device)
    params = ptq_load(path, config, label, device)
    kinds = {qt.kernel_meta[0] for layer in params["layers"]
             for qt in layer.values() if getattr(qt, "kernel_meta", None)}
    if kinds != {"fp4"}:
        raise AssertionError(f"{label}: kernel layouts {kinds}")
    qdq = {n: dense_qt(qdq_weight(states[n], dense[n])) if n in states
           else dense_qt(dense[n]) for n in dense}
    ref = ptq_params(dense, extra, config, qdq.__getitem__)
    _, prompt, _ = probe_request(requests)

    def logits(depth, test, check=True):
        return ptq_logits(params if test else ref, config, prompt, depth,
                          test, device=device, check=check)

    ptq_depth_rule(f"{label} ({shards} shards) first-token logits", PTQ_FEW,
                   logits, lambda: one_ulp(ref["embed_tokens"],
                                           prompt[len(prompt) // 3]),
                   rolled_group_scales(params, ("fp4",)),
                   "group scales rolled by one group")
    results = {f"{label} greedy_generate": greedy_8b(params, config, label)}
    check_launched(results, {f"{label} greedy_generate": (
        "w4a16_fp4_matmul", "prefill_attention", "decode_attention")})
    return results


def phase_ptq():
    """Phase 16: the PTQ lifecycle and save path on the card. A dense bf16
    Llama-3-8B (meta-llama/Meta-Llama-3-8B's published config.json:
    hidden 4096, intermediate 14336, 32 layers, 32 heads over 8 KV heads
    of 128, vocab 128256) drawn on the card from seed 0
    (``ptq_dense_llama``), quantized, calibrated, compressed and saved
    through the lifecycle and ``ModelCompressor.save_checkpoint``, then
    served from its own checkpoint: arm A at full depth
    (``ptq_arm_w4``), arms B and C on its first 4 layers (``ptq_arm_fp8``,
    ``ptq_arm_mxfp4``). Every entry point at its default device, the
    card."""
    import torch

    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist_worker

    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # phase 16c's processes start now (torch, the group) and wait for the
    # files it writes
    dist_tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    os.mkdir(os.path.join(dist_tmp.name, "nccl"))
    ranks = {"nccl": torch_dist_worker.start(
                 "nccl", os.path.join(dist_tmp.name, "nccl"), 1, "cuda"),
             "compress-file": torch_dist_worker.start(
                 "compress-file", dist_tmp.name, 2, "cuda")}
    try:
        results = ptq_arms(config, dist_tmp.name, ranks)
    finally:
        for procs in ranks.values():
            torch_dist_worker.stop(procs)
        dist_tmp.cleanup()
    log(f"phase 16 (PTQ) wall {time.perf_counter() - t_phase:.1f} s "
        f"({card()})")
    return results


def ptq_arms(config, dist_tmp, ranks):
    """Phase 16's body: the model, arm A with phase 16b, phase 16c (on
    ``dist_tmp`` with its started ``ranks``), arms B and C."""
    import torch

    t0 = time.perf_counter()
    dense, extra = ptq_dense_llama(config, seed=0)
    torch.cuda.synchronize()
    log(f"dense bf16 Llama-3-8B drawn on the card from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(w.numel() for w in dense.values()) / 1e9:.3f} G parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    requests = serving_requests()
    results = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        results.update(ptq_arm_w4(dense, extra, config, requests,
                                  os.path.join(tmp, "w4a16")))
        phase_offload(os.path.join(tmp, "w4a16"), tmp)
    dense, extra = first_layers(dense, 4), first_layers(extra, 4)
    config = dataclasses.replace(config, num_hidden_layers=4)
    torch.cuda.empty_cache()
    phase_distributed(dense, config, dist_tmp, ranks)
    for arm, name in ((ptq_arm_fp8, "fp8"), (ptq_arm_mxfp4, "mxfp4")):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as tmp:
            results.update(arm(dense, extra, config, requests,
                               os.path.join(tmp, name)))
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------- #
# phases 16b-16c: offload and distributed, on phase 16's model

OFFLOAD_BUDGET = 3 * 1024**3   # the device budget of the offload plan
SPAWN_SECONDS = 300            # each spawned rank's time limit


def checkpoint_modules(path):
    """({module: bytes} in checkpoint order, {tensor name: shard path}) of
    a checkpoint, from its shards' headers."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        CheckpointReader,
        SafetensorsFile,
    )

    reader = CheckpointReader(path)
    headers = {f: SafetensorsFile(os.path.join(path, f)).header
               for f in set(reader.weight_map.values())}
    sizes, where = {}, {}
    for name, f in reader.weight_map.items():
        module = CheckpointReader.split(name)[0]
        start, end = headers[f][name]["data_offsets"]
        sizes[module] = sizes.get(module, 0) + end - start
        where[name] = os.path.join(path, f)
    return sizes, where


def phase_offload(path, tmp):
    """Phase 16b: the offload layer (ROADMAP A8a) on arm A's full-depth
    W4A16 Llama-3-8B checkpoint (``path``, 5.18 GB): ``get_device_map``
    on the card's free memory, then ``dispatch_plan`` with a device budget
    of ``OFFLOAD_BUDGET`` (the trailing modules planned to the host, -1);
    ``stream_modules`` under that plan, every tensor equal to
    ``CheckpointReader``'s byte for byte and on its planned device; the
    host-planned tensors through a pinned ``HostCache`` and through a
    ``DiskCache`` that adopts them from their shards (links, no copy),
    each onloaded onto the card byte for byte, with its GB/s (warm reads:
    the checkpoint was just written and read); one ``DiskCache`` entry
    updated (its link broken, the shard untouched) and
    ``save_checkpoint`` linking the clean entries to the shards."""
    import torch

    from compressed_tensors_tpu_torch.offload import (
        DiskCache,
        HostCache,
        dispatch_plan,
        stream_modules,
    )
    from compressed_tensors_tpu_torch.offload.dispatch import get_device_map
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        CheckpointReader,
    )

    t_phase = time.perf_counter()
    sizes, where = checkpoint_modules(path)
    live = get_device_map(sizes)
    plan = dispatch_plan(sizes, [OFFLOAD_BUDGET])
    host = [m for m in sizes if plan[m] < 0]     # in checkpoint order
    host_bytes = sum(sizes[m] for m in host)
    log(f"offload plan of the PTQ 8B checkpoint ({len(sizes)} modules, "
        f"{sum(sizes.values()) / 1e9:.3f} GB): get_device_map on the card's "
        f"free memory puts {sum(d == 0 for d in live.values())} on device 0 "
        f"and {sum(d < 0 for d in live.values())} on the host; "
        f"dispatch_plan with {OFFLOAD_BUDGET / 2**30:.0f} GiB puts "
        f"{len(plan) - len(host)} on device 0 and {len(host)} "
        f"({host_bytes / 1e9:.3f} GB, from {host[0] if host else None}) on "
        "the host (-1)")
    if not host or len(host) == len(plan):
        raise AssertionError("the offload plan must split the checkpoint "
                             "between the card and the host")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = dict(stream_modules(path, plan))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    if list(streamed) != list(sizes):
        raise AssertionError("stream_modules: modules out of checkpoint order")
    reader = CheckpointReader(path)
    try:
        for module, state in streamed.items():
            want = reader.module_state_dict(module)
            device = "cpu" if plan[module] < 0 else "cuda"
            if list(state) != list(want) or any(
                    t.device.type != device or not same_bits(t, want[k])
                    for k, t in state.items()):
                raise AssertionError(f"stream_modules: {module} differs from "
                                     f"CheckpointReader's or is not on "
                                     f"{device}")
    finally:
        reader.close()
    log(f"stream_modules: {sum(sizes.values()) / 1e9:.3f} GB in "
        f"{stream_s:.2f} s ({sum(sizes.values()) / 1e9 / stream_s:.2f} "
        "GB/s, warm reads), every tensor equal to CheckpointReader's byte "
        "for byte and on its planned device")

    tensors = {f"{m}.{k}": t for m in host for k, t in streamed[m].items()}
    del streamed
    torch.cuda.empty_cache()

    def onload(cache, label):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = {n: cache[n] for n in cache}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        bad = [n for n, v in out.items() if v.device.type != "cuda"
               or not same_bits(v, tensors[n])]
        log(f"{label}: {len(out)} tensors of the host-planned modules "
            f"({host_bytes / 1e9:.3f} GB) onloaded onto the card in "
            f"{seconds:.3f} s ({host_bytes / 1e9 / seconds:.2f} GB/s, warm), "
            f"{len(out) - len(bad)} equal byte for byte ({card()})")
        if bad:
            raise AssertionError(f"{label}: onloaded tensors differ: "
                                 f"{bad[:4]}")
        return out

    hc = HostCache()
    t = time.perf_counter()
    for n, v in tensors.items():
        hc[n] = v
    log(f"HostCache: offloaded into pinned host memory in "
        f"{time.perf_counter() - t:.3f} s "
        f"(pinned: {all(v.is_pinned() for v in hc._store.values())})")
    onload(hc, "HostCache (pinned)")
    del hc
    dc = DiskCache(os.path.join(tmp, "disk_cache"))
    for n in tensors:
        dc.adopt(n, where[n], n)
    if not all(dc.is_adopted(n) for n in tensors):
        raise AssertionError("DiskCache: adopted entries are not links")
    on = onload(dc, "DiskCache (adopted from the shards)")
    first = next(iter(tensors))
    shard = where[first]
    stat = os.stat(shard)
    dc[first] = on[first]
    if dc.is_adopted(first) or not same_bits(dc[first], tensors[first]) \
            or os.stat(shard).st_mtime_ns != stat.st_mtime_ns:
        raise AssertionError("DiskCache: an update must break the link and "
                             "leave the shard")
    saved = dc.save_checkpoint(os.path.join(tmp, "disk_saved"))
    links = [n for n, f in saved.items() if os.path.islink(f)]
    if sorted(links) != sorted(set(tensors) - {first}) or not all(
            os.path.samefile(saved[n], where[n]) for n in links):
        raise AssertionError("DiskCache.save_checkpoint: the clean entries "
                             "must link to their shards")
    log(f"DiskCache: update of {first} broke its link (shard unchanged); "
        f"save_checkpoint linked {len(links)} clean entries to their shards "
        f"and wrote 1")
    del on, dc, tensors
    torch.cuda.empty_cache()
    log(f"phase 16b (offload) wall {time.perf_counter() - t_phase:.1f} s "
        f"({card()})")


def phase_distributed(dense, config, tmp, ranks):
    """Phase 16c: the distributed layer (ROADMAP A8b) on the calibrated
    states of the PTQ model's first 4 layers (28 W4A16 linears, arm A's
    recipe): ``compress_state_parallel`` over 2 processes on the one card
    (``tests/torch_dist_worker.py``, the tests' two-process harness, case
    "compress-file"; ``init_dist`` with gloo, which carries the object
    broadcast; NCCL takes one rank a card, and this machine has one), its
    recoupled state on each rank equal to this process's single-process
    ``compress_state`` byte for byte, each rank's time printed; and, in a
    process of its own run beside them, ``init_dist`` on NCCL at world
    size 1 (case "nccl"), an all-reduce, and the group torn down. No NCCL collective across cards
    runs here. The processes (``ranks``: case -> its processes) started
    at phase 16's start; the gloo ranks wait for the files this writes
    under ``tmp``, the recipe last."""
    import torch

    from compressed_tensors_tpu_torch.compressors import (
        ModelCompressor,
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        load_safetensors,
        save_safetensors,
    )

    import torch_dist_worker

    t_phase = time.perf_counter()
    names = [n for n in dense if n.startswith("model.layers.")]
    _, qconfig, states = ptq_calibrate({n: dense[n] for n in names}, PTQ_W4,
                                       config)
    module_states = {n: {"weight": dense[n], **states[n].qparams}
                     for n in names}
    modules = module_graph_from_names(names)
    qjson = qconfig.model_dump(mode="json")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ModelCompressor(quantization_config=qconfig).compress_state(
        module_states, modules)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for s in module_states.values()
                 for t in s.values())
    save_safetensors(os.path.join(tmp, "states.safetensors"),
                     {f"{m}.{k}": t for m, s in module_states.items()
                      for k, t in s.items()})
    with open(os.path.join(tmp, "quantization_config.tmp"), "w") as f:
        json.dump(qjson, f)
    os.replace(os.path.join(tmp, "quantization_config.tmp"),
               os.path.join(tmp, "quantization_config.json"))
    reports = torch_dist_worker.finish("compress-file", ranks["compress-file"],
                                       tmp, SPAWN_SECONDS)
    nccl = torch_dist_worker.finish("nccl", ranks["nccl"],
                                    os.path.join(tmp, "nccl"),
                                    SPAWN_SECONDS)[0]
    flat = {f"{m}.{k}": t for m, s in ref.items() for k, t in s.items()}
    for r in reports:
        got = load_safetensors(os.path.join(tmp, f"rank{r['rank']}"
                                                 ".safetensors"))
        bad = sorted(set(flat) ^ set(got)) or [
            n for n, t in flat.items() if not same_bits(t, got[n])]
        if bad:
            raise AssertionError(f"compress_state_parallel rank "
                                 f"{r['rank']}: differs from "
                                 f"compress_state in {bad[:4]}")
    log(f"compress_state_parallel over 2 processes on the one card "
        f"(gloo), {len(names)} linears of 4 layers "
        f"({nbytes / 1e9:.3f} GB of calibrated states): "
        + "; ".join(f"rank {r['rank']} owns {r['owned']} modules "
                    f"({r['owned_bytes'] / 1e9:.3f} GB), compressed and "
                    f"recoupled in {r['seconds']:.3f} s"
                    for r in reports)
        + f"; single-process compress_state {single_s:.3f} s; both "
        f"ranks' full states equal it byte for byte ({card()})")
    log(f"init_dist on NCCL at world size 1: backend {nccl['backend']}, "
        f"all-reduce {nccl['all_reduce']}, group down "
        f"{not nccl['initialized_after']}; no NCCL collective across cards "
        "was run (one card)")
    if nccl["backend"] != "nccl" or nccl["all_reduce"] != 1.0 \
            or nccl["initialized_after"]:
        raise AssertionError(f"init_dist on NCCL: {nccl}")
    log(f"phase 16c (distributed) wall {time.perf_counter() - t_phase:.1f} s "
        f"({card()})")


# --------------------------------------------------------------------------- #
# phase 17: transforms (SpinQuant-style rotations) on the card

# the non-power-of-two widths of the model families the port serves
HADAMARD_WIDTHS = {3584: "Qwen2.5-7B hidden", 18944: "Qwen2.5-7B intermediate",
                   11008: "Llama-2-7B intermediate",
                   14336: "Llama-3-8B intermediate"}
TOL_ROTATED = 1e-3        # max|rotated - unrotated| / max|unrotated|, f32
CONTROL_FACTOR = 10       # each control must exceed 10x TOL_ROTATED
ROT_PROMPTS = 8           # the function check's prompts (requests 0-7)


def spinquant_config(head_dim, lm_head_inverse=True, r2_partner=True):
    """SpinQuant's R1 + R2 as llm-compressor writes them, as a dict for
    ``TransformConfig``: R1 (random Hadamard at the hidden width) at the
    embedding's, o_proj's and down_proj's outputs and, inverted, at the
    inputs of q/k/v/gate/up_proj and the lm_head; R2 (random Hadamard of
    ``head_dim``, per head) at v_proj's output and, inverted, o_proj's
    input. The controls leave out the lm_head's ``inverse``
    (``lm_head_inverse=False``) or R2's o_proj partner
    (``r2_partner=False``)."""
    r1_in = ["re:.*q_proj$", "re:.*k_proj$", "re:.*v_proj$",
             "re:.*gate_proj$", "re:.*up_proj$"]
    r1 = [{"targets": ["re:.*embed_tokens$", "re:.*o_proj$",
                       "re:.*down_proj$"], "location": "weight_output"},
          {"targets": r1_in + (["lm_head"] if lm_head_inverse else []),
           "location": "weight_input", "inverse": True}]
    if not lm_head_inverse:
        r1.append({"targets": ["lm_head"], "location": "weight_input"})
    r2 = [{"targets": ["re:.*v_proj$"], "location": "weight_output"}]
    if r2_partner:
        r2.append({"targets": ["re:.*o_proj$"], "location": "weight_input",
                   "inverse": True})
    return {"config_groups": {
        "R1": {"type": "random-hadamard", "apply": r1},
        "R2": {"type": "random-hadamard", "head_dim": head_dim,
               "apply": r2}}}


def hadamard_widths_on_card():
    """Check 1: ``hadamard_matrix`` at each of ``HADAMARD_WIDTHS`` on the
    card in float64, H H^T = n I exactly (integer entries: every product
    and partial sum is exact in float64)."""
    import torch

    from compressed_tensors_tpu_torch.transform import hadamard_matrix
    from compressed_tensors_tpu_torch.transform.hadamard import (
        hadamard_construction,
    )

    for n, what in HADAMARD_WIDTHS.items():
        t0 = time.perf_counter()
        how = hadamard_construction(n)  # builds (and caches) the host base
        t_host = time.perf_counter() - t0
        H = hadamard_matrix(n, device="cuda")
        prod = H @ H.T
        prod.diagonal().sub_(n)
        off = int(prod.count_nonzero())
        torch.cuda.synchronize()
        log(f"transforms: hadamard_matrix({n}) ({what}): {how}; host base "
            f"{t_host:.2f} s, on the card {time.perf_counter() - t0 - t_host:.2f}"
            f" s; H H^T - {n} I in float64 has {off} nonzero entries "
            f"({card()})")
        del H, prod
        torch.cuda.empty_cache()
        if off:
            raise AssertionError(f"hadamard_matrix({n}) is not Hadamard")


def fuse_one_by_one(weights, modules, config, dtype):
    """``apply_transform_config`` module by module on ``dtype`` copies of
    ``weights`` (each copy dropped once fused), so that the copies of the
    whole model are never alive twice."""
    from compressed_tensors_tpu_torch.transform import (
        TransformConfig,
        apply_transform_config,
    )

    tconfig = TransformConfig.model_validate(config)
    out = {}
    for name, w in weights.items():
        fused, online = apply_transform_config(
            {name: {"weight": w.to(dtype)}}, {name: modules[name]}, tconfig)
        if online:
            raise AssertionError(f"online transforms for {name}")
        out[name] = fused[name]["weight"]
    return out


def rotation_function_check(dense, extra, config, requests):
    """Check 3: the SpinQuant config fused into float32 copies of the
    model computes the unrotated float32 model's function: the first-token
    logits of ``ROT_PROMPTS`` prompts through the non-kernel path (f32
    cache; TF32 off) at 1 and all layers within TOL_ROTATED of max|ref|;
    each control (the lm_head entry without ``inverse``; R2 on v_proj
    without its o_proj partner) must exceed CONTROL_FACTOR times that at
    both depths. One float32 model is alive at a time."""
    import torch

    from compressed_tensors_tpu_torch.compressors import (
        module_graph_from_names,
    )

    depths = (1, config.num_hidden_layers)
    prompts = [ids for _, ids, _ in requests[:ROT_PROMPTS]]
    modules = module_graph_from_names(list(dense))
    extra32 = {k: v.float() for k, v in extra.items()}
    head_dim = config.head_dim
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def logits(weights):
        params = ptq_params(weights, extra32, config,
                            lambda n: dense_qt(weights[n]))
        return {d: torch.stack([ptq_logits(
            params, config, ids, d, False, cache_dtype=torch.float32,
            label="rotation check")[0] for ids in prompts])
            for d in depths}

    def reading(got, ref):
        return {d: ((got[d] - ref[d]).abs().max().item()
                    / ref[d].abs().max().item()) for d in depths}

    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = logits({n: w.float() for n, w in dense.items()})
        torch.cuda.empty_cache()
        rotated = fuse_one_by_one(dense, modules, spinquant_config(head_dim),
                                  torch.float32)
        torch.cuda.synchronize()
        t_fuse = time.perf_counter() - t0
        got = reading(logits(rotated), ref)
        controls = {}
        for what, cfg, names in (
                ("the lm_head entry without inverse",
                 spinquant_config(head_dim, lm_head_inverse=False),
                 ["lm_head"]),
                ("R2 on v_proj without its o_proj partner",
                 spinquant_config(head_dim, r2_partner=False),
                 [n for n in dense if n.endswith("o_proj")])):
            kept = {n: rotated[n] for n in names}
            rotated.update(fuse_one_by_one({n: dense[n] for n in names},
                                           modules, cfg, torch.float32))
            controls[what] = reading(logits(rotated), ref)
            rotated.update(kept)
        del rotated
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.empty_cache()
    log("transforms float32 function check (TF32 off, non-kernel path, "
        f"f32 cache, {len(prompts)} prompts): max|rotated - unrotated| / "
        "max|unrotated| " + ", ".join(f"{d} layers {e:.3g}"
                                      for d, e in got.items())
        + f" (limit {TOL_ROTATED}); controls: " + "; ".join(
            f"{what}: " + ", ".join(f"{d} layers {e:.3g}" for d, e in r.items())
            for what, r in controls.items())
        + f" (each must exceed {CONTROL_FACTOR * TOL_ROTATED}); "
        f"{time.perf_counter() - t0:.1f} s (fusions {t_fuse:.1f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card()})")
    if any(e > TOL_ROTATED for e in got.values()):
        raise AssertionError("the rotated float32 model does not compute the "
                             f"unrotated one's function: {got}")
    for what, r in controls.items():
        if any(e <= CONTROL_FACTOR * TOL_ROTATED for e in r.values()):
            raise AssertionError(f"the function check accepted the control "
                                 f"({what}): {r}")


def ulps_apart(a, b):
    """Elements of ``a`` and ``b`` (bf16 or f32, one dtype) more than one
    ulp of their dtype apart, and the count that differ at all."""
    import torch

    fa, fb = a.float(), b.float()
    m = torch.maximum(fa.abs(), fb.abs())
    ulp = torch.ldexp(torch.full_like(m, torch.finfo(a.dtype).eps),
                      torch.frexp(m).exponent - 1)
    diff = (fa - fb).abs()
    return int((diff > ulp).sum()), int((diff > 0).sum())


def rotation_card_vs_cpu(dense, rotated, modules, tconfig, names):
    """Check 2: the named modules fused again on the CPU from the same bf16
    weights (float64 on the host's BLAS): within one bf16 ulp of the
    card's; the count of differing elements printed. The CPU's fusion
    runs in a thread beside the phase's work on the card (its BLAS
    releases the interpreter lock); the returned function waits for it
    and checks."""
    import threading

    from compressed_tensors_tpu_torch.transform import apply_transform_config

    weights = {n: {"weight": dense[n].cpu()} for n in names}
    rotated = {n: rotated[n].cpu() for n in names}
    done = {}

    def fuse():
        t0 = time.perf_counter()
        try:
            done["cpu"], _ = apply_transform_config(
                weights, {n: modules[n] for n in names}, tconfig)
        except BaseException as e:  # raised again by check()
            done["error"] = e
        done["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=fuse, daemon=True)
    thread.start()

    def check():
        thread.join()
        if "error" in done:
            raise done["error"]
        rotation_cpu_check(rotated, done["cpu"], names, done["seconds"])

    return check


def rotation_cpu_check(rotated, cpu, names, seconds):
    """Check 2's comparison (``rotation_card_vs_cpu``)."""
    readings = []
    for n in names:
        bad, differ = ulps_apart(rotated[n], cpu[n]["weight"])
        readings.append(f"{n.split('.')[-1]} {differ}")
        if bad:
            raise AssertionError(f"transforms {n}: {bad} elements more than "
                                 "one bf16 ulp from the CPU's fusion")
    log(f"transforms: {len(names)} modules fused again on the CPU in "
        f"{seconds:.1f} s (beside the card's work): every element within one "
        f"bf16 ulp of the card's; "
        f"elements that differ: {', '.join(readings)}")


def rel_rms_readings(label, logits, refs):
    """Relative RMS of first-token logits against the dense model's, over
    the prompts together."""
    err = rel_rms(logits, refs)
    log(f"transforms {label}: first-token logits of {len(logits)} prompts "
        f"at full depth, relative RMS against the dense bf16 model {err:.4g}"
        f"; argmax agreeing in {int((logits.argmax(-1) == refs.argmax(-1)).sum())}"
        f" of {len(logits)} (read, no limit)")
    return err


def phase_transforms():
    """Phase 17: transforms. A dense bf16 Llama-3-8B
    (meta-llama/Meta-Llama-3-8B's published config.json) drawn on the card
    from seed 0 (``ptq_dense_llama``: its norm weights are ones, as a
    residual rotation needs: folding trained norm weights into the next
    linears is the producer's job, done by neither package), rotated by
    SpinQuant's R1 + R2 (``spinquant_config``) fused in float64 on the
    card: check 1 the Hadamard constructions at real widths; check 3 the
    function kept in float32 with two controls; check 2 the card's
    fusion against the CPU's; checks 4-6 the rotated model quantized to
    W4A16 g128 with a W8A8-int lm_head by phase 16's arm A recipe, saved
    with its transform_config, loaded, held to its QDQ model by depth and
    served (``ptq_arm_w4``); check 7 the first-token logits against the
    dense model, rotated and unrotated W4A16 (read); check 8 a copy of the
    checkpoint with an online transform refused at load; check 9 the
    checkpoint dequantized by ``CompressedTensorsDequantizer`` on the card
    against the CPU (``ct_dequantizer``)."""
    import torch

    from compressed_tensors_tpu_torch.compressors import (
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.transform import (
        TransformConfig,
        apply_transform_config,
    )

    config = LLAMA3_8B
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    hadamard_widths_on_card()
    dense, extra = ptq_dense_llama(config, seed=0)
    requests = serving_requests(config.vocab_size)
    rotation_function_check(dense, extra, config, requests)

    prompts = [ids for _, ids, _ in requests[:ROT_PROMPTS]]
    L = config.num_hidden_layers

    def first_tokens(params):
        return torch.stack([ptq_logits(params, config, ids, L, True,
                                       label="transforms")[0]
                            for ids in prompts])

    ref = first_tokens(ptq_params(dense, extra, config,
                                  lambda n: dense_qt(dense[n])))
    readings = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        modules, qconfig, states = ptq_calibrate(dense, PTQ_W4, config)
        ptq_save(tmp, dense, extra, states, modules, qconfig, config,
                 "unrotated w4a16")
        del states
        params = ptq_load(tmp, config, "unrotated w4a16")
        readings["unrotated W4A16"] = rel_rms_readings(
            "unrotated W4A16", first_tokens(params), ref)
        del params
    torch.cuda.empty_cache()

    tconfig = TransformConfig.model_validate(spinquant_config(config.head_dim))
    modules = module_graph_from_names(list(dense))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fused, online = apply_transform_config(
        {n: {"weight": w} for n, w in dense.items()}, modules, tconfig)
    torch.cuda.synchronize()
    log(f"transforms: R1 + R2 fused into the bf16 Llama-3-8B "
        f"({len(dense)} modules) in float64 on the card in "
        f"{time.perf_counter() - t0:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above "
        f"the dense model) ({card()})")
    if online:
        raise AssertionError(f"online transforms: {sorted(online)}")
    rotated = {n: s["weight"] for n, s in fused.items()}
    del fused
    if any(torch.equal(rotated[n], dense[n]) for n in dense):
        raise AssertionError("a module came out of the fusion unchanged")
    check_cpu_fusion = rotation_card_vs_cpu(
        dense, rotated, modules, tconfig,
        [f"model.layers.0.{sub}.{name}"
         for name, sub in PTQ_SUBMODULE.items()] + ["lm_head"])
    del dense
    torch.cuda.empty_cache()

    def served_logits(params):
        readings["rotated W4A16"] = rel_rms_readings(
            "rotated W4A16 (served from its checkpoint)",
            first_tokens(params), ref)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "rotated")
        results = ptq_arm_w4(rotated, extra, config, requests, path,
                             label="rotated w4a16", transform_config=tconfig,
                             after=served_logits)
        refused = os.path.join(tmp, "online")
        os.makedirs(refused)
        for fname in os.listdir(path):
            if fname != "config.json":
                os.symlink(os.path.join(path, fname),
                           os.path.join(refused, fname))
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        cfg["quantization_config"]["transform_config"]["config_groups"][
            "R4"] = {"type": "hadamard", "apply": [
                {"targets": ["re:.*down_proj$"], "location": "input"}]}
        with open(os.path.join(refused, "config.json"), "w") as f:
            json.dump(cfg, f)
        try:
            load_llama_params(refused)
        except NotImplementedError as e:
            log(f"transforms: the checkpoint with an online (input) R4 entry "
                f"added is refused by load_llama_params: {e}")
        else:
            raise AssertionError("a checkpoint with an online transform "
                                 "loaded")
        ct_dequantizer(path, tmp)
    del rotated
    torch.cuda.empty_cache()
    check_cpu_fusion()
    log("transforms: first-token logits' relative RMS against the dense "
        "bf16 model: " + ", ".join(f"{k} {v:.4g}"
                                   for k, v in readings.items())
        + " (read, no limit: the draw is Gaussian, without outlier channels)")
    log(f"phase 17 (transforms) wall {time.perf_counter() - t_phase:.1f} s "
        f"({card()})")
    return results


PART = ("model.layers.0.", "lm_head")   # the part dequantized on the CPU


def ct_dequantizer(path, tmp):
    """Phase 17, check 9: ``CompressedTensorsDequantizer`` by
    ``convert_checkpoint`` over the rotated W4A16 checkpoint at ``path``
    (no linear biases) on the card, and over a copy of its layer 0 and
    lm_head on the CPU: every bf16 weight dequantized, the CPU's tensors
    equal the card's files byte for byte. The dense files (about 16 GB)
    go under ``tmp`` and are removed at once. The lm_head's weight and
    scale must lie in one shard: the reference's ``get_dependencies``
    pulls in no partner of a later scheme's module (ROADMAP, reference
    caveats)."""
    import torch

    from compressed_tensors_tpu_torch.entrypoints.convert import (
        CompressedTensorsDequantizer,
        convert_checkpoint,
    )
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        CheckpointReader,
    )

    src = read_checkpoint(path)
    quantized = {n.rpartition(".")[0] for n in src
                 if n.endswith((".weight_packed", ".weight_scale"))}
    part = {n: t for n, t in src.items() if n.startswith(PART)}
    del src
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    dst, part_dir, part_dst = (os.path.join(tmp, d) for d in (
        "dequantized", "part", "part_dequantized"))
    write_shards(part_dir, part, cfg, shards=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    convert_checkpoint(path, dst, CompressedTensorsDequantizer.from_pretrained(
        path), max_workers=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_checkpoint(part_dir, part_dst,
                       CompressedTensorsDequantizer.from_pretrained(
                           part_dir, device="cpu"))
    t_cpu = time.perf_counter() - t0
    want = read_checkpoint(part_dst)
    reader = CheckpointReader(dst)
    try:
        names = set(reader.tensor_names())
        nbytes = sum(os.path.getsize(os.path.join(dst, f))
                     for f in os.listdir(dst) if f.endswith(".safetensors"))
        dense = {m for m in quantized if f"{m}.weight" in names}
        leftover = sorted(n for n in names if not n.endswith(".weight")
                          and n.rpartition(".")[0] in quantized)
        differ = [n for n, t in want.items()
                  if n not in names or not same_bits(reader.get(n), t)]
    finally:
        reader.close()
    shutil.rmtree(dst)
    log(f"transforms: CompressedTensorsDequantizer over the rotated "
        f"checkpoint by convert_checkpoint on the card in {seconds:.2f} s "
        f"({nbytes / 1e9:.3f} GB of bf16 written, {nbytes / 1e9 / seconds:.2f}"
        f" GB/s; {card()}): {len(dense)} of {len(quantized)} quantized "
        f"modules dequantized; layer 0 and the lm_head on the CPU in {t_cpu:.2f} s: "
        f"{len(want) - len(differ)} of {len(want)} tensors equal the card's "
        "byte for byte")
    part_dense = [m for m in quantized if m.startswith(PART)
                  and want.get(f"{m}.weight", torch.empty(0)).dtype
                  == torch.bfloat16]
    if len(quantized) != 7 * cfg["num_hidden_layers"] + 1 \
            or dense != quantized or leftover or len(part_dense) != 7 + 1:
        raise AssertionError(f"CompressedTensorsDequantizer: {len(dense)} of "
                             f"{len(quantized)} modules dequantized on the "
                             f"card ({leftover[:5]} left), {len(part_dense)} "
                             "of 8 on the CPU")
    if differ:
        raise AssertionError(f"CompressedTensorsDequantizer: the card's "
                             f"files differ from the CPU's in {differ[:5]}")


# --------------------------------------------------------------------------- #
# phase 18: converters on the card

CONVERT_LAYERS = 4
# Qwen/Qwen2.5-7B-Instruct-AWQ's published quantization_config
AWQ_CONFIG = {"quant_method": "awq", "bits": 4, "group_size": 128,
              "zero_point": True, "version": "gemm",
              "modules_to_not_convert": None}
# an NVIDIA ModelOpt NVFP4 checkpoint's hf_quant_config, as config.json
# names it (the converter reads none of it)
MODELOPT_CONFIG = {"quant_method": "modelopt", "quant_algo": "NVFP4",
                   "group_size": 16, "exclude_modules": ["lm_head"]}
MODELOPT_INPUT_SCALE = 0.0125   # each linear's input_scale (amax / 2688)
FP8_BLOCK = 128


def awq_words(u):
    """(R, C) unsigned 4-bit values -> (R, C/8) int32 AutoAWQ GEMM words,
    eight nibbles a word in AutoAWQ's order (the inverse of
    ``AutoAWQConverter.AWQ_REVERSE_ORDER``), on ``u``'s device."""
    import torch

    from compressed_tensors_tpu_torch.entrypoints.convert import (
        AutoAWQConverter,
    )

    order = torch.from_numpy(np.argsort(AutoAWQConverter.AWQ_REVERSE_ORDER)
                             ).to(u.device)
    r, c = u.shape
    v = u.reshape(r, c // 8, 8)[:, :, order].to(torch.int64)
    words = (v << (4 * torch.arange(8, device=u.device))).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def awq_qwen(config, seed):
    """An AutoAWQ-kind model drawn on the card as ``w4a16_llama`` draws its
    asymmetric one (random int32 words, zero points in [-8, 7], the qkv
    bias), with fp16 group scales in [1e-3, 3e-3] as AutoAWQ stores them,
    N(0, 0.02^2) bf16 embeddings and a dense bf16 lm_head (AutoAWQ leaves
    it unquantized). Returns (the unfused params, pack-quantized with the
    same codes: the twin; {tensor name: tensor} in AutoAWQ GEMM layout:
    qweight (K, N/8), qzeros (K/g, N/8), scales (K/g, N))."""
    import torch

    from compressed_tensors_tpu_torch.ops.linear import QuantizedTensor
    from compressed_tensors_tpu_torch.ops.pack import (
        pack_to_int32,
        unpack_from_int32,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scheme = preset_name_to_scheme("W4A16_ASYM", ["Linear"])
    scheme.format = "pack-quantized"
    g = scheme.weights.group_size
    H, V = config.hidden_size, config.vocab_size

    def bf16(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)

    ones = torch.ones((H,), dtype=torch.bfloat16, device="cuda")
    twin = {"embed_tokens": bf16(V, H), "norm": ones, "layers": []}
    awq = {"model.embed_tokens.weight": twin["embed_tokens"],
           "model.norm.weight": ones}
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}"
        layer = {"input_layernorm": ones, "post_attention_layernorm": ones}
        for norm in layer:
            awq[f"{p}.{norm}.weight"] = ones
        for name, (n, k) in linear_shapes(config).items():
            words = torch.randint(-(2**31), 2**31, (n, k // 8), generator=gen,
                                  device="cuda", dtype=torch.int32)
            zp = torch.randint(-8, 8, (n, k // g), generator=gen,
                               device="cuda", dtype=torch.int8)
            scale = (torch.rand((n, k // g), generator=gen, device="cuda")
                     * 2e-3 + 1e-3).to(torch.float16)
            bias = ((torch.randn((n,), generator=gen, device="cuda")
                     * QKV_BIAS_STD).to(torch.bfloat16)
                    if config.attention_bias
                    and name in ("q_proj", "k_proj", "v_proj") else None)
            layer[name] = QuantizedTensor(
                weight_packed=words, scale=scale,
                zero_point=pack_to_int32(zp, 4, packed_dim=0), bias=bias,
                shape=(n, k), scheme=scheme, format=scheme.format)
            q = unpack_from_int32(words, 4, (n, k))
            m = f"{p}.{PTQ_SUBMODULE[name]}.{name}"
            awq[f"{m}.qweight"] = awq_words((q.to(torch.int32) + 8).t())
            awq[f"{m}.qzeros"] = awq_words((zp.to(torch.int32) + 8).t())
            awq[f"{m}.scales"] = scale.t().contiguous()
            if bias is not None:
                awq[f"{m}.bias"] = bias
        twin["layers"].append(layer)
    twin["lm_head"] = dense_qt(bf16(V, H))
    awq["lm_head.weight"] = twin["lm_head"].weight
    return twin, awq


def write_shards(path, tensors, config_json, shards=2):
    """``tensors`` as ``shards`` safetensors files (split by tensor order)
    with an index, and ``config_json``; returns the bytes written."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        save_safetensors,
        update_safetensors_index,
    )

    os.makedirs(path, exist_ok=True)
    names = list(tensors)
    per = -(-len(names) // shards)
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[s * per:(s + 1) * per]}
        save_safetensors(os.path.join(path, fname), part,
                         metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(part, fname))
    update_safetensors_index(path, weight_map)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_json, f, indent=2)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in set(weight_map.values()))


def read_checkpoint(path):
    """Every tensor of a checkpoint directory, on the host."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        CheckpointReader,
    )

    reader = CheckpointReader(path)
    try:
        return {n: reader.get(n) for n in reader.tensor_names()}
    finally:
        reader.close()


def compare_to_twin(label, got, twin, loose=()):
    """The converted checkpoint's tensors against its twin's: the same
    names (``got`` may hold more), each equal bit for bit; ``weight_shape``
    by value (the converter writes int64, ``save_llama_checkpoint`` int32);
    names ending in one of ``loose`` within one f32 ulp, the differing
    count printed."""
    missing = sorted(set(twin) - set(got))
    if missing:
        raise AssertionError(f"{label}: converted checkpoint lacks "
                             f"{missing[:5]}")
    near, shapes = [0, 0], 0
    for name, t in twin.items():
        g = got[name]
        if name.endswith("weight_shape"):
            shapes += 1
            if g.tolist() != t.tolist():
                raise AssertionError(f"{label} {name}: {g.tolist()} != "
                                     f"{t.tolist()}")
        elif name.endswith(loose):
            if g.dtype != t.dtype:
                raise AssertionError(f"{label} {name}: {g.dtype} against the "
                                     f"twin's {t.dtype}")
            bad, differ = ulps_apart(g, t)
            near[0] += differ
            near[1] += t.numel()
            if bad:
                raise AssertionError(f"{label} {name}: more than one f32 ulp "
                                     "from the twin")
        elif not same_bits(g, t):
            raise AssertionError(f"{label} {name}: differs from the twin")
    extra = sorted({n.rpartition(".")[2] for n in set(got) - set(twin)})
    log(f"{label}: {len(twin)} tensors equal the twin's bit for bit"
        + (f" ({shapes} weight_shape by value: {got[next(n for n in twin if n.endswith('weight_shape'))].dtype} "
           f"against {next(t for n, t in twin.items() if n.endswith('weight_shape')).dtype})"
           if shapes else "")
        + (f", {', '.join(loose)} within one f32 ulp ({near[0]} of "
           f"{near[1]} elements differ)" if loose else "")
        + (f"; besides, the converted checkpoint holds {extra}" if extra
           else ""))


def converted_awq(requests):
    """Phase 18, part 1: an AutoAWQ GEMM checkpoint of Qwen2.5-7B's widths
    (Qwen/Qwen2.5-7B-Instruct-AWQ's config: 4 bits, group 128, zero
    points) at ``CONVERT_LAYERS`` layers, written from codes drawn on the
    card, converted by ``convert_checkpoint``; every tensor against the
    same codes written directly as pack-quantized (``save_llama_checkpoint``);
    greedy tokens at batch 64 of both under ``w4_layout`` "auto" (B1 with
    zero points) and "packed" (B10 int4); the 96 requests dense = paged;
    then ``CompressedTensorsDequantizer`` over the converted checkpoint:
    ``convert_checkpoint`` refuses its qkv biases as the JAX package does
    (phase 17 drives it end to end), and ``process`` is held against
    ``ModelCompressor.decompress_state``."""
    import torch

    from compressed_tensors_tpu_torch.compressors import ModelCompressor
    from compressed_tensors_tpu_torch.entrypoints.convert import (
        AutoAWQConverter,
        CompressedTensorsDequantizer,
        convert_checkpoint,
    )
    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.models.synthetic import (
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = LlamaConfig.from_dict(dict(QWEN25_7B,
                                        num_hidden_layers=CONVERT_LAYERS))
    label = "awq"
    results = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        twin, awq = awq_qwen(config, 0)
        twin_dir, src, dst = (os.path.join(tmp, d)
                              for d in ("twin", "awq", "converted"))
        save_llama_checkpoint(twin, config, twin_dir)
        del twin
        with open(os.path.join(twin_dir, "config.json")) as f:
            cfg = json.load(f)
        cfg["quantization_config"] = AWQ_CONFIG
        nbytes = write_shards(src, awq, cfg)
        del awq
        torch.cuda.empty_cache()
        converter = AutoAWQConverter.from_autoawq_config(AWQ_CONFIG)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convert_checkpoint(src, dst, converter, max_workers=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"{label}: convert_checkpoint of {nbytes / 1e9:.3f} GB in 2 "
            f"shards in {seconds:.2f} s ({nbytes / 1e9 / seconds:.2f} GB/s, "
            f"the read warm: just written; {card()})")
        compare_to_twin(f"{label} converted", read_checkpoint(dst),
                        read_checkpoint(twin_dir))
        tokens = {}
        for layout, kind in (("auto", "w4a16"), ("packed", "w4packed")):
            for which, path in (("converted", dst), ("twin", twin_dir)):
                with flag_overrides(w4_layout=layout):
                    t0 = time.perf_counter()
                    params, lcfg, _ = load_llama_params(path)
                    params = fuse_llama_layers(params)
                kinds = {qt.kernel_meta[0] for layer in params["layers"]
                         for qt in layer.values()
                         if getattr(qt, "kernel_meta", None)}
                if kinds != {kind} or lcfg != config:
                    raise AssertionError(f"{label} {which} {layout}: kernel "
                                         f"layouts {kinds}")
                run = f"{label} {which} {layout} greedy_generate"
                results[run] = greedy_8b(params, config,
                                         f"{label} {which} {layout}")
                tokens[which, layout] = results[run].pop("tokens")
                if which == "converted" and layout == "auto":
                    for paged in (False, True):
                        results[f"{label} {'paged' if paged else 'dense'}"] = \
                            serve_requests(params, config, requests,
                                           f"{label} converted "
                                           f"{'paged' if paged else 'dense'}",
                                           paged=paged,
                                           **({"prefix_caching": False}
                                              if paged else {}))
                del params
                torch.cuda.empty_cache()
            same = bool(torch.equal(tokens["converted", layout],
                                    tokens["twin", layout]))
            log(f"{label}: greedy tokens at batch {BATCH} under "
                f"w4_layout=\"{layout}\", converted vs twin: "
                f"{'identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"{label} {layout}: the converted model's "
                                     "greedy tokens differ from the twin's")
        dense, paged = (results[f"{label} {r}"]["outs"]
                        for r in ("dense", "paged"))
        bad = [i for i in dense if paged[i] != dense[i]]
        log(f"{label} converted serving paged vs dense: "
            f"{N_REQUESTS - len(bad)}/{N_REQUESTS} completions identical")
        if bad:
            raise AssertionError(f"{label} serving: paged and dense "
                                 f"completions differ for requests {bad}")
        check_launched(results, {
            f"{label} converted auto greedy_generate": ("w4a16_matmul",),
            f"{label} converted packed greedy_generate": (
                "w4a16_planes_int4",),
            f"{label} dense": ("w4a16_matmul", "flash_decode_attention"),
            f"{label} paged": ("w4a16_matmul", "paged_decode_attention")})

        dequantizer = CompressedTensorsDequantizer.from_pretrained(dst)
        try:
            convert_checkpoint(dst, os.path.join(tmp, "dequantized"),
                               dequantizer)
        except ValueError as e:
            # the JAX package's validate() counts a quantized linear's bias
            # as an unconsumed key (ROADMAP, reference caveats)
            if "unconsumed" not in str(e):
                raise
            log(f"{label}: convert_checkpoint with CompressedTensorsDequantizer "
                f"refuses the qkv biases, as the JAX package's does: {e}"[:300])
        else:
            raise AssertionError(f"{label}: CompressedTensorsDequantizer "
                                 "converted linears with biases, which the "
                                 "JAX package refuses")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deq = dequantizer.process(read_checkpoint(dst))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mc = ModelCompressor.from_pretrained(dst)
        states, _ = mc.load_checkpoint(dst, run_compressed=False)
        quantized = {n.rpartition(".")[0] for n in read_checkpoint(dst)
                     if n.endswith(".weight_packed")}
        held = [m for m, state in states.items()
                if m in quantized and same_bits(
                    deq[f"{m}.weight"], state["weight"].to(torch.bfloat16))]
        if len(held) != len(quantized) or \
                len(quantized) != 7 * CONVERT_LAYERS:
            raise AssertionError(f"{label} dequantized: {len(held)} of "
                                 f"{len(quantized)} weights equal "
                                 "decompress_state's")
        log(f"{label}: CompressedTensorsDequantizer.process over the "
            f"converted checkpoint in {seconds:.2f} s: {len(held)} bf16 "
            "weights equal ModelCompressor.decompress_state's bit for bit")
    return results


def converted_modelopt(requests):
    """Phase 18, part 2: Llama-3-8B NVFP4A16 drawn on the card by
    ``nvfp4_llama`` at ``CONVERT_LAYERS`` layers with a dense bf16 lm_head
    (its W8A8 head dequantized), written as a ModelOpt NVFP4 checkpoint
    (``weight`` packed bytes, ``weight_scale`` e4m3, ``weight_scale_2`` =
    1 / the global scale, ``input_scale``), converted by
    ``ModelOptNvfp4Converter``: every tensor against the twin written
    directly (``save_llama_checkpoint``), the global scales within one f32
    ulp; the converted config is NVFP4 (fp4 activations, which neither
    package quantizes) and loads weight-only through B8; B8 on the
    converted layer 0 against its plain version (the a8b rule), the
    first-token logits by the depth rule at 1 and 4 layers against the
    model with B8 through its plain version (rolled group scales must fail
    it), 16 B8 launches a decode step, greedy."""
    import torch

    from compressed_tensors_tpu_torch.entrypoints.convert import (
        ModelOptNvfp4Converter,
        convert_checkpoint,
    )
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.synthetic import (
        LLAMA3_8B,
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    config = dataclasses.replace(LLAMA3_8B, num_hidden_layers=CONVERT_LAYERS)
    label = "modelopt nvfp4"
    results = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        params = nvfp4_llama(config, 0)
        lm = params["lm_head"]
        params["lm_head"] = dense_qt((lm.weight.float() * lm.scale.float()
                                      ).to(torch.bfloat16))
        del lm
        twin_dir, src, dst = (os.path.join(tmp, d)
                              for d in ("twin", "modelopt", "converted"))
        save_llama_checkpoint(params, config, twin_dir)
        del params
        twin = read_checkpoint(twin_dir)
        modelopt = {}
        for name, t in twin.items():
            module, _, local = name.rpartition(".")
            if local == "weight_packed":
                modelopt[f"{module}.weight"] = t
            elif local == "weight_global_scale":
                g = t.to("cuda", torch.float32)
                modelopt[f"{module}.weight_scale_2"] = torch.ones_like(g) / g
                modelopt[f"{module}.input_scale"] = torch.full_like(
                    g, MODELOPT_INPUT_SCALE)
            else:
                modelopt[name] = t
        with open(os.path.join(twin_dir, "config.json")) as f:
            cfg = json.load(f)
        cfg["quantization_config"] = MODELOPT_CONFIG
        nbytes = write_shards(src, modelopt, cfg)
        del modelopt
        converter = ModelOptNvfp4Converter(targets=["re:.*_proj$"],
                                           ignore=["lm_head"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convert_checkpoint(src, dst, converter, max_workers=2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"{label}: convert_checkpoint of {nbytes / 1e9:.3f} GB in 2 "
            f"shards in {seconds:.2f} s ({nbytes / 1e9 / seconds:.2f} GB/s, "
            f"the read warm; {card()})")
        got = read_checkpoint(dst)
        compare_to_twin(f"{label} converted", got, twin,
                        loose=("weight_global_scale",))
        inputs = [t for n, t in got.items() if n.endswith("input_global_scale")]
        want = 1 / torch.tensor(MODELOPT_INPUT_SCALE, dtype=torch.float32)
        if len(inputs) != 7 * CONVERT_LAYERS or any(
                not bool((t == want).all()) for t in inputs):
            raise AssertionError(f"{label}: input_global_scale not 1 / "
                                 "input_scale")
        with open(os.path.join(dst, "config.json")) as f:
            scheme = json.load(f)["quantization_config"]["config_groups"][
                "config_group_0"]
        acts = scheme["input_activations"]
        log(f"{label}: the converted config is {scheme['format']} with "
            f"{acts['num_bits']}-bit {acts['type']} input activations "
            f"(group {acts['group_size']}), served weight-only (neither "
            "package quantizes fp4 activations); input_global_scale read "
            f"in {len(inputs)} linears")
        del twin, got
        params, _, _ = load_llama_params(dst)
        params = fuse_llama_layers(params)
        layer0 = params["layers"][0]
        kinds = {qt.kernel_meta[0] for layer in params["layers"]
                 for qt in layer.values() if getattr(qt, "kernel_meta", None)}
        if kinds != {"fp4"} or not ("qkv_proj" in layer0
                                    and "gate_up_proj" in layer0):
            raise AssertionError(f"{label}: kernel layouts {kinds}, layer 0 "
                                 f"{sorted(layer0)}")
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
            qt = layer0[name]
            n, k, group = qt.kernel_meta[1:4]
            x = torch.randn((BATCH, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            out = w4.w4a16_fp4_matmul(x, qt.kernel_packed, qt.kernel_scales,
                                      n=n, k=k, group_size=group)
            check_rule(f"{label} layer 0 {name} (B8, M={BATCH})", out,
                       w4.w4a16_fp4_matmul_plain(
                           x, qt.kernel_packed, qt.kernel_scales, n=n, k=k,
                           group_size=group, out_dtype=torch.float32))
        depth_rule_against_plain(params, config, requests, label, plain_fp4,
                                 ("fp4",))
        results[f"{label} dense"] = serve_requests(
            params, config, requests, f"{label} converted dense",
            paged=False)
        step = results[f"{label} dense"]["per_step"]
        log(f"{label}: launches a decode step: B8 "
            f"{step['w4a16_fp4_matmul']:g}, B3 {step['w8a8_matmul']:g}")
        if step["w4a16_fp4_matmul"] != 4 * CONVERT_LAYERS or \
                step["w8a8_matmul"]:
            raise AssertionError(f"{label}: launches a decode step {step}")
        results[f"{label} greedy_generate"] = greedy_8b(params, config, label)
        check_launched(results, {
            f"{label} dense": ("w4a16_fp4_matmul", "prefill_attention",
                               "flash_decode_attention"),
            f"{label} greedy_generate": ("w4a16_fp4_matmul",
                                         "decode_attention")})
        del params
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_fp4():
    """Every fp4 matmul (B8) through its plain version on the card; undone
    on exit."""
    from compressed_tensors_tpu_torch.ops import linear
    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4

    kernel = linear.w4a16_fp4_matmul
    linear.w4a16_fp4_matmul = w4.w4a16_fp4_matmul_plain
    try:
        yield
    finally:
        linear.w4a16_fp4_matmul = kernel


@contextlib.contextmanager
def plain_decode():
    """The block and flash decode kernels (B5, B6) through their plain
    versions on the card; undone on exit."""
    from compressed_tensors_tpu_torch.models import llama
    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as dec,
    )
    from compressed_tensors_tpu_torch.ops.kernels import flash_decode as fd

    kernels = llama.decode_attention, llama.flash_decode_attention
    llama.decode_attention = dec.decode_attention_plain
    llama.flash_decode_attention = fd.flash_decode_attention_plain
    try:
        yield
    finally:
        llama.decode_attention, llama.flash_decode_attention = kernels


def depth_rule_against_plain(params, config, requests, label, plain, kinds):
    """First-token logits at 1 and ``CONVERT_LAYERS`` layers held to the
    depth rule (``logits_rule_failures``) against the same model with
    some kernels through their plain versions (``plain``); the kernel
    scales of ``kinds`` rolled by one group must fail every check."""
    sweep, faulty = logits_by_depth(
        params, config, requests, label, depths=(1, CONVERT_LAYERS),
        plain=plain, fault=rolled_group_scales(params, kinds))
    failures = logits_rule_failures(sweep)
    caught = logits_rule_failures(faulty)
    log(f"{label} logits against the plain path: "
        + ", ".join(f"{d} layers max {t:.4g} of max|ref|, rel_rms / spread "
                    f"{e / max(s, 1e-30):.3g}" for d, (e, s, t) in sweep.items())
        + f"; control ({'/'.join(kinds)} scales rolled by one group): "
        + ", ".join(f"{d}: max {t:.4g}" for d, (_, _, t) in faulty.items())
        + f"; the rule fails {len(caught)} of its {len(sweep) + 1} checks")
    if failures:
        raise AssertionError(f"{label} logits: {'; '.join(failures)}")
    if len(caught) < len(sweep) + 1:
        raise AssertionError(f"{label}: the rule accepted rolled scales")
    a8b_rule_logits(params, config, requests, label, plain)


def a8b_rule_logits(params, config, requests, label, plain):
    """The a8b rule per element on the one-layer first-token logits
    against the plain path: the count outside it printed (read: the rule
    is a single kernel call's, and the logits pass a layer's
    bf16 roundings)."""
    _, ids, _ = probe_request(requests)
    got = first_token_logits(params, config, ids, 1, True, label)
    with plain():
        want = first_token_logits(params, config, ids, 1, True, label)
    top = want.abs().max().item()
    out = int(((got - want).abs() > A8B_REL * want.abs() + A8B_ABS * top)
              .sum())
    log(f"{label} one-layer first-token logits against the plain path: "
        f"{out} of {want.numel()} elements outside the a8b rule (read)")


def c2_arms(requests):
    """Phase 18, part 4 (ROADMAP C2): the two opt-in kernel paths no model
    ran before, at ``CONVERT_LAYERS`` layers of Llama-3-8B. FP8 W8A8
    (phase 6's draw, ``fp8_synthetic_llama``) with an fp8 KV cache under
    ``fp8_transcode="always"`` (int8 weights through
    B3 int8, an int8 cache through the scaled decode kernels: rows 5c, 6c,
    7c), and W4A16 under ``w4_layout="e8"`` (B9: rows 9c, 9d). Each: the
    first-token and decode-step logits at 1 and 4 layers held to the depth
    rule against its own path with those kernels through their plain
    versions, scales rolled by one group (one channel) failing every
    check; greedy at batch 64; the FP8 model also served dense and paged
    (identical) on an int8 cache."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.llama import (
        transcode_fp8_kv_to_int8,
    )
    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    config = dataclasses.replace(LLAMA3_8B, num_hidden_layers=CONVERT_LAYERS)
    fp8 = torch.float8_e4m3fn
    _, prompt, _ = probe_request(requests)
    steps = requests[1][1][:PTQ_STEPS]
    views = {" first-token logits": lambda t: t[:1],
             " decode-step logits": lambda t: t[1:]}
    results = {}

    with flag_overrides(fp8_transcode="always"):
        params = fp8_synthetic_llama(config)
        kinds = {(qt.kernel_meta[0], qt.kernel_packed.dtype)
                 for layer in params["layers"] for qt in layer.values()
                 if getattr(qt, "kernel_meta", None)}
        served, cache_dtype = transcode_fp8_kv_to_int8(params, fp8)
        if kinds != {("w8a8", torch.int8)} or cache_dtype != torch.int8:
            raise AssertionError(f"fp8 transcode: layouts {kinds}, cache "
                                 f"{cache_dtype}")
        label = "fp8 transcode (int8 weights, int8 cache)"

        def run(depth, test, check=True):
            with contextlib.nullcontext() if test else plain_w8a8(), \
                    contextlib.nullcontext() if test else plain_decode():
                return ptq_logits(served, config, prompt, depth, True, steps,
                                  cache_dtype=cache_dtype, check=check,
                                  label=label)

        reset_counts()
        counts = ptq_depth_rule(label, (1, CONVERT_LAYERS), run,
                       lambda: one_ulp(params["embed_tokens"],
                                       prompt[len(prompt) // 3]),
                       rolled_group_scales(params, ("w8a8",)),
                       "channel scales rolled by one channel", views=views,
                       ref_name="plain path")
        results["c2 fp8 transcode logits"] = {"counts": counts}
        results["c2 fp8 transcode greedy_generate"] = greedy_8b(
            served, config, "c2 fp8 transcode", cache_dtype=cache_dtype)
        for paged in (False, True):
            run_name = f"c2 fp8 transcode {'paged' if paged else 'dense'}"
            res = serve_requests(params, config, requests, run_name,
                                 keep=True, paged=paged, cache_dtype=fp8,
                                 **({"prefix_caching": False} if paged
                                    else {}))
            if res.pop("engine").cache.k.dtype != torch.int8:
                raise AssertionError(f"{run_name}: the cache is not int8")
            results[run_name] = res
        del params, served
    torch.cuda.empty_cache()
    dense, paged = (results[f"c2 fp8 transcode {r}"]["outs"]
                    for r in ("dense", "paged"))
    bad = [i for i in dense if paged[i] != dense[i]]
    log(f"c2 fp8 transcode serving paged vs dense (int8 cache): "
        f"{N_REQUESTS - len(bad)}/{N_REQUESTS} completions identical")
    if bad:
        raise AssertionError(f"c2 fp8 transcode serving: paged and dense "
                             f"completions differ for requests {bad}")

    with flag_overrides(w4_layout="e8"):
        params = fuse_llama_layers(w4a16_llama(config, 0, False))
    kinds = {qt.kernel_meta[0] for layer in params["layers"]
             for qt in layer.values() if getattr(qt, "kernel_meta", None)}
    if kinds != {"w4e8"}:
        raise AssertionError(f"w4a16 e8: layouts {kinds}")
    label = "w4a16 under w4_layout=e8"

    def run_e8(depth, test, check=True):
        with contextlib.nullcontext() if test else plain_e8():
            return ptq_logits(params, config, prompt, depth, True, steps,
                              check=check, label=label)

    reset_counts()
    counts = ptq_depth_rule(label, (1, CONVERT_LAYERS), run_e8,
                   lambda: one_ulp(params["embed_tokens"],
                                   prompt[len(prompt) // 3]),
                   rolled_group_scales(params, ("w4e8",)),
                   "group scales rolled by one group", views=views,
                   ref_name="plain path")
    results["c2 e8 logits"] = {"counts": counts}
    results["c2 e8 greedy_generate"] = greedy_8b(params, config, "c2 e8")
    del params
    torch.cuda.empty_cache()
    need = {"c2 fp8 transcode logits": ("w8a8_matmul",
                                        "decode_attention_scaled"),
            "c2 fp8 transcode greedy_generate": ("w8a8_matmul",
                                                 "decode_attention_scaled"),
            "c2 fp8 transcode dense": ("w8a8_matmul",
                                       "flash_decode_attention_scaled"),
            "c2 fp8 transcode paged": ("w8a8_matmul",
                                       "paged_decode_attention_scaled"),
            "c2 e8 logits": ("w4_e8_matmul",),
            "c2 e8 greedy_generate": ("w4_e8_matmul",)}
    log("c2 launches: " + "; ".join(
        f"{run}: " + ", ".join(f"{k} {results[run]['counts'][k]}"
                               for k in kernels)
        for run, kernels in need.items()))
    check_launched(results, need)
    return results


def phase_converters():
    """Phase 18: converters (AutoAWQ, ModelOpt NVFP4, the two dequantizers)
    and ROADMAP C2's two opt-in kernel paths, each at ``CONVERT_LAYERS``
    layers of its model's published widths."""
    import torch

    t_phase = time.perf_counter()
    requests = serving_requests(VOCAB8)
    results = converted_awq(requests)
    results.update(converted_modelopt(requests))
    fp8_block_dequantizer()
    results.update(c2_arms(requests))
    log(f"phase 18 (converters, C2) wall {time.perf_counter() - t_phase:.1f}"
        f" s ({card()})")
    torch.cuda.empty_cache()
    return results


def fp8_block_dequantizer():
    """Phase 18, part 3: one Llama-3-8B layer's seven linears written as a
    DeepSeek-style FP8-block checkpoint (e4m3 ``weight``,
    ``weight_scale_inv`` (N/128, K/128) in [1e-4, 3e-4]) drawn on the card,
    dequantized to bf16 by ``FP8BlockDequantizer`` on the card and on the
    CPU: the two files equal byte for byte."""
    import torch

    from compressed_tensors_tpu_torch.entrypoints.convert import (
        FP8BlockDequantizer,
        convert_checkpoint,
    )
    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B

    gen = torch.Generator(device="cuda").manual_seed(6)
    tensors = {}
    for name, (n, k) in linear_shapes(LLAMA3_8B).items():
        m = f"model.layers.0.{PTQ_SUBMODULE[name]}.{name}"
        tensors[f"{m}.weight"], _ = fp8_weight(gen, n, k)
        tensors[f"{m}.weight_scale_inv"] = torch.rand(
            (-(-n // FP8_BLOCK), -(-k // FP8_BLOCK)), generator=gen,
            device="cuda") * 2e-4 + 1e-4
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        src = os.path.join(tmp, "fp8block")
        nbytes = write_shards(src, tensors, {"quantization_config": {
            "quant_method": "fp8", "fmt": "e4m3", "activation_scheme":
            "dynamic", "weight_block_size": [FP8_BLOCK, FP8_BLOCK]}},
            shards=1)
        seconds = {}
        for where in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            convert_checkpoint(src, os.path.join(tmp, where),
                               FP8BlockDequantizer(targets=["re:.*_proj$"],
                                                   device=where))
            torch.cuda.synchronize()
            seconds[where] = time.perf_counter() - t0
        fname = "model-00001-of-00001.safetensors"
        blobs = []
        for where in ("cuda", "cpu"):
            with open(os.path.join(tmp, str(where), fname), "rb") as f:
                blobs.append(f.read())
        log(f"fp8 block: FP8BlockDequantizer over one 8B layer "
            f"({nbytes / 1e9:.3f} GB) on the card in {seconds["cuda"]:.2f}"
            f" s, on the CPU in {seconds['cpu']:.2f} s: the bf16 files "
            f"{'equal' if blobs[0] == blobs[1] else 'DIFFER'} byte for byte "
            f"({len(blobs[0])} bytes; {card()})")
        if blobs[0] != blobs[1]:
            raise AssertionError("FP8BlockDequantizer: the card's file differs "
                                 "from the CPU's")


# --------------------------------------------------------------------------- #
# phase 19: tensor parallelism (parallel/, ServingEngine(mesh=...))

# meta-llama/Meta-Llama-3-70B's published config.json (cited, not fetched)
LLAMA3_70B = dict(vocab_size=128256, hidden_size=8192,
                  intermediate_size=28672, num_hidden_layers=80,
                  num_attention_heads=64, num_key_value_heads=8,
                  head_dim=128, rope_theta=500000.0,
                  max_position_embeddings=8192)
TP70_LAYERS = 4            # of the 80
TP70_REQUESTS = 32         # phase 5's first 32 requests
TP_MS = (BATCH, M_CHUNK)   # 19b's rows: a decode step's and a prefill chunk's


def phase_mesh_one(serving):
    """Phase 19a: ``ServingEngine(mesh=make_mesh())`` (one process, every
    axis 1) on phase 5's Llama-3-8B W4A16 model and 96 requests, dense and
    paged: the completions identical to phase 5's unsharded engine token
    for token, and 128 B1 + 1 B3 launches a decode step (the unsharded
    path)."""
    import torch

    from compressed_tensors_tpu_torch.models.synthetic import LLAMA3_8B
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.parallel import make_mesh

    params = fuse_llama_layers(w4a16_llama(LLAMA3_8B, 0, asym=False))
    requests = serving_requests()
    mesh = make_mesh()
    results = {}
    for name, kw in (("dense", dict(paged=False)),
                     ("paged", dict(paged=True, prefix_caching=False))):
        run = f"mesh-one {name}"
        results[run] = res = serve_requests(params, LLAMA3_8B, requests, run,
                                            mesh=mesh, **kw)
        want = serving[name]["outs"]
        same = sum(res["outs"][i] == want[i] for i in want)
        step = {k: res["per_step"][k] for k in ("w4a16_matmul",
                                                "w8a8_matmul")}
        log(f"{run}: {same}/{len(want)} completions identical to phase 5's "
            f"unsharded engine; launches a decode step {step} (expected "
            "128 B1 + 1 B3)")
        if same != len(want) or step != {"w4a16_matmul": 128,
                                         "w8a8_matmul": 1}:
            raise AssertionError(f"{run}: differs from the unsharded engine")
    del params
    torch.cuda.empty_cache()
    return results


def shard_rule(name, got, want, slack=None):
    """``got`` (a kernel's bf16 output) against ``want`` (its plain version
    in f32) by the a8b rule per element (``slack`` replaces A8B_REL * |y|
    where the result sums several bf16 roundings); returns max|got -
    want| / max|want|."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    limit = (A8B_REL * want.abs() if slack is None else slack) + A8B_ABS * top
    bad = int(((got - want).abs() > limit).sum())
    err = (got - want).abs().max().item() / top
    if bad or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: {bad} elements outside the a8b rule")
    return err


def shard_call(x, qt):
    """A rank's kernel call on its shard as ``quantized_matmul`` makes it,
    beside the kernel's plain version in f32: (kernel output, plain
    output, the mode that ran)."""
    import torch

    from compressed_tensors_tpu_torch.ops.kernels import w4a16_matmul as w4
    from compressed_tensors_tpu_torch.ops.kernels import w8a8_matmul as w8
    from compressed_tensors_tpu_torch.ops.linear import (
        _w4b8_mode,
        quantized_matmul,
    )

    kind, n, k = qt.kernel_meta[:3]
    got = quantized_matmul(x, qt)
    if kind == "w8a8":
        return got, w8.w8a8_matmul_plain(x, qt.kernel_packed,
                                         qt.kernel_scales, n=n, k=k,
                                         out_dtype=torch.float32), "B3"
    mode = _w4b8_mode(x.shape[0], n, k)
    return got, w4.w4a16_matmul_plain(
        x, qt.kernel_packed, qt.kernel_scales, qt.kernel_zp, n=n, k=k,
        group_size=qt.kernel_meta[3], mode=mode,
        out_dtype=torch.float32), {"int4b": "B1", "a8b": "B2"}[mode]


def phase_shard_arithmetic():
    """Phase 19b: each rank's shard arithmetic at tp = 2 in this process,
    no collectives: layer 0 of config 5's mix at Llama-3-70B width (W4A16
    g128 and, as layer 1, W8A8-int, fused) and the int8 lm_head, sharded
    by ``shard_llama_params`` for rank 0 and rank 1 (``make_mesh(tp=2,
    rank=r, world=2)``). At a decode step's 64 rows and a 512-row chunk,
    every shard's kernel call (B1, B2 or B3 as ``quantized_matmul``
    dispatches the local shape) is held to its plain version by the a8b
    rule; the column-parallel outputs of the two ranks, put back in order,
    and the row-parallel f32 partials, summed, are read against the
    unsharded layer's kernel output. The quantized ring's two K-slice B1
    launches (``ring_k_slices``) on rank 0's qkv shard, summed, are held
    to B1 on the whole shard within the bf16 rounding of the three
    outputs."""
    import torch

    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels.w4a16_matmul import (
        w4a16_matmul,
    )
    from compressed_tensors_tpu_torch.ops.linear import quantized_matmul
    from compressed_tensors_tpu_torch.parallel import (
        make_mesh,
        shard_llama_params,
    )
    from compressed_tensors_tpu_torch.parallel.mesh import row_parallel_input
    from compressed_tensors_tpu_torch.parallel.overlap import ring_k_slices

    t_phase = time.perf_counter()
    config = LlamaConfig(**dict(LLAMA3_70B, num_hidden_layers=2))
    params = fuse_llama_layers(mixed_llama(config, seed=2))
    meshes = [make_mesh(tp=2, rank=r, world=2, device="cuda")
              for r in range(2)]
    ranks = [shard_llama_params(params, mesh, config) for mesh in meshes]
    gen = torch.Generator(device="cuda").manual_seed(19)
    modes = set()
    for li, layer in enumerate(params["layers"]):
        for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
            full = layer[name]
            for m in TP_MS:
                x = dev_randn(gen, m, full.shape[1])
                ref = quantized_matmul(x, full).float()
                parts, errs = [], []
                for r, shards in enumerate(ranks):
                    local = shards["layers"][li][name]
                    if name in ("o_proj", "down_proj"):
                        k = local.shape[1]
                        xin = row_parallel_input(
                            x[:, r * k:(r + 1) * k], local, meshes[r],
                            amax=x.float().abs().amax(-1, keepdim=True))
                    else:
                        xin = x
                    got, want, mode = shard_call(xin.contiguous(), local)
                    modes.add(mode)
                    errs.append(shard_rule(f"19b layer {li} {name} M={m} "
                                           f"rank {r}", got, want))
                    parts.append(got.float())
                if name in ("o_proj", "down_proj"):
                    whole = parts[0] + parts[1]
                else:
                    sizes = ([config.num_attention_heads * config.head_dim]
                             + [config.num_key_value_heads
                                * config.head_dim] * 2
                             if name == "qkv_proj"
                             else [config.intermediate_size] * 2)
                    cols, start = [], 0
                    for n in sizes:
                        for p in parts:
                            a = start // 2
                            cols.append(p[:, a:a + n // 2])
                        start += n
                    whole = torch.cat(cols, dim=1)
                dist_full = ((whole - ref).abs().max().item()
                             / ref.abs().max().item())
                log(f"19b layer {li} ({full.kernel_meta[0]}) {name} M={m}: "
                    f"shards {[s['layers'][li][name].shape for s in ranks]} "
                    f"({mode}), each within the a8b rule of its plain "
                    f"version (max {max(errs):.4g} of max|plain|); the two "
                    f"ranks {'summed' if name in ('o_proj', 'down_proj') else 'put together'}"
                    f" against the unsharded layer: max {dist_full:.4g} of "
                    f"max|ref|")
    lm = params["lm_head"]
    for m in TP_MS:
        x = dev_randn(gen, m, lm.shape[1])
        ref = quantized_matmul(x, lm).float()
        parts = []
        for r, shards in enumerate(ranks):
            got, want, _ = shard_call(x, shards["lm_head"])
            shard_rule(f"19b lm_head M={m} rank {r}", got, want)
            parts.append(got.float())
        whole = torch.cat(parts, dim=1)
        log(f"19b lm_head (vocabulary halves {shards['lm_head'].shape}) "
            f"M={m}: each within the a8b rule of B3's plain version; put "
            f"together against the unsharded head: max "
            f"{(whole - ref).abs().max().item() / ref.abs().max().item():.4g}"
            f" of max|ref|, {int((whole != ref).sum())} of {ref.numel()} "
            "logits differ")
    local = ranks[0]["layers"][0]["qkv_proj"]
    n, k, g = local.kernel_meta[1:]
    x = dev_randn(gen, BATCH, k)
    whole = w4a16_matmul(x, local.kernel_packed, local.kernel_scales,
                         local.kernel_zp, n=n, k=k, group_size=g).float()
    chunks = [w4a16_matmul(x[:, s * ks:(s + 1) * ks].contiguous(), wp, sc,
                           zp, n=n, k=ks, group_size=g).float()
              for s, (wp, sc, zp, ks) in enumerate(ring_k_slices(local, 2))]
    err = shard_rule("19b ring K-slices", chunks[0] + chunks[1], whole,
                     slack=A8B_REL * (chunks[0].abs() + chunks[1].abs()
                                      + whole.abs()))
    log(f"19b quantized ring on rank 0's qkv shard (N {n}, K {k}): two "
        f"K-slice B1 launches of K {k // 2}, summed in f32, against B1 on "
        f"the whole shard: max {err:.4g} of max|B1|, within 2^-8 of the "
        "three bf16 outputs' magnitudes plus 1e-4 max|y|")
    if not {"B1", "B2", "B3"} <= modes:
        raise AssertionError(f"19b ran {modes}, not B1, B2 and B3")
    del params, ranks
    torch.cuda.empty_cache()
    log(f"phase 19b wall {time.perf_counter() - t_phase:.1f} s ({card()})")


def tp2_parent_side(config, requests, probe, depths, serve, tmp, ranks):
    """Phase 19c in this process while the ranks start: the model drawn
    (``mixed_llama`` from seed 3) and its checkpoint written, the unsharded
    model's logits (each with its one-ulp spread)
    and its paged serving, plain and with its embeddings one ulp up; then
    inputs.json for the ranks, and their reports. Returns (reports, ref,
    spread, single, moved, checkpoint bytes)."""
    import torch

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models.synthetic import (
        save_llama_checkpoint,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers

    import torch_dist_worker

    raw = mixed_llama(config, seed=3)
    t0 = time.perf_counter()
    save_llama_checkpoint(raw, config, os.path.join(tmp, "ckpt"))
    write_s = time.perf_counter() - t0
    total = sum(os.path.getsize(os.path.join(tmp, "ckpt", f))
                for f in os.listdir(os.path.join(tmp, "ckpt"))
                if f.endswith(".safetensors"))
    log(f"19c Llama-3-70B mix, {TP70_LAYERS} of 80 layers: checkpoint of "
        f"{total / 1e9:.3f} GB written in {write_s:.1f} s")
    params = fuse_llama_layers(raw)
    del raw
    emb, tok = params["embed_tokens"], probe[len(probe) // 3]
    ref, spread = {}, {}
    for act in ("bf16", "auto"):
        with flag_overrides(w4_act=act):
            for d in depths:
                ref[act, d] = torch_dist_worker.last_logits(
                    params, config, probe, d)
                row = emb[tok].clone()
                emb[tok, :64] = (row[:64].float() * (1 + 2**-7)).to(
                    emb.dtype)
                spread[act, d] = rel_rms(torch_dist_worker.last_logits(
                    params, config, probe, d), ref[act, d])
                emb[tok] = row
    single = serve_requests(params, config, requests, "70B tp=1 paged",
                            paged=True, prefix_caching=False)
    # the model's own sensitivity: one bf16 ulp up on the first 64 values
    # of every embedding row
    row = emb[:, :64].clone()
    emb[:, :64] = (row.float() * (1 + 2**-7)).to(emb.dtype)
    moved = serve_requests(params, config, requests,
                           "70B tp=1 paged, embeddings one ulp up",
                           paged=True, prefix_caching=False)
    emb[:, :64] = row
    del params, row
    torch.cuda.empty_cache()
    with open(os.path.join(tmp, "inputs.tmp"), "w") as f:
        json.dump({"requests": requests, "probe": probe, "depths": depths,
                   "serve": serve}, f)
    os.replace(os.path.join(tmp, "inputs.tmp"),
               os.path.join(tmp, "inputs.json"))
    reports = torch_dist_worker.finish("tp70b", ranks, tmp, SPAWN_SECONDS)
    return reports, ref, spread, single, moved, total


def phase_tp2_processes(tmp):
    """Phase 19c: tensor parallelism across two processes on the one card
    (gloo over CUDA tensors; NCCL takes one rank a card). Config 5's mix
    at Llama-3-70B width (even layers W4A16 g128, odd W8A8-int, int8
    lm_head; ``mixed_llama`` from seed 3) cut from 80 layers to 4, written
    once by ``save_llama_checkpoint``; each rank
    (``tests/torch_dist_worker.py`` case "tp70b") reads its blocks through
    ``load_llama_params(mesh=make_mesh(tp=2))`` (``load_sharded_params``'
    reader), fuses, and computes the probe's last-position logits at 1 and
    4 layers, with every W4 linear at bf16 activations (as phase 5 holds
    the depth rule) and at the serving default (a8b prefill rows), then
    both again with every decoder linear's scales rolled by one group (one
    channel for W8A8), and serves phase 5's first 32 requests through the
    paged engine. Here (``tp2_parent_side``, while the ranks start): the
    same logits of the unsharded model (the reference) and its one-ulp
    spread at each activation setting; on both ranks the depth rule
    (``logits_rule_failures``) held at bf16 activations and its spread arm
    (``spread_rule_failures``) at the default (a one-ulp change moves this
    model's one-layer logits at the default as far as the rule's one-layer
    limit), each failing every check under the control; both ranks'
    completions equal, and at least as many of their first tokens equal
    to the unsharded paged engine's as the unsharded model's with its
    embeddings one ulp up; bytes read and seconds per
    rank, decode ms a step at tp = 2 against tp = 1. The checkpoint stays
    under ``tmp`` for phase 20. Returns (the runs with their launch
    counts, the tp = 2 completions and what phase 20 reads beside
    them)."""
    import torch

    from compressed_tensors_tpu_torch.models.config import LlamaConfig

    import torch_dist_worker

    t_phase = time.perf_counter()
    config = LlamaConfig(**dict(LLAMA3_70B, num_hidden_layers=TP70_LAYERS))
    requests = serving_requests()[:TP70_REQUESTS]
    _, probe, _ = probe_request(requests)
    depths = (1, TP70_LAYERS)
    serve = dict(SERVE, paged=True, prefix_caching=False)
    # the ranks start (torch, the card, the group) while this process
    # writes the checkpoint and computes the references; they wait for
    # inputs.json, written last
    t_spawn = time.perf_counter()
    ranks = torch_dist_worker.start("tp70b", tmp, 2, "cuda")
    try:
        reports, ref, spread, single, moved, total = tp2_parent_side(
            config, requests, probe, depths, serve, tmp, ranks)
    finally:
        torch_dist_worker.stop(ranks)
    spawn_s = time.perf_counter() - t_spawn
    logits = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
              for r in range(2)]
    for r, (rep, lg) in enumerate(zip(reports, logits)):
        for label, key, act in (
                ("bf16 activations", "bf16_d", "bf16"),
                ("control (scales rolled), bf16", "rolled_bf16_d", "bf16"),
                ("the default (a8b prefill rows)", "auto_d", "auto"),
                ("control (scales rolled), the default", "rolled_auto_d",
                 "auto")):
            sweep = {}
            for d in depths:
                got, want = lg[f"{key}{d}"].cuda(), ref[act, d]
                sweep[d] = (rel_rms(got, want), spread[act, d],
                            (got - want).abs().max().item()
                            / want.abs().max().item())
            # at bf16 activations the depth rule; at the default its
            # spread arm alone: the one-ulp change moves this model's
            # one-layer logits as far as the rule's one-layer limit
            fails = (logits_rule_failures(sweep) if act == "bf16"
                     else spread_rule_failures(sweep))
            checks = len(sweep) + (act == "bf16")
            log(f"19c rank {r} logits at {label} vs the unsharded model: "
                + ", ".join(f"{d} layers rel_rms {e:.4g} (one-ulp spread "
                            f"{s:.4g}, max {t:.4g} of max|ref|)"
                            for d, (e, s, t) in sweep.items())
                + f"; the {'depth' if act == 'bf16' else 'spread'} rule "
                f"fails {len(fails)} of {checks}")
            if not key.startswith("rolled") and fails:
                raise AssertionError(f"19c rank {r} logits at {label}: "
                                     f"{fails}")
            if key.startswith("rolled") and len(fails) < checks:
                raise AssertionError(f"19c rank {r}: the rule accepted "
                                     f"the rolled scales at {act}")
    outs = [{int(i): o for i, o in rep["completions"].items()}
            for rep in reports]
    if outs[0] != outs[1]:
        raise AssertionError("19c: the ranks' completions differ")

    def agreement(got):
        """(identical completions, equal first tokens, mean common
        prefix in tokens) against the unsharded engine's."""
        ref_outs = single["outs"]
        common = [next((j for j, (a, b) in enumerate(zip(got[i], o))
                        if a != b), min(len(got[i]), len(o)))
                  for i, o in ref_outs.items()]
        return (sum(got[i] == o for i, o in ref_outs.items()),
                sum(got[i][0] == o[0] for i, o in ref_outs.items()),
                sum(common) / len(common))

    same, first, prefix = agreement(outs[0])
    ulp_same, ulp_first, ulp_prefix = agreement(moved["outs"])
    tp1_ms = single["decode_s"] * 1e3 / max(single["steps"], 1)
    for r, rep in enumerate(reports):
        log(f"19c rank {r}: local heads {rep['heads']}, read "
            f"{rep['bytes_read'] / 1e9:.3f} of {total / 1e9:.3f} GB in "
            f"{rep['load_s']:.2f} s with the fuse ({rep['gib']:.2f} GiB on "
            f"the card); served {len(rep['completions'])} requests in "
            f"{rep['serve_s']:.2f} s, decode {rep['decode_ms']:.2f} ms a "
            f"step over {rep['steps']} steps; launches {rep['launches']}")
    n = len(single["outs"])
    log(f"19c tp = 2 over 2 processes (gloo): completions equal on both "
        f"ranks; against the unsharded engine's {same}/{n} identical, "
        f"{first}/{n} first tokens equal, {prefix:.2f} tokens in common on "
        f"average (the unsharded model with its embeddings one ulp up: "
        f"{ulp_same}/{n}, {ulp_first}/{n}, {ulp_prefix:.2f}); decode "
        f"{reports[0]['decode_ms']:.2f} ms a step at tp = 2 against "
        f"{tp1_ms:.2f} at tp = 1; the ranks ran {spawn_s:.1f} s, started "
        f"before the checkpoint was written ({card()})")
    if first < ulp_first:
        raise AssertionError(
            f"19c: {first}/{n} first tokens equal to tp = 1's, fewer than "
            f"the one-ulp model's {ulp_first}/{n}")
    for rep in reports:
        missing = [k for k, v in rep["launches"].items() if not v]
        if missing:
            raise AssertionError(f"19c never launched {missing}")
    log(f"phase 19c wall {time.perf_counter() - t_phase:.1f} s ({card()})")
    return ({"70B tp=1 paged": single,
             "70B tp=1 paged, embeddings one ulp up": moved},
            dict(outs=outs[0], requests=requests, first_floor=ulp_first,
                 decode_ms=reports[0]["decode_ms"],
                 ckpt=os.path.join(tmp, "ckpt")))


# --------------------------------------------------------------------------- #
# phase 20: data parallelism (dp = 2 x tp = 2, ServingEngine(mesh=...))

DP70_RUNS = ("dense", "paged", "prefix")
DP70_BATCH = 32            # two dp blocks of 16 slots


def row_count_probe():
    """The GEMMs of phase 20's decode step at 16 rows (a dp block) within
    64 (phase 19c's batch): B1 (int4b) on a tp = 2 qkv shard of the 70B
    mix and B3 on an lm_head vocabulary half, each row's output compared
    bit for bit. Returns {kernel: rows whose output differs}."""
    import torch

    from compressed_tensors_tpu_torch.config import CompressionFormat
    from compressed_tensors_tpu_torch.ops.linear import (
        QuantizedTensor,
        prepare_for_kernels,
        quantized_matmul,
    )
    from compressed_tensors_tpu_torch.ops.pack import pack_to_int32
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    gen = torch.Generator(device="cuda").manual_seed(20)
    h = LLAMA3_70B["hidden_size"]
    qkv = (LLAMA3_70B["num_attention_heads"]
           + 2 * LLAMA3_70B["num_key_value_heads"]) * LLAMA3_70B["head_dim"]
    codes, scale = card_w4_codes(gen, qkv // 2, h)
    linears = {
        "w4a16_matmul": prepare_for_kernels(QuantizedTensor(
            weight_packed=pack_to_int32(codes, 4), scale=scale,
            shape=(qkv // 2, h),
            scheme=preset_name_to_scheme("W4A16", ["Linear"]),
            format=CompressionFormat.pack_quantized.value)),
        "w8a8_matmul": card_w8a8(gen, LLAMA3_70B["vocab_size"] // 2, h,
                                 preset_name_to_scheme("W8A8",
                                                       ["Linear"]))}
    x = dev_randn(gen, BATCH, h)
    block = DP70_BATCH // 2
    out = {}
    for name, qt in linears.items():
        whole = quantized_matmul(x, qt)[:block].view(torch.int16)
        part = quantized_matmul(x[:block].contiguous(), qt).view(torch.int16)
        out[name] = int((part != whole).any(-1).sum())
    return out


def dp70_parent_side(tp2, dp_dir, ranks):
    """Phase 20 in this process: inputs.json for the ranks (started at
    phase 19's start, waiting for it; after 19c's ranks, so that neither
    phase's processes serve beside the other's), the row-count probe
    while they load and serve, then their reports."""
    import torch_dist_worker

    with open(os.path.join(dp_dir, "inputs.tmp"), "w") as f:
        json.dump({"ckpt": tp2["ckpt"], "requests": tp2["requests"],
                   "serve": dict(SERVE, max_batch=DP70_BATCH),
                   "counters": COUNTERS}, f)
    os.replace(os.path.join(dp_dir, "inputs.tmp"),
               os.path.join(dp_dir, "inputs.json"))
    probe = row_count_probe()
    reports = torch_dist_worker.finish("dp70b", ranks, dp_dir, SPAWN_SECONDS)
    return reports, probe


def phase_dp_processes(tp2, dp_dir, ranks):
    """Phase 20: data parallelism, dp = 2 x tp = 2, four processes on the
    one card (``tests/torch_dist_worker.py`` case "dp70b", gloo over CUDA
    tensors, started at phase 19's start). Each rank reads its tp blocks
    of 19c's checkpoint (config 5's mix at Llama-3-70B width, 4 of 80
    layers) through ``load_llama_params(mesh=make_mesh(dp=2, tp=2))``
    once 19c's ranks are done, fuses, and serves 19c's 32 requests at ``SERVE`` with 32 slots (two dp
    blocks of 16) dense, paged, and paged with prefix caching. Checks:
    the four ranks' completions equal in each run; dense = paged; both
    identical to 19c's tp = 2 completions (the same tp shards with the
    rows split; the GEMMs' per-row results at a block's 16 rows within
    19c's 64 bit for bit, ``row_count_probe``), or, where a kernel's
    per-row result depends on the rows of its call, that kernel named
    and the first tokens held to 19c's rule; the prefix run's requests
    without the prefix identical to the dense run's, hits > 0 of which
    at least one on a page the other dp block wrote, and the pages both
    blocks hold equal byte for byte on the ranks of one tp index; B1, B2,
    B3, B4, B6 and B7 launched on every rank. Readings: bytes read,
    seconds and GiB a rank, decode ms a step against 19c's tp = 2.
    Returns each rank's runs with their launch counts."""
    t_phase = time.perf_counter()
    reports, probe = dp70_parent_side(tp2, dp_dir, ranks)
    ref = {int(i): o for i, o in tp2["outs"].items()}
    n = len(ref)
    outs = {run: [{int(i): o for i, o in rep[run]["completions"].items()}
                  for rep in reports] for run in DP70_RUNS}
    for run in DP70_RUNS:
        if any(o != outs[run][0] for o in outs[run]):
            raise AssertionError(f"20 {run}: the ranks' completions differ")
    if outs["dense"][0] != outs["paged"][0]:
        raise AssertionError("20: dense and paged completions differ")
    same = sum(outs["paged"][0][i] == o for i, o in ref.items())
    first = sum(outs["paged"][0][i][0] == o[0] for i, o in ref.items())
    log(f"20 row-count probe ({DP70_BATCH // 2} rows within {BATCH}): rows "
        f"that differ "
        f"bit for bit {probe} ({card()})")
    if same != n:
        moved = [k for k, v in probe.items() if v]
        log(f"20: {same}/{n} completions identical to 19c's tp = 2, "
            f"{first}/{n} first tokens; kernels whose per-row result "
            f"depends on the call's rows: {moved or 'none of the probed'}")
        if not moved or first < tp2["first_floor"]:
            raise AssertionError(
                f"20: {same}/{n} identical to tp = 2 and {first}/{n} first "
                f"tokens (19c's rule: >= {tp2['first_floor']}); row-count "
                f"probe {probe}")
    prefix = outs["prefix"][0]
    shared = {i for i, _, _ in tp2["requests"] if i % SHARE_EVERY == 0}
    plain_same = sum(prefix[i] == outs["dense"][0][i] for i in ref
                     if i not in shared)
    if plain_same != n - len(shared):
        raise AssertionError(f"20 prefix: {plain_same}/{n - len(shared)} "
                             "requests without the prefix equal the dense "
                             "run's")
    for r, rep in enumerate(reports):
        run = rep["prefix"]
        if run["hits"] <= 0 or run["cross_block_hits"] <= 0 \
                or not run["shared_pages"]:
            raise AssertionError(f"20 rank {r}: prefix hits {run['hits']}, "
                                 f"{run['cross_block_hits']} on the other "
                                 "block's pages")
    for tp in range(2):
        digests = {rep["prefix"]["shared_digest"] for rep in reports
                   if rep["coords"]["tp"] == tp}
        if len(digests) != 1:
            raise AssertionError(f"20: the pages both dp blocks hold differ "
                                 f"at tp index {tp}")
    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    results = {}
    for r, rep in enumerate(reports):
        missing = [k for k in ("w4a16_matmul", "w4a16_a8b_matmul",
                               "w8a8_matmul", "prefill_attention",
                               "flash_decode_attention",
                               "paged_decode_attention")
                   if not sum(rep[run]["counts"][k] for run in DP70_RUNS)]
        if missing:
            raise AssertionError(f"20 rank {r} never launched {missing}")
        for run in DP70_RUNS:
            results[f"70B dp=2 x tp=2 rank {r} {run}"] = rep[run]
        log(f"20 rank {r} (dp {rep['coords']['dp']}, tp "
            f"{rep['coords']['tp']}): local heads {rep['heads']}, read "
            f"{rep['bytes_read'] / 1e9:.3f} GB in {rep['load_s']:.2f} s with "
            f"the fuse ({rep['gib']:.2f} GiB on the card); "
            + "; ".join(f"{run} {rep[run]['serve_s']:.2f} s, decode "
                        f"{rep[run]['decode_ms']:.2f} ms a step over "
                        f"{rep[run]['steps']} steps, launches "
                        f"{nonzero(rep[run]['counts'])}"
                        for run in DP70_RUNS)
            + f"; prefix hits {rep['prefix']['hits']}, "
            f"{rep['prefix']['cross_block_hits']} on pages the other block "
            f"wrote, {len(rep['prefix']['shared_pages'])} pages both blocks "
            "hold")
    log(f"20 dp = 2 x tp = 2 over 4 processes (gloo): completions equal on "
        f"all four ranks in each run, dense = paged, {same}/{n} identical "
        f"to 19c's tp = 2 ({first}/{n} first tokens); prefix run: the "
        f"{n - len(shared)} requests without the prefix equal the dense "
        f"run's, {sum(prefix[i] == outs['dense'][0][i] for i in shared)}/"
        f"{len(shared)} with it; decode {reports[0]['paged']['decode_ms']:.2f}"
        f" ms a step (paged) against 19c's {tp2['decode_ms']:.2f} at tp = 2 "
        f"({card()})")
    log(f"phase 20 wall {time.perf_counter() - t_phase:.1f} s ({card()})")
    return results


def phase_parallel(serving):
    """Phase 19 (19a, 19b, 19c) and phase 20, whose four ranks start first
    (their torch import and group beside 19a-19c) and read 19c's
    checkpoint: one temporary directory spans both."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist_worker

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dp_dir = os.path.join(tmp, "dp")
        os.makedirs(dp_dir)
        dp_ranks = torch_dist_worker.start("dp70b", dp_dir, 4, "cuda")
        try:
            results = phase_mesh_one(serving)
            log(f"phase 19a wall {time.perf_counter() - t_phase:.1f} s")
            phase_shard_arithmetic()
            tp_results, tp2 = phase_tp2_processes(tmp)
            results.update(tp_results)
            log(f"phase 19 wall {time.perf_counter() - t_phase:.1f} s "
                f"({card()})")
            results.update(phase_dp_processes(tp2, dp_dir, dp_ranks))
        finally:
            torch_dist_worker.stop(dp_ranks)
    return results


KERNEL_META = {
    "w4a16_matmul": ("compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
                     "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w4a16_a8b_matmul": (
        "compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w8a8_matmul": ("compressed_tensors_tpu_torch/csrc/w8a8_matmul.cu",
                    "compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:118"),
    "w8a8_matmul_fp8": ("compressed_tensors_tpu_torch/csrc/w8a8_matmul.cu",
                        "compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:118"),
    "prefill_attention": (
        "compressed_tensors_tpu_torch/csrc/prefill_attention.cu",
        "compressed_tensors_tpu/ops/kernels/prefill_attention.py:141"),
    "decode_attention": (
        "compressed_tensors_tpu_torch/csrc/decode_attention.cu",
        "compressed_tensors_tpu/ops/kernels/decode_attention.py:290"),
    "decode_attention_scaled": (
        "compressed_tensors_tpu_torch/csrc/decode_attention.cu",
        "compressed_tensors_tpu/ops/kernels/decode_attention.py:290"),
    "flash_decode_attention": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/flash_decode.py:317"),
    "flash_decode_attention_scaled": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/flash_decode.py:317"),
    "paged_decode_attention": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/paged_decode.py:310"),
    "paged_decode_attention_scaled": (
        "compressed_tensors_tpu_torch/csrc/paged_decode.cu",
        "compressed_tensors_tpu/ops/kernels/paged_decode.py:310"),
    "w4a16_fp4_matmul": (
        "compressed_tensors_tpu_torch/csrc/wna16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w4_e8_matmul": ("compressed_tensors_tpu_torch/csrc/wna16_matmul.cu",
                     "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:485"),
    **{f"w4a16_planes_{mode}": (
        "compressed_tensors_tpu_torch/csrc/w4a16_planes.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541")
       for mode in ("int4", "a8", "mat")},
    # the expert-batched launches: the JAX package vmaps these kernels over
    # the expert dim in quantized_matmul_experts (ops/linear.py:800, :810)
    "w4a16_experts_matmul": (
        "compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w4a16_a8b_experts_matmul": (
        "compressed_tensors_tpu_torch/csrc/w4a16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:541"),
    "w4_e8_experts_matmul": (
        "compressed_tensors_tpu_torch/csrc/wna16_matmul.cu",
        "compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:485"),
    # MLA's latent head: the JAX package calls these kernels with kvh=1,
    # rep=h, d=Dp, true_d (models/mla.py:149-165)
    "decode_attention_latent": (
        "compressed_tensors_tpu_torch/csrc/mla_decode.cu",
        "compressed_tensors_tpu/ops/kernels/decode_attention.py:290"),
    "paged_decode_attention_latent": (
        "compressed_tensors_tpu_torch/csrc/mla_decode.cu",
        "compressed_tensors_tpu/ops/kernels/paged_decode.py:310"),
}
BATCHED_BY = {
    "w4a16_experts_matmul": "compressed_tensors_tpu/ops/linear.py:800",
    "w4a16_a8b_experts_matmul": "compressed_tensors_tpu/ops/linear.py:800",
    "w4_e8_experts_matmul": "compressed_tensors_tpu/ops/linear.py:810"}


# the main variant of kernels timed in several (the others go under
# "variants"); the scaled decode kernels' main variant is the fp8 cache
MAIN_VARIANT = {"prefill_attention": "8B chunk", "w8a8_matmul_fp8": BATCH,
                "w8a8_matmul": f"8B lm_head M={BATCH}",
                "w4a16_matmul": f"8B M={BATCH}",
                "w4a16_a8b_matmul": f"M={M_CHUNK}",
                "decode_attention": "TinyLlama",
                "flash_decode_attention": "8B", "paged_decode_attention": "8B",
                "w4a16_fp4_matmul": "nvfp4 M=64", "w4_e8_matmul": "w8a16 M=64",
                "w4a16_planes_int4": "M=64", "w4a16_planes_a8": "M=64",
                "w4a16_planes_mat": "M=64", "w4a16_experts_matmul": "gate C=8",
                "w4a16_a8b_experts_matmul": "Mixtral C=320",
                "w4_e8_experts_matmul": "gate C=8",
                "decode_attention_latent": "bf16 S_pad=1024",
                "paged_decode_attention_latent": "bf16"}


def kernel_report(errs, rows, variant_rows, paths):
    """The kernels line: one entry per kernel, at the newest (8B) shapes
    where a path runs it: B1 (int4b) at decode rows (M = 64; TinyLlama's M
    = 64 and 8192 and the 8B 512-row chunk under ``variants``), prefill
    attention at the 8B chunk (the Qwen2.5-7B
    chunk and TinyLlama's prompts under ``variants``), fp8 W8A8 at decode rows (M = 64) with the
    512-row chunk under ``variants``, the scaled decode kernels on the
    fp8 cache with the int8 cache under ``variants``, the fp4 kernel on
    NVFP4 at M = 64 (MXFP4 and M = 512 under ``variants``), the
    grouped-int8 kernel on W8A16 at M = 64 (W4A16 under e8 and M = 512
    under ``variants``), each plane-layout mode at Qwen2.5-7B shapes at
    M = 64 (M = 512 under ``variants``). Launches are summed over the main
    paths' runs (``paths``: run name -> launch counts), with the split by
    run beside them."""
    by_name = {r["name"]: r for r in rows}  # later (8B) rows win
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        if name in variant_rows:
            variants = variant_rows[name]
            key = MAIN_VARIANT.get(name, "fp8")
            r = variants[key]
            extra = {"variants": {str(v): dict(vr) for v, vr in
                                  variants.items() if v != key}}
        else:
            r, extra = by_name[name], {}
        by_path = {run: counts[name] for run, counts in paths.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shapes": r["shapes"], **extra,
            **({"batched_by": BATCHED_BY[name]} if name in BATCHED_BY
               else {}),
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
    from compressed_tensors_tpu_torch.flags import FLAGS

    if FLAGS.enforce_eager or FLAGS.w4_dense_m:
        print("chip_smoke: enforce_eager or w4_dense_m is set (the "
              "CT_TORCH_ENFORCE_EAGER / CT_TORCH_W4_DENSE_M variables): the "
              "kernel paths would not run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    resources, serialized = phase_device_and_build()
    errs = phase_parity()
    phase_parity_8b(errs)
    phase_parity_fp8(errs)
    log(f"phases 1-2 done at {time.perf_counter() - t_start:.1f} s")
    e2e = phase_end_to_end()
    rows, b1 = phase_timings(errs, e2e["run_counts"], e2e["per_step"])
    log(f"phases 3-4 (TinyLlama) done at {time.perf_counter() - t_start:.1f} s")
    serving = phase_serving()
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    rows_8b, prefill, decode, a8b, b1_8b = phase_timings_8b(serving)
    prefill["TinyLlama B=64 S=128"] = next(
        r for r in rows if r["name"] == "prefill_attention")
    rows += rows_8b
    fp8 = phase_fp8()
    log(f"phase 6 (FP8) done at {time.perf_counter() - t_start:.1f} s")
    variant_rows = phase_timings_fp8()
    variant_rows["prefill_attention"] = prefill
    variant_rows.update(decode)
    variant_rows["w4a16_a8b_matmul"] = a8b
    variant_rows["w4a16_matmul"] = {**b1_8b, **b1}
    variant_rows["decode_attention"]["TinyLlama"] = next(
        r for r in rows if r["name"] == "decode_attention")
    log(f"FP8 timings done at {time.perf_counter() - t_start:.1f} s")
    nvfp4 = phase_nvfp4(errs)
    log(f"phase 7 (NVFP4) done at {time.perf_counter() - t_start:.1f} s")
    w8a16 = phase_w8a16(errs)
    log(f"phase 8 (W8A16) done at {time.perf_counter() - t_start:.1f} s")
    variant_rows["w4a16_fp4_matmul"] = timings_wna16("w4a16_fp4_matmul",
                                                     FP4_GROUPS)
    variant_rows["w4_e8_matmul"] = timings_wna16("w4_e8_matmul", E8_BITS)
    for name in ("w4a16_fp4_matmul", "w4_e8_matmul"):
        for r in variant_rows[name].values():
            log(f"kernel {name} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
    log(f"phases 7-8 timings done at {time.perf_counter() - t_start:.1f} s")
    qwen25 = phase_qwen25(errs)
    log(f"phase 9 (Qwen2.5-7B) done at {time.perf_counter() - t_start:.1f} s")
    qwen3 = phase_qwen3(errs)
    log(f"phase 10 (Qwen3-8B) done at {time.perf_counter() - t_start:.1f} s")
    variant_rows.update(timings_planes())
    for name in ("w4a16_planes_int4", "w4a16_planes_a8", "w4a16_planes_mat"):
        for r in variant_rows[name].values():
            log(f"kernel {name} [{r['shapes']}]: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
    log(f"phases 9-10 timings done at {time.perf_counter() - t_start:.1f} s")
    sparse24 = phase_sparse24(serving)
    log(f"phase 11 (2:4 + INT4) done at {time.perf_counter() - t_start:.1f} s")
    w8a8_tiny = phase_w8a8_tiny()
    log(f"phase 12 (TinyLlama W8A8) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    mixed = phase_mixed()
    log(f"phase 13 (mixed W4A16/W8A8) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    variant_rows["w8a8_matmul"] = {
        f"8B lm_head M={BATCH}": next(r for r in rows_8b
                                      if r["name"] == "w8a8_matmul"),
        f"TinyLlama lm_head M={BATCH}": next(
            r for r in rows if r["name"] == "w8a8_matmul"),
        **timings_w8a8_int8()}
    log(f"phases 11-13 timings done at {time.perf_counter() - t_start:.1f} s")
    moe = phase_moe(errs)
    log(f"phase 14 (Qwen3-30B-A3B MoE) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    variant_rows.update(timings_moe())
    log(f"phase 14 timings done at {time.perf_counter() - t_start:.1f} s")
    mla = phase_mla(errs)
    log(f"phase 15 (DeepSeek-V2-Lite MLA) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    mla.update(phase_mla_v2())
    log(f"phase 15b (DeepSeek-V2, 128 heads) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    latent_rows, b1e_g64 = timings_mla()
    variant_rows.update(latent_rows)
    variant_rows["w4a16_experts_matmul"].update(b1e_g64)
    log(f"phase 15 timings done at {time.perf_counter() - t_start:.1f} s")
    ptq = phase_ptq()
    log(f"phase 16 (PTQ) done at {time.perf_counter() - t_start:.1f} s")
    transforms = phase_transforms()
    log(f"phase 17 (transforms) done at {time.perf_counter() - t_start:.1f} s")
    converters = phase_converters()
    log(f"phase 18 (converters) done at {time.perf_counter() - t_start:.1f} s")
    parallel = phase_parallel(serving)
    log(f"phases 19-20 (parallel) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    paths = {"greedy_generate": e2e["run_counts"]}
    paths.update({f"serving {run}": res["counts"]
                  for run, res in serving.items()})
    for phase in (fp8, nvfp4, w8a16, qwen25, qwen3, sparse24, w8a8_tiny,
                  mixed, moe, mla, ptq, transforms, converters, parallel):
        paths.update({run: res["counts"] for run, res in phase.items()})
    kernels = kernel_report(errs, rows, variant_rows, paths)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"registers": {
        name: {"registers": r, "spill_bytes": b,
               "wgmma_serialized": serialized.get(name, [])}
        for name, (r, b) in resources.items()}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
