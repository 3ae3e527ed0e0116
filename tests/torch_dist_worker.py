"""The port's two-process harness: ``spawn`` starts the ranks and this file
is one rank. ``tests/test_torch_distributed.py`` runs it on the CPU and
``chip_smoke.py`` phase 16c on the card.

A rank is ``python tests/torch_dist_worker.py CASE DEVICE RANK WORLD PORT
OUT_DIR`` with the repository root on ``PYTHONPATH``: it imports only the
port (no JAX, no pytest), opens a group at ``localhost:PORT`` through
``init_dist``, runs CASE and writes what the parent checks into OUT_DIR
(``rank<RANK>.json``, and for the compress cases
``rank<RANK>.safetensors``, the full recoupled state).

CASE "broadcast": a gloo group, ``broadcast_object`` from rank 0 and from
rank 1, ``wait_for_comms``. CASE "compress": a gloo group,
``compress_state_parallel`` over the states of ``tests/test_distributed/
test_multiprocess.py::test_compress_state_parallel_recouple`` (three int8
channel-quantized linears drawn from ``np.random.default_rng(3)``), drawn
and calibrated with the port on DEVICE. CASE "compress-file": a gloo group
(it carries the object broadcast), ``compress_state_parallel`` over the
states the parent wrote to ``OUT_DIR/states.safetensors`` with the recipe
of ``OUT_DIR/quantization_config.json``, loaded onto DEVICE, timed. CASE
"nccl": an NCCL group on the card, an all-reduce of a one, the group torn
down. CASE "parallel": a gloo group on the CPU and the tensor, expert,
pipeline and data parallel oracles of ``tests/test_torch_parallel.py``
over the inputs the parent wrote (``inputs.json``, ``inputs.npz``), the
arrays written to ``rank<RANK>.npz``. CASE "dp4": four gloo ranks on the
CPU, the dp = 2 x tp = 2 engine and the pp = 2 x dp = 2 pipeline of
``tests/test_torch_data_parallel.py``, written the same way. CASE
"tp70b": a gloo group over CUDA tensors (NCCL takes one rank a card):
this rank's blocks of the checkpoint under
``OUT_DIR/ckpt`` loaded at tp = 2, logits and serving as ``chip_smoke.py``
phase 19c reads them (``rank<RANK>.pt``). CASE "dp70b": four such ranks at
dp = 2 x tp = 2, the checkpoint and requests ``OUT_DIR/inputs.json``
names served dense, paged and prefix-cached (``chip_smoke.py`` phase 20).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from compressed_tensors_tpu_torch.distributed import (
    broadcast_object,
    compress_state_parallel,
    init_dist,
    is_distributed,
    partition_modules,
    process_count,
    process_index,
)
from compressed_tensors_tpu_torch.distributed.utils import wait_for_comms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_distributed/test_multiprocess.py's recipe
CONFIG = {
    "config_groups": {"group_0": {
        "targets": ["Linear"],
        "weights": {"num_bits": 8, "type": "int", "strategy": "channel",
                    "symmetric": True}}},
    "format": "naive-quantized",
    "quant_method": "compressed-tensors",
}
ROWS = (32, 8, 8)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(case, out_dir, world=2, device="cpu"):
    """Start ``world`` ranks of CASE on DEVICE; ``finish`` collects them."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        env.pop(var, None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, device, str(rank),
         str(world), str(port), str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def stop(procs):
    """Kill the ranks still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def spawn(case, out_dir, world=2, device="cpu", timeout=90):
    """Run ``world`` ranks of CASE on DEVICE, each within ``timeout``
    seconds; returns their reports after every rank exited 0, and raises
    with a rank's output otherwise. No rank outlives the call."""
    return finish(case, start(case, out_dir, world, device), out_dir,
                  timeout)


def finish(case, procs, out_dir, timeout=90):
    """Wait for ranks from ``start``, each within ``timeout`` seconds;
    their reports, as ``spawn`` returns them. No rank outlives the
    call."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        stop(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{case} rank {rank} exited {p.returncode}:"
                               f"\n{out[-4000:]}")
    reports = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    return reports


def wait_for(path):
    """Return once the parent has written ``path`` (it writes each file a
    rank waits for under another name first, then renames it)."""
    while not os.path.exists(path):
        time.sleep(0.1)


def recouple_states(device="cpu"):
    """The module states and graph of ``test_compress_state_parallel_
    recouple``, drawn and calibrated with the port."""
    from compressed_tensors_tpu_torch.compressors import (
        ModelCompressor,
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.ops import calculate_qparams

    mc = ModelCompressor.from_compression_config(CONFIG)
    args = mc.quantization_config.config_groups["group_0"].weights
    rng = np.random.default_rng(3)
    states = {}
    for i, rows in enumerate(ROWS):
        w = torch.from_numpy(rng.normal(size=(rows, 16)).astype(
            np.float32)).to(device)
        scale, _ = calculate_qparams(w.amin(-1, keepdim=True),
                                     w.amax(-1, keepdim=True), args)
        states[f"m.proj{i}"] = {"weight": w, "weight_scale": scale}
    return mc, states, module_graph_from_names(list(states))


def file_states(out_dir, device):
    """The states and recipe the parent wrote to OUT_DIR, on DEVICE."""
    from compressed_tensors_tpu_torch.compressors import (
        ModelCompressor,
        module_graph_from_names,
    )
    from compressed_tensors_tpu_torch.quantization import QuantizationConfig
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        load_safetensors,
    )

    # the parent may start the ranks before it writes the states: the
    # recipe comes last
    wait_for(os.path.join(out_dir, "quantization_config.json"))
    with open(os.path.join(out_dir, "quantization_config.json")) as f:
        qconfig = QuantizationConfig.model_validate(json.load(f))
    states = {}
    for name, t in load_safetensors(
            os.path.join(out_dir, "states.safetensors")).items():
        module, key = name.rsplit(".", 1)
        states.setdefault(module, {})[key] = t.to(device)
    return (ModelCompressor(quantization_config=qconfig), states,
            module_graph_from_names(list(states)))


def compress(case, device, rank, world, out_dir):
    """``compress_state_parallel`` of the case's states; the full state
    written to ``rank<RANK>.safetensors``; the report."""
    from compressed_tensors_tpu_torch.utils.safetensors_io import (
        save_safetensors,
    )

    mc, states, modules = (recouple_states(device) if case == "compress"
                           else file_states(out_dir, device))
    _, owner = partition_modules(states, world)
    mine = [m for m in states if owner[m] == rank]
    dist.barrier()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = compress_state_parallel(mc, states, modules)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    save_safetensors(
        os.path.join(out_dir, f"rank{rank}.safetensors"),
        {f"{m}.{k}": v for m, s in out.items() for k, v in s.items()})
    return {"owner": owner, "seconds": seconds, "owned": len(mine),
            "owned_bytes": sum(t.numel() * t.element_size() for m in mine
                               for t in states[m].values()),
            "devices": sorted({v.device.type for s in out.values()
                               for v in s.values()})}


# --------------------------------------------------------------------------- #
# CASE "parallel": tensor, expert and pipeline parallelism (parallel/), each
# sub-case's results written for the parent, which holds them against the
# JAX package's single-device results

# tests/test_parallel/test_moe_sharding.py's and test_pipeline.py's model
PARALLEL_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=32)
MOE = dict(num_local_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=128)
# (name, mesh, MOE overrides) of the MoE forwards
MOE_CASES = (("moe_ep2", "ep2", {}), ("moe_tp2", "tp2", {}),
             ("moe_wide_tp2", "tp2", dict(moe_intermediate_size=256)),
             ("moe_ep2_odd", "ep2", dict(num_local_experts=3)))


def shared_pages_digest(engine):
    """sha256 of the K/V bytes of the registered pages every dp block holds
    (``ServingEngine._page_shared``), in page order."""
    import hashlib

    from compressed_tensors_tpu_torch.utils.dtypes import byte_view

    pages = sorted(set(engine._page_shared) & set(engine._page_digest))
    h = hashlib.sha256()
    if pages:
        idx = torch.tensor(pages, device=engine.cache.k.device)
        for pool in (engine.cache.k, engine.cache.v):
            rows = byte_view(pool)[:, idx].contiguous()
            h.update(rows.view(torch.uint8).cpu().numpy().tobytes())
    return pages, h.hexdigest()


def engine_run(params, config, requests, mesh, **kw):
    """test_serving_sharded.py's ``_run`` settings through the port's
    engine; ``kw`` overrides them. Over a dp split the decode calls with
    an empty dp block are counted and the pages shared across blocks
    digested."""
    from compressed_tensors_tpu_torch.engine import Request, ServingEngine

    settings = dict(max_batch=2, max_len=32, prefill_chunk=4)
    settings.update(kw)
    engine = ServingEngine(params, config, dtype=torch.float32, mesh=mesh,
                           device="cpu", **settings)
    empty = [0]
    if engine._dp_split:
        decode = engine._decode

        def counted(active, burst):
            blocks = active.reshape(mesh.shape["dp"], -1).any(axis=1)
            empty[0] += int(not blocks.all())
            return decode(active, burst)

        engine._decode = counted
    done = []
    for batch in requests:   # each batch runs to its end before the next
        for r in batch:
            engine.submit(Request(**r))
        done += engine.run()
    out = {"completions": {c.request_id: [c.output_ids, c.finish_reason]
                           for c in done},
           "preemptions": engine.preemptions,
           "prefix_cache_hits": engine.prefix_cache_hits}
    if engine.paged:
        out["pages_accounted"] = (len(engine._free_pages)
                                  + len(engine._cached_free)
                                  + len(engine._page_ref))
    if engine._dp_split:
        out["empty_block_steps"] = empty[0]
        out["cross_block_hits"] = engine.cross_block_hits
        if engine.paged:
            out["shared_pages"], out["shared_digest"] = shared_pages_digest(
                engine)
    return out


def parallel(out_dir, rank):
    """Every sub-case of CASE "parallel" on this rank (2 gloo ranks on the
    CPU); returns the JSON report and the arrays."""
    import dataclasses

    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models import (
        llama_forward,
        load_llama_params,
    )
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.models.synthetic import (
        make_synthetic_llama,
    )
    from compressed_tensors_tpu_torch.offload import load_sharded_params
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels.w8a8_matmul import (
        quantize_rows_plain,
    )
    from compressed_tensors_tpu_torch.parallel import (
        make_mesh,
        matmul_reducescatter,
        pipeline_forward,
        ring_allgather_matmul,
        ring_allgather_matmul_quantized,
        shard_llama_params,
        stack_stage_params,
    )
    from compressed_tensors_tpu_torch.ops.linear import quantized_matmul
    from compressed_tensors_tpu_torch.parallel.mesh import (
        _shard_qt,
        row_parallel_input,
        row_parallel_matmul,
    )

    with open(os.path.join(out_dir, "inputs.json")) as f:
        inputs = json.load(f)
    arrays = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    # every rank opens the same groups in the same order
    tp2 = make_mesh(tp=2, device="cpu")
    ep2 = make_mesh(ep=2, device="cpu")
    pp2 = make_mesh(pp=2, device="cpu")
    dp2 = make_mesh(dp=2, device="cpu")
    report, out = {}, {}
    t0 = time.perf_counter()

    def load(name):
        return load_llama_params(inputs["paths"][name], dtype=torch.float32,
                                 device="cpu")

    # engines: test_serving_sharded.py's oracles at tp = 2
    params, config, _ = load("w4")
    fused = fuse_llama_layers(params)
    reqs = inputs["requests"]["w4"]
    report["dense"] = engine_run(fused, config, [reqs], tp2)
    report["paged"] = engine_run(fused, config, [reqs], tp2, paged=True,
                                 page_size=8)
    # the multiprocess forward and sharded loading
    ids = torch.from_numpy(arrays["forward_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    sharded = shard_llama_params(params, tp2, config)
    out["forward_logits"] = llama_forward(sharded, config, ids, pos)[0]
    # B2's a8b mode quantizes each row by its absmax: a K shard takes the
    # whole row's
    with flag_overrides(w4_act="int8"):
        out["a8b_sharded"] = llama_forward(sharded, config, ids, pos)[0]
        out["a8b_unsharded"] = llama_forward(params, config, ids, pos)[0]
    loaded, _, _ = load_llama_params(inputs["paths"]["w4"],
                                     dtype=torch.float32, device="cpu",
                                     mesh=tp2)
    same = []
    for a, b in zip(loaded["layers"], sharded["layers"]):
        for key, qt in b.items():
            if hasattr(qt, "kernel_meta"):
                for field in dataclasses.fields(qt):
                    x, y = getattr(qt, field.name), getattr(a[key],
                                                           field.name)
                    same.append(torch.equal(x, y) if isinstance(
                        x, torch.Tensor) else x == y)
    report["sharded_load_equal"] = all(same) and torch.equal(
        loaded["embed_tokens"], sharded["embed_tokens"])
    out["loaded_logits"] = llama_forward(loaded, config, ids, pos)[0]
    report["loaded_bytes"] = loaded["shard"].bytes_read

    mixed, mconfig, _ = load("mixed")
    mfused = fuse_llama_layers(mixed)
    reqs = inputs["requests"]["mixed"]
    report["mixed"] = engine_run(mfused, mconfig, [reqs], tp2)
    report["mixed_paged"] = engine_run(mfused, mconfig, [reqs], tp2,
                                       paged=True, page_size=8)
    report["preempt"] = engine_run(
        mfused, mconfig, [inputs["requests"]["preempt"]], tp2,
        prefill_chunk=8, paged=True, page_size=8, num_pages=5)
    # the unsharded dense engine the JAX test holds preemption against
    report["preempt_unsharded"] = engine_run(
        mfused, mconfig, [inputs["requests"]["preempt"]], None,
        prefill_chunk=8)
    report["prefix"] = engine_run(
        mfused, mconfig, [[r] for r in inputs["requests"]["prefix"]], tp2,
        max_len=64, prefill_chunk=8, paged=True, page_size=8)
    report["burst"] = engine_run(mfused, mconfig,
                                 [inputs["requests"]["burst"]], tp2,
                                 steps_per_sync=4)
    report["burst_per_step"] = engine_run(mfused, mconfig,
                                          [inputs["requests"]["burst"]], tp2)

    # a K-sharded W8A8 down projection, rows' absmax on the other rank
    qt = mixed["layers"][1]["down_proj"]
    x = torch.from_numpy(arrays["w8_x"])
    k = qt.shape[1] // 2
    local = shard_llama_params(mixed, tp2, mconfig)["layers"][1]["down_proj"]
    xin = row_parallel_input(x[:, rank * k:(rank + 1) * k], local, tp2)
    xq, xs = quantize_rows_plain(xin, torch.int8)
    fq, fs = quantize_rows_plain(x, torch.int8)
    report["w8_codes_equal"] = torch.equal(xq[:, :k],
                                           fq[:, rank * k:(rank + 1) * k])
    report["w8_scales_equal"] = torch.equal(xs, fs)
    out["w8_y"] = row_parallel_matmul(x[:, rank * k:(rank + 1) * k], local,
                                      tp2)
    out["w8_y_nonkernel"] = row_parallel_matmul(
        x[:, rank * k:(rank + 1) * k], local, tp2, use_kernels=False)

    # an actorder (g_idx) W4A16 linear split on K: the permutation crosses
    # the shards, so each rank gathers the input, permutes, and takes its
    # slice through the permuted kernel layout
    qt, x = actorder_linear()
    local = _shard_qt(qt, "down_proj", tp2)
    k = qt.shape[1] // 2
    out["actorder_y"] = row_parallel_matmul(x[:, rank * k:(rank + 1) * k],
                                            local, tp2)
    out["actorder_ref"] = quantized_matmul(x, qt)
    try:
        row_parallel_matmul(x[:, rank * k:(rank + 1) * k], local, tp2,
                            use_kernels=False)
        report["actorder_nonkernel_refused"] = False
    except NotImplementedError:
        report["actorder_nonkernel_refused"] = True

    # shard-per-process checkpoint load
    stats = {}
    blocks = load_sharded_params(os.path.join(out_dir, "st"),
                                 {"w": ("tp", None)}, tp2, stats=stats)
    out["st_w"], out["st_b"] = blocks["w"], blocks["b"]
    report["st_bytes_read"] = stats["bytes_read"]

    # MLA: only o_proj is sharded
    mla, mla_config, _ = load("mla")
    mla_ids = torch.from_numpy(arrays["mla_ids"])
    mla_pos = torch.arange(mla_ids.shape[1]).expand(mla_ids.shape)
    mla_s = shard_llama_params(mla, tp2, mla_config)
    report["mla_rows"] = sorted(mla_s["layers"][0]["shard"].rows)
    report["mla_replicated_inputs"] = sorted(
        mla_s["layers"][0]["shard"].replicated_inputs)
    report["mla_q_a_whole"] = (mla_s["layers"][0]["q_a_proj"]
                               is mla["layers"][0]["q_a_proj"])
    out["mla_logits"] = llama_forward(mla_s, mla_config, mla_ids, mla_pos)[0]

    # rings (test_overlap.py)
    x, w = torch.from_numpy(arrays["ring_x"]), torch.from_numpy(
        arrays["ring_w"])
    kk, nn = x.shape[1] // 2, w.shape[0] // 2
    out["ring_ag"] = ring_allgather_matmul(
        x[:, rank * kk:(rank + 1) * kk], w[rank * nn:(rank + 1) * nn], tp2)
    out["ring_rs"] = matmul_reducescatter(
        x[:, rank * kk:(rank + 1) * kk], w[:, rank * kk:(rank + 1) * kk], tp2)
    x, wu, wd = (torch.from_numpy(arrays[n]) for n in
                 ("mlp_x", "mlp_up", "mlp_down"))
    hh, ii = x.shape[1] // 2, wu.shape[0] // 2
    h = ring_allgather_matmul(x[:, rank * hh:(rank + 1) * hh],
                              wu[rank * ii:(rank + 1) * ii], tp2)
    out["ring_mlp"] = matmul_reducescatter(
        torch.nn.functional.gelu(h, approximate="tanh"),
        wd[:, rank * ii:(rank + 1) * ii], tp2)
    x = torch.from_numpy(arrays["ringq_x"])
    shard = ring_shard(rank)
    kk = x.shape[1] // 2
    out["ring_q"] = ring_allgather_matmul_quantized(
        x[:, rank * kk:(rank + 1) * kk], shard, tp2)

    # pipeline (test_pipeline.py): pp = 2
    pcfg = LlamaConfig(**dict(PARALLEL_CFG, num_hidden_layers=4))
    ids = torch.from_numpy(arrays["pp_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    for preset in ("W4A16", "W8A8"):
        p = make_synthetic_llama(pcfg, preset=preset, use_kernels=False,
                                 dtype=torch.float32, device="cpu")
        p["stages"] = stack_stage_params(p.pop("layers"), 2)
        out[f"pp_{preset}"] = pipeline_forward(p, pcfg, ids, pos, pp2,
                                               n_microbatches=2)

    # MoE (test_moe_sharding.py): ep = 2, tp = 2, and tp = 2 with experts
    # wide enough to split into whole groups; ep = 2 over 3 experts, which
    # it does not divide (every rank holds them all)
    ids = torch.from_numpy(arrays["moe_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    for name, mesh, extra in MOE_CASES:
        cfg = LlamaConfig(**PARALLEL_CFG, **dict(MOE, **extra))
        p = make_synthetic_llama(cfg, preset="W4A16", use_kernels=False,
                                 dtype=torch.float32, device="cpu")
        ps = shard_llama_params(p, {"ep2": ep2, "tp2": tp2}[mesh], cfg)
        report[name + "_experts"] = list(ps["layers"][0]["shard"].experts)
        out[name] = llama_forward(ps, cfg, ids, pos)[0]

    # K shards of the other kernels that quantize their input rows by the
    # row's absmax, each on an input whose rows' absmax lies on rank 1's
    # half of K, against the unsharded port: the MoE block of stacked
    # experts' int4 words in a8b (B2e) and of W8A8 experts (per-token int8
    # products), and a down projection in the plane layout's a8 mode (B10)
    from compressed_tensors_tpu_torch.models.moe import moe_mlp

    wide = LlamaConfig(**PARALLEL_CFG, **dict(MOE, moe_intermediate_size=256))
    dense = LlamaConfig(**PARALLEL_CFG)
    x = torch.from_numpy(arrays["rows_x"])
    for name, cfg, preset, flags in (
            ("rows_moe_a8b", wide, "W4A16", dict(w4_act="int8")),
            ("rows_moe_w8a8", wide, "W8A8", {}),
            ("rows_planes_a8", dense, "W4A16",
             dict(w4_layout="packed", w4_mode="a8"))):
        with flag_overrides(**flags):
            p = make_synthetic_llama(cfg, preset=preset, dtype=torch.float32,
                                     device="cpu")
            layer = shard_llama_params(p, tp2, cfg)["layers"][0]
            if "moe" in layer:
                report[name + "_split"] = bool(layer["shard"].experts[2])
                out[name + "_sharded"] = moe_mlp(layer, x, cfg)
                out[name + "_unsharded"] = moe_mlp(p["layers"][0], x, cfg)
            else:
                local = layer["down_proj"]
                report[name + "_split"] = "down_proj" in layer["shard"].rows
                h = torch.nn.functional.silu(x @ x.new_ones(128, 256) / 64)
                h[..., 200] = 9.0
                k = local.shape[1]
                out[name + "_sharded"] = row_parallel_matmul(
                    h[..., rank * k:(rank + 1) * k], local, tp2)
                out[name + "_unsharded"] = quantized_matmul(
                    h, p["layers"][0]["down_proj"])
    data_parallel(inputs, arrays, dp2, report, out, models=dict(
        w4=(fused, config), mixed=(mfused, mconfig), mla=(mla, mla_config)))
    report["seconds"] = time.perf_counter() - t0
    return report, {k: v.numpy() for k, v in out.items()}


def data_parallel(inputs, arrays, dp2, report, out, models):
    """The data parallel sub-cases of CASE "parallel" at dp = 2 (keys
    ``dp_*``): the engine cases and bursts, a prefix hit on a page the
    other block wrote, ``moe_mlp`` with capacity over both blocks (and its
    control, each block's capacity alone), ``llama_forward`` on each
    rank's rows of the MoE, mixed and MLA models, and ``greedy_generate``
    over dp-replicated MoE params with the whole batch."""
    from compressed_tensors_tpu_torch.engine import greedy_generate
    from compressed_tensors_tpu_torch.models import llama_forward
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.models.moe import moe_mlp
    from compressed_tensors_tpu_torch.models.synthetic import (
        make_synthetic_llama,
    )
    from compressed_tensors_tpu_torch.parallel import (
        dp_rows,
        shard_llama_params,
    )

    reqs = inputs["requests"]
    fused, config = models["w4"]
    report["dp_dense"] = engine_run(fused, config, [reqs["w4"]], dp2)
    report["dp_paged"] = engine_run(fused, config, [reqs["w4"]], dp2,
                                    paged=True, page_size=8)
    mfused, mconfig = models["mixed"]
    report["dp_mixed"] = engine_run(mfused, mconfig, [reqs["mixed"]], dp2)
    report["dp_mixed_paged"] = engine_run(mfused, mconfig, [reqs["mixed"]],
                                          dp2, paged=True, page_size=8)
    report["dp_preempt"] = engine_run(
        mfused, mconfig, [reqs["preempt"]], dp2, prefill_chunk=8, paged=True,
        page_size=8, num_pages=5)
    report["dp_prefix"] = engine_run(
        mfused, mconfig, [[r] for r in reqs["prefix"]], dp2, max_len=64,
        prefill_chunk=8, paged=True, page_size=8)
    report["dp_burst"] = engine_run(mfused, mconfig, [reqs["burst"]], dp2,
                                    steps_per_sync=4)
    # the first prefixed request shares slot 1 (block 1) with a filler in
    # slot 0; the second, alone, takes slot 0 (block 0) and hits its pages
    report["dp_cross"] = engine_run(
        mfused, mconfig, reqs["dp_cross"], dp2, max_len=64, prefill_chunk=8,
        paged=True, page_size=8)

    # test_moe_sharding.py's model: moe_mlp with capacity over both
    # blocks' rows, and the control, each block's capacity alone
    cfg = LlamaConfig(**PARALLEL_CFG, **MOE)
    p = make_synthetic_llama(cfg, preset="W4A16", use_kernels=False,
                             dtype=torch.float32, device="cpu")
    ps = shard_llama_params(p, dp2, cfg)
    x = torch.from_numpy(arrays["dp_moe_x"])
    rows = dp_rows(dp2, x.shape[0])
    f = inputs["dp_capacity_factor"]
    out["dp_moe_mlp"] = moe_mlp(ps["layers"][0], x[rows], cfg,
                                capacity_factor=f, dp_block=True)
    out["dp_moe_mlp_control"] = moe_mlp(p["layers"][0], x[rows], cfg,
                                        capacity_factor=f)
    # each rank's rows through the whole forward
    ids = torch.from_numpy(arrays["moe_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    rows = dp_rows(dp2, ids.shape[0])
    out["dp_moe_forward"] = llama_forward(ps, cfg, ids[rows], pos[rows],
                                          dp_block=True)[0]
    out["dp_greedy"] = greedy_generate(ps, cfg, ids[:, :4], max_new_tokens=4,
                                       dtype=torch.float32, device="cpu")
    out["dp_greedy_unsharded"] = greedy_generate(
        p, cfg, ids[:, :4], max_new_tokens=4, dtype=torch.float32,
        device="cpu")
    mcfg = LlamaConfig(**dict(PARALLEL_CFG, num_hidden_layers=4))
    p = make_synthetic_llama(mcfg, layer_presets=["W4A16", "W8A8"],
                             use_kernels=False, dtype=torch.float32,
                             device="cpu")
    ids = torch.from_numpy(arrays["dp_mixed_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    rows = dp_rows(dp2, ids.shape[0])
    out["dp_mixed_forward"] = llama_forward(
        shard_llama_params(p, dp2, mcfg), mcfg, ids[rows], pos[rows],
        use_kernels=False, dp_block=True)[0]
    mla, mla_config = models["mla"]
    ids = torch.from_numpy(arrays["mla_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    rows = dp_rows(dp2, ids.shape[0])
    out["dp_mla_forward"] = llama_forward(
        shard_llama_params(mla, dp2, mla_config), mla_config, ids[rows],
        pos[rows], dp_block=True)[0]


def actorder_linear(n=64, k=512, group=128):
    """A W4A16 g128 linear with an actorder g_idx (each group's columns
    scattered over K), compressed and prepared by the port, and an input."""
    from compressed_tensors_tpu_torch.compressors import (
        PackedQuantizationCompressor,
    )
    from compressed_tensors_tpu_torch.ops.linear import (
        from_compressed_state,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    scheme = preset_name_to_scheme("W4A16", ["Linear"])
    r = np.random.default_rng(13)
    w = torch.from_numpy((r.normal(size=(n, k)) * 0.1).astype(np.float32))
    g_idx = torch.from_numpy(r.permutation(k) // group).to(torch.int32)
    scale = torch.from_numpy(r.uniform(0.01, 0.03, size=(n, k // group))
                             .astype(np.float32))
    comp = PackedQuantizationCompressor.compress(
        {"weight": w, "weight_scale": scale, "weight_g_idx": g_idx}, scheme)
    qt = prepare_for_kernels(from_compressed_state(comp, scheme))
    assert qt.kernel_perm is not None
    x = torch.from_numpy(r.normal(size=(4, k)).astype(np.float32))
    return qt, x


def ring_shard(seed, n=64, k=2048, tp=2):
    """test_overlap.py's ``make_shard``: an (N/tp, K) W4A16 shard drawn
    from ``seed``, compressed and prepared by the port."""
    from compressed_tensors_tpu_torch.compressors import (
        PackedQuantizationCompressor,
    )
    from compressed_tensors_tpu_torch.ops import calculate_qparams
    from compressed_tensors_tpu_torch.ops.linear import (
        from_compressed_state,
        prepare_for_kernels,
    )
    from compressed_tensors_tpu_torch.quantization import (
        preset_name_to_scheme,
    )

    scheme = preset_name_to_scheme("W4A16", ["Linear"])
    args = scheme.weights
    r = np.random.default_rng(seed)
    w = torch.from_numpy((r.normal(size=(n // tp, k)) * 0.1).astype(
        np.float32))
    g = w.reshape(n // tp, -1, args.group_size)
    scale, _ = calculate_qparams(g.amin(-1), g.amax(-1), args)
    comp = PackedQuantizationCompressor.compress(
        {"weight": w, "weight_scale": scale}, scheme)
    return prepare_for_kernels(from_compressed_state(comp, scheme))


# --------------------------------------------------------------------------- #
# CASE "dp4": four ranks, dp = 2 x tp = 2 and pp = 2 x dp = 2


def dp4(out_dir, rank):
    """The engine at dp = 2 x tp = 2 on test_serving_sharded.py's W4A16
    g32 recipe (each rank's tp blocks read by ``load_llama_params(mesh=
    ...)``) and mixed recipe (dense and paged), and ``pipeline_forward``
    at pp = 2 x dp = 2 over each rank's dp block of test_pipeline.py's
    rows; returns the JSON report and the arrays."""
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.models.config import LlamaConfig
    from compressed_tensors_tpu_torch.models.synthetic import (
        make_synthetic_llama,
    )
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.parallel import (
        dp_rows,
        make_mesh,
        pipeline_forward,
        stack_stage_params,
    )

    with open(os.path.join(out_dir, "inputs.json")) as f:
        inputs = json.load(f)
    arrays = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    # every rank opens the same groups in the same order
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    pp_dp = make_mesh(pp=2, dp=2, device="cpu")
    report, out = {}, {}
    t0 = time.perf_counter()
    reqs = inputs["requests"]
    params, config, _ = load_llama_params(
        inputs["paths"]["w4"], dtype=torch.float32, device="cpu", mesh=mesh)
    report["heads"] = list(params["shard"].heads)
    report["w4"] = engine_run(fuse_llama_layers(params), config,
                              [reqs["w4"]], mesh)
    params, config, _ = load_llama_params(
        inputs["paths"]["mixed"], dtype=torch.float32, device="cpu")
    params = fuse_llama_layers(params)
    report["mixed"] = engine_run(params, config, [reqs["mixed"]], mesh)
    report["mixed_paged"] = engine_run(params, config, [reqs["mixed"]],
                                       mesh, paged=True, page_size=8)
    pcfg = LlamaConfig(**dict(PARALLEL_CFG, num_hidden_layers=4))
    ids = torch.from_numpy(arrays["pp_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    rows = dp_rows(pp_dp, ids.shape[0])
    for preset in ("W4A16", "W8A8"):
        p = make_synthetic_llama(pcfg, preset=preset, use_kernels=False,
                                 dtype=torch.float32, device="cpu")
        p["stages"] = stack_stage_params(p.pop("layers"), 2)
        out[f"pp_{preset}"] = pipeline_forward(p, pcfg, ids[rows], pos[rows],
                                               pp_dp, n_microbatches=2)
    report["coords"] = mesh.coords
    report["seconds"] = time.perf_counter() - t0
    return report, {k: v.numpy() for k, v in out.items()}


# --------------------------------------------------------------------------- #
# CASE "tp70b": the card's tensor-parallel run (chip_smoke.py phase 19c)


def last_logits(params, config, ids, depth):
    """f32 logits of the last prompt position through the first ``depth``
    layers (full width)."""
    from compressed_tensors_tpu_torch.models import llama_forward

    p = dict(params, layers=params["layers"][:depth])
    ids = torch.as_tensor(ids, device=p["norm"].device)[None]
    logits, _ = llama_forward(p, config, ids,
                              torch.arange(ids.shape[1], device=ids.device)
                              [None], last_logit_only=True)
    return logits[0, -1].float()


def roll_scales(params, step):
    """Roll the kernel scales of every W4A16 and W8A8 decoder linear by
    ``step`` groups (channels for W8A8): a planted fault, undone by
    rolling back."""
    for layer in params["layers"]:
        for qt in layer.values():
            meta = getattr(qt, "kernel_meta", None)
            if meta and meta[0] in ("w4a16", "w8a8"):
                qt.kernel_scales.copy_(qt.kernel_scales.roll(step, 0))


def tp70b(out_dir, rank, device):
    """Load this rank's blocks of the checkpoint under OUT_DIR/ckpt
    (``load_llama_params(mesh=...)``, tp = 2 on DEVICE: bf16 on the card,
    f32 on the CPU), fuse; the last prompt position's logits at each
    depth with every W4 linear at bf16 activations and at the default
    (a8b prefill rows), then both again with the scales rolled; the
    requests through the paged engine, timed."""
    from compressed_tensors_tpu_torch.engine import Request, ServingEngine
    from compressed_tensors_tpu_torch.flags import flag_overrides
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.ops.kernels import (
        paged_decode,
        prefill_attention,
        w4a16_matmul,
        w8a8_matmul,
    )
    from compressed_tensors_tpu_torch.parallel import make_mesh

    mesh = make_mesh(tp=2, device=device)
    # the parent may start the ranks before it has written the checkpoint:
    # inputs.json comes last
    wait_for(os.path.join(out_dir, "inputs.json"))
    with open(os.path.join(out_dir, "inputs.json")) as f:
        inputs = json.load(f)
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    dist.barrier()
    t0 = time.perf_counter()
    params, config, _ = load_llama_params(os.path.join(out_dir, "ckpt"),
                                          dtype=dtype, device=device,
                                          mesh=mesh)
    params = fuse_llama_layers(params)
    sync()
    report = {"load_s": time.perf_counter() - t0,
              "bytes_read": params["shard"].bytes_read,
              "heads": list(params["shard"].heads),
              "gib": (torch.cuda.memory_allocated() / 2**30
                      if device == "cuda" else 0.0)}
    logits = {}
    for act in ("bf16", "auto"):   # every W4 linear at bf16; the default
        with flag_overrides(w4_act=act):
            for d in inputs["depths"]:
                logits[f"{act}_d{d}"] = last_logits(params, config,
                                                    inputs["probe"], d)
    roll_scales(params, 1)
    for act in ("bf16", "auto"):
        with flag_overrides(w4_act=act):
            for d in inputs["depths"]:
                logits[f"rolled_{act}_d{d}"] = last_logits(
                    params, config, inputs["probe"], d)
    roll_scales(params, -1)
    torch.save({k: v.cpu() for k, v in logits.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))

    engine = ServingEngine(params, config, mesh=mesh, dtype=dtype,
                           **inputs["serve"])
    timing = {"decode_s": 0.0, "steps": 0}
    decode = engine._decode

    def timed_decode(active, burst):
        t = time.perf_counter()
        out = decode(active, burst)   # ends in the trace's host copy
        timing["decode_s"] += time.perf_counter() - t
        timing["steps"] += burst
        return out

    engine._decode = timed_decode
    for i, ids, new in inputs["requests"]:
        engine.submit(Request(request_id=i, prompt_ids=ids,
                              max_new_tokens=new))
    kernels = {"w4a16_matmul": w4a16_matmul.w4a16_matmul,
               "w4a16_a8b_matmul": w4a16_matmul.w4a16_a8b_matmul,
               "w8a8_matmul": w8a8_matmul.w8a8_matmul,
               "prefill_attention": prefill_attention.prefill_attention,
               "paged_decode_attention": paged_decode.paged_decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    sync()
    dist.barrier()
    t = time.perf_counter()
    done = engine.run()
    sync()
    report["serve_s"] = time.perf_counter() - t
    report["launches"] = {k: fn.launches for k, fn in kernels.items()}
    report["decode_ms"] = timing["decode_s"] * 1e3 / max(timing["steps"], 1)
    report["steps"] = timing["steps"]
    report["completions"] = {c.request_id: c.output_ids for c in done}
    return report


# --------------------------------------------------------------------------- #
# CASE "dp70b": the card's data-parallel run (chip_smoke.py phase 20)


def dp70b(out_dir, rank, device):
    """dp = 2 x tp = 2 over four ranks on DEVICE: this rank's tp blocks of
    the checkpoint ``inputs.json`` names (``load_llama_params(mesh=...)``,
    bf16 on the card, f32 on the CPU), fused; the requests served dense,
    paged without and paged with prefix caching, each run's completions,
    kernel launches (the counters ``inputs.json`` names, reset before the
    run), host seconds and decode ms a step, prefix hits, hits on pages
    the other dp block wrote, and the digest of the pages both blocks
    hold."""
    import importlib

    from compressed_tensors_tpu_torch.engine import Request, ServingEngine
    from compressed_tensors_tpu_torch.models import load_llama_params
    from compressed_tensors_tpu_torch.ops.fuse import fuse_llama_layers
    from compressed_tensors_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=2, tp=2, device=device)
    # the parent starts the ranks long before it writes the checkpoint:
    # inputs.json comes last
    wait_for(os.path.join(out_dir, "inputs.json"))
    with open(os.path.join(out_dir, "inputs.json")) as f:
        inputs = json.load(f)
    counters = {
        name: (getattr(importlib.import_module(
            f"compressed_tensors_tpu_torch.ops.kernels.{module}"), fn), attr)
        for name, (module, fn, attr) in inputs["counters"].items()}
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    dist.barrier()
    t0 = time.perf_counter()
    params, config, _ = load_llama_params(inputs["ckpt"], dtype=dtype,
                                          device=device, mesh=mesh)
    params = fuse_llama_layers(params)
    sync()
    report = {"load_s": time.perf_counter() - t0,
              "bytes_read": params["shard"].bytes_read,
              "heads": list(params["shard"].heads), "coords": mesh.coords,
              "gib": (torch.cuda.memory_allocated() / 2**30
                      if device == "cuda" else 0.0)}
    for run, kw in (("dense", dict(paged=False)),
                    ("paged", dict(paged=True, prefix_caching=False)),
                    ("prefix", dict(paged=True, prefix_caching=True))):
        engine = ServingEngine(params, config, mesh=mesh, dtype=dtype,
                               device=device, **inputs["serve"], **kw)
        timing = {"decode_s": 0.0, "steps": 0}
        decode = engine._decode

        def timed_decode(active, burst, decode=decode, timing=timing):
            t = time.perf_counter()
            out = decode(active, burst)   # ends in the trace's host copy
            timing["decode_s"] += time.perf_counter() - t
            timing["steps"] += burst
            return out

        engine._decode = timed_decode
        for i, ids, new in inputs["requests"]:
            engine.submit(Request(request_id=i, prompt_ids=ids,
                                  max_new_tokens=new))
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        sync()
        dist.barrier()
        t = time.perf_counter()
        done = engine.run()
        sync()
        got = {"serve_s": time.perf_counter() - t,
               "decode_ms": timing["decode_s"] * 1e3
               / max(timing["steps"], 1),
               "steps": timing["steps"],
               "counts": {name: getattr(fn, attr)
                          for name, (fn, attr) in counters.items()},
               "completions": {c.request_id: c.output_ids for c in done},
               "hits": engine.prefix_cache_hits,
               "cross_block_hits": engine.cross_block_hits}
        if engine.paged:
            got["shared_pages"], got["shared_digest"] = shared_pages_digest(
                engine)
        report[run] = got
        del engine
    return report


def main(case, device, rank, world, port, out_dir):
    address = f"localhost:{port}"
    if case == "nccl":
        init_dist(address, world, rank)
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        report = {"rank": rank, "backend": dist.get_backend(),
                  "all_reduce": x.item()}
        dist.destroy_process_group()
        report["initialized_after"] = dist.is_initialized()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
        return
    init_dist(address, world, rank, device="cpu")
    report = {"rank": process_index(), "count": process_count(),
              "distributed": is_distributed(),
              "backend": dist.get_backend()}
    if case == "broadcast":
        report["from0"] = broadcast_object(
            {"payload": [1, 2, 3], "rank": 0} if rank == 0 else None,
            source=0)
        report["from1"] = broadcast_object(
            ["from-one"] if rank == 1 else None, source=1)
        wait_for_comms([torch.ones(4) * (rank + 1),
                        dist.barrier(async_op=True)])
    elif case in ("compress", "compress-file"):
        report.update(compress(case, device, rank, world, out_dir))
    elif case == "tp70b":
        report.update(tp70b(out_dir, rank, device))
    elif case == "dp70b":
        report.update(dp70b(out_dir, rank, device))
    elif case in ("parallel", "dp4"):
        got, arrays = (parallel if case == "parallel" else dp4)(out_dir,
                                                                 rank)
        report.update(got)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    else:
        raise ValueError(f"unknown case {case!r}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    case, device, rank, world, port, out_dir = sys.argv[1:]
    main(case, device, int(rank), int(world), int(port), out_dir)
