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
down.
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


def spawn(case, out_dir, world=2, device="cpu", timeout=90):
    """Run ``world`` ranks of CASE on DEVICE, each within ``timeout``
    seconds; returns their reports after every rank exited 0, and raises
    with a rank's output otherwise. No rank outlives the call."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, device, str(rank),
         str(world), str(port), str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{case} rank {rank} exited {p.returncode}:"
                               f"\n{out[-4000:]}")
    reports = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    return reports


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
    else:
        raise ValueError(f"unknown case {case!r}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    case, device, rank, world, port, out_dir = sys.argv[1:]
    main(case, device, int(rank), int(world), int(port), out_dir)
