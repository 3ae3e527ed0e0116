"""Work-partitioned parallel compression.

Counterpart of ``compressed_tensors_tpu/distributed/module_parallel.py``:
modules are greedy-bin-packed across processes by bytes, each process
compresses its share with ``ModelCompressor.compress_state`` where its
tensors lie, and the shares recouple by ``broadcast_object`` as host
tensors, in rank order: every process ends with the full compressed state
(on the host), as the JAX package's processes end with host arrays.
"""

from __future__ import annotations

from typing import Mapping

import torch

from compressed_tensors_tpu_torch.distributed.assign import greedy_bin_packing
from compressed_tensors_tpu_torch.distributed.utils import (
    broadcast_object,
    is_distributed,
    process_count,
    process_index,
)

__all__ = ["partition_modules", "compress_state_parallel"]


def _state_nbytes(state: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size()
               for t in map(torch.as_tensor, state.values()))


def partition_modules(
    module_states: Mapping[str, Mapping],
    num_partitions: int,
) -> tuple[list[list[str]], dict[str, int]]:
    """Greedy bin-pack module names across partitions by byte size."""
    names = list(module_states.keys())
    _, bins, owner = greedy_bin_packing(
        names, num_partitions,
        item_weight_fn=lambda n: _state_nbytes(module_states[n]))
    return bins, owner


def compress_state_parallel(
    model_compressor,
    module_states: Mapping[str, Mapping],
    modules: Mapping,
) -> dict:
    """Compress a model's modules with the work partitioned across the
    process group's ranks. A single process compresses them all
    (``compress_state``)."""
    if not is_distributed():
        return model_compressor.compress_state(module_states, modules)

    nprocs = process_count()
    rank = process_index()
    _, owner = partition_modules(module_states, nprocs)

    owned = {name: state for name, state in module_states.items()
             if owner[name] == rank}
    compressed_local = model_compressor.compress_state(owned, modules)
    compressed_local = {
        name: {k: torch.as_tensor(v).to("cpu") for k, v in state.items()}
        for name, state in compressed_local.items()}

    # recouple: every rank's share from it, in rank order
    full: dict = {}
    for src in range(nprocs):
        share = broadcast_object(
            compressed_local if src == rank else None, source=src)
        full.update(share)
    return full
