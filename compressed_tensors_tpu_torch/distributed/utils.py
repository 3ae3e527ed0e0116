"""Process-group management and host-object collectives over
``torch.distributed``.

Counterpart of ``compressed_tensors_tpu/distributed/utils.py``: the JAX
package initializes ``jax.distributed`` and broadcasts host objects with
``multihost_utils``; the port opens a ``torch.distributed`` process group,
NCCL for the card and gloo for ``device="cpu"``, and broadcasts objects
with ``broadcast_object_list``. Nothing discovers a cluster: the caller
gives the coordinator's address, the process count and this process's
index, or sets torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "init_dist",
    "is_distributed",
    "process_index",
    "process_count",
    "broadcast_object",
    "wait_for_comms",
]


def init_dist(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Open the default process group: ``tcp://coordinator_address``
    ("host:port"), ``num_processes`` ranks, this one ``process_id``; each
    missing argument is read from torchrun's variables. Without any (a
    single process) it does nothing, as the JAX one does; with a group
    already open, nothing either.

    ``device`` is where the group's collectives run: the card (NCCL; this
    process takes CUDA device ``LOCAL_RANK``, or ``process_id``, modulo the
    card count, and raises without a card) or ``"cpu"`` (gloo).
    """
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_dist needs the coordinator address, the "
                         "process count and the process id (or torchrun's "
                         "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)")
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_object(obj: Any, source: int = 0) -> Any:
    """Broadcast a picklable object from rank ``source`` to every rank
    (``broadcast_object_list``); without a group of more than one process,
    the object itself. Tensors travel pickled: move them to the host
    first."""
    if not is_distributed():
        return obj
    box = [obj if process_index() == source else None]
    dist.broadcast_object_list(box, src=source)
    return box[0]


def wait_for_comms(work) -> None:
    """Block until in-flight collectives and the card's queued work on the
    given tensors are done: waits each ``torch.distributed`` work handle
    and synchronizes the current stream of each CUDA tensor's device, in
    any nest of lists, tuples and dicts."""
    if isinstance(work, dict):
        work = list(work.values())
    if isinstance(work, (list, tuple)):
        for w in work:
            wait_for_comms(w)
    elif isinstance(work, torch.Tensor):
        if work.is_cuda:
            torch.cuda.current_stream(work.device).synchronize()
    elif hasattr(work, "wait"):
        work.wait()
