"""Memory-aware placement planning.

Counterpart of ``compressed_tensors_tpu/offload/dispatch.py``: given each
module's bytes and each device's memory budget, a greedy, in-order device
assignment that fits, with the largest per-device reserve a binary search
finds; what does not fit even with no reserve goes to the host (device
-1). The planner is pure Python and gives the JAX package's plans.
"""

from __future__ import annotations

from typing import Callable, Mapping, TypeVar

import torch

__all__ = [
    "max_binary_search",
    "SearchFailureError",
    "dispatch_plan",
    "get_device_map",
    "dispatch_with_map",
]

T = TypeVar("T")

# the budget of a device without a memory limit (the CPU)
UNBOUNDED = 1 << 62


class SearchFailureError(ValueError):
    pass


def max_binary_search(
    fn: Callable[[int], T],
    cond: Callable[[T], bool],
    start: int,
    end: int,
) -> tuple[int, T]:
    """Largest idx in [start, end] where cond(fn(idx)) holds."""
    best_idx = None
    best_val = None
    while start <= end:
        mid = (start + end) // 2
        val = fn(mid)
        if cond(val):
            best_idx, best_val = mid, val
            start = mid + 1
        else:
            end = mid - 1
    if best_idx is None:
        raise SearchFailureError()
    return best_idx, best_val


def _greedy_dispatch(
    module_sizes: Mapping[str, int],
    device_memory: list[int],
    reserve: int,
) -> dict[str, int] | None:
    """Sequential greedy fill: modules stay in order, moving to the next
    device when the current one is full. None if the modules do not fit."""
    assignment: dict[str, int] = {}
    device = 0
    used = 0
    for name, size in module_sizes.items():
        while device < len(device_memory) and \
                used + size > device_memory[device] - reserve:
            device += 1
            used = 0
        if device >= len(device_memory):
            return None
        assignment[name] = device
        used += size
    return assignment


def dispatch_plan(
    module_sizes: Mapping[str, int],
    device_memory: list[int],
    allow_host_offload: bool = True,
) -> dict[str, int]:
    """Plan module -> device placement.

    Binary-searches the largest per-device reserve (memory kept free for
    activations) such that a greedy dispatch still fits. If nothing fits
    even with no reserve, the trailing modules go to the host (device -1)
    until the rest fits; with ``allow_host_offload=False`` that raises
    ``SearchFailureError``.

    :return: module name -> device index (-1 = host)
    """
    if not module_sizes:
        return {}

    try:
        max_reserve = min(device_memory)
        _, assignment = max_binary_search(
            fn=lambda reserve: _greedy_dispatch(
                module_sizes, device_memory, reserve),
            cond=lambda a: a is not None,
            start=0,
            end=max_reserve,
        )
        return assignment
    except SearchFailureError:
        if not allow_host_offload:
            raise

    # move trailing modules to the host until the rest fits
    names = list(module_sizes.keys())
    offloaded: set[str] = set()
    for cut in range(len(names) - 1, -1, -1):
        kept = {n: module_sizes[n] for n in names[:cut]}
        assignment = _greedy_dispatch(kept, device_memory, 0)
        if assignment is not None:
            offloaded = set(names[cut:])
            break
    else:
        assignment = {}
        offloaded = set(names)

    for name in offloaded:
        assignment[name] = -1
    return assignment


def _devices(devices) -> list[torch.device]:
    """The given devices, or every CUDA device (raising without a card)."""
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def get_device_map(
    module_sizes: Mapping[str, int],
    devices: list | None = None,
    memory_fraction: float = 0.9,
) -> dict[str, int]:
    """Plan placement against the devices' memory budgets (every CUDA
    device by default, raising without a card). A CUDA device's budget is
    ``memory_fraction`` of its total memory less the memory in use, both
    from ``torch.cuda.mem_get_info`` (device-wide: other processes'
    allocations count as in use). A CPU device is unbounded."""
    budgets = []
    for d in _devices(devices):
        if d.type != "cuda":
            budgets.append(UNBOUNDED)
            continue
        free, total = torch.cuda.mem_get_info(d)
        budgets.append(max(0, int(total * memory_fraction) - (total - free)))
    return dispatch_plan(module_sizes, budgets)


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def dispatch_with_map(
    module_params: Mapping[str, dict],
    device_map: Mapping[str, int],
    devices: list | None = None,
):
    """Place per-module tensor trees per a plan: modules mapped to -1 go to
    (or stay on) the host, the rest onto ``devices[index]`` (every CUDA
    device by default). A module the plan lacks raises ``KeyError``: a
    stale plan must not change a placement silently.

    :param module_params: module name -> dict (or list) of tensors
    :param device_map: module name -> device index (-1 = host)
    :return: new {module: tree} with placed tensors
    """
    missing = [n for n in module_params if n not in device_map]
    if missing:
        raise KeyError(
            f"device_map has no entry for module(s) {missing[:5]}"
            + ("..." if len(missing) > 5 else ""))
    if devices is not None or any(device_map[n] >= 0 for n in module_params):
        devices = _devices(devices)
    out = {}
    for name, params in module_params.items():
        dev = device_map[name]
        target = torch.device("cpu") if dev == -1 else devices[dev]
        out[name] = _map_tensors(params, lambda t: t.to(target))
    return out
