"""Streaming model loading.

Counterpart of ``compressed_tensors_tpu/offload/load.py:stream_modules``:
a checkpoint read one module at a time (bounded host memory), each
module's tensors placed on its planned device. ``load_sharded_params``,
which reads each process's slice of a sharded tensor, waits for the
port's tensor-parallel slice (ROADMAP A8c).
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch

from compressed_tensors_tpu_torch.utils.safetensors_io import CheckpointReader

__all__ = ["stream_modules"]


def stream_modules(
    path: str,
    device_plan: Mapping[str, int] | None = None,
    device="cuda",
) -> Iterator[tuple[str, dict[str, torch.Tensor]]]:
    """Yield (module name, {local name: tensor}) in checkpoint order.

    A module planned to device -1 stays on the host; the others go to CUDA
    device ``index`` (the last one where the index is past the card count;
    ``device_plan`` None puts every module on device 0). With
    ``device="cpu"`` every module stays on the host.

    :param path: checkpoint directory
    :param device_plan: module name -> device index (from
        ``offload.dispatch.dispatch_plan``)
    """
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    device = resolve_device(device)
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    reader = CheckpointReader(path)
    try:
        for module_name in reader.module_names():
            state = reader.module_state_dict(module_name)
            index = (device_plan or {}).get(module_name, 0)
            if index < 0 or device.type != "cuda":
                yield module_name, state
            else:
                target = torch.device("cuda", min(index, count - 1))
                yield module_name, {k: v.to(target) for k, v in state.items()}
    finally:
        reader.close()
