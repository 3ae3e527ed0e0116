"""Sharded and streaming model loading.

Counterpart of ``compressed_tensors_tpu/offload/load.py``:
``load_sharded_params`` reads each process's block of every sharded tensor
of a checkpoint, and only those bytes (where the JAX package assembles
global arrays from the blocks each process reads, a process here keeps its
block as a plain tensor); ``stream_modules`` reads a checkpoint one module
at a time (bounded host memory), each module's tensors placed on its
planned device.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch

from compressed_tensors_tpu_torch.utils.safetensors_io import CheckpointReader

__all__ = ["load_sharded_params", "read_block", "stream_modules"]


def load_sharded_params(
    path: str,
    shardings: Mapping[str, tuple],
    mesh,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Read this process's block of each tensor of a checkpoint onto the
    mesh's device.

    :param path: checkpoint directory
    :param shardings: tensor name -> spec, one mesh axis name (or None) per
        dim, as a PartitionSpec; an axis that does not divide its dim
        replicates that dim (``parallel.mesh._sanitize_spec``). Names
        without a spec are read whole.
    :param mesh: the ``parallel.make_mesh`` mesh whose coordinates pick
        the blocks
    :param stats: a dict that receives "bytes_read", the bytes this
        process read
    :return: name -> this process's block
    """
    reader = CheckpointReader(path)
    out: dict[str, torch.Tensor] = {}
    read = 0
    try:
        for name in reader.tensor_names():
            t, n = read_block(reader, name, shardings.get(name), mesh)
            read += n
            out[name] = t.to(mesh.device)
    finally:
        reader.close()
    if stats is not None:
        stats["bytes_read"] = stats.get("bytes_read", 0) + read
    return out


def read_block(reader: CheckpointReader, name: str, spec, mesh
               ) -> tuple[torch.Tensor, int]:
    """This process's block of tensor ``name`` of ``reader`` under
    ``spec`` (as in ``load_sharded_params``), reading only its bytes; the
    whole tensor where ``spec`` is None. Returns (tensor, bytes read)."""
    from compressed_tensors_tpu_torch.parallel.mesh import _slice_ranges

    if spec is None:
        t = CheckpointReader.get(reader, name)
        return t, t.numel() * t.element_size()
    return reader.get_slice(name, _slice_ranges(reader.get_shape(name), spec,
                                                mesh))


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
