"""Offload caches: the memory-hierarchy layer.

Counterpart of ``compressed_tensors_tpu/offload/cache.py``: name -> tensor
MutableMappings that offload on write and onload on read, backed by host
memory (``HostCache``), the card (``DeviceCache``) or one safetensors file
per tensor (``DiskCache``), for parameter sets larger than the card's
memory. The JAX package's semantics are kept: an update of matching shape
and dtype lands in place; ``disable_offloading`` keeps onloaded copies for
reuse inside the context and ``disable_onloading`` returns the stored
representation itself; both flags are thread-local and nest.

As in the JAX package, leaving ``disable_offloading`` does not drop the
copies it kept: they stay in ``_onloaded`` until ``evict()``, an update
or a delete (the upstream library clears them on exit).

Every cache onloads to ``onload_device``, the card unless the caller
passes another ("cpu" for the CPU); asking for the card without one
raises. ``HostCache`` keeps pinned host tensors when it onloads to the
card, and onloads by a non-blocking copy on the current stream.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
from collections.abc import MutableMapping
from typing import Iterator

import torch

__all__ = [
    "OffloadCache",
    "HostCache",
    "DeviceCache",
    "DiskCache",
    "disable_offloading",
    "disable_onloading",
]

_DISABLE_OFFLOADING = threading.local()
_DISABLE_ONLOADING = threading.local()


@contextlib.contextmanager
def disable_offloading():
    """Keep values onloaded for the duration of the context: each entry is
    onloaded once and the copy reused."""
    prev = getattr(_DISABLE_OFFLOADING, "value", False)
    _DISABLE_OFFLOADING.value = True
    try:
        yield
    finally:
        _DISABLE_OFFLOADING.value = prev


@contextlib.contextmanager
def disable_onloading():
    """Raw access: reads return the offloaded representation itself (the
    host tensor, the file path, the device tensor) without onloading, for
    save paths that want the stored bytes."""
    prev = getattr(_DISABLE_ONLOADING, "value", False)
    _DISABLE_ONLOADING.value = True
    try:
        yield
    finally:
        _DISABLE_ONLOADING.value = prev


def _tensor(value) -> torch.Tensor:
    return value.detach() if isinstance(value, torch.Tensor) \
        else torch.as_tensor(value)


class OffloadCache(MutableMapping):
    """name -> tensor mapping that offloads on write and onloads on read."""

    def __init__(self, onload_device="cuda"):
        from compressed_tensors_tpu_torch.models.llama import resolve_device

        self._store: dict[str, object] = {}
        self._onloaded: dict[str, torch.Tensor] = {}
        self.onload_device = resolve_device(onload_device)

    # subclass interface ------------------------------------------------- #
    def offload(self, value) -> object:
        raise NotImplementedError

    def onload(self, stored) -> torch.Tensor:
        raise NotImplementedError

    def update_offload(self, name: str, stored, value) -> object:
        """In-place update when shapes/dtypes match; default re-offloads."""
        return self.offload(value)

    # MutableMapping ----------------------------------------------------- #
    def __setitem__(self, name: str, value) -> None:
        if name in self._store:
            self._store[name] = self.update_offload(
                name, self._store[name], value)
        else:
            self._store[name] = self.offload(value)
        self._onloaded.pop(name, None)

    def __getitem__(self, name: str) -> torch.Tensor:
        if getattr(_DISABLE_ONLOADING, "value", False):
            return self._store[name]
        if name in self._onloaded:
            return self._onloaded[name]
        value = self.onload(self._store[name])
        if getattr(_DISABLE_OFFLOADING, "value", False):
            self._onloaded[name] = value
        return value

    def __delitem__(self, name: str) -> None:
        self._store.pop(name)
        self._onloaded.pop(name, None)

    def __iter__(self) -> Iterator[str]:
        return iter(self._store)

    def __len__(self) -> int:
        return len(self._store)

    def evict(self) -> None:
        """Drop any onloaded copies."""
        self._onloaded.clear()


class HostCache(OffloadCache):
    """The offloaded representation is a host tensor (pinned when the
    cache onloads to the card)."""

    def offload(self, value) -> torch.Tensor:
        t = _tensor(value)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=(
            self.onload_device.type == "cuda")).copy_(t)

    def onload(self, stored: torch.Tensor) -> torch.Tensor:
        return stored.to(self.onload_device, non_blocking=True, copy=True)

    def update_offload(self, name, stored: torch.Tensor, value):
        t = _tensor(value)
        if stored.shape == t.shape and stored.dtype == t.dtype:
            if self.onload_device.type == "cuda":
                # a non-blocking onload may still read this buffer
                torch.cuda.current_stream(self.onload_device).synchronize()
            stored.copy_(t)
            return stored
        return self.offload(t)


class DeviceCache(OffloadCache):
    """Values stay resident on the onload device."""

    def offload(self, value) -> torch.Tensor:
        return _tensor(value).to(self.onload_device)

    def onload(self, stored: torch.Tensor) -> torch.Tensor:
        return stored


class DiskCache(OffloadCache):
    """The offloaded representation is a safetensors file per tensor.

    A tensor that comes straight from a checkpoint shard can be
    ``adopt``ed: its offloaded representation is then a symlink to the
    shard, and no bytes are copied. The first update of an adopted tensor
    breaks the link and writes a file of the cache's own;
    ``save_checkpoint`` symlinks still-clean adopted tensors into the
    destination instead of writing their bytes again. Only files in the
    cache's directory are ever written or deleted.
    """

    def __init__(self, directory: str, onload_device="cuda"):
        super().__init__(onload_device)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._counter = 0
        # path -> safetensors tensor name (adopted entries keep the
        # checkpoint's name; files the cache writes use "tensor")
        self._tensor_name: dict[str, str] = {}

    def _path(self, suffix: int) -> str:
        return os.path.join(self.directory, f"tensor_{suffix}.safetensors")

    def _owned(self, path: str) -> bool:
        """Only ever delete or overwrite files this cache created."""
        return os.path.dirname(os.path.abspath(path)) == os.path.abspath(
            self.directory)

    def offload(self, value) -> str:
        from compressed_tensors_tpu_torch.utils.safetensors_io import (
            save_safetensors,
        )

        path = self._path(self._counter)
        self._counter += 1
        save_safetensors(path, {"tensor": _tensor(value)})
        return path

    def onload(self, stored: str) -> torch.Tensor:
        from compressed_tensors_tpu_torch.utils.safetensors_io import (
            SafetensorsFile,
        )

        f = SafetensorsFile(stored)
        try:
            return f.get(self._tensor_name.get(stored, "tensor")).to(
                self.onload_device)
        finally:
            f.close()

    def update_offload(self, name, stored: str, value):
        from compressed_tensors_tpu_torch.utils.safetensors_io import (
            save_safetensors,
        )

        if not self._owned(stored):
            raise AssertionError(f"refusing to write to {stored}")
        if os.path.islink(stored):
            # an adopted checkpoint tensor: break the link, never write
            # through it into the source shard
            os.unlink(stored)
            self._tensor_name.pop(stored, None)
        save_safetensors(stored, {"tensor": _tensor(value)})
        return stored

    def __delitem__(self, name: str) -> None:
        path = self._store.get(name)
        super().__delitem__(name)
        if path:
            self._tensor_name.pop(path, None)
            if self._owned(path) and os.path.lexists(path):
                os.remove(path)

    # zero-copy checkpoint interop -------------------------------------- #
    def adopt(self, name: str, source_path: str, tensor_name: str) -> None:
        """Register ``tensor_name`` of the checkpoint shard ``source_path``
        as this entry's offloaded representation without copying bytes:
        the entry is a symlink to the shard."""
        if name in self._store:
            del self[name]
        link = self._path(self._counter)
        self._counter += 1
        os.symlink(os.path.abspath(source_path), link)
        self._store[name] = link
        self._tensor_name[link] = tensor_name
        self._onloaded.pop(name, None)

    def is_adopted(self, name: str) -> bool:
        """True while the entry is still an unmodified checkpoint symlink."""
        path = self._store.get(name)
        return path is not None and os.path.islink(path)

    def save_checkpoint(self, out_dir: str) -> dict[str, str]:
        """Write every entry to ``out_dir/<name>.safetensors``. Entries
        still backed by an unmodified checkpoint symlink are symlinked to
        the shard (inode-equal, their bytes neither read nor written);
        the others are copied. Returns name -> file path."""
        os.makedirs(out_dir, exist_ok=True)
        out: dict[str, str] = {}
        for name, path in self._store.items():
            dest = os.path.join(out_dir, f"{name}.safetensors")
            if os.path.lexists(dest):
                os.remove(dest)
            if os.path.islink(path):
                os.symlink(os.path.realpath(path), dest)
            else:
                shutil.copyfile(path, dest)
            out[name] = dest
        return out
