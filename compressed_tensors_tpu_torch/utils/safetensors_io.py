"""Safetensors + checkpoint I/O in pure Python, returning torch tensors.

Counterpart of ``compressed_tensors_tpu/utils/safetensors_io.py`` (reader,
writer and config discovery): 8-byte little-endian header length, JSON
header, raw little-endian tensor data. bf16 and fp8 tensors come back in
their torch dtypes.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Mapping

import torch

from compressed_tensors_tpu_torch.config import (
    QUANTIZATION_CONFIG_NAME,
    QUANTIZATION_METHOD,
    QUANTIZATION_METHOD_NAME,
)
from compressed_tensors_tpu_torch.utils.dtypes import SAFETENSORS_DTYPES

__all__ = [
    "SafetensorsFile",
    "save_safetensors",
    "get_quantization_config_dict",
    "CheckpointReader",
]

_DTYPE_TO_ST = {v: k for k, v in SAFETENSORS_DTYPES.items()}
_ST_INDEX_NAME = "model.safetensors.index.json"


class SafetensorsFile:
    """Reader of one safetensors file; each tensor is read on request."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            self.header = json.loads(f.read(header_len))
        self._data_start = 8 + header_len
        self.metadata = self.header.pop("__metadata__", {})
        self._file = None

    def keys(self) -> list[str]:
        return list(self.header.keys())

    def get(self, name: str) -> torch.Tensor:
        """One tensor, copied into a new CPU tensor."""
        info = self.header[name]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if self._file is None:
            self._file = open(self.path, "rb")
        buf = bytearray(end - start)
        self._file.seek(self._data_start + start)
        if self._file.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: tensor {name} is truncated")
        if not buf:
            return torch.empty(info["shape"], dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def save_safetensors(
    path: str,
    tensors: Mapping[str, torch.Tensor],
    metadata: Mapping[str, str] | None = None,
):
    """Write a safetensors file (8-byte-aligned header)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs: list[torch.Tensor] = []
    for name, tensor in tensors.items():
        t = tensor.detach().to("cpu").contiguous()
        st_dtype = _DTYPE_TO_ST.get(t.dtype)
        if st_dtype is None:
            raise ValueError(f"Cannot serialize dtype {t.dtype} for {name}")
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": st_dtype,
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(t)
        offset += nbytes

    header_bytes = json.dumps(header, separators=(",", ":")).encode()
    header_bytes += b" " * ((-(8 + len(header_bytes))) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def _checkpoint_files(path: str) -> list[str]:
    index_path = os.path.join(path, _ST_INDEX_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(path, fname) for fname in files]
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(".safetensors"))


def _weight_map(path: str) -> dict[str, str]:
    """tensor name -> shard filename."""
    index_path = os.path.join(path, _ST_INDEX_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return json.load(f)["weight_map"]
    weight_map = {}
    for file in _checkpoint_files(path):
        for key in SafetensorsFile(file).keys():
            weight_map[key] = os.path.basename(file)
    return weight_map


def get_quantization_config_dict(path: str) -> dict | None:
    """config.json["quantization_config"] of a compressed-tensors
    checkpoint, or None."""
    config_path = os.path.join(path, "config.json")
    if not os.path.exists(config_path):
        return None
    with open(config_path) as f:
        qconfig = json.load(f).get(QUANTIZATION_CONFIG_NAME)
    if qconfig is None:
        return None
    if qconfig.get(QUANTIZATION_METHOD_NAME) not in (None, QUANTIZATION_METHOD):
        return None
    return qconfig


class CheckpointReader:
    """Reader over a (possibly sharded) checkpoint, grouping tensors into
    per-module local state dicts."""

    # local param names that belong to a module (quantization vocabulary)
    _QPARAM_RE = re.compile(
        r"^(weight|weight_packed|weight_scale|weight_shape|weight_zero_point|"
        r"weight_g_idx|weight_global_scale|input_scale|input_zero_point|"
        r"input_global_scale|output_scale|output_zero_point|bias|"
        r"k_scale|v_scale|q_scale|"
        r"weight\.(compressed|bitmask|shape|row_offsets))$"
    )

    def __init__(self, path: str):
        self.path = path
        self.weight_map = _weight_map(path)
        self._files: dict[str, SafetensorsFile] = {}

    def _file_for(self, tensor_name: str) -> SafetensorsFile:
        fname = self.weight_map[tensor_name]
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self.path, fname))
        return self._files[fname]

    def tensor_names(self) -> list[str]:
        return list(self.weight_map.keys())

    def get(self, name: str) -> torch.Tensor:
        return self._file_for(name).get(name)

    def module_names(self) -> list[str]:
        """Distinct module prefixes, in checkpoint order."""
        return list(dict.fromkeys(self.split(n)[0] for n in self.weight_map))

    @classmethod
    def split(cls, tensor_name: str) -> tuple[str, str]:
        """Split a full tensor name into (module prefix, local param name),
        handling the dotted sparse suffixes (weight.compressed etc.)."""
        for suffix in ("weight.compressed", "weight.bitmask", "weight.shape",
                       "weight.row_offsets"):
            if tensor_name.endswith("." + suffix):
                return tensor_name[: -len(suffix) - 1], suffix
        module, _, param = tensor_name.rpartition(".")
        return module, param

    def module_state_dict(self, module_name: str) -> dict[str, torch.Tensor]:
        """All local tensors of one module."""
        out = {}
        prefix = module_name + "." if module_name else ""
        for name in self.weight_map:
            if name.startswith(prefix) and self._QPARAM_RE.match(
                    name[len(prefix):]):
                out[name[len(prefix):]] = self.get(name)
        return out

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()
