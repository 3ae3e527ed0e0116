"""Safetensors + checkpoint I/O, returning torch tensors.

Counterpart of ``compressed_tensors_tpu/utils/safetensors_io.py``: reader
and writer (8-byte little-endian header length, JSON header, raw
little-endian tensor data; bf16 and fp8 tensors in their torch dtypes),
shard and index resolution, index and ``config.json`` writing,
weight-name -> file mappings and nested qparam grouping. Tensors of 64 MiB
or more are read by the native parallel reader (``utils/native.py``) when
it is available.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Iterable, Mapping

import numpy as np
import torch

from compressed_tensors_tpu_torch.config import (
    COMPRESSION_VERSION_NAME,
    QUANTIZATION_CONFIG_NAME,
    QUANTIZATION_METHOD,
    QUANTIZATION_METHOD_NAME,
    SPARSITY_CONFIG_NAME,
    TRANSFORM_CONFIG_NAME,
)
from compressed_tensors_tpu_torch.utils.dtypes import SAFETENSORS_DTYPES

__all__ = [
    "SafetensorsFile",
    "load_safetensors",
    "save_safetensors",
    "get_weight_map",
    "get_checkpoint_files",
    "get_safetensors_header",
    "get_nested_weight_mappings",
    "get_quantization_parameter_to_path_mapping",
    "is_quantization_param",
    "get_quantization_config_dict",
    "update_config",
    "update_safetensors_index",
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

    # tensors at least this large use the native parallel reader when it
    # is available (cold-cache loads are IO-latency bound)
    PARALLEL_READ_BYTES = 64 * 1024 * 1024

    def get(self, name: str) -> torch.Tensor:
        """One tensor, copied into a new CPU tensor."""
        info = self.header[name]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end - start >= self.PARALLEL_READ_BYTES:
            from compressed_tensors_tpu_torch.utils.native import (
                read_range_parallel,
            )

            buf = read_range_parallel(self.path, self._data_start + start,
                                      end - start)
            if buf is not None:
                return buf.view(dtype).reshape(info["shape"])
        if self._file is None:
            self._file = open(self.path, "rb")
        buf = bytearray(end - start)
        self._file.seek(self._data_start + start)
        if self._file.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: tensor {name} is truncated")
        if not buf:
            return torch.empty(info["shape"], dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])

    def get_slice(self, name: str, ranges) -> torch.Tensor:
        """The block ``ranges`` ((start, stop) per dim) of one tensor, read
        as its contiguous runs only: one read per index of the dims before
        the last sliced one. Returns (tensor, bytes read)."""
        info = self.header[name]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = list(info["shape"])
        out_shape = [b - a for a, b in ranges]
        item = torch.empty((), dtype=dtype).element_size()
        cut = [d for d, (a, b) in enumerate(ranges) if (a, b) != (0, shape[d])]
        last = cut[-1] if cut else 0
        inner = int(np.prod(shape[last + 1:], dtype=np.int64))
        run = (ranges[last][1] - ranges[last][0]) * inner * item
        strides = [int(np.prod(shape[d + 1:], dtype=np.int64))
                   for d in range(len(shape))]
        offsets = np.zeros((1,), np.int64)
        for d in range(last + 1):
            a, b = ranges[d] if d < last else (ranges[d][0], ranges[d][0] + 1)
            offsets = (offsets[:, None] + np.arange(a, b, dtype=np.int64)
                       * strides[d]).reshape(-1)
        buf = bytearray(run * len(offsets))
        if self._file is None:
            self._file = open(self.path, "rb")
        fd, base = self._file.fileno(), self._data_start + info[
            "data_offsets"][0]
        view = memoryview(buf)
        for i, off in enumerate(offsets.tolist()):
            if os.preadv(fd, [view[i * run:(i + 1) * run]],
                         base + off * item) != run:
                raise ValueError(f"{self.path}: tensor {name} is truncated")
        if not buf:
            return torch.empty(out_shape, dtype=dtype), 0
        return torch.frombuffer(buf, dtype=dtype).reshape(out_shape), len(buf)

    def get_shape(self, name: str) -> tuple[int, ...]:
        return tuple(self.header[name]["shape"])

    def get_dtype(self, name: str) -> torch.dtype:
        return SAFETENSORS_DTYPES[self.header[name]["dtype"]]

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    f = SafetensorsFile(path)
    try:
        return {k: f.get(k) for k in f.keys()}
    finally:
        f.close()


def save_safetensors(
    path: str,
    tensors: Mapping[str, torch.Tensor],
    metadata: Mapping[str, str] | None = None,
):
    """Write a safetensors file (8-byte-aligned header). Tensors may lie
    on any device: each is copied to the host once."""
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


def get_checkpoint_files(path: str) -> list[str]:
    """All safetensors shard paths of a local checkpoint directory."""
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


def get_safetensors_header(path: str) -> dict:
    """Header-only read of one safetensors file: tensor name -> {dtype,
    shape, data_offsets}, no tensor data touched."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len))
    header.pop("__metadata__", None)
    return header


def is_quantization_param(name: str) -> bool:
    """Whether a tensor name is a quantization parameter (a scale, zero
    point or g_idx)."""
    return (name.endswith("_scale") or name.endswith("zero_point")
            or name.endswith("g_idx"))


def get_quantization_parameter_to_path_mapping(path: str) -> dict[str, str]:
    """Full tensor name -> absolute shard path, qparams only."""
    return {name: os.path.join(path, fname)
            for name, fname in get_weight_map(path).items()
            if is_quantization_param(name)}


def get_nested_weight_mappings(
    path: str,
    params_to_nest: Iterable[str] | None = None,
    return_unmatched_params: bool = False,
):
    """module name -> {local param name -> absolute shard path}. With
    ``params_to_nest`` only those local names are kept; with
    ``return_unmatched_params`` the flat {full name -> path} map of
    everything not nested is returned too."""
    keep = set(params_to_nest) if params_to_nest is not None else None
    nested: dict[str, dict[str, str]] = {}
    unmatched: dict[str, str] = {}
    for name, fname in get_weight_map(path).items():
        module, param = CheckpointReader.split(name)
        full_path = os.path.join(path, fname)
        if keep is not None and param not in keep:
            unmatched[name] = full_path
            continue
        nested.setdefault(module, {})[param] = full_path
    if return_unmatched_params:
        return nested, unmatched
    return nested


def get_weight_map(path: str) -> dict[str, str]:
    """tensor name -> shard filename."""
    index_path = os.path.join(path, _ST_INDEX_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return json.load(f)["weight_map"]
    weight_map = {}
    for file in get_checkpoint_files(path):
        for key in SafetensorsFile(file).keys():
            weight_map[key] = os.path.basename(file)
    return weight_map


def update_safetensors_index(save_directory: str,
                             weight_map: dict[str, str]) -> None:
    """Write model.safetensors.index.json (total size of the shards on
    disk, sorted keys), as the JAX package writes it."""
    total_size = 0
    for file in set(weight_map.values()):
        fpath = os.path.join(save_directory, file)
        if os.path.exists(fpath):
            total_size += os.path.getsize(fpath)
    index = {"metadata": {"total_size": total_size}, "weight_map": weight_map}
    with open(os.path.join(save_directory, _ST_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)


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


def update_config(
    save_directory: str,
    quantization_config=None,
    sparsity_config=None,
    transform_config=None,
    version: str | None = None,
) -> None:
    """Write the quantization, sparsity and transform configs into
    ``config.json["quantization_config"]``, keeping the file's other keys.

    The JAX package writes ``sparsity_config: {}`` whatever the model
    holds; this writes the given sparsity config (``{}`` without one), so
    that a sparse checkpoint names its sparse format. The transform config
    is written as the JAX package writes it (``{}`` without one)."""
    from compressed_tensors_tpu_torch.version import __version__

    config_file_path = os.path.join(save_directory, "config.json")
    config_data = {}
    if os.path.exists(config_file_path):
        with open(config_file_path) as file:
            config_data = json.load(file)
    qconfig_data = (quantization_config.model_dump(
        mode="json", exclude=["quant_method"])
        if quantization_config is not None else {})
    config_data[QUANTIZATION_CONFIG_NAME] = {
        COMPRESSION_VERSION_NAME: version or __version__,
        QUANTIZATION_METHOD_NAME: QUANTIZATION_METHOD,
        SPARSITY_CONFIG_NAME: (sparsity_config.model_dump(mode="json")
                               if sparsity_config is not None else {}),
        TRANSFORM_CONFIG_NAME: (transform_config.model_dump(mode="json")
                                if transform_config is not None else {}),
        **qconfig_data,
    }
    with open(config_file_path, "w") as config_file:
        json.dump(config_data, config_file, indent=2, sort_keys=True)


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
        self.weight_map = get_weight_map(path)
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

    def get_shape(self, name: str) -> tuple[int, ...]:
        return self._file_for(name).get_shape(name)

    def get_dtype(self, name: str) -> torch.dtype:
        return self._file_for(name).get_dtype(name)

    def get_slice(self, name: str, ranges) -> tuple[torch.Tensor, int]:
        """The block ``ranges`` ((start, stop) per dim) of a tensor, reading
        only its bytes; returns (tensor, bytes read)."""
        return self._file_for(name).get_slice(name, ranges)

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
