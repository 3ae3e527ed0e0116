"""ctypes bindings for the port's native host IO/codec library
(``compressed_tensors_tpu_torch/csrc/ct_io.cpp``).

Counterpart of ``compressed_tensors_tpu/utils/native.py``. The library is
compiled with ``g++`` into ``build/native/`` beside the package (named by
a hash of the source) on the first call that needs it, never at import.
Every entry point returns None when the library is off
(``disable_native``) or cannot be built (no ``g++``), and its callers run
their pure-Python path then, as in the JAX package. Tensors are CPU torch
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import torch

__all__ = [
    "native_available",
    "read_range_parallel",
    "unpack_int32_native",
    "pack_int32_native",
]

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "ct_io.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
_LIB = None
_TRIED = False


def _build_lib() -> Path | None:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"ct_io_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-pthread", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        from compressed_tensors_tpu_torch.logger import log_once

        log_once(logging.WARNING, "native IO library not built (%s): the "
                 "pure-Python reads and codecs run", e)
        return None
    tmp.replace(lib_path)
    return lib_path


def _get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from compressed_tensors_tpu_torch.flags import FLAGS

    if FLAGS.disable_native:
        return None
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ct_read_range_parallel.restype = ctypes.c_int
    lib.ct_read_range_parallel.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int]
    lib.ct_unpack_int32_mt.restype = None
    lib.ct_unpack_int32_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.ct_pack_int32.restype = None
    lib.ct_pack_int32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def read_range_parallel(path: str, offset: int, size: int,
                        num_threads: int = 8) -> torch.Tensor | None:
    """Bytes [offset, offset + size) of a file, read by parallel pread
    workers, as a uint8 tensor; None without the library or on a failed
    read."""
    lib = _get_lib()
    if lib is None:
        return None
    buf = torch.empty(size, dtype=torch.uint8)
    rc = lib.ct_read_range_parallel(str(path).encode(), offset, size,
                                    buf.data_ptr(), num_threads)
    return buf if rc == 0 else None


def unpack_int32_native(packed: torch.Tensor, num_bits: int, cols: int,
                        num_threads: int = 8) -> torch.Tensor | None:
    """(rows, words) int32 -> (rows, cols) int8, codec-identical to
    ``ops.pack.unpack_from_int32`` with packed_dim=1."""
    lib = _get_lib()
    if lib is None:
        return None
    packed = packed.to(torch.int32).contiguous()
    rows, words = packed.shape
    out = torch.empty((rows, cols), dtype=torch.int8)
    lib.ct_unpack_int32_mt(packed.data_ptr(), out.data_ptr(), rows, words,
                           cols, num_bits, num_threads)
    return out


def pack_int32_native(values: torch.Tensor,
                      num_bits: int) -> torch.Tensor | None:
    """(rows, cols) int8 -> (rows, ceil(cols * bits / 32)) int32,
    codec-identical to ``ops.pack.pack_to_int32`` with packed_dim=1."""
    lib = _get_lib()
    if lib is None:
        return None
    values = values.to(torch.int8).contiguous()
    rows, cols = values.shape
    out = torch.empty((rows, (cols * num_bits + 31) // 32), dtype=torch.int32)
    lib.ct_pack_int32(values.data_ptr(), out.data_ptr(), rows, cols,
                      out.shape[1], num_bits)
    return out
