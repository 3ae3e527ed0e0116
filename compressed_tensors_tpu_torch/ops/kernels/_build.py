"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes. The library lands in
``build/kernels/`` beside the package, named by a hash of the sources and
flags, so a changed source is rebuilt and a built one is reused. Nothing
is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

__all__ = ["build", "load", "check", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("w4a16_matmul.cu", "w4a16_planes.cu", "wna16_matmul.cu",
           "w8a8_matmul.cu",
           "prefill_attention.cu", "decode_attention.cu", "paged_decode.cu",
           "mla_decode.cu", "errors.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ct_w4a16_matmul": [_P] * 5 + [_I] * 7 + [_P],
    "ct_w4a16_matmul_experts": [_P] * 5 + [_I] * 8 + [_P],
    "ct_w4a16_a8b_matmul_experts": [_P] * 7 + [_I] * 7 + [_P],
    "ct_w4a16_a8b_matmul": [_P] * 7 + [_I] * 6 + [_P],
    "ct_w4a16_a8b_quantize": [_P] * 3 + [_I] * 2 + [_P],
    "ct_w4a16_a8b_gemm": [_P] * 6 + [_I] * 6 + [_P],
    "ct_w4a16_fp4_matmul": [_P] * 4 + [_I] * 7 + [_P],
    "ct_w4_e8_matmul": [_P] * 4 + [_I] * 7 + [_P],
    "ct_w4_e8_matmul_experts": [_P] * 4 + [_I] * 8 + [_P],
    "ct_w4a16_planes_int4": [_P] * 6 + [_I] * 7 + [_P],
    "ct_w4a16_planes_mat": [_P] * 6 + [_I] * 7 + [_P],
    "ct_w4a16_planes_a8": [_P] * 8 + [_I] * 7 + [_P],
    "ct_w8a8_matmul": [_P] * 6 + [_I] * 6 + [_P],
    "ct_w8a8_fp8_matmul": [_P] * 6 + [_I] * 6 + [_P],
    "ct_w8a8_quantize": [_P] * 3 + [_I] * 3 + [_P],
    "ct_w8a8_gemm": [_P] * 5 + [_I] * 7 + [_P],
    "ct_prefill_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "ct_decode_attention": [_P] * 9 + [_I] * 9 + [_F, _P],
    "ct_flash_decode": [_P] * 11 + [_I] * 9 + [_F, _P],
    "ct_paged_decode": [_P] * 12 + [_I] * 11 + [_F, _P],
    "ct_latent_decode": [_P] * 12 + [_I] * 9 + [_F, _P],
    "ct_latent_paged_decode": [_P] * 13 + [_I] * 11 + [_F, _P],
}

_lib = None
_lock = threading.Lock()
# source name -> nvcc's output of the last verbose build (ptxas's report)
_VERBOSE_OUT: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")
    return path


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path. ``verbose`` prints ptxas's register
    and shared-memory report per kernel."""
    sources = [CSRC / s for s in SOURCES]
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources + headers)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libct_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{digest}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        if verbose:
            _VERBOSE_OUT[src.name] = out
        if proc.returncode or verbose:
            print(f"[nvcc {src.name}]\n{out}", file=sys.stderr)
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
    tmp = lib_path.with_name(lib_path.name + f".{os.getpid()}.tmp")
    subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                    *(str(obj) for _, obj, _ in jobs)], check=True)
    os.replace(tmp, lib_path)
    return lib_path


def ptxas_report(sources: tuple[str, ...], serialized: dict | None = None
                 ) -> dict[str, tuple[int, int]]:
    """Registers and spill-store bytes of every kernel in ``sources``
    (``csrc`` file names), from ptxas's report: the one a verbose
    ``build`` of this process printed, else a compile-only build (each
    source by its own nvcc, all at once): {mangled name: (registers, spill
    bytes)}. A ``serialized`` dict receives {mangled name: [codes]} of
    ptxas's "wgmma ... serialized" performance warnings (C75xx)."""
    import re
    import tempfile

    outs = [_VERBOSE_OUT[src] for src in sources if src in _VERBOSE_OUT]
    missing = [src for src in sources if src not in _VERBOSE_OUT]
    if missing:
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
                 "-o", os.path.join(tmp, f"{i}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i, src in enumerate(missing)]
            outs += [p.communicate()[0] for p in procs]
    report, name = {}, None
    for line in "\n".join(outs).splitlines():
        m = re.search(r"\((C75\d\d)\).*serialized.*function '([^']+)'", line)
        if m and serialized is not None:
            serialized.setdefault(m.group(2), []).append(m.group(1))
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), spill)
            name = None
    return report


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ct_error_string.argtypes = [ctypes.c_int]
            lib.ct_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.ct_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
