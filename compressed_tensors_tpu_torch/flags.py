"""Runtime behaviour flags, resolved from the environment once at import.

Counterpart of ``compressed_tensors_tpu/flags.py`` with the flags the
ported paths read. Programmatic control:

- ``set_flags(decode_attn="block")`` -- process-wide override
- ``with flag_overrides(w4_act="bf16"): ...`` -- scoped override
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

__all__ = ["FLAGS", "set_flags", "flag_overrides"]


@dataclasses.dataclass
class _Flags:
    # W4A16 kernel weight layout: "auto" or "b8" keep the checkpoint's
    # int4 words (the int4b / a8b kernels); "e8" expands symmetric 4-bit
    # weights to signed int8 (the w4_e8 kernel); "packed" is the JAX
    # package's int32 8-plane layout, run by the plane kernel in the mode
    # ``w4_mode`` names. Asymmetric weights under "e8" fall through to
    # "packed", as in the JAX package.
    w4_layout: str = "auto"
    # W4A16 activation precision: "auto" (int8 acts at >= 256 rows with N
    # and K >= 4096, bf16 otherwise) | "bf16" | "int8"
    w4_act: str = "auto"
    # decode mode of the "packed" layout: "int4" (bf16 plane dots, the
    # offset as a rank-8 correction) | "a8" (int8 activations, int8 plane
    # dots) | "mat" (each plane's scaled bf16 tile, one deep dot)
    w4_mode: str = "int4"
    # decode attention on the dense cache: "auto" (flash decode when the
    # cache's S_pad >= 512, the block kernel below) | "block" | "flash"
    decode_attn: str = "auto"
    # fp8 checkpoints on chips without native fp8: "always" re-grids fp8
    # weights to int8 at load (prepare_for_kernels) and fp8 KV caches to
    # int8 (transcode_fp8_kv_to_int8); "never" keeps fp8; "auto" keeps fp8
    # here, since the H100 has fp8 tensor cores (and the CPU runs fp8 as
    # the JAX package does off the TPU)
    fp8_transcode: str = "auto"


def _from_env() -> _Flags:
    env = os.environ.get
    return _Flags(
        w4_layout=env("CT_TORCH_W4_LAYOUT", "auto"),
        w4_act=env("CT_TORCH_W4_ACT", "auto"),
        w4_mode=env("CT_TORCH_W4_MODE", "int4"),
        decode_attn=env("CT_TORCH_DECODE_ATTN", "auto"),
        fp8_transcode=env("CT_TORCH_FP8_TRANSCODE", "auto"),
    )


FLAGS = _from_env()


def set_flags(**kwargs) -> None:
    """Process-wide flag override; unknown names raise."""
    for name, value in kwargs.items():
        if not hasattr(FLAGS, name):
            raise AttributeError(f"unknown flag {name!r}")
        setattr(FLAGS, name, value)


@contextlib.contextmanager
def flag_overrides(**kwargs):
    """Scoped flag override (restores previous values on exit)."""
    prev = {name: getattr(FLAGS, name) for name in kwargs}
    set_flags(**kwargs)
    try:
        yield FLAGS
    finally:
        set_flags(**prev)
