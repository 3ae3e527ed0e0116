"""Runtime behaviour flags, resolved from the environment once at import.

Counterpart of ``compressed_tensors_tpu/flags.py``: each flag is read from
the JAX package's variable with ``CT_TORCH_`` in place of ``CT_TPU_``.
The JAX flag ``pallas_interpret`` (run the Pallas kernels in interpret
mode on the CPU) has no CUDA meaning and is not copied: a CUDA kernel has
no interpret mode, and the port's wrappers run their plain PyTorch
versions only for CPU tensors. Programmatic control:

- ``set_flags(decode_attn="block")`` -- process-wide override
- ``with flag_overrides(w4_act="bf16"): ...`` -- scoped override
- ``reload_flags_from_env()`` -- re-resolve every flag from the
  environment
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

__all__ = ["FLAGS", "set_flags", "flag_overrides", "reload_flags_from_env",
           "kernels_enabled"]


@dataclasses.dataclass
class _Flags:
    # run no hand-written kernel: every entry point takes the non-kernel
    # path, as use_kernels=False does. An explicit opt-in, off by default,
    # logged when it turns the kernels off
    enforce_eager: bool = False
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
    # row count at or above which a 4-bit linear at bf16 activations
    # dequantizes its weight once and runs one torch.matmul instead of its
    # kernel, as the JAX package does outside its kernel; 0 (the default)
    # means never. The int8-activation mode (w4_act="int8") ignores it
    w4_dense_m: int = 0
    # disable the native C++ host IO library (utils/native.py): the pure
    # Python reads and codecs run instead
    disable_native: bool = False


def _from_env() -> _Flags:
    env = os.environ.get
    return _Flags(
        enforce_eager=env("CT_TORCH_ENFORCE_EAGER", "") == "1",
        w4_layout=env("CT_TORCH_W4_LAYOUT", "auto"),
        w4_act=env("CT_TORCH_W4_ACT", "auto"),
        w4_mode=env("CT_TORCH_W4_MODE", "int4"),
        decode_attn=env("CT_TORCH_DECODE_ATTN", "auto"),
        fp8_transcode=env("CT_TORCH_FP8_TRANSCODE", "auto"),
        w4_dense_m=int(env("CT_TORCH_W4_DENSE_M", "0")),
        disable_native=env("CT_TORCH_DISABLE_NATIVE", "") == "1",
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


def reload_flags_from_env() -> None:
    """Re-resolve every flag from the current environment."""
    set_flags(**dataclasses.asdict(_from_env()))


def kernels_enabled(use_kernels: bool) -> bool:
    """``use_kernels`` unless ``enforce_eager`` is set, which turns the
    kernels off (logged once)."""
    if use_kernels and FLAGS.enforce_eager:
        import logging

        from compressed_tensors_tpu_torch.logger import log_once

        log_once(logging.WARNING, "enforce_eager is set: the hand-written "
                 "kernels are off, every matmul and attention takes the "
                 "non-kernel path")
        return False
    return use_kernels
