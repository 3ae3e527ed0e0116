"""Runtime behaviour flags, resolved from the environment once at import.

Counterpart of ``compressed_tensors_tpu/flags.py`` with the two flags the
W4A16 decode path reads. Programmatic control:

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
    # W4A16 activation precision: "auto" (int8 acts at >= 256 rows with N
    # and K >= 4096, bf16 otherwise) | "bf16" | "int8"
    w4_act: str = "auto"
    # decode attention on the dense cache: "auto" (flash decode when the
    # cache's S_pad >= 512, the block kernel below) | "block" | "flash"
    decode_attn: str = "auto"


def _from_env() -> _Flags:
    env = os.environ.get
    return _Flags(
        w4_act=env("CT_TORCH_W4_ACT", "auto"),
        decode_attn=env("CT_TORCH_DECODE_ATTN", "auto"),
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
