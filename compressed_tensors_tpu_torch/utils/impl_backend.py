"""Priority-based backend dispatch.

Counterpart of ``compressed_tensors_tpu/utils/impl_backend.py``:
implementations register under an op name with an availability predicate
and a priority; the entrypoint decorator turns a plain function into a
dispatch wrapper whose own body is the fallback, and ``enforce_eager``
(``CT_TORCH_ENFORCE_EAGER=1``) forces the fallbacks.

No kernel wrapper of this package dispatches through it: each wrapper
launches its CUDA kernel for CUDA tensors or raises, and runs its plain
version only for CPU tensors. The registry is here for code built on the
package.
"""

from __future__ import annotations

import functools
from typing import Callable

__all__ = ["ImplBackend", "enforce_eager"]


def enforce_eager() -> bool:
    from compressed_tensors_tpu_torch.flags import FLAGS

    return FLAGS.enforce_eager


class ImplBackend:
    # op name -> list of (impl_fn, requirement_fn, priority)
    _backends: dict[str, list[tuple[Callable, Callable, int]]] = {}
    # impl function __name__ -> impl fn (for targeted calls)
    _fn_registry: dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str, req: Callable[..., bool],
                 priority: int | str = 0):
        """Register a backend for op ``name``; ``req(*args, **kwargs)``
        decides per call whether it applies. Priority "disable" records
        the function by name without dispatching to it."""

        def decorator(fn):
            if fn.__name__ in cls._fn_registry:
                raise RuntimeError(
                    f"backend {fn.__name__} registered more than once")
            cls._fn_registry[fn.__name__] = fn
            if priority != "disable":
                cls._backends.setdefault(name, []).append(
                    (fn, req, int(priority)))
                cls._backends[name].sort(key=lambda t: -t[2])
            return fn

        return decorator

    @classmethod
    def entrypoint(cls, name: str):
        """Make the decorated function the dispatch entrypoint and fallback
        of op ``name``."""

        def decorator(fallback):
            cls._fn_registry.setdefault(fallback.__name__, fallback)

            @functools.wraps(fallback)
            def wrapper(*args, **kwargs):
                if not enforce_eager():
                    for fn, req, _prio in cls._backends.get(name, []):
                        try:
                            ok = req(*args, **kwargs)
                        except Exception:
                            ok = False
                        if ok:
                            return fn(*args, **kwargs)
                return fallback(*args, **kwargs)

            wrapper.__ct_fallback__ = fallback
            return wrapper

        return decorator

    @classmethod
    def call(cls, fn_name: str, *args, **kwargs):
        """Call one registered backend by function name."""
        if fn_name not in cls._fn_registry:
            raise KeyError(f"No backend named {fn_name}. "
                           f"Registered: {sorted(cls._fn_registry)}")
        return cls._fn_registry[fn_name](*args, **kwargs)

    @classmethod
    def registered(cls, name: str) -> list[str]:
        return [fn.__name__ for fn, _, _ in cls._backends.get(name, [])]
