"""Plugin registry for compressors, sparsity configs and transform factories.

Counterpart of ``compressed_tensors_tpu/registry.py`` (the registry concept
of `compressed_tensors/registry/registry.py:56`): per-parent-class
name->value registries with alias support and hyphen/underscore/case
normalization.
"""

from __future__ import annotations

import importlib
from typing import Any, TypeVar

__all__ = ["RegistryMixin", "standardize_lookup_name"]

_T = TypeVar("_T")

# parent class -> {standardized name -> registered value}
_REGISTRIES: dict[type, dict[str, Any]] = {}
# parent class -> {alias -> standardized name}
_ALIASES: dict[type, dict[str, str]] = {}


def standardize_lookup_name(name: str) -> str:
    """Normalize a registry key: lowercase, hyphens for underscores."""
    return name.replace("_", "-").lower()


class RegistryMixin:
    """Universal registry mixin.

    Subclass hierarchies each get an independent registry rooted at the class
    that directly inherits ``RegistryMixin``::

        class BaseCompressor(RegistryMixin): ...

        @BaseCompressor.register(name="pack-quantized")
        class PackedCompressor(BaseCompressor): ...

        BaseCompressor.get_value_from_registry("pack_quantized")  # normalized
    """

    @classmethod
    def _registry_root(cls) -> type:
        # first class in the MRO that directly lists RegistryMixin as a base
        for klass in cls.__mro__:
            if RegistryMixin in klass.__bases__:
                return klass
        raise ValueError(f"{cls.__name__} does not inherit RegistryMixin")

    @classmethod
    def register(cls, name: str | None = None, alias: str | list[str] | None = None):
        def decorator(value):
            cls.register_value(value, name=name or value.__name__, alias=alias)
            return value

        return decorator

    @classmethod
    def register_value(
        cls, value: Any, name: str, alias: str | list[str] | None = None
    ) -> None:
        root = cls._registry_root()
        registry = _REGISTRIES.setdefault(root, {})
        aliases = _ALIASES.setdefault(root, {})

        if isinstance(value, type) and not issubclass(value, root):
            raise ValueError(
                f"Cannot register {value.__name__}: not a subclass of {root.__name__}"
            )

        key = standardize_lookup_name(name)
        if key in registry and registry[key] is not value:
            raise RuntimeError(
                f"name {name!r} already registered in {root.__name__} registry"
            )
        registry[key] = value

        if alias is not None:
            alias_list = [alias] if isinstance(alias, str) else list(alias)
            for a in alias_list:
                aliases[standardize_lookup_name(a)] = key

    @classmethod
    def get_value_from_registry(cls, name: str) -> Any:
        """Look up a registered value by name or alias.

        Supports ``"path/to/file.py:ClassName"`` and ``"module.path:ClassName"``
        plugin loading like the reference (`registry.py:318-336`).
        """
        if ":" in name:
            return _load_external(name)

        root = cls._registry_root()
        registry = _REGISTRIES.get(root, {})
        aliases = _ALIASES.get(root, {})
        key = standardize_lookup_name(name)
        key = aliases.get(key, key)
        if key not in registry:
            raise KeyError(
                f"Unable to find {name!r} registered under {root.__name__}. "
                f"Registered values: {sorted(registry)}"
            )
        return registry[key]

    @classmethod
    def load_from_registry(cls, name: str, **kwargs) -> Any:
        """Look up a registered class and instantiate it."""
        return cls.get_value_from_registry(name)(**kwargs)

    @classmethod
    def registered_names(cls) -> list[str]:
        return sorted(_REGISTRIES.get(cls._registry_root(), {}))

    @classmethod
    def registered_aliases(cls) -> list[str]:
        return sorted(_ALIASES.get(cls._registry_root(), {}))


def _load_external(path: str) -> Any:
    """Load ``file.py:ClassName`` or ``module.sub:ClassName`` plugin values."""
    module_path, _, attr = path.partition(":")
    if module_path.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_ct_tpu_plugin", module_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(module_path)
    return getattr(module, attr)
