"""Small helpers shared by the port's modules. Counterpart of
``compressed_tensors_tpu/utils/__init__.py``."""

import torch

from compressed_tensors_tpu_torch.utils.dtypes import (  # noqa: F401
    SAFETENSORS_DTYPES,
    TensorDType,
    parse_dtype,
    serialize_dtype,
)
from compressed_tensors_tpu_torch.utils.match import (  # noqa: F401
    ModuleInfo,
    is_match,
    is_narrow_match,
    match_modules_set,
    match_name,
    match_named_modules,
    match_named_parameters,
    match_quantizable_tensors,
    match_targets,
)


class Aliasable:
    """Enum mixin allowing member aliasing: equality and hashing route
    through a canonical alias map."""

    @staticmethod
    def get_aliases() -> dict:
        raise NotImplementedError()

    def __eq__(self, other):
        aliases = self.get_aliases()
        if isinstance(other, self.__class__):
            return self.value == other.value or (
                aliases.get(self.value, self.value)
                == aliases.get(other.value, other.value))
        return aliases.get(self.value, self.value) == aliases.get(other, other)

    def __hash__(self):
        return hash(self.get_aliases().get(self.value, self.value))


class ParameterizedDefaultDict(dict):
    """dict whose missing values are built by calling a factory with the
    key (tuple keys splat as positional args); ``get`` forwards keyword
    arguments to the factory."""

    def __init__(self, default_factory):
        self.default_factory = default_factory
        self._factory_kwargs = {}
        super().__init__()

    def __missing__(self, key):
        if isinstance(key, tuple):
            value = self.default_factory(*key, **self._factory_kwargs)
        else:
            value = self.default_factory(key, **self._factory_kwargs)
        self[key] = value
        return value

    def get(self, *args, factory_kwargs=None):
        """__getitem__ on the args tuple, with kwargs forwarded to the
        factory."""
        prev = self._factory_kwargs
        self._factory_kwargs = factory_kwargs or {}
        try:
            return self[args]
        finally:
            self._factory_kwargs = prev


def shard_tensor(tensor, shard_sizes: list, dim: int = 0) -> list:
    """Split a tensor into contiguous shards along ``dim``; sizes must sum
    to the dim length."""
    if sum(shard_sizes) != tensor.shape[dim]:
        raise ValueError(
            "Sum of shard_sizes must equal the size of the tensor "
            "along the specified dimension.")
    return list(torch.split(tensor, list(shard_sizes), dim=dim))


def combine_shards(shards: list, dim: int = 0):
    """Concatenate shards along ``dim``."""
    if not shards:
        raise ValueError("The list of shards is empty.")
    if len({s.dtype for s in shards}) > 1:
        raise ValueError("All shards must have the same dtype.")
    return torch.cat(list(shards), dim=dim)


def getattr_chain(obj, chain: str, *args):
    """Chained getattr: getattr_chain(scheme, "weights.symmetric", True)."""
    has_default = len(args) >= 1
    default = args[0] if has_default else None
    res = obj
    for attr_name in chain.split("."):
        if not hasattr(res, attr_name):
            if has_default:
                return default
            raise AttributeError(f"{res} object has no attribute {attr_name!r}")
        res = getattr(res, attr_name)
    return res
