"""Transform application: fused (offline) weight transforms + online
transform specs.

Counterpart of ``compressed_tensors_tpu/transform/apply.py``:
- WEIGHT_INPUT / WEIGHT_OUTPUT are fused into weights (and bias for
  WEIGHT_OUTPUT: y' = R W x + R b) in float64 on the weights' device,
  one module at a time, each rounded back to its weight's dtype;
- INPUT / OUTPUT / K_CACHE / Q_ATTN are online: they come back as
  ``OnlineTransform`` specs. No engine of either package applies them,
  so a checkpoint that needs them is refused at load
  (``ModelCompressor.from_compression_config``);
- transform weights are deduplicated per size within a scheme.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from compressed_tensors_tpu_torch.registry import RegistryMixin
from compressed_tensors_tpu_torch.transform.hadamard import (
    deterministic_hadamard_matrix,
    hadamard_matrix,
    high_precision_invert,
    random_hadamard_matrix,
    random_matrix,
)
from compressed_tensors_tpu_torch.transform.schemas import (
    TransformConfig,
    TransformLocation,
    TransformScheme,
)
from compressed_tensors_tpu_torch.utils.match import ModuleInfo, is_match

__all__ = [
    "TransformFactory",
    "HadamardFactory",
    "RandomHadamardFactory",
    "RandomMatrixFactory",
    "OnlineTransform",
    "apply_transform_config",
    "apply_transform_weight",
    "get_transform_size",
    "multihead_matmul",
]


def get_transform_size(
    module_type: str,
    location: TransformLocation | str,
    weight_shape: tuple[int, ...],
    head_dim: int | None = None,
) -> int:
    """Size of the transform matrix for a module/location."""
    location = TransformLocation(location)
    size = None
    if module_type == "Linear":
        # weight (out_features, in_features)
        if location in (TransformLocation.INPUT,
                        TransformLocation.WEIGHT_INPUT):
            size = weight_shape[1]
        else:
            size = weight_shape[0]
    elif module_type == "Embedding":
        # weight (num_embeddings, embedding_dim)
        if location in (TransformLocation.INPUT,
                        TransformLocation.WEIGHT_INPUT):
            size = weight_shape[0]
        else:
            size = weight_shape[1]
    elif head_dim is None:
        raise NotImplementedError(
            f"Transforms on {module_type} are not supported without head_dim"
        )

    if head_dim is not None:
        if size is not None and size % head_dim != 0:
            raise ValueError(
                f"{head_dim} must divide {size} for {module_type} at "
                f"{location}"
            )
        size = head_dim
    return size


def multihead_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with block-diagonal broadcasting when the shared dim
    differs."""
    if A.shape[-1] > B.shape[-2]:
        head_dim = B.shape[-2]
        num_heads = A.shape[-1] // head_dim
        A2 = A.reshape(*A.shape[:-1], num_heads, head_dim)
        out = A2 @ B
        return out.reshape(*out.shape[:-2], num_heads * out.shape[-1])
    elif A.shape[-1] < B.shape[-2]:
        head_dim = A.shape[-1]
        num_heads = B.shape[-2] // head_dim
        B2 = B.reshape(*B.shape[:-2], num_heads, head_dim, B.shape[-1])
        out = A @ B2
        return out.reshape(*out.shape[:-3], out.shape[-3] * out.shape[-2],
                           out.shape[-1])
    return A @ B


def apply_transform_weight(
    transform_weight: torch.Tensor,
    value: torch.Tensor,
    location: TransformLocation | str,
    module_type: str,
) -> torch.Tensor:
    """Apply a transform weight to a value per location/module type. With
    y = x W^T: xh = x V, Wh = U^T W Vi^T, yh = y U."""
    location = TransformLocation(location)
    assert transform_weight.shape[-2] == transform_weight.shape[-1]

    if location.is_online():
        return multihead_matmul(value, transform_weight)

    if module_type == "Linear":
        if location == TransformLocation.WEIGHT_INPUT:
            return multihead_matmul(value, transform_weight.T)
        elif location == TransformLocation.WEIGHT_OUTPUT:
            return multihead_matmul(transform_weight.T, value)
    elif module_type == "Embedding":
        if location == TransformLocation.WEIGHT_INPUT:
            return multihead_matmul(transform_weight, value)
        elif location == TransformLocation.WEIGHT_OUTPUT:
            return multihead_matmul(value, transform_weight)

    raise NotImplementedError(
        f"Applying transforms to {module_type} {location} is not supported"
    )


@dataclasses.dataclass
class OnlineTransform:
    """A run-time transform of activations (no engine applies one yet)."""

    weight: torch.Tensor
    location: str
    module_type: str
    precision: torch.dtype
    scale: float = 1.0  # 1/sqrt(n) normalization for hadamard


class TransformFactory(RegistryMixin):
    """Creates transform weights for a scheme, in float64 on ``device``.
    Weights of the same size are shared within the factory."""

    normalize = False  # hadamard factories divide by sqrt(n) at apply

    def __init__(self, name: str, scheme: TransformScheme,
                 seed: int | None = None, device="cuda"):
        self.name = name
        self.scheme = scheme
        self.seed = seed or 0
        self.device = device
        self._weights: dict[int, torch.Tensor] = {}

    @classmethod
    def from_scheme(cls, scheme: TransformScheme, name: str,
                    seed: int | None = None,
                    device="cuda") -> "TransformFactory":
        factory_cls = TransformFactory.get_value_from_registry(scheme.type)
        return factory_cls(name, scheme, seed, device)

    def _construct(self, size: int, seed: int) -> torch.Tensor:
        raise NotImplementedError

    def get_weight(self, size: int) -> torch.Tensor:
        """Weights are deduplicated per size for every factory type;
        ``randomize`` only changes how the shared weight is built."""
        if size not in self._weights:
            self._weights[size] = self._construct(size, self.seed)
        return self._weights[size]

    def inverse(self, weight: torch.Tensor) -> torch.Tensor:
        return high_precision_invert(weight)


@TransformFactory.register("hadamard")
class HadamardFactory(TransformFactory):
    normalize = True

    def _construct(self, size: int, seed: int) -> torch.Tensor:
        if (size & (size - 1)) == 0:
            return deterministic_hadamard_matrix(size, device=self.device)
        return hadamard_matrix(size, device=self.device)

    def get_weight(self, size: int) -> torch.Tensor:
        """Deterministic base weight, deduplicated by size; ``randomize``
        applies a symmetric permutation H[perm][:, perm] drawn from
        ``np.random.default_rng(seed + size)``, one per size, so inverse
        pairs stay consistent. The permuted matrix stays Hadamard and its
        normalized inverse stays the transpose."""
        if size not in self._weights:
            weight = self._construct(size, self.seed)
            if self.scheme.randomize:
                rng = np.random.default_rng(self.seed + size)
                perm = torch.from_numpy(rng.permutation(size)).to(
                    weight.device)
                weight = weight[perm][:, perm]
            self._weights[size] = weight
        return self._weights[size]

    def inverse(self, weight: torch.Tensor) -> torch.Tensor:
        # hadamard inverse (after 1/sqrt(n) normalization) is the transpose
        return weight.T


@TransformFactory.register("random-hadamard")
class RandomHadamardFactory(HadamardFactory):
    def _construct(self, size: int, seed: int) -> torch.Tensor:
        return random_hadamard_matrix(size, seed=seed, device=self.device)


@TransformFactory.register("random-matrix")
class RandomMatrixFactory(TransformFactory):
    def _construct(self, size: int, seed: int) -> torch.Tensor:
        return random_matrix(size, seed=seed, device=self.device)


def _states_device(module_states: Mapping[str, dict], device):
    """The device of the first tensor in ``module_states``, else
    ``device`` (the card unless the caller names another)."""
    for state in module_states.values():
        for value in state.values():
            if isinstance(value, torch.Tensor):
                return value.device
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    return resolve_device(device)


def apply_transform_config(
    module_states: Mapping[str, dict],
    modules: Mapping[str, ModuleInfo],
    config: TransformConfig,
    seed: int | None = None,
    head_dims: Mapping[str, int] | None = None,
    device="cuda",
) -> tuple[dict[str, dict], dict[str, list[OnlineTransform]]]:
    """Apply a transform config, in the JAX package's order (scheme by
    scheme, each ``apply`` entry over every matched module).

    Fuses offline (WEIGHT_*) transforms into the module weights in float64
    on the weights' device, one module at a time, each rounded back to its
    weight's dtype (a module matched by several entries is rounded after
    each), and collects online transforms. The caller's dicts and tensors
    are not modified.

    :param module_states: name -> {"weight": tensor, ["bias": tensor]} with
        *dense* weights (transforms apply before quantization/compression)
    :param device: where the transform weights are built when no module
        state holds a tensor (online transforms of weightless modules);
        otherwise the weights' device
    :return: (updated module states, name -> [OnlineTransform])
    """
    new_states = {k: dict(v) for k, v in module_states.items()}
    online: dict[str, list[OnlineTransform]] = {}
    device = _states_device(module_states, device)

    for name, scheme in config.config_groups.items():
        factory = TransformFactory.from_scheme(scheme, name=name, seed=seed,
                                               device=device)

        for args in scheme.apply:
            for mod_name, info in modules.items():
                if not is_match(mod_name, info, args.targets, args.ignore):
                    continue
                state = new_states.get(mod_name)
                w = state.get("weight") if state else None
                loc = TransformLocation(args.location)
                attn_online = loc in (TransformLocation.Q_ATTN,
                                      TransformLocation.K_CACHE)
                if w is None and not (attn_online
                                      and scheme.head_dim is not None):
                    # weightless modules (attention containers) can only
                    # take per-head online q/k transforms sized by head_dim
                    continue
                size = get_transform_size(
                    info.type_name, args.location,
                    tuple(w.shape) if w is not None else None,
                    scheme.head_dim)
                tw = factory.get_weight(size)
                if args.inverse:
                    tw = factory.inverse(tw)
                norm = (1.0 / math.sqrt(size)) if factory.normalize else 1.0

                if not args.is_online():
                    tw = tw.to(w.device)
                    fused = apply_transform_weight(
                        tw, w.to(torch.float64), args.location,
                        info.type_name)
                    state["weight"] = fused.mul_(norm).to(w.dtype)
                    del fused
                    # bias fuses for WEIGHT_OUTPUT: y' = R W x + R b
                    bias = state.get("bias")
                    if bias is not None and \
                            loc == TransformLocation.WEIGHT_OUTPUT:
                        b = bias.to(torch.float64)
                        state["bias"] = (
                            multihead_matmul(tw.T, b[:, None])[:, 0] * norm
                        ).to(bias.dtype)
                else:
                    online.setdefault(mod_name, []).append(
                        OnlineTransform(
                            weight=tw.to(
                                scheme.precision
                                if scheme.precision != torch.float64
                                else torch.float32),
                            location=str(loc.value),
                            module_type=info.type_name,
                            precision=scheme.precision,
                            scale=norm,
                        )
                    )

    return new_states, online
