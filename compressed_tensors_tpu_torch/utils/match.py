"""Target resolution (model-free): exact / `re:`-regex / class matching
with fused-module suffix mapping and ignore lists, over a lightweight
module-graph abstraction. A "module" is a :class:`ModuleInfo` carrying its
class names; checkpoint loaders build these from tensor names.

Counterpart of ``compressed_tensors_tpu/utils/match.py`` for what the load
path resolves; the module-set, parameter and narrow matchers join with the
lifecycle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Mapping

__all__ = [
    "ModuleInfo",
    "match_name",
    "match_targets",
    "is_match",
]

FusedMapping = Mapping[str, Iterable[str]]

# vLLM-style fused module mapping used by llama-family checkpoints
DEFAULT_FUSED_MAPPING: FusedMapping = {
    "qkv_proj": ["q_proj", "k_proj", "v_proj"],
    "gate_up_proj": ["gate_proj", "up_proj"],
}


@dataclass(frozen=True)
class ModuleInfo:
    """Minimal module description for target matching.

    :param type_name: the module's class name (e.g. "Linear", "Embedding")
    :param parent_classes: additional class names in the MRO, for class
        matching (ref `_match_class`, match.py:448-466)
    :param is_internal: internal modules are excluded from matching
        (ref utils/internal.py InternalModule)
    """

    type_name: str = "Linear"
    parent_classes: tuple[str, ...] = field(default_factory=tuple)
    is_internal: bool = False

    @property
    def all_classes(self) -> tuple[str, ...]:
        return (self.type_name, *self.parent_classes)




def match_name(name: str, target: str, fused: FusedMapping | None = None) -> bool:
    """True if `target` is `re:`-regex matching or exactly equal to `name`.

    Fused-module names (vLLM `qkv_proj` style) match if any of their shard
    names match (ref match.py:422-445).
    """
    if fused is not None:
        for fused_suffix in fused:
            if name.endswith(fused_suffix):
                name_stripped = name.removesuffix(fused_suffix)
                return any(
                    match_name(name_stripped + shard_suffix, target)
                    for shard_suffix in fused[fused_suffix]
                )

    if target.startswith("re:"):
        return re.match(target.removeprefix("re:"), name) is not None
    return target == name


def _match_class(module: ModuleInfo, target: str) -> bool:
    """True if any class name matches target exactly. vLLM's `LinearBase`
    matches target "Linear" (ref match.py:448-466)."""
    return any(
        cls == target or (cls == "LinearBase" and target == "Linear")
        for cls in module.all_classes
    )


def is_match(
    name: str,
    module: ModuleInfo,
    targets: str | Iterable[str],
    ignore: str | Iterable[str] = (),
    fused: FusedMapping | None = None,
) -> bool:
    """True if name-or-class matches any target and no ignore entry."""
    targets = [targets] if isinstance(targets, str) else targets
    ignore = [ignore] if isinstance(ignore, str) else ignore

    return not module.is_internal and (
        any(
            match_name(name, target, fused) or _match_class(module, target)
            for target in targets
        )
        and not any(
            match_name(name, ign, fused) or _match_class(module, ign)
            for ign in ignore
        )
    )


def match_targets(
    name: str, module: ModuleInfo, targets: Iterable[str] | None
) -> list[str]:
    """Targets matching (name, module), ordered: exact > regex > class
    (ref match.py:116-151)."""
    targets = list(targets or [])
    if module.is_internal:
        return []

    targets = sorted(targets, key=lambda x: ("re:" in x, x))
    matched_targets = []
    for target in targets:
        if match_name(name, target):
            matched_targets.append(target)
    for target in targets:
        if _match_class(module, target) and target not in matched_targets:
            matched_targets.append(target)
    return matched_targets
