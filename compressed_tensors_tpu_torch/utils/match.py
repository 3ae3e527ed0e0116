"""Target resolution (model-free): exact / `re:`-regex / class matching
with fused-module suffix mapping and ignore lists, over a lightweight
module-graph abstraction. A "module" is a :class:`ModuleInfo` carrying its
class names; checkpoint loaders build these from tensor names.

Counterpart of ``compressed_tensors_tpu/utils/match.py``.
"""

from __future__ import annotations

import logging
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Generator, Iterable, Iterator, Mapping

_LOGGER = logging.getLogger(__name__)

__all__ = [
    "ModuleInfo",
    "match_name",
    "match_named_modules",
    "match_named_parameters",
    "match_targets",
    "match_modules_set",
    "match_quantizable_tensors",
    "get_lowest_common_ancestor_name",
    "is_match",
    "is_narrow_match",
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


ModuleGraph = Mapping[str, ModuleInfo]


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


def match_named_modules(
    modules: ModuleGraph,
    targets: Iterable[str] | None,
    ignore: Iterable[str] | None = None,
    fused: FusedMapping | None = None,
    warn_on_fail: bool = False,
) -> Generator[tuple[str, ModuleInfo], None, None]:
    """Yield (name, info) matching `targets` but not `ignore`, in mapping
    order (ref match.py:34-70)."""
    targets = list(targets or [])
    ignore = list(ignore or [])

    unmatched_targets = set(targets)
    for name, module in modules.items():
        for target in targets:
            if is_match(name, module, target, fused=fused):
                unmatched_targets -= {target}
                if not is_match(name, module, ignore, fused=fused):
                    yield name, module
                break

    if warn_on_fail:
        for target in unmatched_targets:
            _LOGGER.warning(f"Could not match `{target}` in model")


def match_named_parameters(
    modules: ModuleGraph,
    targets: Iterable[str] | None,
    ignore: Iterable[str] | None = None,
    fused: FusedMapping | None = None,
    warn_on_fail: bool = False,
    params: Mapping[str, Iterable[str]] | None = None,
) -> Generator[tuple[str, str, ModuleInfo], None, None]:
    """Yield parameters matching `targets` but not `ignore`, in mapping
    order (ref match.py:73-114 `match_named_parameters`).

    Parameter matching is by fully-qualified name ("{module}.{param}")
    against name targets only (no class matching, unlike module matching),
    with the same fused-suffix and `re:` semantics. Internal modules are
    skipped.

    :param params: module name -> parameter names carried by that module
        (the stand-in for torch's `named_parameters(recurse=False)`);
        defaults to a single "weight" per non-container module
    :return: generator of (param_fqn, module_name, module_info) — the
        functional analogue of the reference's (fqn, module, param)
    """
    targets = list(targets or [])
    ignore = list(ignore or [])

    unmatched_targets = set(targets)
    for module_name, module in modules.items():
        if module.is_internal:
            continue
        if params is not None:
            param_names = list(params.get(module_name, ()))
        else:
            param_names = [] if module.type_name == "Module" else ["weight"]
        for param_name in param_names:
            param_fqn = f"{module_name}.{param_name}"
            # NOTE: no break — a param matching several targets yields once
            # per matching target, mirroring the reference exactly
            # (ref match.py:96-107 has no break, unlike match_named_modules)
            for target in targets:
                if match_name(param_fqn, target, fused):
                    unmatched_targets -= {target}
                    if not any(match_name(param_fqn, ign, fused)
                               for ign in ignore):
                        yield param_fqn, module_name, module

    if warn_on_fail:
        for target in unmatched_targets:
            _LOGGER.warning(f"Could not match `{target}` in model")


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


def get_lowest_common_ancestor_name(names: list[str | None]) -> str:
    """Lowest-scope common dotted-name prefix, ignoring Nones
    (ref match.py:154-177)."""
    names = [name for name in names if name is not None]
    if len(names) == 0:
        return ""
    s1 = "." + min(names) + "."
    s2 = "." + max(names) + "."
    common_prefix = os.path.commonprefix([s1, s2])
    return common_prefix[1 : common_prefix.rfind(".")]


def match_modules_set(
    modules: ModuleGraph,
    targets: Iterable[str] | None,
    ignore: Iterable[str] | None = None,
    error_on_module_rematch: bool = True,
) -> Generator[list[list[str]], None, None]:
    """Yield groups of matched module *names* grouped by parent context
    (ref match.py:180-341). Each yielded group is a list of lists with the
    same order as `targets`."""
    targets = list(targets or [])
    ignore = list(ignore or [])

    matches: dict[str, list[str]] = defaultdict(list)
    parent_context = None
    unmatched_targets = set(targets)

    for name, module in modules.items():
        matched_targets_for_cur_module = set()
        for target in targets:
            if is_match(name, module, target, ignore):
                new_parent_context = get_lowest_common_ancestor_name(
                    [name, parent_context]
                )
                if not unmatched_targets and new_parent_context != parent_context:
                    yield [matches[t] for t in targets]
                    matches = defaultdict(list)
                    new_parent_context = name
                    unmatched_targets = set(targets)

                matches[target].append(name)
                parent_context = new_parent_context
                unmatched_targets -= {target}
                matched_targets_for_cur_module |= {target}

        if len(matched_targets_for_cur_module) > 1 and error_on_module_rematch:
            raise ValueError(
                f"module: {name} was matched with multiple targets: "
                f"{matched_targets_for_cur_module} which is unexpected "
                "disable this check by setting `error_on_module_rematch = False`"
            )

    if unmatched_targets == set(targets):
        return

    if not unmatched_targets:
        yield [matches[t] for t in targets]
        return

    raise ValueError(
        f"Found a final incomplete set with matches found for keys: "
        f"{set(targets) - unmatched_targets} "
        f"but no matches found for keys: {unmatched_targets}"
    )


def is_narrow_match(
    modules: ModuleGraph,
    targets: str | Iterable[str],
    name: str,
) -> bool:
    """True if a target matches the module but neither its parent nor any
    child (gates attention-module quantization, ref match.py:384-419)."""
    targets = [targets] if isinstance(targets, str) else targets
    module = modules[name]

    # reference quirk kept for parity: a top-level name has no ".", so
    # rsplit leaves parent_name == name — the parent "match" mirrors the
    # child and narrow can never be True at top level (ref match.py:384-419,
    # behavior pinned by the reference's own test_narrow_match_top_level)
    parent_name = name.rsplit(".", 1)[0]
    parent = modules.get(parent_name, ModuleInfo(type_name="Module"))

    child_items = [
        (child_name, child)
        for child_name, child in modules.items()
        if child_name.startswith(name + ".")
    ]

    def _matches_any_child(target: str) -> bool:
        return any(
            is_match(child_name, child, target) for child_name, child in child_items
        )

    return any(
        is_match(name, module, target)
        and not is_match(parent_name, parent, target)
        and not _matches_any_child(target)
        for target in targets
    )


def match_quantizable_tensors(
    tensors: Mapping[str, object],
    ignore: Iterable[str],
    targets: Iterable[str] = (),
    param_targets: Iterable[str] = ("weight",),
    allow_nonquantizable: bool = False,
) -> Iterator[tuple[str, str]]:
    """Match quantizable tensors by name for model-free conversion
    (ref match.py:469-523). Yields (module_name, full tensor name)."""
    targets = list(targets)
    ignore = list(ignore)
    for name in list(tensors.keys()):
        module_name, _, param_name = name.rpartition(".")

        if not allow_nonquantizable and module_name.endswith("norm"):
            continue

        if not any(match_name(param_name, t) for t in param_targets):
            continue

        is_module_targeted = (
            len(targets) == 0
            or "Linear" in targets
            or any(match_name(module_name, t) for t in targets)
        )
        if not is_module_targeted:
            continue

        if any(match_name(module_name, ign) for ign in ignore):
            continue

        yield module_name, name
