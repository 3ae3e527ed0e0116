"""Load balancing: the counterpart of
``compressed_tensors_tpu/distributed/assign.py``."""

from __future__ import annotations

from typing import Callable, Hashable, TypeVar

__all__ = ["greedy_bin_packing"]

T = TypeVar("T", bound=Hashable)


def greedy_bin_packing(
    items: list[T],
    num_bins: int,
    item_weight_fn: Callable[[T], float] = lambda x: 1,
) -> tuple[list[T], list[list[T]], dict[T, int]]:
    """Sort ``items`` in place by descending weight (stable), then give
    each to the lightest bin (the first of equal ones).

    :return: (items sorted desc, bin -> items, item -> bin index)
    """
    items.sort(key=item_weight_fn, reverse=True)
    bin_to_items: list[list[T]] = [[] for _ in range(num_bins)]
    item_to_bin: dict[T, int] = {}
    bin_weights: list[float] = [0.0 for _ in range(num_bins)]
    for item in items:
        target_bin = bin_weights.index(min(bin_weights))
        bin_to_items[target_bin].append(item)
        item_to_bin[item] = target_bin
        bin_weights[target_bin] += item_weight_fn(item)
    return items, bin_to_items, item_to_bin
