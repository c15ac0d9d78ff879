"""The frozen base's fp32 -> bf16 cast in bounded groups (counterpart of
``hcpdiff_tpu/utils/casting.py``).

A cast of the whole tree at once (``{n: t.to(torch.bfloat16) for ...}``)
keeps every fp32 tensor alive until the new tree is assigned, so the fp32
and bf16 copies of the whole base are live together: the fp32 base plus
half of it again. Here the tree is cast a group at a time and each tensor
is replaced in its container as its group is done, so a group's fp32
storage is freed (where nothing else holds it) before the next group is
cast, and the peak is the fp32 base plus one group.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

__all__ = ['cast_tree_bf16']

GROUP_BYTES = 512 * 1024 * 1024


def _fp32_leaves(tree: Any) -> List[Tuple[Any, Any]]:
    """(container, key) of every fp32 tensor of a tree of dicts and lists, in
    order."""
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, torch.Tensor):
            if value.dtype == torch.float32:
                out.append((tree, key))
        elif isinstance(value, (dict, list)):
            out += _fp32_leaves(value)
    return out


def cast_tree_bf16(tree: Any, group_bytes: int = GROUP_BYTES) -> Any:
    """Cast the fp32 tensors of ``tree`` (nested dicts and lists) to bf16 in
    place, in groups that close once they hold ``group_bytes`` of fp32 (as
    the JAX package groups them); other leaves pass through. Returns
    ``tree``."""
    group, size = [], 0

    def flush():
        cast = [c[k].to(torch.bfloat16) for c, k in group]
        for (c, k), t in zip(group, cast):
            c[k] = t                   # the fp32 tensor's last reference goes here
        group.clear()

    for container, key in _fp32_leaves(tree):
        group.append((container, key))
        size += container[key].numel() * 4
        if size >= group_bytes:
            flush()
            size = 0
    if group:
        flush()
    return tree
