"""Helpers the runners share."""

from __future__ import annotations

import gc
import types

import torch


def clone_tree(tree):
    """A copy of a tree of NamedTuples, tuples, dicts and tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    if isinstance(tree, types.SimpleNamespace):
        return types.SimpleNamespace(**clone_tree(vars(tree)))
    return tree.detach().clone()


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
