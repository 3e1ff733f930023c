"""Checkpoint / resume for simulation state.

The reference persists settings (.sim round-trip, main.cpp:508-611) and
mesh snapshots (.veg export) but has no mid-simulation state serialization
(SURVEY §5.4); this adds it: a tree of tensors (FemState, frame counters)
round-trips through a single .npz file.

Counterpart of fembrain_tpu/utils/checkpoint.py, in its file layout: one
array `leaf_i` per leaf and a `__treedef__` JSON, the leaves in the order
of `jax.tree_util.tree_flatten`, so a state saved by either package loads
into the other. A tree here is tensors, numpy arrays and Python scalars
held in dataclasses (field order), tuples, lists and dicts (sorted keys);
None holds no leaf. The reference's `enable_compilation_cache` (XLA's
persistent cache) has no counterpart: the hand-written kernels keep their
own build cache (`fembrain_tpu_torch.native`), and PyTorch compiles
nothing else.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _leaves(tree):
    if isinstance(tree, _LEAF_TYPES):
        yield tree
    elif tree is None:
        return
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        raise TypeError(f"not a tree of arrays: {type(tree).__name__}")


def _rebuild(tree, leaves):
    """`tree` with each leaf replaced by the next of the iterator
    `leaves` (the traversal of `_leaves`)."""
    if isinstance(tree, _LEAF_TYPES):
        return next(leaves)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(
            tree)(vals)
    return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str | Path, tree) -> None:
    """Serialize a tree of arrays/scalars to .npz + structure JSON."""
    arrays = {}
    meta = []
    for i, leaf in enumerate(_leaves(tree)):
        arr = _numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        meta.append({"dtype": str(arr.dtype), "shape": list(arr.shape)})
    np.savez_compressed(
        Path(path),
        __treedef__=np.frombuffer(
            json.dumps({"n": len(arrays), "meta": meta}).encode(), np.uint8
        ),
        **arrays,
    )


def load_pytree(path: str | Path, like):
    """Load arrays saved by save_pytree into the structure of `like`: each
    tensor leaf takes the dtype and device of `like`'s, each numpy leaf
    its dtype, each scalar its type."""
    p = Path(path)
    if not p.exists() and p.with_suffix(p.suffix + ".npz").exists():
        p = p.with_suffix(p.suffix + ".npz")
    data = np.load(p, allow_pickle=False)
    new = []
    for i, ref in enumerate(_leaves(like)):
        arr = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            new.append(torch.as_tensor(arr).to(dtype=ref.dtype,
                                               device=ref.device))
        elif isinstance(ref, (np.ndarray, np.generic)):
            new.append(np.asarray(arr, ref.dtype))
        else:
            new.append(type(ref)(arr))
    return _rebuild(like, iter(new))
