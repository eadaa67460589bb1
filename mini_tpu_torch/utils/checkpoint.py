"""Checkpoint / resume for algorithm and model state, in the file format of
``mini_tpu.utils.checkpoint``.

A tree of tensors (nested dicts, lists, tuples, namedtuples and
dataclasses; ``None`` holds no leaf) round-trips through one ``.npz``:
``leaf_<i>`` arrays in the order ``jax.tree_util`` flattens the same
structure (dict keys sorted) and a ``__treedef__`` JSON with
``num_leaves``, ``leaf_sig`` (each leaf's shape and dtype name) and
``key_paths`` (each leaf's path as ``jax.tree_util.keystr`` renders it:
``[0]['w']``, ``.field``).  :func:`load_pytree` checks all three against
the target structure and raises ``ValueError`` on a mismatch, so a file
written by either package loads into the other's structure, and a
structural mismatch fails loudly in both.

``jax_version`` is written as ``mini_tpu_torch-<version>``, a value no JAX
release has: ``mini_tpu`` then does not compare its ``str(treedef)``
(which the port does not render; it writes the fixed ``TREEDEF``) and
relies on the count, the signature and the key paths, as the port does.
A list stored where ``like`` has a tuple loads as ``like``'s kind.

bfloat16 leaves (NumPy has no bfloat16) are stored as their raw 2-byte
words, dtype ``V2``, with the signature ``bfloat16``: the bytes
``mini_tpu`` writes for a bfloat16 leaf.  :func:`load_pytree` reads them
back bitwise, from either package's file.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mini_tpu_torch import __version__

WRITER = f"mini_tpu_torch-{__version__}"
TREEDEF = "PyTreeDef(*)"  # a placeholder: no JAX compares it (WRITER)


def _children(node):
    """``(keys, children)`` of an inner node, None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [f"[{k!r}]" for k in keys], [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # namedtuple
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [f"[{i}]" for i in range(len(node))], list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return [f".{f}" for f in names], [getattr(node, f) for f in names]
    return None


def _flatten(tree):
    """(leaves, key paths) in ``jax.tree_util``'s order."""
    leaves, paths = [], []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            paths.append(path)
            return
        for k, c in zip(*kids):
            walk(c, path + k)

    walk(tree, "")
    return leaves, paths


def _unflatten(like, leaves):
    """``like``'s structure with ``leaves`` in :func:`_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        vals = [build(c) for c in kids[1]]
        if isinstance(node, dict):  # like's key order; flattened sorted
            by_key = dict(zip(sorted(node), vals))
            return {k: by_key[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*vals)
        if isinstance(node, (list, tuple)):
            return type(node)(vals)
        return dataclasses.replace(node, **{
            f.name: v for f, v in zip(dataclasses.fields(node), vals)})

    return build(like)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # its raw words, as mini_tpu writes them
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_pytree(path: str, tree) -> None:
    leaves, key_paths = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    meta = json.dumps(
        {
            "treedef": TREEDEF,
            "num_leaves": len(leaves),
            "jax_version": WRITER,
            "leaf_sig": [[list(a.shape), _dtype_name(l)]
                         for a, l in zip(arrays.values(), leaves)],
            "key_paths": key_paths,
        }
    )
    np.savez(
        path,
        __treedef__=np.frombuffer(meta.encode(), dtype=np.uint8),
        **arrays,
    )


def _leaf_like(a: np.ndarray, like) -> torch.Tensor:
    """The stored array as a tensor on ``like``'s device, in its dtype."""
    if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(like.device)
    t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (a tree with matching
    topology, e.g. the freshly-initialized state); each leaf comes back
    on ``like``'s leaf's device, in its dtype.

    Raises ``ValueError`` when the stored structure does not match
    ``like``: leaf count, per-leaf shape and dtype, and key paths.
    """
    with np.load(path) as data:
        leaves_like, got_paths = _flatten(like)
        n = len(leaves_like)

        stored_n, stored_sig, stored_paths = None, None, None
        if "__treedef__" in data:
            meta_raw = data["__treedef__"].tobytes().decode()
            meta = json.loads(meta_raw)
            if isinstance(meta, dict):
                stored_n = meta.get("num_leaves")
                stored_sig = meta.get("leaf_sig")
                stored_paths = meta.get("key_paths")
            else:  # mini_tpu's first format: json.dumps(str(treedef))
                stored_n = sum(1 for k in data.files if k.startswith("leaf_"))
        if stored_n is not None and stored_n != n:
            raise ValueError(
                f"checkpoint {path!r} holds {stored_n} leaves but the target "
                f"structure has {n}"
            )
        if stored_sig is not None:
            got_sig = [[list(np.shape(l)), _dtype_name(l)]
                       for l in leaves_like]
            if stored_sig != got_sig:
                raise ValueError(
                    f"checkpoint {path!r} leaf signature mismatch:\n"
                    f"  stored: {stored_sig}\n  target: {got_sig}"
                )
        if stored_paths is not None and stored_paths != got_paths:
            raise ValueError(
                f"checkpoint {path!r} key-path mismatch:\n"
                f"  stored: {stored_paths}\n  target: {got_paths}"
            )
        leaves = [_leaf_like(data[f"leaf_{i}"], l)
                  for i, l in enumerate(leaves_like)]
    return _unflatten(like, leaves)
