"""Pytree checkpoints: ``arrays.npz`` plus a JSON ``manifest.json``
(port of ``repro.checkpoint.ckpt``).

The format is the reference's, byte for byte in what it means, so a
checkpoint written by either package restores through the other's
reader:

* leaves are flattened to ``::``-joined key paths (dict keys as they
  are, list and tuple positions as ``#i``) and stored as numpy arrays in
  one ``arrays.npz``; ``None`` subtrees and empty containers store
  nothing, and the manifest's ``root_kind`` brings an empty root back as
  ``{}`` / ``[]`` / ``None``;
* the manifest holds each key's dtype and shape, the caller's
  ``metadata`` (JSON) and ``root_kind``;
* bfloat16 has no numpy dtype: it is stored as a ``uint16`` view and
  named ``"bfloat16"`` in the manifest.

Leaves may be torch tensors on any device or numpy arrays; both are
written as numpy.  The reader returns numpy leaves; a ``"bfloat16"``
leaf comes back as its raw ``uint16`` bits (``bf16="uint16"``, the
default) or as a ``torch.bfloat16`` tensor (``bf16="torch"``).  Lists
come back as lists (a tuple is stored like a list).  Both files are
written through a temp file and ``os.replace``, so a reader never sees a
half-written file under either name; damage — a missing or corrupt
manifest, a missing or truncated array store, an array the manifest
names but the store lacks — raises ``CheckpointError``.

The engines build on this for live-state checkpoints:
``OnlineCascade.save_state`` and ``BatchedCascadeEngine.save_state``
store their learned and queue state here and keep the non-array live
state (generator states, commit cursors, stats) in ``metadata``.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "::"
BF16_MODES = ("uint16", "torch")


class CheckpointError(RuntimeError):
    """A checkpoint is missing, corrupted, or written for another config."""


def _flatten(tree, prefix: Tuple[str, ...] = (),
             out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Leaves of ``tree`` by key path, dict keys in sorted order (as
    ``jax.tree_util`` visits them)."""
    out = {} if out is None else out
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, prefix + (f"#{i}",), out)
    else:
        out[_SEP.join(prefix)] = tree
    return out


def _part_order(part: str):
    # list indices must sort numerically: "#10" comes after "#9", not
    # between "#1" and "#2" as a lexicographic sort would place it
    if part.startswith("#"):
        return (1, int(part[1:]), "")
    return (0, 0, part)


def _unflatten(flat: Dict[str, Any]):
    root: Any = None

    def insert(node, parts, value):
        head = parts[0]
        is_idx = head.startswith("#")
        key = int(head[1:]) if is_idx else head
        if is_idx:
            while len(node) <= key:
                node.append(None)
        if len(parts) == 1:
            node[key] = value
            return
        if is_idx:
            if node[key] is None:
                node[key] = [] if parts[1].startswith("#") else {}
        elif key not in node:
            node[key] = [] if parts[1].startswith("#") else {}
        insert(node[key], parts[1:], value)

    for k in sorted(flat, key=lambda s: tuple(_part_order(p)
                                              for p in s.split(_SEP))):
        parts = k.split(_SEP)
        if root is None:
            root = [] if parts[0].startswith("#") else {}
        insert(root, parts, flat[k])
    return root


def _root_kind(tree) -> str:
    if tree is None:
        return "none"
    if isinstance(tree, (list, tuple)):
        return "list"
    if isinstance(tree, dict):
        return "dict"
    return "leaf"


def _host_leaf(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the numpy array to store, and the manifest dtype when it
    differs from the array's own ("bfloat16" for a uint16 view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":    # an ml_dtypes array (from JAX)
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def _replace_atomically(path: str, name: str, suffix: str, write) -> None:
    """Write ``path/name`` through a temp file in ``path`` and
    ``os.replace``; ``write(tmp_path)`` fills the temp file."""
    fd, tmp = tempfile.mkstemp(dir=path, suffix=suffix)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, os.path.join(path, name))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(path: str, tree, metadata: Optional[dict] = None) -> str:
    """Atomically write ``tree`` (+ metadata) under ``path`` (a
    directory); returns ``path``."""
    os.makedirs(path, exist_ok=True)
    store, keys = {}, {}
    for k, leaf in _flatten(tree).items():
        arr, dtype = _host_leaf(leaf)
        store[k] = arr
        keys[k] = {"dtype": dtype or str(arr.dtype),
                   "shape": list(arr.shape)}
    manifest = {
        "keys": keys,
        "metadata": metadata or {},
        # empty trees flatten to nothing; the container kind brings an
        # empty dict back as {} rather than None
        "root_kind": _root_kind(tree),
    }

    # np.savez appends '.npz' unless the name already ends with it
    def write_arrays(tmp):
        np.savez(tmp, **store)

    def write_manifest(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)

    _replace_atomically(path, "arrays.npz", ".tmp.npz", write_arrays)
    _replace_atomically(path, "manifest.json", ".tmp.json", write_manifest)
    return path


def _bf16_leaf(arr: np.ndarray, bf16: str):
    if bf16 == "torch":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return arr


def restore_checkpoint(path: str, bf16: str = "uint16") -> Tuple[Any, dict]:
    """Returns (tree, metadata) with numpy leaves; raises
    ``CheckpointError`` on damage.  ``bf16`` picks how a "bfloat16" leaf
    comes back: its raw ``uint16`` bits or a ``torch.bfloat16`` tensor."""
    if bf16 not in BF16_MODES:
        raise ValueError(f"bf16 must be one of {BF16_MODES}, got {bf16!r}")
    manifest_path = os.path.join(path, "manifest.json")
    arrays_path = os.path.join(path, "arrays.npz")
    if not os.path.isfile(manifest_path):
        raise CheckpointError(f"no checkpoint manifest at {manifest_path}")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"corrupted manifest {manifest_path}: {e}") from e
    keys = manifest.get("keys") or {}
    flat = {}
    if keys:
        if not os.path.isfile(arrays_path):
            raise CheckpointError(f"manifest names arrays but {arrays_path} "
                                  "is missing (partial write?)")
        try:
            with np.load(arrays_path) as data:
                for k, info in keys.items():
                    if k not in data.files:
                        raise CheckpointError(
                            f"array {k!r} named in manifest is missing "
                            f"from {arrays_path} (truncated?)")
                    arr = data[k]
                    flat[k] = (_bf16_leaf(arr, bf16)
                               if info["dtype"] == "bfloat16" else arr)
        except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
            raise CheckpointError(
                f"corrupted array store {arrays_path}: {e}") from e
    tree = _unflatten(flat)
    if tree is None:
        kind = manifest.get("root_kind", "none")
        tree = {"dict": {}, "list": [], "none": None, "leaf": None}[kind]
    return tree, manifest["metadata"]
