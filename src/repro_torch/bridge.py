"""numpy pytrees <-> torch, and installing a reference level's state.

The reference's ``_Level.state_tree()`` (``params``, ``opt_state`` with
``count`` int32 / ``m`` / ``v``, ``dparams``, ``dopt_state``) exported as
numpy installs into a port level with ``load_level_state``, and the
reference zoo's ``transformer.init_params`` tree becomes the port's with
``load_zoo_params``, so both packages can start from the same numbers —
``jax.random`` bits cannot be reproduced with ``torch.Generator``.
Structure, shapes and dtypes must match the port's own exactly; a
mismatch raises.

A bfloat16 array exported from JAX has numpy dtype
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; its bits go
through int16 and are viewed as ``torch.bfloat16`` (bit-exact, and no
``ml_dtypes`` import here).  A leaf that is already a torch tensor (a
bfloat16 leaf read with ``restore_checkpoint(path, bf16="torch")``) is
taken as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.cascade import STATE_ATTRS
from repro_torch.models.transformer import init_params
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _leaf_to_torch(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_torch(tree: Any, device) -> Any:
    """numpy leaves -> torch tensors on ``device``, keeping dtype (bfloat16
    included) and the dict / list / tuple structure."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree).to(device)


def to_numpy(tree: Any) -> Any:
    """torch leaves -> numpy arrays, keeping the structure."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def _check_like(new: Any, cur: Any, path: str) -> None:
    if isinstance(cur, dict):
        if not isinstance(new, dict) or set(new) != set(cur):
            raise ValueError(f"{path}: expected a dict with keys "
                             f"{sorted(cur)}")
        for k in cur:
            _check_like(new[k], cur[k], f"{path}.{k}")
    elif isinstance(cur, (list, tuple)):
        if not isinstance(new, (list, tuple)) or len(new) != len(cur):
            raise ValueError(f"{path}: expected a sequence of {len(cur)}")
        for i, (n, c) in enumerate(zip(new, cur)):
            _check_like(n, c, f"{path}[{i}]")
    elif tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
        raise ValueError(f"{path}: {new.dtype}{tuple(new.shape)} != "
                         f"{cur.dtype}{tuple(cur.shape)}")


def load_level_state(level, tree: dict) -> None:
    """Install a ``_Level.state_tree()`` exported as numpy (by either
    package, or read back from a checkpoint) into the port level
    ``level``, on the level's device.  Every attribute is checked before
    any is replaced, and the containers follow the level's own (a
    checkpoint stores a tuple as a list)."""
    new = {a: to_torch(tree[a], level.device) for a in STATE_ATTRS}
    for attr in STATE_ATTRS:
        _check_like(new[attr], getattr(level, attr), attr)
    for attr in STATE_ATTRS:
        setattr(level, attr, tree_unflatten(getattr(level, attr),
                                            tree_leaves(new[attr])))


def load_zoo_params(tree_np: dict, cfg, device) -> dict:
    """The reference zoo's ``init_params(key, cfg)`` tree exported as numpy
    -> the port's parameter tree on ``device``.  Every path, shape and
    dtype is checked against the port's own ``init_params(None, cfg)``
    (shapes only, on the meta device)."""
    new = to_torch(tree_np, "cpu")
    _check_like(new, init_params(None, cfg), "params")
    return tree_map(lambda t: t.to(device), new)
