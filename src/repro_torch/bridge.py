"""numpy pytrees <-> torch, and installing a reference level's state.

The reference's ``_Level.state_tree()`` (``params``, ``opt_state`` with
``count`` int32 / ``m`` / ``v``, ``dparams``, ``dopt_state``) exported as
numpy installs into a port level with ``load_level_state``, so both
packages can start from the same numbers — ``jax.random`` bits cannot be
reproduced with ``torch.Generator``.  Structure and shapes must match the
port level's own state exactly; a mismatch raises.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.cascade import STATE_ATTRS


def to_torch(tree: Any, device) -> Any:
    """numpy leaves -> torch tensors on ``device``, keeping dtype and the
    dict / list / tuple structure."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


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
    """Install a reference ``_Level.state_tree()`` exported as numpy into
    the port level ``level`` (on the level's device)."""
    for attr in STATE_ATTRS:
        new = to_torch(tree[attr], level.device)
        cur = getattr(level, attr)
        _check_like(new, cur, attr)
        setattr(level, attr, new)
