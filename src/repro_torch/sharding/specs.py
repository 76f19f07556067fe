"""Lane-sharding rules (port of the lane half of ``repro.sharding.specs``).

The batched cascade engine's per-lane arrays are lane-major: feature
batches, deferral probs, called masks, expert labels.  Lanes shard over
the batch-like mesh axes ('pod', 'data' — whichever the mesh has); the
shared cascade state (students, deferral gates, optimizer state, the
demonstration rings) is one policy serving every lane, not one per
shard.

The reference hands both to GSPMD on one controller.  The port runs the
same single-controller model by hand: lane shard s of a padded batch of
B rows holds the contiguous rows ``[s·B/N, (s+1)·B/N)`` and runs on its
own device with its own replica of the state, in lane order; outputs
come back to the host and are concatenated in the same order.  A
"replicated" value is held once per lane shard (``put_replicated``),
not once per distinct device, so a mesh whose shards share one device
(the CPU tests; one card) still keeps N copies.

The parameter rules, ``constrain`` / ``constrain_tokens`` and sequence
parallelism belong to the zoo's model sharding, which is not ported
here.  ``host_prefetch``'s counterpart is ``repro_torch.transfer``
``HostPrefetch``; ``LaneGather`` runs one per shard.  The reference's
``jit_cache_scatter`` only donates the demonstration rings to its
scatter; the port donates nothing and keeps the rings on the mesh's
first device, so the engine calls ``core.batched.ring_scatter`` itself.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.transfer import HostPrefetch
from repro_torch.tree import tree_leaves, tree_map

_CURRENT_MESH = None


def set_mesh(mesh) -> None:
    """Install ``mesh`` as the process-wide default device mesh."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    """The process-wide default device mesh, if one is installed."""
    return _CURRENT_MESH


def batch_axes(mesh=None) -> Optional[Tuple[str, ...]]:
    """The mesh axes a batch dim shards over (the 'pod', 'data' subset),
    or None without a mesh or without such an axis."""
    mesh = mesh or _CURRENT_MESH
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _fits(mesh, dim: int, axes) -> bool:
    size = _axis_size(mesh, axes)
    return size > 0 and dim % size == 0


# ---------------------------------------------------------------------------
# lane sharding (batched cascade engine)
# ---------------------------------------------------------------------------
def lane_count(mesh) -> int:
    """Number of lane shards: the product of the lane axes' sizes."""
    return _axis_size(mesh, batch_axes(mesh))


def lane_spec(mesh) -> Tuple[str, ...]:
    """The axes dim 0 of a lane-major array shards over, as a tuple of
    names (the reference's ``PartitionSpec`` entry; () = replicated)."""
    return batch_axes(mesh) or ()


def lane_devices(mesh) -> List[torch.device]:
    """The device of each lane shard, in lane order: shard s sits at the
    index that s unravels to over the lane axes (in ``lane_spec``
    order), and at index 0 of every other axis."""
    axes = lane_spec(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for s in range(lane_count(mesh)):
        at = dict(zip(axes, np.unravel_index(s, sizes))) if axes else {}
        out.append(mesh.devices[tuple(int(at.get(a, 0))
                                      for a in mesh.axis_names)])
    return out


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for a block (the port's
    kernels launch on the current device's stream); a no-op elsewhere."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def put_lanes(x, mesh, upload: Optional[Callable] = None
              ) -> List[torch.Tensor]:
    """Split a lane-major host array over dim 0 into ``lane_count``
    contiguous shards, shard s on lane device s; where dim 0 does not
    divide (e.g. a partial final tick) every shard holds the whole array
    instead — one replicated placement, ``constrain``'s divisibility
    rule.  ``upload(part, device)`` moves a part (default: a plain copy;
    the engine passes its pinned staging)."""
    x = np.asarray(x)
    devs = lane_devices(mesh)
    if x.ndim and _fits(mesh, x.shape[0], batch_axes(mesh)):
        parts = np.split(x, len(devs))
    else:
        parts = [x] * len(devs)
    up = upload or _upload
    return [up(p, d) for p, d in zip(parts, devs)]


def put_replicated(tree, mesh) -> list:
    """One copy of ``tree`` (a tensor, an array or a nested dict / list /
    tuple of them) per lane shard, on that shard's device, in lane
    order."""
    def put(d):
        return tree_map(lambda t: torch.as_tensor(t).to(d, copy=True), tree)
    return [put(d) for d in lane_devices(mesh)]


def refresh_replicas(replicas: Sequence, tree) -> None:
    """Copy ``tree``'s leaves into each replica's, in place (the replicas
    keep their devices and storage)."""
    src = tree_leaves(tree)
    for rep in replicas:
        dst = tree_leaves(rep)
        if len(dst) != len(src):
            raise ValueError(f"replica has {len(dst)} leaves, the state "
                             f"{len(src)}")
        if dst and dst[0].device == src[0].device:
            torch._foreach_copy_(dst, src)
        else:
            for a, b in zip(dst, src):
                a.copy_(b)


class LaneGather:
    """Device -> host copies of each shard's outputs, started at once
    (one ``HostPrefetch`` a shard); ``result()`` waits for them and
    concatenates each output over the shards, in lane order."""

    __slots__ = ("parts",)

    def __init__(self, shard_outputs: Sequence[Sequence[torch.Tensor]]):
        self.parts = [HostPrefetch(out) for out in shard_outputs]

    def result(self) -> List[np.ndarray]:
        outs = [p.result() for p in self.parts]
        return [np.concatenate(col) for col in zip(*outs)]


# ---------------------------------------------------------------------------
# the engine's staged functions
# ---------------------------------------------------------------------------
def jit_route_pass(fn, mesh=None):
    """The per-level route pass ``fn(params, dparams, xb)``.

    Without a mesh, ``fn`` itself.  With one, a function of per-shard
    lists ``(params, dparams, xb)`` that runs ``fn`` once per lane shard,
    on the shard's device, in lane order, and returns the shards'
    outputs (nothing is gathered: the caller starts the copies to the
    host).  Nothing is donated: each shard's input is a fresh upload
    that dies with the call."""
    if mesh is None:
        return fn
    devs = lane_devices(mesh)

    def sharded(params, dparams, xb):
        outs = []
        for d, p, dp, x in zip(devs, params, dparams, xb):
            with on_device(d):
                outs.append(fn(p, dp, x))
        return outs

    return sharded

