"""Explicit collectives over the installed mesh's ranks, and the
reference's ``constrain`` / ``constrain_tokens`` on them.

The port runs the reference's single-controller model by hand (see
``sharding.specs``): rank r is the mesh's r-th device in row-major
order, and one process computes every rank's part of a step, rank by
rank.  A value spread over the ranks is a ``Sharded``: one tensor a
rank, the mesh axes each dim is split over (its ``spec``), and
optionally an axis whose ranks hold addends of the value (``partial``:
a row-parallel product before its all-reduce).

``constrain(x, spec)`` moves a value to ``spec`` with the collectives
GSPMD inserts at the reference's constraint: a pending sum becomes an
all-reduce, or a reduce-scatter where ``spec`` splits a dim over the
summed axis (the sequence-parallel pattern); a dim split now and not in
``spec`` is all-gathered; a dim ``spec`` splits is sliced where it
lies.  Axes the mesh lacks, and dims their size does not divide, stay
whole: the reference's rule for activations.  Each collective is plain
torch ops in a fixed rank order, so autograd differentiates it and its
result depends on nothing but its inputs.  With no mesh installed,
``constrain`` and ``constrain_tokens`` return their input, the
reference's no-op.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import specs
from repro_torch.sharding.specs import (_axes, _axis_size, _fits, batch_axes,
                                        get_mesh, on_device, rank_devices,
                                        rank_index)


class Sharded:
    """``parts``: one tensor a rank, in rank order; ``spec``: per dim, a
    tuple of the mesh axes it is split over (() whole); ``partial``: an
    axis whose ranks' parts add up to the value, or None."""

    __slots__ = ("parts", "spec", "partial")

    def __init__(self, parts: Sequence[torch.Tensor], spec: Sequence,
                 partial: Optional[str] = None):
        self.parts = list(parts)
        self.spec = tuple(_axes(e) for e in spec)
        self.partial = partial

    @property
    def ndim(self) -> int:
        return len(self.spec)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole value's shape."""
        mesh = get_mesh()
        return tuple(n * _axis_size(mesh, axes) for n, axes in
                     zip(self.parts[0].shape, self.spec))

    def __add__(self, other: "Sharded") -> "Sharded":
        if self.spec != other.spec or self.partial or other.partial:
            raise ValueError("add needs two whole values in one layout")
        return Sharded([a + b for a, b in zip(self.parts, other.parts)],
                       self.spec)


def _mesh():
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("no mesh is installed (sharding.set_mesh)")
    return mesh


def rank_map(fn: Callable, *rank_args: Sequence) -> list:
    """``[fn(r, a[r], b[r], ...)]`` over the ranks, each on its device."""
    out = []
    for r, dev in enumerate(rank_devices(_mesh())):
        with on_device(dev):
            out.append(fn(r, *(a[r] for a in rank_args)))
    return out


def axis_size(axis: str) -> int:
    """The installed mesh's size along ``axis`` (1 where it lacks it)."""
    mesh = _mesh()
    return mesh.shape.get(axis, 1)


def axis_rank(r: int, axes) -> int:
    """Rank r's index over ``axes`` (those the mesh has)."""
    mesh = _mesh()
    return rank_index(mesh, r, _present(mesh, axes))


def _present(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in _axes(axes) if a in mesh.axis_names)


@functools.lru_cache(maxsize=64)
def _groups_of(mesh, axes: Tuple[str, ...]) -> Tuple[Tuple[int, ...], ...]:
    """The ranks that differ only along ``axes``, each group in its
    index order over them."""
    groups = {}
    for r in range(mesh.size):
        key = tuple(rank_index(mesh, r, (a,)) for a in mesh.axis_names
                    if a not in axes)
        groups.setdefault(key, []).append(r)
    for g in groups.values():
        g.sort(key=lambda r: rank_index(mesh, r, axes))
    return tuple(tuple(g) for g in groups.values())


def _groups(axes):
    mesh = _mesh()
    return _groups_of(mesh, _present(mesh, axes)), rank_devices(mesh)


def all_reduce(parts: Sequence[torch.Tensor], axes,
               op: str = "sum") -> List[torch.Tensor]:
    """Each rank gets the sum (``op="max"``: the maximum) of its
    group's parts over ``axes``, added in rank-index order."""
    groups, devs = _groups(axes)
    out = [None] * len(parts)
    for g in groups:
        dev = devs[g[0]]
        acc = parts[g[0]]
        for r in g[1:]:
            p = parts[r].to(dev)
            acc = acc + p if op == "sum" else torch.maximum(acc, p)
        for r in g:
            out[r] = acc.to(devs[r])
    return out


def all_gather(parts: Sequence[torch.Tensor], axes,
               dim: int) -> List[torch.Tensor]:
    """Each rank gets its group's parts over ``axes`` concatenated along
    ``dim``, in rank-index order."""
    groups, devs = _groups(axes)
    out = [None] * len(parts)
    for g in groups:
        if len(g) == 1:
            out[g[0]] = parts[g[0]]
            continue
        by_dev = {}
        for r in g:
            if devs[r] not in by_dev:
                by_dev[devs[r]] = torch.cat(
                    [parts[q].to(devs[r]) for q in g], dim=dim)
            out[r] = by_dev[devs[r]]
    return out


def reduce_scatter(parts: Sequence[torch.Tensor], axes,
                   dim: int) -> List[torch.Tensor]:
    """Each rank gets its own slice along ``dim`` (by its index over
    ``axes``) of its group's sum."""
    groups, devs = _groups(axes)
    out = [None] * len(parts)
    for g in groups:
        dev = devs[g[0]]
        acc = parts[g[0]]
        for r in g[1:]:
            acc = acc + parts[r].to(dev)
        chunks = acc.chunk(len(g), dim=dim)
        for i, r in enumerate(g):
            out[r] = chunks[i].contiguous().to(devs[r])
    return out


def _local_slice(parts, axes, dim):
    mesh = _mesh()
    n = _axis_size(mesh, axes)
    out = []
    for r, t in enumerate(parts):
        size = t.shape[dim] // n
        out.append(t.narrow(dim, rank_index(mesh, r, axes) * size,
                            size).contiguous())
    return out


def replicate(x: torch.Tensor) -> Sharded:
    """``x`` whole on every rank (no copy on a rank of ``x``'s device)."""
    return Sharded([x.to(d) for d in rank_devices(_mesh())],
                   (None,) * x.ndim)


def _clean(mesh, shape, spec) -> Tuple[Tuple[str, ...], ...]:
    """The reference's ``constrain`` rule: each entry keeps the axes the
    mesh has, and a dim those do not divide stays whole."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        present = _present(mesh, axes)
        out.append(present if present and _fits(mesh, dim, present)
                   else ())
    return tuple(out)


def constrain(x, spec: Sequence):
    """``x`` (a ``Sharded``, or a tensor taken as the whole value on
    every rank) in the layout ``spec``, through the collectives that
    layout needs; ``x`` itself without a mesh."""
    mesh = get_mesh()
    if mesh is None:
        return x
    if not isinstance(x, Sharded):
        x = replicate(x)
    target = _clean(mesh, x.shape, spec)
    parts, cur = x.parts, list(x.spec)
    if x.partial is not None:
        p = _present(mesh, x.partial)
        d = next((i for i, t in enumerate(target) if p and t == p
                  and not cur[i]), None)
        if d is not None:
            parts = reduce_scatter(parts, p, d)
            cur[d] = p
        else:
            parts = all_reduce(parts, p)
    for d, (c, t) in enumerate(zip(cur, target)):
        if c == t:
            continue
        if c:
            parts = all_gather(parts, c, d)
        if t:
            parts = _local_slice(parts, t, d)
    return Sharded(parts, target)


def token_spec(shape: Sequence[int]) -> Tuple:
    """``constrain_tokens``'s layout of (B, S, ...) activations:
    the batch over (pod, data) where it divides, else the sequence over
    them (batch 1, long context); with ``SEQ_PARALLEL`` the sequence
    also over 'model' where it divides (batch split case only, as in
    the reference)."""
    mesh = _mesh()
    baxes = batch_axes(mesh)
    nd = len(shape)
    seq_ax = ("model",) if (specs.SEQ_PARALLEL and nd >= 2
                            and "model" in mesh.axis_names
                            and _fits(mesh, shape[1], ("model",))) else None
    if baxes and _fits(mesh, shape[0], baxes):
        return (baxes, seq_ax) + (None,) * (nd - 2)
    if nd >= 2 and baxes and _fits(mesh, shape[1], baxes):
        return (None, baxes) + (None,) * (nd - 2)
    return (None,) * nd


def constrain_tokens(x):
    """Shard (B, S, ...) activations in ``token_spec``'s layout; ``x``
    itself without a mesh."""
    if get_mesh() is None:
        return x
    shape = x.shape if isinstance(x, Sharded) else tuple(x.shape)
    return constrain(x, token_spec(shape))


def unshard(x) -> torch.Tensor:
    """The whole value of ``x`` on rank 0's device (a tensor is
    returned as it is)."""
    if not isinstance(x, Sharded):
        return x
    return constrain(x, (None,) * x.ndim).parts[0]
