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
whole: the reference's rule for activations.  Each collective is torch
sums and concatenations in a fixed rank order, so its result depends on
nothing but its inputs (a sum of bf16 / fp16 parts is taken in fp32
and rounded once), wrapped in an autograd Function whose backward
is the dual collective (all-reduce for all-reduce, reduce-scatter for
all-gather and back).  Forward and backward, each tells an active
``metrics.cost.CostCounter`` the result bytes every rank receives (the
reference's ``parse_collective_bytes`` convention); its own sums and
copies count as neither FLOPs nor bytes accessed, and ranks that share a
device hold copies of their own, as ranks on devices of their own
would.  On a mesh that runs only some of its ranks (the dry-run's
``data_slice``, a count on ``meta``) the absent ranks' parts are stood
in for by a present rank's.
With no mesh installed, ``constrain`` and ``constrain_tokens`` return
their input, the reference's no-op.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.metrics import cost as _cost
from repro_torch.metrics.cost import storage_key
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
    """``[fn(r, a[r], b[r], ...)]`` over the ranks, each on its device
    (and counted as its own, ``metrics.cost.rank``)."""
    out = []
    for r, dev in enumerate(rank_devices(_mesh())):
        with on_device(dev), _cost.rank(r):
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


# ---------------------------------------------------------------------------
# the collectives: each an autograd Function whose backward is its dual
# (all-reduce <-> all-reduce, all-gather <-> reduce-scatter), and whose
# result bytes, forward and backward, go to the active counter
# ---------------------------------------------------------------------------
DUAL = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
        "reduce-scatter": "all-gather"}


def _members(g, n, devs):
    """The ranks of group ``g`` a step runs (all but on a data slice,
    where only a count on ``meta`` may stand in for the others)."""
    mine = [r for r in g if r < n]
    if len(mine) < len(g) and any(devs[r].type != "meta" for r in mine):
        raise RuntimeError("a data slice of a mesh runs on meta only")
    return mine


def _sum(parts, mine, dev, op="sum"):
    """The group's sum (or maximum) on ``dev``; a sum of half-precision
    parts is taken in fp32 and rounded once, as the unsharded product
    whose addends the parts are rounds its fp32 accumulator once (a
    bf16 running sum over 16 ranks rounds 15 times)."""
    acc = parts[mine[0]]
    low = (op == "sum" and len(mine) > 1 and acc.is_floating_point()
           and acc.element_size() < 4)
    if low:
        acc = acc.float()
    for r in mine[1:]:
        p = parts[r].to(dev)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    return acc.to(parts[mine[0]].dtype) if low else acc


def _run(kind, parts, groups, devs, dim, op):
    """One collective over every group: each rank's result, in rank
    order.  Sums are taken in rank-index order on the group's first
    device, so the result depends on nothing but the inputs."""
    n = len(parts)
    out = [None] * n
    for g in groups:
        mine = _members(g, n, devs)
        if not mine:
            continue
        if kind == "all-gather":
            by_dev = {}
            for r in mine:
                d = devs[r]
                if d not in by_dev:
                    by_dev[d] = torch.cat(
                        [parts[q if q < n else mine[0]].to(d) for q in g],
                        dim=dim)
                out[r] = by_dev[d]
            continue
        acc = _sum(parts, mine, devs[mine[0]], op)
        if acc is parts[mine[0]]:            # the others are absent
            acc = acc.clone()
        if kind == "all-reduce":
            for r in mine:
                out[r] = acc.to(devs[r])
        else:
            chunks = acc.chunk(len(g), dim=dim)
            for r in mine:
                out[r] = chunks[g.index(r)].contiguous().to(devs[r])
    return out


def _distinct(out):
    """One tensor a rank, each with a storage of its own: where ranks
    share a device the result is copied for each, as ranks on devices
    of their own would hold it (so a count holds each rank's bytes live
    on it, and no more)."""
    seen = set()
    for r, t in enumerate(out):
        if t is None:
            continue
        key = storage_key(t)
        if key in seen or t.numel() * t.element_size() \
                != t.untyped_storage().nbytes():
            t = t.clone()
        seen.add(storage_key(t))
        out[r] = t
    return out


def _collect(kind, parts, groups, devs, dim, op):
    with _cost.quiet():
        out = _distinct(_run(kind, parts, groups, devs, dim, op))
    for g in groups:
        if len(g) > 1:
            for r in g:
                if r < len(out):
                    _cost.report_collective(kind, out[r], r)
    return out


class _Collective(torch.autograd.Function):
    """``_collect`` differentiated: the backward runs the dual collective
    over the same groups on the results' gradients."""

    @staticmethod
    def forward(ctx, kind, groups, devs, dim, op, *parts):
        ctx.kind, ctx.groups, ctx.devs, ctx.dim = kind, groups, devs, dim
        ctx.set_materialize_grads(False)
        out = tuple(_collect(kind, parts, groups, devs, dim, op))
        ctx.like = [(t.shape, t.dtype, t.device) for t in out]
        return out

    @staticmethod
    def backward(ctx, *grads):
        # a result nothing used has no gradient: its zeros belong to the
        # collective, as its sums do
        with _cost.quiet():
            grads = [g if g is not None else torch.zeros(
                s, dtype=dt, device=d) for g, (s, dt, d) in zip(grads,
                                                                  ctx.like)]
        return (None,) * 5 + tuple(_collect(
            DUAL[ctx.kind], grads, ctx.groups, ctx.devs, ctx.dim, "sum"))


def _collective(kind, parts, axes, dim=None, op="sum"):
    mesh = _mesh()
    groups = _groups_of(mesh, _present(mesh, axes))
    if all(len(g) == 1 for g in groups):
        return list(parts)
    devs = rank_devices(mesh)
    if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
        return list(_Collective.apply(kind, groups, devs, dim, op, *parts))
    return _collect(kind, parts, groups, devs, dim, op)


def all_reduce(parts: Sequence[torch.Tensor], axes,
               op: str = "sum") -> List[torch.Tensor]:
    """Each rank gets the sum (``op="max"``: the maximum) of its
    group's parts over ``axes``, added in rank-index order."""
    return _collective("all-reduce", parts, axes, op=op)


def all_gather(parts: Sequence[torch.Tensor], axes,
               dim: int) -> List[torch.Tensor]:
    """Each rank gets its group's parts over ``axes`` concatenated along
    ``dim``, in rank-index order."""
    return _collective("all-gather", parts, axes, dim=dim)


def reduce_scatter(parts: Sequence[torch.Tensor], axes,
                   dim: int) -> List[torch.Tensor]:
    """Each rank gets its own slice along ``dim`` (by its index over
    ``axes``) of its group's sum."""
    return _collective("reduce-scatter", parts, axes, dim=dim)


def _local_slice(parts, axes, dim):
    mesh = _mesh()
    n = _axis_size(mesh, axes)

    def one(r, t):
        size = t.shape[dim] // n
        return t.narrow(dim, rank_index(mesh, r, axes) * size,
                        size).contiguous()

    return rank_map(one, parts)


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
