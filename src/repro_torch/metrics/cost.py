"""Counting a step's work and memory, on ``meta`` and on the card alike.

``CostCounter`` is a ``TorchDispatchMode``: every aten op that runs under
it is seen once, after ``einsum`` / ``matmul`` / ``F.linear`` have
decomposed into ``bmm`` / ``mm`` / ``addmm``, so each product counts
once.  It keeps what the reference's dry-run reads from XLA's cost and
memory analyses:

* FLOPs by dtype: every op ``torch.utils.flop_counter`` has a formula
  for, under the dtype of its first tensor operand, plus the kernels'
  own products (``kernel``);
* bytes accessed as XLA counts them: every op's tensor operands plus its
  results (views and bare allocations move nothing), plus the kernels'
  reported bytes;
* each kernel op's launches by variant, with its FLOPs and bytes
  (``metrics.roofline``'s formulas), which the ops report through
  ``report_kernel``;
* live and peak bytes of the storages created under it (also by phase,
  ``phase``), each released
  by a weakref finalizer when its last holder (a tensor, a view or the
  autograd graph) lets it go: the counterpart of ``memory_analysis``'s
  temp and output sizes (arguments are the caller's to count,
  ``tree_bytes``).

The same Python runs a step on ``meta`` (no data, no device) and on the
card, so the two counts of one step agree: FLOPs and launches exactly,
bytes but for the ops a launcher runs only on the card.

Over a mesh (``CostCounter(n_ranks=n)``) one process runs every rank of
a step, so the counter also keeps what one device would see:

* the collectives of ``sharding.collectives``, forward and backward, by
  kind, as the reference's ``parse_collective_bytes`` counts them:
  the result bytes on each rank (``collective``).  Their own adds and
  copies are neither FLOPs nor bytes accessed (``quiet``);
* each rank's share: an op belongs to the rank ``rank(r)`` names
  (``collectives.rank_map`` sets it), else to the one rank whose
  storages it reads (the storages a rank's arguments, ops and
  collective results hold), else to the ranks that share what it reads
  (``by_rank``; "shared" where that is more than one);
* the device's peak: each storage is live on the ranks it belongs to,
  and ``peak_bytes`` is the largest any one rank holds at any moment.
  One process holds every rank's activations at once, so the global
  peak over n would understate a device's: its transients are one
  rank's.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import (Dict, FrozenSet, Iterable, Iterator, Optional, Set,
                    Tuple)

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.metrics.roofline import KernelCost, dtype_name
from repro_torch.tree import tree_leaves

_aten = torch.ops.aten
# ops that allocate without reading or writing a byte, or re-view a
# buffer without moving it (matmul's reshape of its mm output)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (shared by its views)."""
    return t.untyped_storage()._cdata


def tree_bytes(tree, exclude: Optional[Set[int]] = None) -> int:
    """Bytes of the distinct storages a tree's tensors hold, each once
    (views of one buffer count it once), less those in ``exclude``."""
    seen = set(exclude or ())
    total = 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        key = storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def tree_storages(tree) -> Set[int]:
    """The storage keys of a tree's tensors."""
    return {storage_key(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_SHARED = "shared"


class CostCounter(TorchDispatchMode):
    """FLOPs by dtype, bytes accessed, kernel launches by variant,
    collective bytes by kind, and the live / peak bytes of the storages
    created while it is active; over ``n_ranks`` ranks also each rank's
    share and the largest one rank holds."""

    def __init__(self, n_ranks: int = 1):
        super().__init__()
        self.n_ranks = n_ranks
        self._all = frozenset(range(n_ranks))
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes_accessed = 0
        self.kernel_flops: Dict[str, float] = defaultdict(float)
        self.kernel_bytes = 0
        self.launches: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, int] = defaultdict(int)
        self.collective_ops = 0
        self.by_rank: Dict[object, dict] = {}
        self.peak_bytes = 0
        self.phase_peaks: Dict[str, int] = {}
        self._phase: Optional[str] = None
        self._rank: Optional[int] = None
        self._quiet = 0
        self._rank_live = [0] * n_ranks
        self._owner: Dict[int, FrozenSet[int]] = {}
        self._live: Dict[int, Tuple[int, FrozenSet[int]]] = {}

    # -- ranks ---------------------------------------------------------------
    def _ranks_of(self, ins) -> FrozenSet[int]:
        """The ranks an op on ``ins`` belongs to (see the module doc)."""
        if self.n_ranks == 1:
            return self._all
        if self._rank is not None:
            return frozenset((self._rank,))
        single, shared = set(), set()
        for t in ins:
            o = self._owner.get(storage_key(t))
            if o is not None:
                (single if len(o) == 1 else shared).update(o)
        return frozenset(single or shared) or self._all

    def _share(self, ranks: FrozenSet[int]) -> dict:
        key = next(iter(ranks)) if len(ranks) == 1 else _SHARED
        if key not in self.by_rank:
            self.by_rank[key] = {"flops": defaultdict(float), "bytes": 0,
                                 "launches": defaultdict(int),
                                 "collectives": defaultdict(int)}
        return self.by_rank[key]

    def own(self, tree, r: int) -> None:
        """Rank r holds the storages of ``tree`` (its arguments)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                key = storage_key(t)
                self._owner[key] = self._owner.get(key, frozenset()) | {r}

    # -- aten ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        ranks = self._ranks_of(ins)
        share = self._share(ranks) if self.n_ranks > 1 else None
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None and ins:
            f = formula(*args, **kwargs, out_val=out)
            self.flops[dtype_name(ins[0].dtype)] += f
            if share is not None:
                share["flops"][dtype_name(ins[0].dtype)] += f
        if not func.is_view and func not in _NO_TRAFFIC:
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes_accessed += n
            if share is not None:
                share["bytes"] += n
        if not func.is_view:
            self._track(outs, {storage_key(t) for t in ins}, ranks)
        return out

    def _track(self, outs, in_keys, ranks: FrozenSet[int]):
        for t in outs:
            st = t.untyped_storage()
            key, n = st._cdata, st.nbytes()
            if n == 0 or key in in_keys or key in self._live:
                continue
            self._live[key] = (n, ranks)
            self._owner[key] = ranks
            self._hold(ranks, n)
            weakref.finalize(st, self._free, key)

    def _hold(self, ranks, n: int) -> None:
        """``n`` more bytes live on each of ``ranks``: the peaks."""
        top = 0
        for r in ranks:
            self._rank_live[r] += n
            top = max(top, self._rank_live[r])
        self.peak_bytes = max(self.peak_bytes, top)
        if self._phase is not None:
            self.phase_peaks[self._phase] = max(
                self.phase_peaks[self._phase], top)

    def _free(self, key):
        n, ranks = self._live.pop(key, (0, ()))
        self._owner.pop(key, None)
        for r in ranks:
            self._rank_live[r] -= n

    @contextlib.contextmanager
    def in_phase(self, name: str) -> Iterator[None]:
        """Keep the peak of the live bytes within ``name`` apart (from
        what is live when it starts): a step's peak is the largest of its
        phases', each of which the dry-run extends on its own."""
        prev, self._phase = self._phase, name
        self.phase_peaks[name] = max(self.phase_peaks.get(name, 0),
                                     max(self._rank_live))
        try:
            yield
        finally:
            self._phase = prev

    # -- kernel ops and collectives -----------------------------------------
    def kernel(self, name: str, variant: str, cost: KernelCost) -> None:
        """One launch of kernel ``name`` in ``variant`` doing ``cost``."""
        by = self.launches.setdefault(name, {})
        by[variant] = by.get(variant, 0) + 1
        self.flops[cost.dtype] += cost.flops
        self.kernel_flops[cost.dtype] += cost.flops
        self.bytes_accessed += cost.nbytes
        self.kernel_bytes += cost.nbytes
        if self.n_ranks > 1:
            share = self._share(frozenset((self._rank,)) if self._rank
                                is not None else self._all)
            share["flops"][cost.dtype] += cost.flops
            share["bytes"] += cost.nbytes
            share["launches"][f"{name}:{variant}"] += 1

    def collective(self, kind: str, t: torch.Tensor, r: int) -> None:
        """Rank r receives ``t``, the result of one collective of
        ``kind``: its bytes are counted, and its storage is live on r
        (on each rank it was handed to, where ranks share one)."""
        n = _nbytes(t)
        self.collectives[kind] += n
        self.collective_ops += 1
        if self.n_ranks == 1:
            r = 0
        else:
            self._share(frozenset((r,)))["collectives"][kind] += n
        key = storage_key(t)
        held = self._live.get(key)
        if held is None:
            self._track([t], (), frozenset((r,)))
        elif r not in held[1]:
            # one storage handed to several ranks (on one device): live
            # on each of them
            size, ranks = held
            self._live[key] = (size, ranks | {r})
            self._owner[key] = ranks | {r}
            self._hold((r,), size)

    def summary(self) -> dict:
        """The counts as plain numbers (a JSON-ready dict)."""
        return {"flops": dict(self.flops),
                "bytes_accessed": self.bytes_accessed,
                "launches": {k: dict(v) for k, v in self.launches.items()},
                "collectives": dict(self.collectives),
                "collective_ops": self.collective_ops,
                "n_ranks": self.n_ranks,
                "by_rank": {str(k): {"flops": dict(v["flops"]),
                                     "bytes": v["bytes"],
                                     "launches": dict(v["launches"]),
                                     "collectives": dict(v["collectives"])}
                            for k, v in self.by_rank.items()},
                "peak_bytes": self.peak_bytes,
                "phase_peaks": dict(self.phase_peaks)}


def _active() -> Iterator[CostCounter]:
    return (m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostCounter))


def report_kernel(name: str, variant: str, cost: KernelCost) -> None:
    """Tell every active ``CostCounter`` of one kernel launch (a no-op
    when none is active).  The kernel ops call it where they launch, on
    the card, and where their ``meta`` shape function stands in."""
    for mode in _active():
        mode.kernel(name, variant, cost)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """``CostCounter.in_phase`` on every active counter (a no-op when
    none is active)."""
    with contextlib.ExitStack() as stack:
        for mode in list(_active()):
            stack.enter_context(mode.in_phase(name))
        yield


@contextlib.contextmanager
def rank(r: int) -> Iterator[None]:
    """Count what runs in the block as rank r's on every active counter
    (``collectives.rank_map`` runs each rank's work in one)."""
    modes = list(_active())
    prev = [m._rank for m in modes]
    for m in modes:
        m._rank = r
    try:
        yield
    finally:
        for m, p in zip(modes, prev):
            m._rank = p


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """Count nothing that runs in the block (a collective's own adds and
    copies: ``report_collective`` counts its result)."""
    modes = list(_active())
    for m in modes:
        m._quiet += 1
    try:
        yield
    finally:
        for m in modes:
            m._quiet -= 1


def report_collective(kind: str, t: torch.Tensor, r: int) -> None:
    """Tell every active ``CostCounter`` that rank r received ``t`` from
    a collective of ``kind`` (a no-op when none is active)."""
    for mode in _active():
        mode.collective(kind, t, r)
