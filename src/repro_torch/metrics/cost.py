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
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Iterable, Iterator, Optional, Set

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


class CostCounter(TorchDispatchMode):
    """FLOPs by dtype, bytes accessed, kernel launches by variant, and the
    live / peak bytes of the storages created while it is active."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes_accessed = 0
        self.kernel_flops: Dict[str, float] = defaultdict(float)
        self.kernel_bytes = 0
        self.launches: Dict[str, Dict[str, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.phase_peaks: Dict[str, int] = {}
        self._phase: Optional[str] = None
        self._live: Dict[int, int] = {}

    # -- aten ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None and ins:
            self.flops[dtype_name(ins[0].dtype)] += formula(
                *args, **kwargs, out_val=out)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, outs))
        if not func.is_view:
            self._track(outs, {storage_key(t) for t in ins})
        return out

    def _track(self, outs, in_keys):
        for t in outs:
            st = t.untyped_storage()
            key, n = st._cdata, st.nbytes()
            if n == 0 or key in in_keys or key in self._live:
                continue
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self._phase is not None:
                self.phase_peaks[self._phase] = max(
                    self.phase_peaks[self._phase], self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    @contextlib.contextmanager
    def in_phase(self, name: str) -> Iterator[None]:
        """Keep the peak of the live bytes within ``name`` apart (from
        what is live when it starts): a step's peak is the largest of its
        phases', each of which the dry-run extends on its own."""
        prev, self._phase = self._phase, name
        self.phase_peaks[name] = max(self.phase_peaks.get(name, 0),
                                     self.live_bytes)
        try:
            yield
        finally:
            self._phase = prev

    # -- kernel ops --------------------------------------------------------
    def kernel(self, name: str, variant: str, cost: KernelCost) -> None:
        """One launch of kernel ``name`` in ``variant`` doing ``cost``."""
        by = self.launches.setdefault(name, {})
        by[variant] = by.get(variant, 0) + 1
        self.flops[cost.dtype] += cost.flops
        self.kernel_flops[cost.dtype] += cost.flops
        self.bytes_accessed += cost.nbytes
        self.kernel_bytes += cost.nbytes

    def summary(self) -> dict:
        """The counts as plain numbers (a JSON-ready dict)."""
        return {"flops": dict(self.flops),
                "bytes_accessed": self.bytes_accessed,
                "launches": {k: dict(v) for k, v in self.launches.items()},
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
