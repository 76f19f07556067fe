"""Expert m_N for the cascade (port of the ``SimulatedExpert`` half of
``repro.core.experts``).

``SimulatedExpert`` returns the stream's precomputed expert annotations
(ground truth corrupted at the paper's per-dataset LLM accuracy,
length-biased; ``data.streams``): zero compute, exact control of the
noisy-teacher regime.  Its async interface (``submit_many`` / ``poll``)
hands out ``ExpertTicket``s whose labels resolve lazily, at poll time.
Copied from the reference (pure Python and numpy) with the ticket's
``# guarded-by:`` lock annotation, which cascade-lint checks.

Per-lane completion, multi-worker pools, fake latency and the shard
failure surface serve the per-lane commit and fault paths; they come
back with those paths, as do ``ModelExpert`` (a trained stand-in
transformer) and ``FlakyExpert`` (fault injection) (ROADMAP).
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.streams import Stream


def shard_bounds(k: int, workers: int) -> List[Tuple[int, int]]:
    """Contiguous balanced split of ``k`` items into ``min(workers, k)``
    shards: shard j covers ``[j*k//w, (j+1)*k//w)``.

    A pure function of (k, workers) — never of worker timing — so a
    pooled annotation's shard layout is deterministic.
    """
    if k <= 0:
        return []
    w = max(1, min(int(workers), k))
    edges = [(j * k) // w for j in range(w + 1)]
    return [(edges[j], edges[j + 1]) for j in range(w)]


class ExpertTicket:
    """Handle for one in-flight batched annotation request.

    The ticket is a list of contiguous *shards* ``[lo, hi, payload]``,
    each payload either an already resolved ``np.ndarray`` of labels or a
    future-like object exposing ``done()``/``result()``.

    Thread safety: the shard table is mutated in place as shards resolve
    (``_resolve`` swaps a future for its labels), so every shard access
    goes through ``self._lock``.  cascade-lint CAS004 enforces the
    enclosure.
    """

    __slots__ = ("_shards", "_lock")

    def __init__(self, shards: Sequence):
        self._lock = threading.RLock()
        self._shards = [[int(lo), int(hi), payload]  # guarded-by: _lock
                        for lo, hi, payload in shards]

    @staticmethod
    def _resolve(shard) -> np.ndarray:
        if not isinstance(shard[2], np.ndarray):
            shard[2] = np.asarray(shard[2].result(), np.int32)
        return shard[2]

    def done(self) -> bool:
        """True once every item's labels are available without blocking."""
        with self._lock:
            return all([isinstance(s[2], np.ndarray) or s[2].done()
                        for s in self._shards])

    def result(self) -> np.ndarray:
        """Block until every shard resolves; return all labels in order."""
        with self._lock:
            if not self._shards:
                return np.zeros((0,), np.int32)
            return np.concatenate([self._resolve(s) for s in self._shards])


def poll_ticket(ticket: ExpertTicket,
                block: bool = True) -> Optional[np.ndarray]:
    """Shared ``poll`` body: labels when ready, else None (non-blocking)."""
    if not block and not ticket.done():
        return None
    return ticket.result()


class _SimulatedAnnotation:
    """Future-like shard payload for ``SimulatedExpert``: labels are
    computed lazily at resolution (``result``), never at submit, so the
    engine's poll path is exercised for real."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], np.ndarray]):
        self._fn = fn

    def done(self) -> bool:
        return True

    def result(self) -> np.ndarray:
        return self._fn()


class SimulatedExpert:
    """Zero-compute expert replaying precomputed noisy-LLM labels."""

    def __init__(self, stream: Stream, name: str = "gpt-3.5-turbo",
                 cost: float = 1.0e6):
        self.name = name
        self.cost = cost
        self._labels = stream.expert_labels(name)

    def label(self, idx: int, doc: np.ndarray) -> int:
        """Annotate one stream item (table lookup)."""
        return int(self._labels[idx])

    def label_batch(self, idxs, docs) -> np.ndarray:
        """Annotate a deferred batch in one call (zero compute here; the
        batched engine routes all deferrals of a tick through this)."""
        return self._labels[np.asarray(idxs, np.int64)].astype(np.int32)

    def submit_many(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch annotation as one lazily resolving shard."""
        sel = np.asarray(idxs, np.int64)
        return ExpertTicket([
            (lo, hi, _SimulatedAnnotation(
                lambda s=sel[lo:hi]: self._labels[s].astype(np.int32)))
            for lo, hi in shard_bounds(len(sel), 1)])

    def poll(self, ticket: ExpertTicket,
             block: bool = True) -> Optional[np.ndarray]:
        """Labels when ready, else None (non-blocking poll)."""
        return poll_ticket(ticket, block)
