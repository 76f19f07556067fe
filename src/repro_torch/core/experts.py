"""Expert models m_N for the cascade (port of ``repro.core.experts``:
``SimulatedExpert``, ``ModelExpert`` with its thread pool, and
``train_model_expert``).

* ``SimulatedExpert`` returns the stream's precomputed expert annotations
  (ground truth corrupted at the paper's per-dataset LLM accuracy,
  length-biased; ``data.streams``): zero compute, exact control of the
  noisy-teacher regime.
* ``ModelExpert`` is a real model: a ``tinytf`` classifier trained
  offline on ground truth (``train_model_expert``) to stand in for a
  zero-shot LLM, so the served path runs real expert compute.  Its
  forward is plain PyTorch on the expert's ``device`` (CUDA unless
  ``"cpu"`` is asked for).

Both hand out ``ExpertTicket``s from ``submit_many`` (``ModelExpert``
also ``submit``); ``poll`` blocks until a ticket's labels are ready.
``ModelExpert.submit_many`` splits a batch into ``shard_bounds``
contiguous shards and runs each shard's forward on a pool thread, so the
labels are a deterministic function of (k, workers) and equal to
``label_batch``'s.  The ticket's and the expert's ``# guarded-by:``
lock annotations are checked by cascade-lint.

Per-item completion, fake latency and the shard failure surface serve
the per-lane commit and fault paths; they come back with those paths, as
do ``FlakyExpert``, ``ModelExpert(backend="process")`` and
``workers="auto"`` (ROADMAP).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cascade import _grads
from repro_torch.data.features import hash_ids
from repro_torch.data.streams import Stream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.students import (
    TinyTFSpec, tinytf_init, tinytf_loss, tinytf_predict)
from repro_torch.optim import adam


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


@dataclass
class ModelExpert:
    """A trained transformer classifier acting as the LLM expert.

    ``params`` is a ``tinytf`` tree on ``device``.  ``workers`` sizes the
    annotation pool: ``submit_many`` splits a batch into that many
    contiguous shards and runs each shard's batched forward on its own
    pool thread (torch releases the GIL inside its kernels).  Only the
    thread backend and a fixed worker count are ported."""

    params: dict
    spec: TinyTFSpec
    name: str = "model-expert"
    cost: float = 1.0e6
    workers: Union[int, str] = 1
    backend: str = "thread"
    device: DeviceLike = None
    _executor: Optional[ThreadPoolExecutor] = field(     # guarded-by: _lock
        default=None, init=False, repr=False, compare=False)
    _lock: threading.RLock = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.backend != "thread":
            raise ValueError(
                f"backend {self.backend!r} is not ported (ROADMAP Queue 1 "
                "item 6); the port's ModelExpert runs a thread pool")
        if self.workers == "auto":
            raise ValueError("workers='auto' (the engine's autoscaler) is "
                             "not ported (ROADMAP Queue 1 item 6)")
        self.workers = max(int(self.workers), 1)
        self.device = resolve_device(self.device)
        self._lock = threading.RLock()

    @torch.no_grad()
    def _argmax(self, ids: np.ndarray) -> np.ndarray:
        probs = tinytf_predict(self.params,
                               torch.from_numpy(ids).to(self.device),
                               self.spec)
        return torch.argmax(probs, dim=-1).cpu().numpy().astype(np.int32)

    def label(self, idx: int, doc: np.ndarray) -> int:
        """Annotate one stream item with a single model forward."""
        return int(self._argmax(
            hash_ids(doc, self.spec.vocab, self.spec.max_len)[None])[0])

    def label_batch(self, idxs, docs) -> np.ndarray:
        """One batched forward for a tick's whole deferred subset."""
        if len(docs) == 0:
            return np.zeros((0,), np.int32)
        return self._argmax(np.stack(
            [hash_ids(d, self.spec.vocab, self.spec.max_len) for d in docs]))

    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix=self.name)
            return self._executor

    def submit(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch annotation as ONE pool request."""
        idxs, docs = list(idxs), list(docs)
        return ExpertTicket([(0, len(idxs), self._pool().submit(
            self.label_batch, idxs, docs))])

    def submit_many(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch sharded over the worker pool."""
        idxs, docs = list(idxs), list(docs)
        pool = self._pool()
        return ExpertTicket([
            (lo, hi, pool.submit(self.label_batch, idxs[lo:hi], docs[lo:hi]))
            for lo, hi in shard_bounds(len(idxs), self.workers)])

    def poll(self, ticket: ExpertTicket,
             block: bool = True) -> Optional[np.ndarray]:
        """Labels when ready, else None (non-blocking poll)."""
        return poll_ticket(ticket, block)

    def close(self) -> None:
        """Reap the pool threads (idempotent)."""
        with self._lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __del__(self):  # best-effort: don't leak the workers at GC
        try:
            self.close()
        except Exception:
            pass


def train_tinytf(params: dict, spec: TinyTFSpec, ids: np.ndarray,
                 labels: np.ndarray, epochs: int, batch: int, lr: float,
                 seed: int) -> dict:
    """The expert's offline training loop, from ``params`` (on their
    device): per epoch a ``np.random.default_rng(seed)`` permutation cut
    into full batches, one ``adam(lr)`` step on the mean xent each."""
    dev = params["embed"].device
    opt = adam(lr)
    state = opt.init(params)
    x_all = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
    y_all = torch.from_numpy(np.asarray(labels, np.int32)).to(dev)
    n = len(ids)

    def loss(p, xb, yb):
        return tinytf_loss(p, xb, yb, spec)

    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            sel = torch.from_numpy(order[s:s + batch]).to(dev)
            grads = _grads(loss, params, x_all[sel], y_all[sel])
            params, state = opt.step(params, grads, state)
    return params


def train_model_expert(stream: Stream, n_classes: int,
                       d_model: int = 256, n_layers: int = 4,
                       epochs: int = 3, batch: int = 32,
                       lr: float = 1e-3, seed: int = 0,
                       max_samples: Optional[int] = None,
                       cost: float = 1.0e6,
                       workers: Union[int, str] = 1,
                       backend: str = "thread",
                       device: DeviceLike = None) -> ModelExpert:
    """Train the stand-in LLM on ground truth (offline, before serving),
    on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    spec = TinyTFSpec(d_model=d_model, n_layers=n_layers, d_ff=4 * d_model,
                      n_classes=n_classes)
    params = tinytf_init(torch.Generator().manual_seed(seed), spec, dev)
    n = len(stream) if max_samples is None else min(max_samples, len(stream))
    ids = np.stack([hash_ids(stream.docs[i], spec.vocab, spec.max_len)
                    for i in range(n)])
    params = train_tinytf(params, spec, ids, stream.labels[:n], epochs,
                          batch, lr, seed)
    return ModelExpert(params=params, spec=spec, cost=cost, workers=workers,
                       backend=backend, device=dev)
