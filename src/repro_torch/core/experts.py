"""Expert models m_N for the cascade (port of ``repro.core.experts``).

* ``SimulatedExpert`` returns the stream's precomputed expert annotations
  (ground truth corrupted at the paper's per-dataset LLM accuracy,
  length-biased; ``data.streams``): zero compute, exact control of the
  noisy-teacher regime.
* ``ModelExpert`` is a real model: a ``tinytf`` classifier trained
  offline on ground truth (``train_model_expert``) to stand in for a
  zero-shot LLM, so the served path runs real expert compute.  Its
  forward is plain PyTorch on the expert's ``device`` (CUDA unless
  ``"cpu"`` is asked for).

Async annotation interface (``submit`` / ``submit_many`` / ``poll``)
--------------------------------------------------------------------
``submit_many`` splits a batch into ``shard_bounds(k, workers)``
contiguous shards (a pure function of (k, workers), never of worker
timing) and hands back an ``ExpertTicket`` that completes *per item*:
``item_done`` / ``ready_mask`` probe it, ``result_slice`` blocks on
exactly the shards a range overlaps (the engine's per-lane commit drain
is built on it), ``poll_partial`` reads what has landed.
``SimulatedExpert`` resolves labels lazily at poll time; its optional
fake ``latency`` is counted in non-blocking ``done()`` probes, so delay
and pool tests run the real poll path.  ``ModelExpert`` runs each
shard's batched forward on a pool worker.  On the card every pool thread
runs its forward on a CUDA stream of its own, so the expert's kernels
never queue behind (or hold up) the engine's route passes on the main
stream.  Either way a ticket resolves to exactly the labels
``label_batch`` returns for each shard.

Failure semantics
-----------------
A shard that fails raises a typed error carrying its item range:
``ExpertShardTimeout`` when ``result_slice(..., timeout=)`` expires,
``ExpertWorkerDied`` when the worker raised or its process vanished.
The engine requeues the range (``ExpertTicket.replace``) or, past its
``max_requeues``, force-resolves it to the ``-1`` dropped-annotation
sentinel (``force_resolve``).  ``FlakyExpert`` wraps any expert with
scripted or seeded fault injection.  ``ModelExpert(backend="process")``
runs shard forwards in a spawn-context process pool (each child rebuilds
the tree on its ``device``, opening its own CUDA context on the card); a
broken pool is rebuilt on the next submit.

The ticket's and the experts' ``# guarded-by:`` lock annotations are
checked statically by cascade-lint and at runtime by the port's lock
sanitizer (``repro_torch.analysis.sanitize``, mode ``locks``), which
instruments this module.  The model expert's forward runs behind the
retrace sanitizer's probe (``expert.predict``), as in the reference.
"""
from __future__ import annotations

import threading
import zlib
from concurrent.futures import (ProcessPoolExecutor, ThreadPoolExecutor,
                                TimeoutError as _FuturesTimeout)
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.core.cascade import _grads
from repro_torch.data.features import hash_ids
from repro_torch.data.streams import Stream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.students import (
    TinyTFSpec, tinytf_init, tinytf_loss, tinytf_predict)
from repro_torch.optim import adam
from repro_torch.tree import tree_map


class ExpertShardError(RuntimeError):
    """A ticket shard failed to resolve.

    Carries the failed item range ``[lo, hi)`` (``hi`` is None for a
    legacy future-form shard whose length was never observed — the
    holder of the ticket substitutes the submitted batch size)."""

    def __init__(self, lo: int, hi: Optional[int], msg: str,
                 cause: Optional[BaseException] = None):
        super().__init__(f"{msg} (items [{lo}, {hi}))")
        self.lo = int(lo)
        self.hi = None if hi is None else int(hi)
        self.cause = cause


class ExpertShardTimeout(ExpertShardError):
    """``result_slice(..., timeout=)`` expired before the shard landed."""

    def __init__(self, lo, hi, cause=None):
        super().__init__(lo, hi, "expert shard timed out", cause)


class ExpertWorkerDied(ExpertShardError):
    """The worker annotating a shard raised or its process vanished."""

    def __init__(self, lo, hi, cause=None):
        super().__init__(lo, hi, f"expert worker died: {cause!r}", cause)


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

    The ticket is a list of contiguous shards ``[lo, hi, payload]``, each
    payload either an already resolved ``np.ndarray`` of labels or a
    future-like object exposing ``done()``/``result()``.  Built from
    exactly one of ``labels=`` (resolved), ``future=`` (one shard of
    unknown length, settled on resolution) or ``shards=``.

    Thread safety: the shard table is mutated in place as shards resolve
    (``_resolve`` swaps a future for its labels, ``_settle_bounds`` fills
    a legacy shard's upper bound), so every shard access goes through
    ``self._lock`` (re-entrant).  cascade-lint CAS004 enforces it.
    """

    __slots__ = ("_shards", "_lock")

    def __init__(self, labels: Optional[np.ndarray] = None, future=None,
                 shards: Optional[Sequence] = None):
        if sum(x is not None for x in (labels, future, shards)) != 1:
            raise ValueError(
                "exactly one of labels/future/shards required")
        self._lock = threading.RLock()
        if labels is not None:
            labels = np.asarray(labels, np.int32)
            self._shards = [[0, len(labels), labels]]  # guarded-by: _lock
        elif future is not None:
            self._shards = [[0, None, future]]
        else:
            self._shards = [[int(lo), None if hi is None else int(hi),
                             payload] for lo, hi, payload in shards]

    # -- internals ------------------------------------------------------
    def _resolve(self, shard, timeout: Optional[float] = None) -> np.ndarray:
        if not isinstance(shard[2], np.ndarray):
            try:
                # no-timeout waits stay a plain result() call: payloads
                # are duck-typed and need not take a timeout argument
                labels = (shard[2].result() if timeout is None
                          else shard[2].result(timeout))
            except (_FuturesTimeout, TimeoutError) as e:
                raise ExpertShardTimeout(shard[0], shard[1], cause=e) from e
            except ExpertShardError:
                raise
            except Exception as e:
                # anything else out of a future is the worker's demise:
                # an exception it raised, or BrokenProcessPool after its
                # process vanished
                raise ExpertWorkerDied(shard[0], shard[1], cause=e) from e
            shard[2] = np.asarray(labels, np.int32)
            if shard[1] is None:
                shard[1] = shard[0] + len(shard[2])
        return shard[2]

    @staticmethod
    def _shard_done(shard) -> bool:
        return isinstance(shard[2], np.ndarray) or shard[2].done()

    def _settle_bounds(self, shard) -> None:
        """Resolve a legacy shard of unknown length once it is done."""
        if shard[1] is None and self._shard_done(shard):
            self._resolve(shard)

    def _n_items(self) -> int:
        with self._lock:
            last = self._shards[-1] if self._shards else None
            if last is None:
                return 0
            self._settle_bounds(last)
            if last[1] is None:
                raise ValueError("ticket length unknown while its legacy "
                                 "future-form shard is still in flight")
            return int(last[1])

    # -- whole-ticket interface (the per-tick commit path) --------------
    def done(self) -> bool:
        """True once every item's labels are available without blocking.
        Probes every shard (no short-circuit), so fake-latency credits
        drain at the rate ``ready_mask`` consumes them."""
        with self._lock:
            return all([self._shard_done(s) for s in self._shards])

    def result(self) -> np.ndarray:
        """Block until every shard resolves; return all labels in order."""
        with self._lock:
            if not self._shards:
                return np.zeros((0,), np.int32)
            return np.concatenate([self._resolve(s) for s in self._shards])

    # -- per-item interface (the per-lane commit path) ------------------
    def item_done(self, i: int) -> bool:
        """True once item ``i``'s label is available without blocking
        (IndexError out of range; conservatively False past the start of
        a legacy shard still in flight)."""
        with self._lock:
            for shard in self._shards:
                self._settle_bounds(shard)
                lo, hi = shard[0], shard[1]
                if lo <= i and (hi is None or i < hi):
                    return self._shard_done(shard)
        raise IndexError(i)

    def ready_mask(self) -> np.ndarray:
        """(n,) bool — which items are resolvable without blocking."""
        with self._lock:
            for shard in self._shards:
                self._settle_bounds(shard)
            mask = np.zeros(self._n_items(), bool)
            for shard in self._shards:
                mask[shard[0]:shard[1]] = self._shard_done(shard)
            return mask

    def result_slice(self, lo: int, hi: int,
                     timeout: Optional[float] = None) -> np.ndarray:
        """Labels for items ``[lo, hi)``, blocking only on the shards that
        overlap the range; ``timeout`` bounds the wait on each of them
        (``ExpertShardTimeout`` with that shard's range on expiry)."""
        parts = []
        with self._lock:
            for s in self._shards:
                s_lo, s_hi = s[0], s[1]
                if s_hi is not None and (s_hi <= lo or s_lo >= hi):
                    continue
                labels = self._resolve(s, timeout)
                s_hi = s[1]
                if s_hi <= lo or s_lo >= hi:
                    continue
                parts.append(labels[max(lo - s_lo, 0):hi - s_lo])
        if not parts:
            return np.zeros((0,), np.int32)
        return np.concatenate(parts)

    # -- failure handling (the engine's requeue path) -------------------
    def _find_shard(self, lo: int, hi: int) -> int:
        with self._lock:
            for i, s in enumerate(self._shards):
                if s[0] == lo and (s[1] == hi or s[1] is None):
                    return i
        raise ValueError(f"no shard covering exactly [{lo}, {hi})")

    def replace(self, lo: int, hi: int, ticket: "ExpertTicket") -> None:
        """Splice ``ticket`` (a fresh annotation of items ``[lo, hi)``,
        indexed from 0) over the failed shard covering that range, its
        shards re-based to this ticket's coordinates."""
        with self._lock:
            i = self._find_shard(lo, hi)
            with ticket._lock:
                repl = [[lo + s[0],
                         hi if s[1] is None else lo + s[1],
                         s[2]] for s in ticket._shards]
            self._shards[i:i + 1] = repl

    def force_resolve(self, lo: int, hi: int, labels: np.ndarray) -> None:
        """Overwrite the shard covering ``[lo, hi)`` with fixed labels
        (the engine passes the ``-1`` dropped-annotation sentinel)."""
        with self._lock:
            i = self._find_shard(lo, hi)
            self._shards[i] = [lo, hi, np.asarray(labels, np.int32)]

    def wrapped(self, fn: Callable) -> "ExpertTicket":
        """A new ticket over the same shard spans, each payload replaced
        by ``fn(shard_idx, payload)`` (``FlakyExpert``'s hook)."""
        with self._lock:
            return ExpertTicket(shards=[
                (s[0], s[1], fn(j, s[2]))
                for j, s in enumerate(self._shards)])


def poll_ticket(ticket: ExpertTicket,
                block: bool = True) -> Optional[np.ndarray]:
    """Shared ``poll`` body: labels when ready, else None (non-blocking)."""
    if not block and not ticket.done():
        return None
    return ticket.result()


def poll_ticket_partial(
        ticket: ExpertTicket) -> Tuple[np.ndarray, np.ndarray]:
    """Non-blocking partial poll: ``(ready_mask, labels)``, unready slots
    holding -1."""
    mask = ticket.ready_mask()
    labels = np.full(mask.shape, -1, np.int32)
    lo = 0
    while lo < mask.size:
        if not mask[lo]:
            lo += 1
            continue
        hi = lo
        while hi < mask.size and mask[hi]:
            hi += 1
        labels[lo:hi] = ticket.result_slice(lo, hi)
        lo = hi
    return mask, labels


LatencyLike = Union[None, int, Callable[[int, int], int]]


class _SimulatedAnnotation:
    """Future-like shard payload for ``SimulatedExpert``: labels are
    computed at resolution, never at submit.  Each non-blocking ``done()``
    probe consumes one latency credit; ``result()`` always resolves (a
    blocking poll waits the latency out), so latency shifts when labels
    are observable, never what they are."""

    __slots__ = ("_fn", "_credits")

    def __init__(self, fn: Callable[[], np.ndarray], credits: int):
        self._fn = fn
        self._credits = max(int(credits), 0)

    def done(self) -> bool:
        if self._credits > 0:
            self._credits -= 1
            return False
        return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        self._credits = 0
        return self._fn()


class SimulatedExpert:
    """Zero-compute expert replaying precomputed noisy-LLM labels.

    ``workers`` sets how many shards ``submit_many`` splits a batch into
    (``"auto"`` hands the width to the engine's autoscaler, starting at
    1); ``latency`` is an int of credits per shard or a callable
    ``(submit_seq, shard_idx) -> int`` scripting per-shard schedules."""

    def __init__(self, stream: Stream, name: str = "gpt-3.5-turbo",
                 cost: float = 1.0e6, *, workers: Union[int, str] = 1,
                 latency: LatencyLike = None):
        self.name = name
        self.cost = cost
        self.auto_workers = workers == "auto"
        self.workers = 1 if self.auto_workers else max(int(workers), 1)
        self.latency = latency
        self._labels = stream.expert_labels(name)
        self._lock = threading.RLock()
        self._submit_seq = 0   # guarded-by: _lock

    def label(self, idx: int, doc: np.ndarray) -> int:
        """Annotate one stream item (table lookup)."""
        return int(self._labels[idx])

    def label_batch(self, idxs, docs) -> np.ndarray:
        """Annotate a deferred batch in one call (zero compute here; the
        batched engine routes all deferrals of a tick through this)."""
        return self._labels[np.asarray(idxs, np.int64)].astype(np.int32)

    # -- async interface ------------------------------------------------
    def _shard_delay(self, seq: int, j: int) -> int:
        lat = self.latency
        if lat is None:
            return 0
        if callable(lat):
            return int(lat(seq, j))
        return int(lat)

    def _make_ticket(self, idxs, nshards: int) -> ExpertTicket:
        idx_arr = np.asarray(idxs, np.int64)
        with self._lock:
            seq = self._submit_seq
            self._submit_seq += 1
        shards = []
        for j, (lo, hi) in enumerate(shard_bounds(len(idx_arr), nshards)):
            sel = idx_arr[lo:hi]
            shards.append((lo, hi, _SimulatedAnnotation(
                lambda sel=sel: self._labels[sel].astype(np.int32),
                self._shard_delay(seq, j))))
        return ExpertTicket(shards=shards)

    def submit(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch annotation as one lazily resolving shard."""
        return self._make_ticket(idxs, 1)

    def submit_many(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch sharded into ``min(workers, k)`` lazily
        resolving sub-requests with per-item completion."""
        return self._make_ticket(idxs, self.workers)

    def poll(self, ticket: ExpertTicket,
             block: bool = True) -> Optional[np.ndarray]:
        """Labels when ready, else None (non-blocking poll)."""
        return poll_ticket(ticket, block)

    def poll_partial(self, ticket: ExpertTicket):
        """Non-blocking partial poll: (ready_mask, labels-with--1)."""
        return poll_ticket_partial(ticket)


def _fault_draw(seed: int, seq: int, shard: int, salt: str) -> float:
    """Deterministic uniform in [0, 1) for one (submit, shard) cell: a
    keyed hash, so a replayed schedule injects the same faults."""
    h = zlib.crc32(f"{seed}:{seq}:{shard}:{salt}".encode())
    return (h & 0xFFFFFF) / float(1 << 24)


class _FaultyShard:
    """Payload wrapper injecting one scripted fault into a shard:
    ``"timeout"`` (never done; ``result`` raises ``TimeoutError`` even
    when blocking, so no path deadlocks), ``"die"`` (done; ``result``
    raises), ``("slow", n)`` (n extra not-done probes)."""

    __slots__ = ("_inner", "_kind", "_credits")

    def __init__(self, inner, fault):
        if isinstance(fault, tuple):
            kind, credits = fault
        else:
            kind, credits = fault, 0
        if kind not in ("timeout", "die", "slow"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self._inner = inner
        self._kind = kind
        self._credits = max(int(credits), 0)

    def done(self) -> bool:
        if self._kind == "timeout":
            return False
        if self._kind == "die":
            return True
        if self._credits > 0:
            self._credits -= 1
            return False
        return (isinstance(self._inner, np.ndarray)
                or self._inner.done())

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._kind == "timeout":
            raise TimeoutError("injected shard timeout (hung worker)")
        if self._kind == "die":
            raise RuntimeError("injected worker death")
        self._credits = 0
        if isinstance(self._inner, np.ndarray):
            return self._inner
        return self._inner.result(timeout)


class FlakyExpert:
    """Fault-injection wrapper around any expert.

    Faults apply per (submit sequence, shard index) cell, chosen by
    ``schedule(seq, shard) -> None | "timeout" | "die" | ("slow", n)`` or
    by seeded per-cell rates (``timeout_rate`` / ``death_rate`` /
    ``slow_rate``, keyed hashes).  Requeued shards arrive as new submits
    with fresh sequence numbers.  Labels are never altered: a fault only
    changes whether and when a shard resolves."""

    def __init__(self, inner, *, schedule: Optional[Callable] = None,
                 timeout_rate: float = 0.0, death_rate: float = 0.0,
                 slow_rate: float = 0.0, slow_credits: int = 2,
                 seed: int = 0):
        self.inner = inner
        self.name = getattr(inner, "name", "flaky")
        self.cost = getattr(inner, "cost", 0.0)
        self.schedule = schedule
        self.timeout_rate = float(timeout_rate)
        self.death_rate = float(death_rate)
        self.slow_rate = float(slow_rate)
        self.slow_credits = int(slow_credits)
        self.seed = int(seed)
        self._lock = threading.RLock()
        self._submit_seq = 0        # guarded-by: _lock
        self.injected = {"timeout": 0, "die": 0, "slow": 0}

    # the fleet width passes through to the inner pool, so a flaky
    # fleet still autoscales
    @property
    def workers(self) -> int:
        return getattr(self.inner, "workers", 1)

    @workers.setter
    def workers(self, w: int) -> None:
        self.inner.workers = w

    @property
    def auto_workers(self) -> bool:
        return getattr(self.inner, "auto_workers", False)

    def label(self, idx, doc):
        """Synchronous single-item surface, passed through un-faulted."""
        return self.inner.label(idx, doc)

    def label_batch(self, idxs, docs):
        """Synchronous batch surface, passed through un-faulted."""
        return self.inner.label_batch(idxs, docs)

    def _fault(self, seq: int, j: int):
        if self.schedule is not None:
            return self.schedule(seq, j)
        if (self.timeout_rate
                and _fault_draw(self.seed, seq, j, "t") < self.timeout_rate):
            return "timeout"
        if (self.death_rate
                and _fault_draw(self.seed, seq, j, "d") < self.death_rate):
            return "die"
        if (self.slow_rate
                and _fault_draw(self.seed, seq, j, "s") < self.slow_rate):
            return ("slow", self.slow_credits)
        return None

    def _wrap(self, ticket: ExpertTicket) -> ExpertTicket:
        with self._lock:
            seq = self._submit_seq
            self._submit_seq += 1

        def inject(j, payload):
            fault = self._fault(seq, j)
            if fault is None:
                return payload
            kind = fault[0] if isinstance(fault, tuple) else fault
            with self._lock:
                self.injected[kind] += 1
            return _FaultyShard(payload, fault)

        return ticket.wrapped(inject)

    def submit(self, idxs, docs) -> ExpertTicket:
        """Submit through the inner expert, then overlay faults."""
        return self._wrap(self.inner.submit(idxs, docs))

    def submit_many(self, idxs, docs) -> ExpertTicket:
        """Sharded submit through the inner expert, faults overlaid."""
        return self._wrap(self.inner.submit_many(idxs, docs))

    def poll(self, ticket: ExpertTicket,
             block: bool = True) -> Optional[np.ndarray]:
        """Labels when ready, else None (non-blocking poll)."""
        return poll_ticket(ticket, block)

    def poll_partial(self, ticket: ExpertTicket):
        """Non-blocking partial poll: (ready_mask, labels-with--1)."""
        return poll_ticket_partial(ticket)

    def close(self) -> None:
        """Close the wrapped expert's pool (if it has one)."""
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


# -- process-pool worker side (module level: must pickle under spawn) ---
_PROCESS_EXPERT: Optional[list] = None


def _process_worker_init(params, spec, device) -> None:
    """Pool initializer: rebuild the numpy parameter tree as tensors on
    ``device`` (the child's own CUDA context on the card)."""
    global _PROCESS_EXPERT
    dev = torch.device(device)
    _PROCESS_EXPERT = [tree_map(lambda a: torch.from_numpy(a).to(dev),
                                params), spec, dev]


@torch.no_grad()
def _process_label_batch(idxs, docs) -> np.ndarray:
    """``ModelExpert.label_batch``'s body, run inside a pool process."""
    params, spec, dev = _PROCESS_EXPERT
    if len(docs) == 0:
        return np.zeros((0,), np.int32)
    ids = np.stack([hash_ids(d, spec.vocab, spec.max_len) for d in docs])
    probs = tinytf_predict(params, torch.from_numpy(ids).to(dev), spec)
    return torch.argmax(probs, dim=-1).cpu().numpy().astype(np.int32)


@dataclass
class ModelExpert:
    """A trained transformer classifier acting as the LLM expert.

    ``params`` is a ``tinytf`` tree on ``device``.  ``workers`` sizes the
    annotation pool: ``submit_many`` splits a batch into that many
    contiguous shards, each shard's batched forward on its own pool
    worker; ``workers="auto"`` hands the width to the engine's
    queue-depth autoscaler.  ``backend`` is ``"thread"`` (torch releases
    the GIL inside its kernels) or ``"process"``: a spawn-context
    ``ProcessPoolExecutor`` whose children get the parameters as numpy
    at init and rebuild them on ``device`` (spawn, never fork: CUDA does
    not survive a fork after it was initialised).  The executor is sized
    ``max(workers, max_workers)``, so autoscaling up needs no rebuild; a
    broken process pool (a child died) is rebuilt on the next submit.
    """

    params: dict
    spec: TinyTFSpec
    name: str = "model-expert"
    cost: float = 1.0e6
    workers: Union[int, str] = 1
    backend: str = "thread"
    max_workers: Optional[int] = None
    device: DeviceLike = None
    _executor: Optional[object] = field(     # guarded-by: _lock
        default=None, init=False, repr=False, compare=False)
    _streams: dict = field(      # guarded-by: _lock
        default_factory=dict, init=False, repr=False, compare=False)
    _lock: threading.RLock = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.backend not in ("thread", "process"):
            raise ValueError(f"backend must be 'thread' or 'process', "
                             f"got {self.backend!r}")
        self.auto_workers = self.workers == "auto"
        self.workers = 1 if self.auto_workers else max(int(self.workers), 1)
        self.device = resolve_device(self.device)
        self._lock = threading.RLock()
        spec = self.spec
        self._predict = _san.trace_probe(
            "expert.predict", lambda p, ids: tinytf_predict(p, ids, spec))
        # the parameters are complete once the work queued so far on the
        # constructing thread's stream is: every pool stream waits on
        # this event once, when it is made
        self._params_ready = None
        if self.device.type == "cuda":
            self._params_ready = torch.cuda.Event()
            self._params_ready.record()

    @torch.no_grad()
    def _argmax(self, ids: np.ndarray) -> np.ndarray:
        probs = self._predict(self.params,
                              torch.from_numpy(ids).to(self.device))
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

    # -- the pool -------------------------------------------------------
    def _worker_stream(self) -> "torch.cuda.Stream":
        """The calling pool thread's own CUDA stream, made on first use.

        The parameters are read-only once trained, so after the one wait
        on ``_params_ready`` no event between this stream and the
        engine's is needed for them; the shard's input upload and its
        ``.cpu()`` readback are ordered on this stream alone, so a
        readback waits for this shard's forward and nothing else."""
        with self._lock:
            tid = threading.get_ident()
            stream = self._streams.get(tid)
            if stream is None:
                stream = torch.cuda.Stream(self.device)
                stream.wait_event(self._params_ready)
                self._streams[tid] = stream
            return stream

    def worker_streams(self) -> list:
        """The CUDA streams the pool threads have made so far."""
        with self._lock:
            return list(self._streams.values())

    def _pool_label_batch(self, idxs, docs) -> np.ndarray:
        """``label_batch`` as a thread-pool task: on the card, on the
        worker thread's own stream."""
        if self.device.type != "cuda":
            return self.label_batch(idxs, docs)
        with torch.cuda.stream(self._worker_stream()):
            return self.label_batch(idxs, docs)

    def _pool_width(self) -> int:
        return max(self.workers,
                   self.max_workers if self.max_workers else 1)

    def _pool(self):
        with self._lock:
            ex = self._executor
            if ex is not None and getattr(ex, "_broken", False):
                # a dead child poisons the whole ProcessPoolExecutor;
                # rebuild so requeued shards land on fresh workers
                ex.shutdown(wait=False, cancel_futures=True)
                ex = self._executor = None
            if ex is None:
                if self.backend == "process":
                    import multiprocessing as mp
                    host = tree_map(lambda t: t.detach().cpu().numpy(),
                                    self.params)
                    self._executor = ProcessPoolExecutor(
                        max_workers=self._pool_width(),
                        mp_context=mp.get_context("spawn"),
                        initializer=_process_worker_init,
                        initargs=(host, self.spec, str(self.device)))
                else:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self._pool_width(),
                        thread_name_prefix=self.name)
            return self._executor

    def _task(self):
        # process children cannot pickle the bound method; they run the
        # module-level twin against their initializer state
        return (_process_label_batch if self.backend == "process"
                else self._pool_label_batch)

    def _submit_shards(self, idxs, docs, bounds) -> list:
        """One pool request per ``(lo, hi)`` span.  A process pool whose
        child died between our broken-pool check and the submit refuses
        it; the pool is then rebuilt once and the spans resubmitted."""
        task = self._task()
        for attempt in (0, 1):
            pool = self._pool()
            try:
                return [(lo, hi, pool.submit(task, idxs[lo:hi],
                                             docs[lo:hi]))
                        for lo, hi in bounds]
            except BrokenProcessPool:
                if attempt:
                    raise

    def submit(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch annotation as ONE pool request."""
        idxs, docs = list(idxs), list(docs)
        (_, _, fut), = self._submit_shards(idxs, docs, [(0, len(idxs))])
        return ExpertTicket(future=fut)

    def submit_many(self, idxs, docs) -> ExpertTicket:
        """Enqueue a batch sharded over the worker pool; the ticket
        completes per item as each shard's forward lands."""
        idxs, docs = list(idxs), list(docs)
        return ExpertTicket(shards=self._submit_shards(
            idxs, docs, shard_bounds(len(idxs), self.workers)))

    def poll(self, ticket: ExpertTicket,
             block: bool = True) -> Optional[np.ndarray]:
        """Labels when ready, else None (non-blocking poll)."""
        return poll_ticket(ticket, block)

    def poll_partial(self, ticket: ExpertTicket):
        """Non-blocking partial poll: (ready_mask, labels-with--1)."""
        return poll_ticket_partial(ticket)

    def close(self) -> None:
        """Reap the pool's threads or processes (idempotent)."""
        with self._lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
            self._streams.clear()

    def __del__(self):  # best-effort: don't leak the workers at GC
        try:
            self.close()
        except Exception:
            pass


def fit_epochs(params, opt, loss, x: torch.Tensor, y: torch.Tensor,
               epochs: int, batch: int, rng: np.random.Generator):
    """Offline minibatch training from ``params`` (on ``x``'s device): per
    epoch a ``rng`` permutation cut into full batches, one ``opt`` step
    on ``loss(params, xb, yb)`` each.  Returns the trained params."""
    state = opt.init(params)
    n = x.shape[0]
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            sel = torch.from_numpy(order[s:s + batch]).to(x.device)
            grads = _grads(loss, params, x[sel], y[sel])
            params, state = opt.step(params, grads, state)
    return params


def train_tinytf(params: dict, spec: TinyTFSpec, ids: np.ndarray,
                 labels: np.ndarray, epochs: int, batch: int, lr: float,
                 seed: int) -> dict:
    """The expert's offline training loop, from ``params`` (on their
    device): ``fit_epochs`` with ``adam(lr)`` on the mean xent, its
    permutations from ``np.random.default_rng(seed)``."""
    dev = params["embed"].device
    x_all = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
    y_all = torch.from_numpy(np.asarray(labels, np.int32)).to(dev)

    def loss(p, xb, yb):
        return tinytf_loss(p, xb, yb, spec)

    return fit_epochs(params, adam(lr), loss, x_all, y_all, epochs, batch,
                      np.random.default_rng(seed))


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
