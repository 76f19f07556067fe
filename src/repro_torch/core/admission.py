"""Continuous-batching admission over the batched cascade engine (port
of ``repro.core.admission``).

The paper's setting is a stream: queries arrive over time, each with its
own length, and the cascade answers them as they come.  The front-end
serves such traffic over the engine's fixed pool of ``n_streams`` lanes:
requests arrive on a seeded schedule (``data/streams.py`` ``Request``),
claim a free lane, run to completion at their own pace and retire,
recycling the lane.  Occupancy goes through the engine's occupancy
arguments (``lanes=`` names the physical lanes a tick's positions hold),
so a partial tick is just a smaller gathered batch: on the card each
level's live lanes pad to the engine's buckets (8 / 16 / 32 / 64) and a
level with no live lane launches nothing.

One tick of ``step()``:

1. **retire** — streams whose last item routed on an earlier tick free
   their lanes (a lane serves its stream's final item at tick u and is
   reusable from tick u + 1);
2. **admit** — queued requests claim free lanes, FCFS in arrival order,
   lowest free lane first.  Admission reads only the schedule and the
   lane budget, never an engine output, so the admission log is the same
   for any worker count, pipeline depth or delay;
3. **serve** — the occupied lanes' next items form the tick, submitted
   with ``lanes=`` (physical lanes), ``stream_ids=`` (each stream's rid)
   and ``stream_ticks=`` (each stream's own 1-based item counter): stream
   r's j-th item draws ``tick_rngs(seed, r, j)`` whichever lane or global
   tick serves it — what a dedicated lane, or the sequential engine with
   ``stream_id = r``, would draw;
4. **idle** — a tick with arrivals pending but no occupant still calls
   the engine, with an EMPTY tick: it advances the clock and the D-tick
   commit deadlines and launches nothing.

Overload: ``admission="queue"`` queues arrivals without bound;
``admission="shed"`` drops an arrival (recorded, never served) when
every lane is busy or spoken for and the wait queue already holds
``queue_limit`` requests.

Co-scheduled streams share the learning cascade (the paper's point), so
a staggered run matches a dedicated-lane run only in its draws; in the
frozen regime (``hard_budget=0``: no jumps, expert calls or updates)
each stream's trajectory is bitwise the sequential engine's, and the
all-at-t=0 lockstep schedule is bitwise the classic ``run`` even while
learning.  ``save_state`` / ``restore_state`` checkpoint the front-end
mid-schedule: the engine's checkpoint plus ``<path>.frontend.json``.
"""
from __future__ import annotations

import json
import time
from bisect import bisect_right
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class StreamRecord:
    """Per-stream serving record (admit tick, answers, time-to-answer).

    Ticks are engine ticks (1-based; idle ticks count).  ``commit_ticks``
    are the engine ticks this stream's expert annotations committed at,
    recovered from the engine's ``commit_log`` through the lane-occupancy
    history."""
    rid: int
    arrival: int                  # tick the request became admissible
    n_items: int
    admit: int = -1               # tick of first served item (-1: never)
    lane: int = -1                # physical lane served on (-1: never)
    done: int = -1                # tick the final item routed
    retired: int = -1             # tick the lane was freed again
    shed: bool = False
    items_done: int = 0           # outputs consumed so far
    expert_calls: int = 0
    cost_units: float = 0.0
    predictions: List[int] = field(default_factory=list)
    levels: List[int] = field(default_factory=list)
    commit_ticks: List[int] = field(default_factory=list)
    arrival_wall: float = 0.0     # wall clocks (0 = unset)
    answer_wall: float = 0.0

    @property
    def answered(self) -> bool:
        return self.items_done == self.n_items and self.n_items > 0

    def time_to_answer(self) -> int:
        """Ticks from (effective) arrival to the final item's route,
        inclusive, queueing included; -1 while unanswered."""
        if self.done < 0:
            return -1
        return self.done - max(self.arrival, 1) + 1

    def queue_delay(self) -> int:
        """Ticks spent waiting for a lane; -1 if never admitted."""
        if self.admit < 0:
            return -1
        return self.admit - max(self.arrival, 1)


class CascadeFrontEnd:
    """Dynamic lane admission / retirement over a ``BatchedCascadeEngine``.

    The engine's ``n_streams`` is the lane budget and its device is the
    front-end's (CUDA unless the engine was built with ``device="cpu"``).
    The front-end owns the clock: every ``step()`` is one engine tick.
    It drives the pipelined path (``submit_tick`` / ``drain``) when the
    engine has ``pipeline_depth > 0`` and maps late outputs back through
    each output's tick number, so records are identical for any depth.
    """

    def __init__(self, engine, stream, *, admission: str = "queue",
                 queue_limit: int = 0):
        if admission not in ("queue", "shed"):
            raise ValueError(
                f"admission must be 'queue' or 'shed', got {admission!r}")
        if queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        self.engine = engine
        self.stream = stream
        self.admission = admission
        self.queue_limit = queue_limit
        L = engine.n_streams
        self._occupant: List[Optional[int]] = [None] * L  # lane -> rid
        self._free: List[int] = list(range(L))            # sorted
        self._queue: deque = deque()                      # waiting rids
        self._cursor: Dict[int, int] = {}                 # rid -> next item
        self._requests: Dict[int, object] = {}            # rid -> Request
        self.records: Dict[int, StreamRecord] = {}
        # engine tick -> (lanes, rids) of its positions, kept until the
        # tick's output resolves (pipelined outputs arrive up to P late)
        self._tick_layout: Dict[int, tuple] = {}
        # per-lane occupancy spans [(start_tick, end_tick, rid)]: a
        # commit_log entry (submit_t, lane, c) belongs to whichever
        # stream held `lane` at submit_t
        self._lane_history: List[List[tuple]] = [[] for _ in range(L)]
        self._commit_seen = 0
        self.stats = {"offered": 0, "admitted": 0, "shed": 0,
                      "retired": 0, "ticks": 0, "idle_ticks": 0,
                      "occupancy_sum": 0}
        # (rid, admit_tick, lane) in admission order
        self.admission_log: List[tuple] = []

    # -- arrivals --------------------------------------------------------
    def offer(self, request) -> bool:
        """Present one arrival; False when shed under the shed policy."""
        self.stats["offered"] += 1
        rec = StreamRecord(rid=request.rid, arrival=request.arrival,
                           n_items=len(request.items))
        self.records[request.rid] = rec
        if (self.admission == "shed"
                and len(self._queue) >= len(self._free) + self.queue_limit):
            rec.shed = True
            self.stats["shed"] += 1
            return False
        self._requests[request.rid] = request
        self._cursor[request.rid] = 0
        self._queue.append(request.rid)
        return True

    # -- lifecycle -------------------------------------------------------
    def occupied(self) -> List[int]:
        """Occupied physical lanes, ascending."""
        return [s for s, r in enumerate(self._occupant) if r is not None]

    def active(self) -> bool:
        """True while any stream is queued or holds a lane."""
        return bool(self._queue) or any(
            r is not None for r in self._occupant)

    def _retire(self, t_next: int) -> None:
        for lane, rid in enumerate(self._occupant):
            if rid is None:
                continue
            if self._cursor[rid] >= self.records[rid].n_items:
                self.records[rid].retired = t_next
                self._occupant[lane] = None
                self._lane_history[lane][-1] = (
                    self._lane_history[lane][-1][0], t_next - 1, rid)
                self._free.append(lane)
                self.stats["retired"] += 1
        self._free.sort()

    def _admit(self, t_next: int) -> None:
        while self._queue and self._free:
            rid = self._queue.popleft()
            lane = self._free.pop(0)
            self._occupant[lane] = rid
            rec = self.records[rid]
            rec.admit = t_next
            rec.lane = lane
            self._lane_history[lane].append((t_next, None, rid))
            self.admission_log.append((rid, t_next, lane))
            self.stats["admitted"] += 1

    def step(self) -> List[dict]:
        """One engine tick: retire, admit, serve (or idle).  Returns the
        outputs the engine resolved this tick (possibly older ticks')."""
        t_next = self.engine.t + 1
        self._retire(t_next)
        self._admit(t_next)
        lanes, rids, idxs, ticks = [], [], [], []
        for lane, rid in enumerate(self._occupant):
            if rid is None:
                continue
            j = self._cursor[rid]
            lanes.append(lane)
            rids.append(rid)
            idxs.append(self._requests[rid].items[j])
            ticks.append(j + 1)     # the stream's own 1-based item tick
            self._cursor[rid] = j + 1
            if j + 1 == self.records[rid].n_items:
                self.records[rid].done = t_next
        docs = [self.stream.docs[i] for i in idxs]
        self.stats["ticks"] += 1
        self.stats["occupancy_sum"] += len(lanes)
        if not lanes:
            self.stats["idle_ticks"] += 1
        self._tick_layout[t_next] = (lanes, rids)
        if self.engine.pipeline_depth:
            outs = self.engine.submit_tick(
                idxs, docs, lanes=lanes, stream_ids=rids,
                stream_ticks=ticks)
        else:
            outs = [self.engine.process_tick(
                idxs, docs, lanes=lanes, stream_ids=rids,
                stream_ticks=ticks)]
        for out in outs:
            self._consume(out)
        self._consume_commits()
        return outs

    def _consume(self, out: dict) -> None:
        _, rids = self._tick_layout.pop(out["tick"])
        now = time.time()
        for pos, rid in enumerate(rids):
            rec = self.records[rid]
            rec.predictions.append(int(out["predictions"][pos]))
            rec.levels.append(int(out["levels"][pos]))
            rec.expert_calls += int(out["expert_called"][pos])
            rec.cost_units += float(out["cost_units"][pos])
            rec.items_done += 1
            if rec.items_done == rec.n_items:
                rec.answer_wall = now

    def _consume_commits(self) -> None:
        log = self.engine.commit_log
        if log is None:
            return
        for sub_t, lane, commit_t in log[self._commit_seen:]:
            spans = self._lane_history[lane]
            # the rightmost span starting at or before sub_t holds the
            # stream that occupied the lane then
            k = bisect_right([sp[0] for sp in spans], sub_t) - 1
            if k >= 0:
                self.records[spans[k][2]].commit_ticks.append(commit_t)
        self._commit_seen = len(log)

    def finish(self) -> None:
        """Stream end: drain the route ring, flush pending annotations,
        attribute the late commits, retire the survivors."""
        for out in self.engine.drain():
            self._consume(out)
        self.engine.flush()
        self._consume_commits()
        self._retire(self.engine.t + 1)

    def serve(self, requests: Sequence, max_ticks: Optional[int] = None,
              finalize: bool = True) -> Dict[int, StreamRecord]:
        """Serve a whole schedule: offer each request at its arrival tick,
        step until everything retired (or the engine reaches tick
        ``max_ticks``), then ``finish()``.  Deterministic in the schedule:
        nothing here reads an engine output.

        ``finalize=False`` skips ``finish()`` on a ``max_ticks`` break,
        leaving the front-end mid-stream for ``save_state()``; calling
        ``serve()`` again with the same schedule resumes (requests already
        offered are skipped)."""
        pending = deque(sorted(
            (r for r in requests if r.rid not in self.records),
            key=lambda r: (max(r.arrival, 1), r.rid)))
        while pending or self.active():
            if max_ticks is not None and self.engine.t >= max_ticks:
                break
            t_next = self.engine.t + 1
            # retire BEFORE offering so a shed decision sees the lanes
            # this tick frees (step()'s own retire is then a no-op); idle
            # ticks still step, keeping the clock and deadlines moving
            self._retire(t_next)
            while pending and max(pending[0].arrival, 1) <= t_next:
                self.offer(pending.popleft())
            self.step()
        if finalize:
            self.finish()
        return self.records

    # -- live-state checkpoints ------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the front-end mid-schedule: drain the engine's route
        ring (consuming the late outputs), save the engine's live state
        under ``path``, and write the admission bookkeeping to
        ``path + '.frontend.json'`` (the reference's layout)."""
        for out in self.engine.drain():
            self._consume(out)
        self._consume_commits()
        self.engine.save_state(path)
        state = {
            "occupant": [-1 if r is None else int(r)
                         for r in self._occupant],
            "free": [int(s) for s in self._free],
            "queue": [int(r) for r in self._queue],
            "cursor": {str(k): int(v) for k, v in self._cursor.items()},
            "records": {str(k): asdict(v)
                        for k, v in self.records.items()},
            "lane_history": [[list(sp) for sp in spans]
                             for spans in self._lane_history],
            "commit_seen": int(self._commit_seen),
            "stats": dict(self.stats),
            "admission_log": [list(e) for e in self.admission_log],
            "admission": self.admission,
            "queue_limit": int(self.queue_limit),
        }
        with open(path + ".frontend.json", "w") as fh:
            json.dump(state, fh)

    def restore_state(self, path: str, requests: Sequence) -> None:
        """Resume a checkpointed front-end: restore the engine's live
        state, rebuild the admission bookkeeping, and re-bind the
        ``Request`` objects (matched by rid) of the streams that were
        queued or mid-flight at save time.  A different admission policy
        raises ``ValueError``."""
        with open(path + ".frontend.json") as fh:
            state = json.load(fh)
        if (state["admission"] != self.admission
                or state["queue_limit"] != self.queue_limit):
            raise ValueError(
                "checkpoint admission policy mismatch: saved "
                f"({state['admission']!r}, {state['queue_limit']}) vs "
                f"({self.admission!r}, {self.queue_limit})")
        cursor = {int(k): int(v) for k, v in state["cursor"].items()}
        by_rid = {r.rid: r for r in requests}
        missing = set(cursor) - set(by_rid)
        if missing:
            raise ValueError(
                f"restore_state: rids {sorted(missing)} in the "
                "checkpoint are absent from the given schedule")
        self.engine.restore_state(path)
        self._occupant = [None if r < 0 else r for r in state["occupant"]]
        self._free = list(state["free"])
        self._queue = deque(state["queue"])
        self._cursor = cursor
        self.records = {int(k): StreamRecord(**v)
                        for k, v in state["records"].items()}
        self._requests = {rid: by_rid[rid] for rid in cursor}
        self._tick_layout = {}
        self._lane_history = [[tuple(sp) for sp in spans]
                              for spans in state["lane_history"]]
        self._commit_seen = int(state["commit_seen"])
        self.stats = dict(state["stats"])
        self.admission_log = [tuple(e) for e in state["admission_log"]]

    # -- metrics ---------------------------------------------------------
    def metrics(self) -> dict:
        """Serving summary: answered counts, tick-latency percentiles,
        occupancy, and a base-corpus prediction array (-1 where an item
        was shed or unserved) for comparisons with lockstep runs."""
        recs = list(self.records.values())
        answered = [r for r in recs if r.answered]
        ttas = np.array([r.time_to_answer() for r in answered], np.int64)
        delays = np.array([r.queue_delay() for r in answered], np.int64)
        preds = np.full(len(self.stream), -1, np.int64)
        for rid, rec in self.records.items():
            if rec.shed:
                continue
            items = self._requests[rid].items
            for j, p in enumerate(rec.predictions):
                preds[items[j]] = p
        ticks = max(self.stats["ticks"], 1)
        return {
            "requests": len(recs),
            "answered": len(answered),
            "shed": self.stats["shed"],
            "items_done": int(sum(r.items_done for r in recs)),
            "tta_p50": float(np.percentile(ttas, 50)) if ttas.size else 0.0,
            "tta_p99": float(np.percentile(ttas, 99)) if ttas.size else 0.0,
            "queue_delay_mean": (float(delays.mean())
                                 if delays.size else 0.0),
            "occupancy_mean": self.stats["occupancy_sum"] / ticks,
            "idle_ticks": self.stats["idle_ticks"],
            "ticks": self.stats["ticks"],
            "predictions": preds,
        }


def serve_requests(engine, stream, requests, *, admission: str = "queue",
                   queue_limit: int = 0) -> CascadeFrontEnd:
    """Build the front-end, serve the schedule to completion, return the
    front-end (records and metrics inside)."""
    fe = CascadeFrontEnd(engine, stream, admission=admission,
                         queue_limit=queue_limit)
    fe.serve(requests)
    return fe
