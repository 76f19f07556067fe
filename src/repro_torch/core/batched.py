"""Batched multi-stream cascade engine (port of ``repro.core.batched``).

``BatchedCascadeEngine`` runs S stream lanes in lockstep.  Each tick:

  route pass — the cascade walk is vectorised: per-item control flow
    becomes boolean lane masks (jumped / alive / took), and each level's
    predict + defer runs once, batched over the gathered subset of lanes
    still alive there, padded to a bucketed size (powers of two from 8,
    capped at S).  On a CUDA device the upper levels' forwards launch the
    hand-written kernels (flash / decode attention, SSD scan).
  expert call — the deferred subset goes to the expert as one request
    (``submit_many``: sharded over the expert's pool, per-item ticket).
  commit — the tick's demonstrations are scattered into per-level ring
    buffers on the device (in-place ``index_copy_``, the reference's
    donated jitted scatter), then one weighted student step and one
    weighted deferral step per level, through the same ``_Level`` update
    methods the sequential ``OnlineCascade`` uses.

RNG follows ``core.rng``: lane s at tick t draws from the children of
``SeedSequence((seed, s, t))``; cache sampling uses the lane-0 children
(per-lane commits: each lane's own).  With ``n_streams == 1`` the engine
runs exactly the torch ops ``OnlineCascade`` runs, in the same order —
bit-for-bit equal results.  At S > 1 the reference's documented
deviations hold: one weighted update per tick (``updates_per_tick=
"scaled"`` lr-scales it by the tick's k demonstrations via
``Optimizer.step_k``), beta decays per consumed item (decay ** S per
tick), the hard expert budget is enforced at tick granularity (the first
``remaining`` deferred lanes, in lane order, get the expert; the rest
fall back to the last student's prediction, counted and costed as
last-level exits), and annotations land in the ring in lane order.
Under ``sample_actions`` every lane draws its float32 action uniforms
from its tick's ``action`` generator, and a lane defers where its draw
is below the gate's probability.

The serving matrix, as in the reference (its module docstring has the
full contracts; each holds here on the same tick keys):

* ``max_delay=D`` — the async expert queue.  A routed tick's deferred
  lanes are submitted and answered provisionally with the last student's
  prediction (its probs come from the route-time calibration forwards);
  the annotations commit at the end of tick t + D, in FIFO tick order
  with the tick's own cache generators.  ``flush()`` drains the queue.
  D = 0 is the synchronous engine, bitwise.
* ``per_lane=True`` — each lane commits on its own deterministic
  sub-deadline (``lanes_due``) as a per-item update sampled with the
  lane's own tick generators, blocking only on the ticket shard that
  holds it: results are bitwise invariant to the expert's worker count
  and latency.  ``readiness_commits=True`` also commits lanes whose
  labels have already landed (commit age drops; state then depends on
  annotation latency).  ``commit_stats`` / ``commit_log`` record ages.
* ``expert_timeout`` / ``max_requeues`` — a shard that times out or
  whose worker died is requeued as a fresh submit, or past
  ``max_requeues`` dropped to the -1 sentinel (counted in
  ``fault_stats["dropped_annotations"]``; the lane's provisional answer
  stands).  ``autoscale=(lo, hi)`` sizes the expert's fleet off queue
  depth at each tick boundary (``fleet_log``).  ``reset`` closes the
  expert's pool.
* ``pipeline_depth=P`` — up to P ticks' level-0 forwards stay in flight
  (``submit_tick`` / ``resolve_tick`` / ``drain``) while the host
  resolves older ticks, with update and budget fences and a level-0
  refetch when a commit lands between dispatch and resolve
  (``pipeline_stats``): any P gives identical predictions, levels,
  expert calls and parameters.  On the card the level-0 inputs go up
  through pinned staging buffers and its (probs, dprob) come back
  through pinned host tensors fenced by an event (``transfer.py``), so
  neither stage waits for the whole stream.  Route passes and commits
  share the one current stream: a dispatched forward reads the
  parameters live at dispatch, as the reference promises, and the
  refetch covers a commit that lands in between.

Occupancy (``lanes=`` / ``stream_ids=`` / ``stream_ticks=``) — the
continuous-batching front-end (``core/admission.py``) serves requests of
their own lengths over the engine's fixed pool of ``n_streams`` lanes.
``process_tick`` / ``submit_tick`` then name the physical lane each tick
position occupies (strictly increasing; default ``arange(S)``, the
lockstep identity) and replace the position's RNG key ``(s, t)`` with
the stream's own ``(stream_ids[s], stream_ticks[s])``, so stream r's
j-th item draws ``tick_rngs(seed, r, j)`` whichever lane or global tick
serves it; per-tick cache sampling uses position 0's key.  Per-lane
accounting and the commit log go to the physical lanes, and each output
carries its ``"lanes"``.  The route itself is position-indexed and
unchanged, so the defaults are the lockstep engine bitwise.  An EMPTY
tick (S = 0) is legal: it advances ``t`` and the commit deadlines,
launches nothing and transfers nothing — the front-end's idle ticks keep
one clock over busy and idle time.

Live-state checkpoints (``save_state`` / ``restore_state``) write the
reference's format and tree (``repro_torch.checkpoint``; ``levels``,
``cache_x``, ``cache_y``, ``acct``, ``pending{i}``, the same metadata
keys and ``_CKPT_VERSION``), so a checkpoint written by either package
restores into the other.  A save needs the route ring drained (``run``
drains before each save) and resolves every uncommitted annotation
first, under the requeue and timeout rules, storing -1 where one was
dropped; each pending record keeps its cache generators' exact states,
caught partway through a per-lane record's commits.  A restore rebuilds
the rings on the engine's device, the host mirrors, the accounting, the
route-time beta recurrence, the commit / fault / fleet stats and the
pending records (with resolved tickets: a restored engine never needs
the expert pool to replay its commits), then bumps the state version.
The resumed run is bitwise the uninterrupted one from the checkpoint
tick on; ``run`` on a restored engine resumes at item ``t * S``.

Sanitizers (``repro_torch.analysis.sanitize``), as in the reference:
under ``determinism`` every resolved tick appends one record (routing,
per-lane RNG digests, ring mirrors, state digests) at the end of
``_route_resolve``, after the tick's due commits — a point of the
schedule that no worker count, pipeline depth or delay moves, so traces
of such runs compare tick by tick; ``reset`` and ``restore_state`` drop
it.  Under ``retrace`` the engine's route passes (``route_pass[i]``) and
its ring scatter (``cache_scatter``) are probed, beside the levels' own
steps.

Lane sharding (``mesh=``, a ``repro_torch.launch.mesh.Mesh``) — the
reference's single-controller model, run by hand: the cascade is one
shared policy, so its state (params, opt_state, dparams, dopt_state)
and the rings stay canonical on the mesh's first device, and every
update runs there over the gathered lanes, exactly the unmeshed
engine's computation.  Each dispatch's padded bucket of B rows splits
into the mesh's N lane shards (``sharding.lane_count``; contiguous rows
``[s·B/N, (s+1)·B/N)``), and shard s's route pass runs on its own device
(``sharding.lane_devices``) against its own replica of (params,
dparams), with pinned uploads and a ``HostPrefetch`` each; the outputs
come back to the host in lane order.  Every route pass goes through
that one function (``_queue_pass``): the level-0 dispatch, the walk, the
every-gate calibration forwards and the pipelined refetch.  One replica
is kept per shard, not per distinct device, so a stale replica shows on
the CPU too, where every shard is one device; the replicas follow the
canonical trees (updates, ``reset`` and ``restore_state`` replace them,
never write in place) and are refreshed in place after the commits of
each drain, after ``flush``, ``reset`` and ``restore_state``, and before
any route pass.  ``n_streams`` must divide by the lane count, and
``_bucket`` doubles from the lane count, so every bucket divides too.
``_Level.forwards`` / ``forwards_by_batch`` count one forward at the
global bucket per dispatch; the kernels' launch counters count each
shard's launch.  Checkpoints carry no mesh (``_fingerprint``): a meshed
engine's checkpoint restores into an unmeshed one and back.  Routing is
host-deterministic and each route pass is row-wise, so a meshed engine
routes as the unmeshed one on the same tick keys; parameters agree to
float tolerance (a shard's forward at B/N rows may round apart from the
same rows at B).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.checkpoint import (CheckpointError, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.cascade import (
    CascadeConfig, _Level, build_levels, check_fingerprint, make_history)
from repro_torch.core.deferral import reexploration_floor
from repro_torch.core.experts import (ExpertShardError, ExpertShardTimeout,
                                      ExpertTicket)
from repro_torch.core.rng import (generator_from_state, generator_state,
                                  sample_cache_indices, tick_rngs)
from repro_torch.device import DeviceLike, canonical_device, resolve_device
from repro_torch.sharding import (LaneGather, jit_route_pass, lane_count,
                                  lane_devices, on_device, put_lanes,
                                  put_replicated, refresh_replicas)
from repro_torch.transfer import HostPrefetch, PinnedStaging

# autoscale unit: target one worker per this many uncommitted deferred
# items (clipped into the configured [lo, hi] fleet bounds)
_AUTOSCALE_ITEMS_PER_WORKER = 4

# checkpoint schema version (save_state / restore_state), the reference's
_CKPT_VERSION = 1
# the per-lane accounting arrays (the checkpoint's "acct" subtree)
_ACCT = ("expert_calls", "total_cost", "level_counts", "items_seen", "J_cum")


def lanes_due(k: int, age: int, max_delay: int, per_lane: bool) -> int:
    """Cumulative count of a routed tick's k annotated lanes whose commit
    deadline has passed ``age`` ticks after routing: per-tick mode all k
    at age ``max_delay``, none before; per-lane mode ``floor(age * k /
    max_delay)``, everything at ``age >= max_delay``.  A pure function,
    so the commit schedule never depends on worker timing."""
    if age >= max_delay:
        return k
    if not per_lane or age <= 0:
        return 0
    return (age * k) // max_delay


def ring_scatter(cache_x: List[torch.Tensor], cache_y: List[torch.Tensor],
                 feats: List[np.ndarray], y_full: np.ndarray,
                 called: np.ndarray, ptr: List[int], upload):
    """Insert a tick's demonstrations into every level's ring, in place:
    the called lanes of the (S, ...) host rows ``feats[i]`` and labels
    ``y_full`` take consecutive slots after ``ptr[i]``, in lane order; if
    more lanes were called than a ring holds, only the last ``size``
    survive (the sequential FIFO's overwrite order).  ``upload`` moves a
    host array to the rings' device.  Its arguments have the reference's
    jitted scatter's shapes, which its retrace probe counts."""
    sel = np.flatnonzero(called)
    k = sel.size
    for i, (cx, cy) in enumerate(zip(cache_x, cache_y)):
        size = cx.shape[0]
        lo = max(k - size, 0)
        slots = upload((ptr[i] + np.arange(lo, k)) % size)
        cx.index_copy_(0, slots, upload(feats[i][sel[lo:]]))
        cy.index_copy_(0, slots, upload(y_full[sel[lo:]]))


@dataclass
class _PendingTick:
    """One routed tick whose expert annotations are still in flight: what
    the commit needs to replay the synchronous engine's update block once
    the labels land.  ``committed`` is the per-lane drain cursor (0 or k
    in per-tick mode)."""

    ticket: ExpertTicket
    t: int                        # tick this record was routed at
    called: np.ndarray            # (S,) bool — lanes annotated this tick
    sel_c: np.ndarray             # called lane indices
    feats: List[np.ndarray]       # per-level (S, ...) host feature rows
    probs: np.ndarray             # (nlev, S, C) route-time student probs
    dprob: np.ndarray             # (nlev, S) route-time deferral probs
    cache_rngs: list              # per-level np generators (lane-0 tick)
    committed: int = 0            # lanes already committed (prefix)
    lane_cache_rngs: Optional[list] = None   # per called lane, per level
    lanes: Optional[np.ndarray] = None  # physical lane per tick position
                                        # (occupancy ticks; None = arange)
    wall: float = 0.0             # wall-clock at submit (latency stats)
    idxs: Optional[list] = None   # stream indices of the called lanes
                                  # (what a failed shard is requeued as)
    docs_k: Optional[list] = None  # raw docs of the called lanes (None
                                   # after a restore: the ticket is
                                   # resolved, no requeue can happen)
    requeues: dict = field(default_factory=dict)  # shard lo -> retries


@dataclass
class _InFlightTick:
    """One tick between its dispatch (draws, jump mask, level-0 forward)
    and its resolve (the walk, the expert, the commits).  ``version`` is
    the engine's commit counter at dispatch: a commit in between makes
    the resolve refetch the level-0 forward."""

    t: int                        # tick number assigned at dispatch
    indices: List[int]            # per-lane stream indices
    docs: list                    # per-lane raw docs
    S: int                        # lanes in this tick (<= n_streams)
    jump: np.ndarray              # (nlev, S) bool DAgger jump mask
    u_act: np.ndarray             # (nlev, S) float32 sampled-action draws
    budget_ok: bool               # route-time budget gate (fence-stable)
    cache_rngs: list              # per-level cache-sampling generators
    feats_cache: list             # per-level lazily built feature rows
    sel0: np.ndarray              # lanes alive at level 0 (post-jump)
    xb0: Optional[np.ndarray]     # padded level-0 host feature batch
    handles: Optional[object]     # level-0 (probs, dprob), prefetching
                                  # (HostPrefetch, or LaneGather on a mesh)
    version: int                  # engine commit counter at dispatch
    beta_after: List[float]       # per-level beta after this tick's decay
    lane_cache: Optional[list] = None   # per-lane cache rngs (per_lane)
    lanes: Optional[np.ndarray] = None  # physical lane per tick position
                                        # (occupancy ticks; None = arange)
    u_jump_raw: Optional[np.ndarray] = None  # (nlev, S) raw jump draws,
                                             # kept only under the
                                             # determinism sanitizer


class BatchedCascadeEngine:
    """Lockstep multi-stream engine for Algorithm 1.

    ``process_tick(indices, docs)`` advances every lane by one item; lane
    s of tick t handles ``docs[s]``; a tick's deferred lanes go to the
    expert as one ``expert.submit_many(indices, docs)`` request.
    Pipelined serving goes through ``submit_tick`` / ``resolve_tick`` /
    ``drain``.  Runs on ``device`` (CUDA by default; ``device="cpu"``
    explicitly), or lane-sharded over ``mesh`` with its state on the
    mesh's first device (``device``, if given, must be that one).
    """

    def __init__(self, config: CascadeConfig, expert, n_streams: int = 64,
                 *, updates_per_tick: str = "single",
                 max_delay: int = 0, pipeline_depth: int = 0,
                 per_lane: bool = False,
                 history_limit: Optional[int] = None,
                 commit_log: Optional[bool] = None,
                 expert_timeout: Optional[float] = None,
                 max_requeues: int = 2,
                 autoscale: Optional[Tuple[int, int]] = None,
                 readiness_commits: bool = False,
                 device: DeviceLike = None, mesh=None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if updates_per_tick not in ("single", "scaled"):
            raise ValueError(
                f"updates_per_tick must be 'single' or 'scaled', "
                f"got {updates_per_tick!r}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        if pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth}")
        if expert_timeout is not None and expert_timeout <= 0:
            raise ValueError(
                f"expert_timeout must be > 0 (or None), got {expert_timeout}")
        if max_requeues < 0:
            raise ValueError(f"max_requeues must be >= 0, got {max_requeues}")
        # an expert constructed with workers="auto" opts into autoscaling
        # even when the engine caller didn't pass bounds
        if autoscale is None and getattr(expert, "auto_workers", False):
            autoscale = (1, 8)
        if autoscale is True:
            autoscale = (1, 8)
        if autoscale is not None:
            lo, hi = int(autoscale[0]), int(autoscale[1])
            if not (1 <= lo <= hi):
                raise ValueError(
                    f"autoscale bounds must satisfy 1 <= lo <= hi, "
                    f"got ({lo}, {hi})")
            autoscale = (lo, hi)
            if not hasattr(expert, "workers"):
                raise ValueError(
                    "autoscale requires an expert with a mutable "
                    "`workers` fleet width")
        self.mesh = mesh
        if mesh is not None:
            n_lane = lane_count(mesh)
            if n_lane < 1 or n_streams % n_lane:
                raise ValueError(
                    f"n_streams={n_streams} must be a positive multiple "
                    f"of the mesh's lane-device count {n_lane}")
            self.lane_devices = lane_devices(mesh)
            self.device = self.lane_devices[0]
            if device is not None and \
                    canonical_device(resolve_device(device)) != self.device:
                raise ValueError(
                    f"device={device} is not the mesh's first device "
                    f"{self.device}, which holds the engine's state")
            self._n_lane_devices = n_lane
        else:
            self.device = resolve_device(device)
            self.lane_devices = [self.device]
            self._n_lane_devices = 1
        self.cfg = config
        self.expert = expert
        self.n_streams = n_streams
        self.updates_per_tick = updates_per_tick
        self.max_delay = int(max_delay)
        self.pipeline_depth = int(pipeline_depth)
        self.per_lane = bool(per_lane)
        self.expert_timeout = expert_timeout
        self.max_requeues = int(max_requeues)
        self.autoscale = autoscale
        self.readiness_commits = bool(readiness_commits)
        if autoscale is not None:
            expert.workers = autoscale[0]
            # pools sized once take the upper bound so scaling up never
            # needs an executor rebuild (ModelExpert._pool_width)
            if getattr(expert, "max_workers", False) is None:
                expert.max_workers = autoscale[1]
        # identical construction to OnlineCascade (same initial state)
        self.levels: List[_Level] = build_levels(config, self.device)
        nlev = len(self.levels)
        self._bs_list = [min(lvl.spec.batch_size, lvl.spec.cache_size)
                         for lvl in self.levels]
        # the staged route passes and ring scatter, behind the retrace
        # sanitizer's probes (the functions themselves when it is off)
        self._route_pass = [
            _san.trace_probe(f"route_pass[{i}]", jit_route_pass(
                lvl.route_pass if mesh is None else lvl.shard_pass, mesh))
            for i, lvl in enumerate(self.levels)]
        self._scatter = _san.trace_probe("cache_scatter", ring_scatter)
        self._staging = PinnedStaging(self.device)
        if mesh is not None:
            # pinned uploads for each shard's device; per level, one
            # (params, dparams) replica a shard and the canonical trees
            # they were last copied from
            self._lane_staging = {d: PinnedStaging(d) for d in
                                  dict.fromkeys(self.lane_devices)}
            self._lane_staging[self.device] = self._staging
            self._replicas = [put_replicated((lvl.params, lvl.dparams), mesh)
                              for lvl in self.levels]
            self._replica_src = [(lvl.params, lvl.dparams)
                                 for lvl in self.levels]
        self._cache_x: List[torch.Tensor] = []
        self._cache_y: List[torch.Tensor] = []
        self._init_ring()
        self.t = 0
        S = n_streams
        self.expert_calls = np.zeros(S, np.int64)
        self.total_cost = np.zeros(S, np.float64)
        self.level_counts = np.zeros((S, nlev + 1), np.int64)
        self.items_seen = np.zeros(S, np.int64)
        self.J_cum = np.zeros(S, np.float64)
        self.history = make_history(history_limit)
        # routed ticks whose annotations are still in flight (at most
        # max_delay + 1 deep)
        self._pending: deque = deque()
        # per-lane annotation-commit accounting (ages in ticks, latencies
        # in seconds); commit_log records (submit_tick, lane, commit_tick)
        # per lane, on by default only with unbounded history
        self.commit_stats = {"lanes": 0, "age_sum": 0, "age_max": 0,
                             "wall_sum": 0.0}
        if commit_log is None:
            commit_log = history_limit is None
        self.commit_log: Optional[list] = [] if commit_log else None
        # route pipeline: dispatched-but-unresolved ticks, the route-time
        # beta / item recurrence, and the commit counter the staleness
        # check reads
        self._ring: deque = deque()
        self._route_beta: List[float] = [config.beta0] * nlev
        self._route_items = 0
        self._state_version = 0
        self.pipeline_stats = {"submitted": 0, "resolved": 0,
                               "refetches": 0, "update_fences": 0,
                               "budget_fences": 0}
        # every fault is either healed (requeues) or surrendered
        # (dropped_annotations) — never silent
        self.fault_stats = {"timeouts": 0, "worker_deaths": 0,
                            "requeues": 0, "dropped_annotations": 0,
                            "scale_ups": 0, "scale_downs": 0}
        self.fleet_log: List[Tuple[int, int]] = []   # (tick, new width)

    def _init_ring(self) -> None:
        """Device ring buffers (zeroed) + host mirrors of fill/ptr."""
        self._cache_x = [torch.from_numpy(lvl.cache_x).to(self.device)
                         for lvl in self.levels]
        self._cache_y = [torch.from_numpy(lvl.cache_y).to(self.device)
                         for lvl in self.levels]
        self._cache_n = [0] * len(self.levels)
        self._cache_ptr = [0] * len(self.levels)

    def reset(self):
        """Back to tick 0 of a fresh stream (in-flight ticks and pending
        annotations belong to the abandoned stream; the expert's pool is
        closed and rebuilt lazily on the next submit)."""
        for lvl in self.levels:
            lvl.reset()
        self._init_ring()
        self.t = 0
        for name in _ACCT:
            getattr(self, name)[:] = 0
        if self.history is not None:
            for v in self.history.values():
                v.clear()
        self._pending.clear()
        self._ring.clear()
        self._route_beta = [self.cfg.beta0] * len(self.levels)
        self._route_items = 0
        self._state_version += 1
        for k in self.pipeline_stats:
            self.pipeline_stats[k] = 0
        self.commit_stats = {"lanes": 0, "age_sum": 0, "age_max": 0,
                             "wall_sum": 0.0}
        if self.commit_log is not None:
            self.commit_log.clear()
        for k in self.fault_stats:
            self.fault_stats[k] = 0
        self.fleet_log.clear()
        if self.autoscale is not None:
            self.expert.workers = self.autoscale[0]
        self.close()
        self._sync_replicas()
        # a recorded determinism trace belongs to the old stream
        _san.drop_trace(self)

    def close(self) -> None:
        """Shut down the expert's worker pool, if it has one
        (idempotent; the pool is rebuilt lazily on the next submit)."""
        close = getattr(self.expert, "close", None)
        if close is not None:
            close()

    def __del__(self):  # best-effort: don't leak expert workers at GC
        try:
            self.close()
        except Exception:
            pass

    # -- aggregates -----------------------------------------------------
    @property
    def expert_calls_total(self) -> int:
        """Expert calls summed over lanes (resolved ticks only)."""
        return int(self.expert_calls.sum())

    def _budget_exhausted(self) -> bool:
        hb = self.cfg.hard_budget
        return hb is not None and self.expert_calls_total >= hb

    def _bucket(self, n: int) -> int:
        """Padded batch size for a subset of n lanes: the lane-device
        count doubled up to at least max(8, n), capped at n_streams, so
        every bucket divides by the lane count (non-power-of-two meshes
        too).  Without a mesh: powers of two from 8, and exactly 1 when
        S == 1 (the reference's per-item shape, which keeps S=1
        bitwise)."""
        b = self._n_lane_devices
        while b < max(8, n):
            b *= 2
        return min(b, self.n_streams)

    # -- lane sharding ---------------------------------------------------
    def _sync_replicas(self) -> None:
        """Copy each level's canonical (params, dparams) into every
        shard's replica, in place, where the canonical trees were
        replaced since the last copy (no-op without a mesh)."""
        if self.mesh is None:
            return
        for i, lvl in enumerate(self.levels):
            src = self._replica_src[i]
            if src[0] is lvl.params and src[1] is lvl.dparams:
                continue
            refresh_replicas(self._replicas[i], (lvl.params, lvl.dparams))
            self._replica_src[i] = (lvl.params, lvl.dparams)

    def _lane_upload(self, x: np.ndarray, device: torch.device):
        return self._lane_staging[device].upload(x)

    def _queue_pass(self, i: int, xb: np.ndarray):
        """Queue level i's route pass over the padded host batch ``xb``
        and the copy of its (probs, dprob) to the host; returns the
        handle whose ``result()`` is that host pair.  On a mesh, one
        pass per lane shard against the shard's replica, counted as one
        forward at the global batch."""
        lvl = self.levels[i]
        if self.mesh is None:
            return HostPrefetch(self._route_pass[i](
                lvl.params, lvl.dparams, self._staging.upload(xb)))
        self._sync_replicas()
        lvl._count_forward(xb.shape[0])
        reps = self._replicas[i]
        return LaneGather(self._route_pass[i](
            [r[0] for r in reps], [r[1] for r in reps],
            put_lanes(xb, self.mesh, upload=self._lane_upload)))

    # -- expert ---------------------------------------------------------
    def _expert_submit(self, idxs: Sequence[int], docs) -> ExpertTicket:
        """Enqueue a batch annotation: sharded (``submit_many``) where the
        expert has a pool, one request (``submit``) where it has only
        that, else resolved at once through ``label_batch``."""
        sub = getattr(self.expert, "submit_many", None)
        if sub is None:
            sub = getattr(self.expert, "submit", None)
        if sub is not None:
            return sub(idxs, docs)
        return ExpertTicket(labels=np.asarray(
            self.expert.label_batch(idxs, docs), np.int32))

    def _resolve_labels(self, rec: _PendingTick, lo: int,
                        hi: int) -> np.ndarray:
        """Labels for called items ``[lo, hi)`` of a pending record,
        surviving shard failures: ``expert_timeout`` bounds the wait on
        each shard; a failed shard is requeued, or past ``max_requeues``
        force-resolved to -1, so this always returns."""
        while True:
            try:
                return np.asarray(rec.ticket.result_slice(
                    lo, hi, timeout=self.expert_timeout), np.int32)
            except ExpertShardError as e:
                self._requeue_shard(rec, e)

    def _requeue_shard(self, rec: _PendingTick, err: ExpertShardError):
        k = rec.sel_c.size
        lo = err.lo
        hi = k if err.hi is None else err.hi
        if isinstance(err, ExpertShardTimeout):
            self.fault_stats["timeouts"] += 1
        else:
            self.fault_stats["worker_deaths"] += 1
        tries = rec.requeues.get(lo, 0)
        sub = getattr(self.expert, "submit", None)
        if tries < self.max_requeues and sub is not None:
            rec.requeues[lo] = tries + 1
            self.fault_stats["requeues"] += 1
            # the failed range as one fresh submit; not re-counted in
            # expert_calls (the annotation was costed at route time)
            rec.ticket.replace(lo, hi, sub(rec.idxs[lo:hi],
                                           rec.docs_k[lo:hi]))
        else:
            # graceful degradation: the provisional student answer
            # stands; the lost demonstration is counted, never silent
            rec.ticket.force_resolve(lo, hi,
                                     np.full(hi - lo, -1, np.int32))
            self.fault_stats["dropped_annotations"] += hi - lo

    # -- fleet autoscaling ----------------------------------------------
    def _autoscale_tick(self) -> None:
        """Queue-depth worker autoscaling at the tick boundary (dispatch
        time): the uncommitted deferred-item count is a pure function of
        the commit schedule, so two runs of one stream make identical
        decisions (``fleet_log``).  Width only changes future shard
        layouts, never labels."""
        lo, hi = self.autoscale
        depth = sum(r.sel_c.size - r.committed for r in self._pending)
        target = min(hi, max(lo, -(-depth // _AUTOSCALE_ITEMS_PER_WORKER)))
        cur = int(self.expert.workers)
        if target != cur:
            key = "scale_ups" if target > cur else "scale_downs"
            self.fault_stats[key] += 1
            self.expert.workers = target
            self.fleet_log.append((self.t, int(target)))

    # -- the tick -------------------------------------------------------
    def process_tick(self, indices: Sequence[int], docs, *,
                     lanes=None, stream_ids=None,
                     stream_ticks=None) -> dict:
        """Advance every lane by one item (dispatch and resolve back to
        back: the returned dict is this tick's own result).  len(docs)
        may be < n_streams on the final partial tick of a stream, and 0
        on an idle tick.  ``lanes`` / ``stream_ids`` / ``stream_ticks``
        are the occupancy arguments (module docstring).  Mixing it with
        ``submit_tick`` while ticks are in flight is an error."""
        if self._ring:
            raise RuntimeError(
                "route pipeline has in-flight ticks: resolve_tick()/"
                "drain() them first, or drive the engine entirely "
                "through submit_tick()")
        return self._route_resolve(self._route_dispatch(
            indices, docs, lanes=lanes, stream_ids=stream_ids,
            stream_ticks=stream_ticks))

    # -- pipelined route driver (stage A / stage B) ----------------------
    def submit_tick(self, indices: Sequence[int], docs, *,
                    lanes=None, stream_ids=None,
                    stream_ticks=None) -> List[dict]:
        """Dispatch one tick into the route pipeline (stage A); returns
        the output dicts of every tick the call resolved, oldest first:
        ring overflow past ``pipeline_depth``, plus ticks resolved early
        by a fence (a due commit, or a hard budget inside its ambiguous
        window)."""
        outs: List[dict] = []
        S = len(docs)
        hb = self.cfg.hard_budget
        if hb is not None and self._ring:
            resolved_calls = self.expert_calls_total
            in_flight = sum(r.S for r in self._ring)
            if resolved_calls < hb and resolved_calls + in_flight + S > hb:
                # ambiguous budget window: drain so the new tick's jump
                # gate reads the exact call count
                self.pipeline_stats["budget_fences"] += 1
                while self._ring:
                    outs.append(self._route_resolve(self._ring.popleft()))
        while self._ring and self._commit_due():
            # a commit is due while the ring drains: dispatching now is
            # guaranteed stale — resolve past the commit first
            self.pipeline_stats["update_fences"] += 1
            outs.append(self._route_resolve(self._ring.popleft()))
        self._ring.append(self._route_dispatch(
            indices, docs, lanes=lanes, stream_ids=stream_ids,
            stream_ticks=stream_ticks))
        while len(self._ring) > self.pipeline_depth:
            outs.append(self._route_resolve(self._ring.popleft()))
        return outs

    def _commit_due(self) -> bool:
        """True when the pending queue's head has lanes whose deadline
        falls at or before the end of the current tick."""
        if not self._pending:
            return False
        rec = self._pending[0]
        return lanes_due(rec.sel_c.size, self.t - rec.t, self.max_delay,
                         self.per_lane) > rec.committed

    def resolve_tick(self) -> Optional[dict]:
        """Resolve the oldest in-flight tick (stage B); None if empty."""
        if not self._ring:
            return None
        return self._route_resolve(self._ring.popleft())

    def drain(self) -> List[dict]:
        """Resolve every in-flight tick, oldest first."""
        outs = []
        while self._ring:
            outs.append(self._route_resolve(self._ring.popleft()))
        return outs

    def _dispatch_level(self, i: int, fi: np.ndarray, sel: np.ndarray):
        """Pad the gathered lane subset ``fi[sel]`` to its bucket and queue
        the level-i route pass (no host sync).  Returns the handle of its
        (probs, dprob) host pair and the padded host batch (kept for a
        refetch).  Shared by the level-0 dispatch, the walk and the
        every-gate calibration forwards so the pad/bucket rule cannot
        drift."""
        B = self._bucket(sel.size)
        xb = np.zeros((B,) + fi.shape[1:], fi.dtype)
        xb[:sel.size] = fi[sel]
        return self._queue_pass(i, xb), xb

    def _route_dispatch(self, indices: Sequence[int], docs, *,
                        lanes=None, stream_ids=None,
                        stream_ticks=None) -> _InFlightTick:
        """Stage A: draws, masks, the route-time beta recurrence, and the
        level-0 forward with its outputs' copy to the host started.  The
        occupancy arguments only change which physical lane each position
        accounts to and which (stream, tick) key seeds its draws."""
        cfg = self.cfg
        nlev = len(self.levels)
        S = len(docs)
        if S > self.n_streams:
            raise ValueError(f"tick of {S} items > n_streams={self.n_streams}")
        if lanes is not None:
            lanes = np.asarray(lanes, np.int64)
            if lanes.shape != (S,):
                raise ValueError(
                    f"lanes must have one entry per tick position: "
                    f"got shape {lanes.shape} for a tick of {S}")
            if S and (lanes[0] < 0 or lanes[-1] >= self.n_streams
                      or np.any(np.diff(lanes) <= 0)):
                raise ValueError(
                    "lanes must be strictly increasing physical lane ids "
                    f"in [0, n_streams={self.n_streams})")
        if stream_ids is not None and len(stream_ids) != S:
            raise ValueError("stream_ids must have one entry per position")
        if stream_ticks is not None and len(stream_ticks) != S:
            raise ValueError("stream_ticks must have one entry per position")
        self.t += 1
        t = self.t
        self.pipeline_stats["submitted"] += 1
        if self.autoscale is not None:
            self._autoscale_tick()
        feats_cache: list = [None] * nlev
        u_jump = np.empty((nlev, S))
        u_act = np.empty((nlev, S), np.float32)
        cache_rngs = None
        # per-lane commits sample each lane's cache mini-batch with the
        # lane's own tick generators; per-tick mode needs only lane 0's
        lane_cache = [] if self.per_lane else None
        for s in range(S):
            # an admitted stream keeps its own (stream id, local tick)
            # key whichever lane or global tick serves it
            sid = s if stream_ids is None else int(stream_ids[s])
            lt = t if stream_ticks is None else int(stream_ticks[s])
            r = tick_rngs(cfg.seed, sid, lt, nlev)
            u_jump[:, s] = r.jump.random(nlev)
            u_act[:, s] = r.action.random(nlev).astype(np.float32)
            if lane_cache is not None:
                lane_cache.append(r.cache)
            if s == 0:
                cache_rngs = r.cache

        budget_ok = not self._budget_exhausted()
        jump = (u_jump < np.array(self._route_beta)[:, None]) & budget_ok

        # level 0's gather mask (lanes that did not jump) is known before
        # any dprob returns: queue its forward and the copy of its
        # outputs to the host now (an empty tick launches nothing: a
        # zero-sized grid is a CUDA launch error)
        sel0 = np.flatnonzero(~jump[0])
        xb0 = None
        handles = None
        if sel0.size:
            fi = np.stack([self.levels[0].featurize(d) for d in docs])
            feats_cache[0] = fi
            handles, xb0 = self._dispatch_level(0, fi, sel0)

        # beta decays per consumed ITEM (decay^S per tick); the
        # re-exploration floor applies once per tick at the post-tick
        # item count.  Deterministic in items seen, so it advances here
        # and ``lvl.beta`` is synced to it when the tick resolves
        self._route_items += S
        for i, lvl in enumerate(self.levels):
            self._route_beta[i] = max(
                self._route_beta[i] * lvl.spec.beta_decay ** S,
                reexploration_floor(lvl.spec.beta_floor, self._route_items))

        return _InFlightTick(
            t=t, indices=[int(i) for i in indices], docs=list(docs), S=S,
            jump=jump, u_act=u_act, budget_ok=budget_ok,
            cache_rngs=cache_rngs, feats_cache=feats_cache, sel0=sel0,
            xb0=xb0, handles=handles, version=self._state_version,
            beta_after=list(self._route_beta), lane_cache=lane_cache,
            lanes=lanes,
            u_jump_raw=u_jump if _san.determinism_on() else None)

    def _route_resolve(self, rec: _InFlightTick) -> dict:
        """Stage B: the vectorised walk, the expert submit, due commits,
        accounting — the unpipelined op sequence for tick ``rec.t``."""
        cfg = self.cfg
        nlev = len(self.levels)
        S = rec.S
        t = rec.t
        docs = rec.docs
        feats_cache = rec.feats_cache
        self.pipeline_stats["resolved"] += 1

        def feats(i):
            if feats_cache[i] is None:
                feats_cache[i] = np.stack(
                    [self.levels[i].featurize(d) for d in docs])
            return feats_cache[i]

        handles = rec.handles
        if handles is not None and rec.version != self._state_version:
            # a commit landed after this tick's dispatch: the level-0
            # forward read pre-update params; rerun it on the committed
            # state (the featurized batch is reused)
            self.pipeline_stats["refetches"] += 1
            handles = self._queue_pass(0, rec.xb0)

        alive = np.ones(S, bool)            # walking, not yet exited
        jumped = np.zeros(S, bool)
        eval_mask = np.zeros((nlev, S), bool)
        dprob_h = np.zeros((nlev, S), np.float32)
        probs_h = np.zeros((nlev, S, cfg.n_classes), np.float32)
        predictions = np.zeros(S, np.int64)
        exit_level = np.full(S, nlev, np.int64)   # nlev = reached expert
        for i in range(nlev):
            jumped |= alive & rec.jump[i]
            alive &= ~rec.jump[i]
            sel = np.flatnonzero(alive)
            if sel.size == 0:
                continue
            if i == 0:
                # dispatched at stage A (sel == rec.sel0: same jump mask)
                probs_np, dprob_np = handles.result()
            else:
                probs_np, dprob_np = self._dispatch_level(
                    i, feats(i), sel)[0].result()
            probs_np = probs_np[:sel.size]
            dprob_np = dprob_np[:sel.size]
            eval_mask[i, sel] = True
            dprob_h[i, sel] = dprob_np
            probs_h[i, sel] = probs_np
            if cfg.sample_actions:
                defer_np = rec.u_act[i, sel] < dprob_np
            else:
                defer_np = dprob_np > 0.5
            if not rec.budget_ok and i == nlev - 1:
                defer_np[:] = False     # budget gate: cannot reach expert
            take = sel[~defer_np]
            predictions[take] = np.argmax(probs_np[~defer_np], axis=-1)
            exit_level[take] = i
            alive[take] = False

        want = jumped | alive               # deferred past the last level
        level_costs = np.array([lvl.spec.cost for lvl in self.levels])
        cost_h = eval_mask.T @ level_costs  # sum of evaluated level costs

        # hard budget at tick granularity: the first `remaining` lanes win
        called = want.copy()
        hb = cfg.hard_budget
        if hb is not None:
            remaining = max(hb - self.expert_calls_total, 0)
            if int(called.sum()) > remaining:
                called[np.flatnonzero(called)[remaining:]] = False
        overflow = want & ~called
        last = self.levels[-1]
        for s in np.flatnonzero(overflow):
            # budget overflow: the last student answers (a lane that
            # jumped too), costed as an evaluation of the last level
            x = self._staging.upload(feats(nlev - 1)[s])
            with on_device(self.device):
                predictions[s] = int(np.argmax(
                    last._predict(last, last.params, x).cpu().numpy()))

        levels_out = np.where(called, nlev,
                              np.where(overflow, nlev - 1, exit_level))
        cost_out = (cost_h + np.where(called, cfg.expert_cost, 0.0)
                    + np.where(overflow, last.spec.cost, 0.0))

        y_full = np.zeros(S, np.int32)
        resolved = False
        if called.any():
            sel_c = np.flatnonzero(called)

            # the commit only reads the called lanes' rows, so levels the
            # route never featurized hash just those k docs
            def scatter_feats(i):
                if feats_cache[i] is not None:
                    return feats_cache[i]
                lvl = self.levels[i]
                arr = np.zeros((S,) + lvl.cache_x.shape[1:],
                               lvl.cache_x.dtype)
                for s in sel_c:
                    arr[s] = lvl.featurize(docs[s])
                feats_cache[i] = arr
                return arr

            # every annotated lane calibrates EVERY gate: levels the walk
            # never evaluated for a called lane get probs / dprob against
            # the tick's pre-update students (also what the deferred
            # lanes' provisional answers read)
            for i in range(nlev):
                missing = np.flatnonzero(called & ~eval_mask[i])
                if missing.size == 0:
                    continue
                probs_np, dprob_np = self._dispatch_level(
                    i, scatter_feats(i), missing)[0].result()
                probs_h[i, missing] = probs_np[:missing.size]
                dprob_h[i, missing] = dprob_np[:missing.size]

            idxs_c = [rec.indices[s] for s in sel_c]
            docs_c = [docs[s] for s in sel_c]
            prec = _PendingTick(
                ticket=self._expert_submit(idxs_c, docs_c), t=t,
                called=called.copy(), sel_c=sel_c,
                feats=[scatter_feats(i) for i in range(nlev)],
                probs=probs_h, dprob=dprob_h, cache_rngs=rec.cache_rngs,
                lane_cache_rngs=([rec.lane_cache[s] for s in sel_c]
                                 if self.per_lane else None),
                lanes=rec.lanes, wall=time.time(), idxs=idxs_c,
                docs_k=docs_c)
            if self.max_delay == 0:
                # synchronous: resolve inline; -1 marks an annotation
                # dropped past max_requeues, whose lane keeps the last
                # student's answer
                y_lab = self._resolve_labels(prec, 0, sel_c.size)
                y_full[sel_c] = y_lab
                predictions[sel_c] = np.where(
                    y_lab >= 0, y_lab,
                    np.argmax(probs_h[nlev - 1, sel_c], axis=-1))
                resolved = True
            else:
                # deferred lanes answer provisionally with the last
                # student's prediction (the calibration forwards' probs)
                predictions[sel_c] = np.argmax(
                    probs_h[nlev - 1, sel_c], axis=-1)
            self._pending.append(prec)
        # bounded annotation delay, in ticks: a record routed at tick u
        # commits by the end of tick u + max_delay even if no later tick
        # calls the expert (per-lane mode on the finer lanes_due schedule)
        self._drain_due(t)

        for lvl, b in zip(self.levels, rec.beta_after):
            lvl.beta = b

        # per-stream accounting, at the physical lanes this tick occupied
        lanes = np.arange(S) if rec.lanes is None else rec.lanes
        J_t = cfg.mu * cost_out
        self.expert_calls[lanes] += called.astype(np.int64)
        self.total_cost[lanes] += cost_out
        self.level_counts[lanes, levels_out] += 1
        self.items_seen[lanes] += 1
        self.J_cum[lanes] += J_t
        if self.history is not None:
            self.history["level"].append(levels_out.copy())
            self.history["pred"].append(predictions.astype(np.int64))
            self.history["expert_called"].append(called.copy())
            self.history["cost"].append(cost_out.copy())
            self.history["J"].append(J_t.copy())
        if _san.determinism_on() and rec.u_jump_raw is not None:
            # one record per resolved tick, after its due commits: traces
            # of any worker count, pipeline depth or delay line up
            _san.record_tick(
                self, t=t, level=levels_out, called=called,
                pred=predictions, u_jump=rec.u_jump_raw, u_act=rec.u_act,
                cache_n=self._cache_n, cache_ptr=self._cache_ptr,
                levels=self.levels)
        return {
            "indices": np.asarray(rec.indices, np.int64),
            "tick": t,
            # physical lane per position (the identity without lanes=)
            "lanes": lanes.copy(),
            "predictions": predictions.astype(np.int64),
            "levels": levels_out,
            "expert_called": called,
            "cost_units": cost_out,
            # annotations still in flight (max_delay >= 1) report -1
            "expert_labels": (np.where(called, y_full,
                                       np.int32(-1)).astype(np.int32)
                              if resolved else np.full(S, -1, np.int32)),
        }

    # -- commit: apply routed ticks' landed annotations ------------------
    def _drain_due(self, t: int) -> None:
        """Commit every annotation whose deadline has passed by the end of
        tick ``t``, in strict (submit-tick, lane) order: the head record
        drains to its ``lanes_due`` cursor (or, with readiness commits,
        its landed prefix), and the drain moves on only once the head is
        fully committed."""
        while self._pending:
            rec = self._pending[0]
            k = rec.sel_c.size
            due = lanes_due(k, t - rec.t, self.max_delay, self.per_lane)
            if self.readiness_commits and due < k:
                due = max(due, self._ready_count(rec))
            if due > rec.committed:
                if self.per_lane:
                    for j in range(rec.committed, due):
                        self._commit_lane(rec, j, t)
                else:
                    self._commit(rec, t)
            if rec.committed < k:
                break
            self._pending.popleft()
        self._sync_replicas()

    def _ready_count(self, rec: _PendingTick) -> int:
        """Lanes of the head record whose annotations have landed: per
        lane the contiguous ready prefix from the cursor, per tick all or
        nothing.  A hung shard never reports ready."""
        k = rec.sel_c.size
        if not self.per_lane:
            return k if rec.ticket.done() else 0
        j = rec.committed
        while j < k and rec.ticket.item_done(j):
            j += 1
        return j

    def _record_commit(self, rec: _PendingTick, lanes, t: int) -> None:
        """Aggregate per-lane commit age / latency (and the commit log).
        ``lanes`` are tick positions; the log records the physical lane
        each occupied at submit, so the front-end can map a commit back
        to the stream that held that lane at ``rec.t``."""
        n = len(lanes)
        self.commit_stats["lanes"] += n
        self.commit_stats["age_sum"] += n * (t - rec.t)
        self.commit_stats["age_max"] = max(self.commit_stats["age_max"],
                                           t - rec.t)
        self.commit_stats["wall_sum"] += n * (time.time() - rec.wall)
        if self.commit_log is not None:
            phys = (lanes if rec.lanes is None
                    else [rec.lanes[int(s)] for s in lanes])
            self.commit_log.extend((rec.t, int(s), t) for s in phys)

    def _advance_ring(self, k: int, rngs: list) -> list:
        """Host fill / ptr mirrors after inserting k demonstrations, and
        each level's mini-batch indices over the post-insert fill, drawn
        from ``rngs`` (sampling sees the post-insert fill level)."""
        idx_t = []
        for i, lvl in enumerate(self.levels):
            size = lvl.spec.cache_size
            self._cache_n[i] = min(self._cache_n[i] + k, size)
            self._cache_ptr[i] = (self._cache_ptr[i] + k) % size
            idx_t.append(self._staging.upload(sample_cache_indices(
                rngs[i], self._cache_n[i],
                self._bs_list[i]).astype(np.int64)))
        return idx_t

    def _commit(self, rec: _PendingTick, t: Optional[int] = None) -> None:
        """Apply a routed tick's annotations: ring-buffer scatter plus the
        per-tick weighted student / deferral updates, sampling with the
        tick's own cache generators.  Lanes whose annotation was dropped
        (-1) add no demonstration and carry zero update weight."""
        cfg = self.cfg
        nlev = len(self.levels)
        sel_c = rec.sel_c
        k = sel_c.size
        y_sel = self._resolve_labels(rec, 0, k)
        ok = y_sel >= 0
        k_ok = int(ok.sum())
        if k_ok == 0:
            rec.committed = k
            return
        S = rec.called.shape[0]
        sel_ok = sel_c[ok]
        called_ok = np.zeros(S, bool)
        called_ok[sel_ok] = True
        y_full = np.zeros(S, np.int32)
        y_full[sel_c] = np.maximum(y_sel, 0)
        ptr_pre = list(self._cache_ptr)
        idx_t = self._advance_ring(k_ok, rec.cache_rngs)
        self._scatter(self._cache_x, self._cache_y, rec.feats, y_full,
                      called_ok, ptr_pre, self._staging.upload)

        # reach[l] = prod_{k<l} dprob[k], float32 left fold like the
        # sequential reference's running product
        reach = np.ones((nlev, S), np.float32)
        for i in range(1, nlev):
            reach[i] = reach[i - 1] * rec.dprob[i - 1]
        k_arr = (torch.full((), float(k_ok), dtype=torch.float32,
                            device=self.device)
                 if self.updates_per_tick == "scaled" and k_ok > 1 else None)
        B_c = self._bucket(k)
        for i, lvl in enumerate(self.levels):
            xb = self._cache_x[i][idx_t[i]]
            yb = self._cache_y[i][idx_t[i]]
            w = torch.ones((self._bs_list[i],), dtype=torch.float32,
                           device=self.device)
            lvl.apply_student_update(xb, yb, w, k_arr)
            probs_b = np.zeros((B_c, cfg.n_classes), np.float32)
            probs_b[:k] = rec.probs[i, sel_c]
            y_b = np.zeros(B_c, np.int32)
            y_b[:k] = np.maximum(y_sel, 0)
            reach_b = np.zeros(B_c, np.float32)
            reach_b[:k] = reach[i, sel_c]
            w_b = np.zeros(B_c, np.float32)
            w_b[:k] = ok.astype(np.float32)
            up = self._staging.upload
            lvl.apply_deferral_update(up(probs_b), up(y_b), up(reach_b),
                                      up(w_b), k_arr)
        rec.committed = k
        self._record_commit(rec, sel_ok, self.t if t is None else t)
        # params changed: a route forward dispatched before this commit
        # is stale (the resolve refetches it)
        self._state_version += 1

    def _commit_lane(self, rec: _PendingTick, j: int, t: int) -> None:
        """Apply ONE lane's landed annotation (per-lane commit mode): the
        sequential reference's per-item update block for called lane
        ``sel_c[j]`` — a single-demonstration ring insert, one student
        step on a mini-batch sampled with the lane's own tick generators,
        and a single-item deferral update.  Blocks only on the ticket
        shard holding item ``j``."""
        cfg = self.cfg
        s = int(rec.sel_c[j])
        y = self._resolve_labels(rec, j, j + 1)
        if y[0] < 0:
            # annotation dropped past max_requeues: no demonstration
            rec.committed = j + 1
            return
        S = rec.called.shape[0]
        called_one = np.zeros(S, bool)
        called_one[s] = True
        y_full = np.zeros(S, np.int32)
        y_full[s] = y[0]
        ptr_pre = list(self._cache_ptr)
        rngs = rec.lane_cache_rngs[j]
        idx_t = self._advance_ring(1, rngs)
        self._scatter(self._cache_x, self._cache_y, rec.feats, y_full,
                      called_one, ptr_pre, self._staging.upload)
        reach = np.float32(1.0)
        B_c = self._bucket(1)
        for i, lvl in enumerate(self.levels):
            xb = self._cache_x[i][idx_t[i]]
            yb = self._cache_y[i][idx_t[i]]
            w = torch.ones((self._bs_list[i],), dtype=torch.float32,
                           device=self.device)
            lvl.apply_student_update(xb, yb, w)
            probs_b = np.zeros((B_c, cfg.n_classes), np.float32)
            probs_b[0] = rec.probs[i, s]
            y_b = np.zeros(B_c, np.int32)
            y_b[0] = y[0]
            reach_b = np.zeros(B_c, np.float32)
            reach_b[0] = reach
            w_b = np.zeros(B_c, np.float32)
            w_b[0] = 1.0
            up = self._staging.upload
            lvl.apply_deferral_update(up(probs_b), up(y_b), up(reach_b),
                                      up(w_b))
            reach = np.float32(reach * np.float32(rec.dprob[i, s]))
        rec.committed = j + 1
        self._record_commit(rec, [s], t)
        self._state_version += 1

    def flush(self) -> int:
        """Drain the deferred-annotation queue (blocking); returns the
        number of ticks committed.  The route ring must be empty first
        (``drain()``): committing while ticks are in flight would land
        updates out of FIFO tick order."""
        if self._ring:
            raise RuntimeError(
                "route pipeline has in-flight ticks: drain() them "
                "(and consume their outputs) before flush()")
        n = 0
        while self._pending:
            rec = self._pending.popleft()
            if self.per_lane:
                for j in range(rec.committed, rec.sel_c.size):
                    self._commit_lane(rec, j, self.t)
            else:
                self._commit(rec, self.t)
            n += 1
        self._sync_replicas()
        return n

    # -- live-state checkpoints -------------------------------------------
    def _fingerprint(self) -> dict:
        """Config facts a checkpoint must agree on to be restorable."""
        return {
            "engine": "batched", "ckpt_version": _CKPT_VERSION,
            "n_streams": self.n_streams, "n_levels": len(self.levels),
            "max_delay": self.max_delay, "per_lane": self.per_lane,
            "updates_per_tick": self.updates_per_tick,
            "seed": self.cfg.seed, "n_classes": self.cfg.n_classes,
        }

    def save_state(self, path: str) -> str:
        """Checkpoint the engine's full live state mid-stream: per-level
        STATE_ATTRS and betas, the rings, per-lane accounting, the
        route-time beta / item recurrence, commit / pipeline / fault /
        fleet stats, and the pending annotation queue with each record's
        exact cache-generator states.  Uncommitted annotations are
        resolved here (blocking, under the requeue / timeout rules; -1
        where one was dropped), so the checkpoint never holds an
        unresolvable ticket.  The route ring must be drained first."""
        if self._ring:
            raise RuntimeError(
                "route pipeline has in-flight ticks: drain() them "
                "(and consume their outputs) before save_state()")
        tree = {
            "levels": [lvl.state_tree() for lvl in self.levels],
            "cache_x": list(self._cache_x),
            "cache_y": list(self._cache_y),
            "acct": {name: getattr(self, name) for name in _ACCT},
        }
        pending_meta = []
        for r_i, rec in enumerate(self._pending):
            k = rec.sel_c.size
            labels = np.full(k, -1, np.int32)
            if rec.committed < k:
                labels[rec.committed:] = self._resolve_labels(
                    rec, rec.committed, k)
            entry = {
                "called": rec.called, "sel_c": rec.sel_c,
                "labels": labels, "probs": rec.probs, "dprob": rec.dprob,
                "feats": list(rec.feats),
                "idxs": np.asarray(rec.idxs or [], np.int64),
            }
            if rec.lanes is not None:
                entry["lanes"] = rec.lanes
            tree[f"pending{r_i}"] = entry
            pending_meta.append({
                "t": rec.t, "committed": rec.committed,
                "has_lanes": rec.lanes is not None,
                "requeues": {str(lo): n for lo, n in rec.requeues.items()},
                "cache_rngs": [generator_state(g) for g in rec.cache_rngs],
                "lane_cache_rngs": (
                    [[generator_state(g) for g in lane]
                     for lane in rec.lane_cache_rngs]
                    if rec.lane_cache_rngs is not None else None),
            })
        meta = {
            **self._fingerprint(),
            "t": self.t,
            "beta": [float(lvl.beta) for lvl in self.levels],
            "cache_n": list(self._cache_n),
            "cache_ptr": list(self._cache_ptr),
            "route_beta": [float(b) for b in self._route_beta],
            "route_items": self._route_items,
            "commit_stats": dict(self.commit_stats),
            "commit_log": ([list(e) for e in self.commit_log]
                           if self.commit_log is not None else None),
            "pipeline_stats": dict(self.pipeline_stats),
            "fault_stats": dict(self.fault_stats),
            "fleet_log": [list(e) for e in self.fleet_log],
            "n_pending": len(self._pending),
            "pending": pending_meta,
        }
        return save_checkpoint(path, tree, meta)

    def _ring_from(self, arrays, cur: List[torch.Tensor],
                   name: str) -> List[torch.Tensor]:
        """Checkpointed ring buffers on the engine's device, each checked
        against the engine's own ring."""
        out = []
        for i, (a, c) in enumerate(zip(arrays, cur)):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if tuple(t.shape) != tuple(c.shape) or t.dtype != c.dtype:
                raise CheckpointError(
                    f"checkpoint {name}[{i}] is {t.dtype}{tuple(t.shape)}, "
                    f"the engine's ring {c.dtype}{tuple(c.shape)}")
            out.append(t.to(self.device))
        return out

    def restore_state(self, path: str) -> None:
        """Restore a ``save_state`` checkpoint (of either package) into
        this freshly built, same-config engine, on its device; raises
        ``CheckpointError`` on a config mismatch.  The resumed run is
        bitwise the uninterrupted one from the checkpoint tick on."""
        tree, meta = restore_checkpoint(path)
        check_fingerprint(meta, self._fingerprint())
        for lvl, st, b in zip(self.levels, tree["levels"], meta["beta"]):
            lvl.load_state_tree(st)
            lvl.beta = float(b)
        self._cache_x = self._ring_from(tree["cache_x"], self._cache_x,
                                        "cache_x")
        self._cache_y = self._ring_from(tree["cache_y"], self._cache_y,
                                        "cache_y")
        self._cache_n = [int(v) for v in meta["cache_n"]]
        self._cache_ptr = [int(v) for v in meta["cache_ptr"]]
        for name in _ACCT:
            getattr(self, name)[:] = np.asarray(tree["acct"][name])
        self.t = int(meta["t"])
        self._route_beta = [float(b) for b in meta["route_beta"]]
        self._route_items = int(meta["route_items"])
        cs = meta["commit_stats"]
        self.commit_stats = {"lanes": int(cs["lanes"]),
                             "age_sum": int(cs["age_sum"]),
                             "age_max": int(cs.get("age_max", 0)),
                             "wall_sum": float(cs["wall_sum"])}
        self.commit_log = ([tuple(e) for e in meta["commit_log"]]
                           if meta["commit_log"] is not None else None)
        self.pipeline_stats = {k: int(v)
                               for k, v in meta["pipeline_stats"].items()}
        self.fault_stats = {k: int(v)
                            for k, v in meta["fault_stats"].items()}
        self.fleet_log = [tuple(int(x) for x in e)
                          for e in meta["fleet_log"]]
        self._pending.clear()
        for r_i, pm in enumerate(meta["pending"]):
            pt = tree[f"pending{r_i}"]
            self._pending.append(_PendingTick(
                # resolved at save time (-1 where dropped): the restored
                # record never needs the docs or the pool for a requeue
                ticket=ExpertTicket(
                    labels=np.asarray(pt["labels"], np.int32)),
                t=int(pm["t"]),
                called=np.asarray(pt["called"], bool),
                sel_c=np.asarray(pt["sel_c"], np.int64),
                feats=[np.asarray(f) for f in pt["feats"]],
                probs=np.asarray(pt["probs"], np.float32),
                dprob=np.asarray(pt["dprob"], np.float32),
                cache_rngs=[generator_from_state(g)
                            for g in pm["cache_rngs"]],
                committed=int(pm["committed"]),
                lane_cache_rngs=(
                    [[generator_from_state(g) for g in lane]
                     for lane in pm["lane_cache_rngs"]]
                    if pm["lane_cache_rngs"] is not None else None),
                lanes=(np.asarray(pt["lanes"], np.int64)
                       if pm["has_lanes"] else None),
                wall=time.time(),
                idxs=[int(i) for i in np.asarray(pt["idxs"])],
                docs_k=None,
                requeues={int(lo): int(n)
                          for lo, n in pm["requeues"].items()}))
        # restored params invalidate anything dispatched before
        self._state_version += 1
        self._sync_replicas()
        _san.drop_trace(self)

    # -- per-stream metrics ---------------------------------------------
    def stream_metrics(self) -> dict:
        """Independent per-lane accounting (S rows each)."""
        seen = np.maximum(self.items_seen, 1)[:, None]
        return {
            "expert_calls": self.expert_calls.copy(),
            "items_seen": self.items_seen.copy(),
            "level_fractions": self.level_counts / seen,
            "total_cost_units": self.total_cost.copy(),
            "J_cum": self.J_cum.copy(),
        }

    def run(self, stream, log_every: int = 0, checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None) -> dict:
        """Serve an entire stream, tick-major: tick T covers items
        [T*S, T*S + S) with lane s = offset; with ``pipeline_depth >= 1``
        through ``submit_tick`` / ``drain`` (results mapped back through
        each output's "indices"), then ``flush``.  Returns
        OnlineCascade-style summary metrics plus throughput and per-stream
        accounting.

        ``checkpoint_every=k`` saves live state to ``checkpoint_path``
        every k ticks (draining the route ring first).  On an engine that
        holds restored state, serving resumes at item ``self.t * S``, and
        accuracy and items/s cover the items this call served."""
        S = self.n_streams
        n = len(stream)
        preds = np.zeros(n, np.int32)
        done = 0                      # items with results already landed
        first = self.t * S            # 0 on a fresh engine; the resume
                                      # point on a restored one

        def take(out):
            nonlocal done
            idxs = out["indices"]
            preds[idxs] = out["predictions"]
            done = max(done, int(idxs.max()) + 1) if idxs.size else done

        t0 = time.time()
        for start in range(first, n, S):
            stop = min(start + S, n)
            idxs = list(range(start, stop))
            docs = [stream.docs[i] for i in idxs]
            if self.pipeline_depth:
                for out in self.submit_tick(idxs, docs):
                    take(out)
            else:
                take(self.process_tick(idxs, docs))
            if (log_every and done
                    and (stop // log_every) > (start // log_every)):
                lo = min(first, done)
                acc = float(np.mean(preds[lo:done]
                                    == stream.labels[lo:done]))
                print(f"[{done}/{n}] acc={acc:.4f} "
                      f"expert_calls={self.expert_calls_total}")
            if (checkpoint_every and checkpoint_path
                    and self.t % checkpoint_every == 0 and stop < n):
                for out in self.drain():
                    take(out)
                self.save_state(checkpoint_path)
        for out in self.drain():
            take(out)
        self.flush()
        dt = time.time() - t0
        return {
            "accuracy": float(np.mean(preds[first:]
                                      == stream.labels[first:])),
            "expert_calls": self.expert_calls_total,
            "total_cost_units": float(self.total_cost.sum()),
            "level_fractions": (self.level_counts.sum(axis=0)
                                / max(n, 1)).tolist(),
            "predictions": preds,
            "items_per_sec": (n - first) / max(dt, 1e-9),
            "per_stream": self.stream_metrics(),
        }
