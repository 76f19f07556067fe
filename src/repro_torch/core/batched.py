"""Batched multi-stream cascade engine, base form (port of
``repro.core.batched``).

``BatchedCascadeEngine`` runs S stream lanes in lockstep.  Each tick:

  route pass — the cascade walk is vectorised: per-item control flow
    becomes boolean lane masks (jumped / alive / took), and each level's
    predict + defer runs once, batched over the gathered subset of lanes
    still alive there, padded to a bucketed size (powers of two from 8,
    capped at S).  On a CUDA device the upper levels' forwards launch the
    hand-written kernels (flash / decode attention, SSD scan).
  expert call — the deferred subset goes to the expert as one batch.
  commit — the tick's demonstrations are scattered into per-level ring
    buffers on the device (in-place ``index_copy_``, the reference's
    donated jitted scatter), then one weighted student step and one
    weighted deferral step per level, through the same ``_Level`` update
    methods the sequential ``OnlineCascade`` uses.

RNG follows ``core.rng``: lane s at tick t draws from the children of
``SeedSequence((seed, s, t))``; cache sampling uses the lane-0 children.
With ``n_streams == 1`` the engine therefore runs exactly the torch ops
``OnlineCascade`` runs, in the same order — bit-for-bit equal results.
At S > 1 the reference's documented deviations hold: one weighted update
per tick (``updates_per_tick="scaled"`` lr-scales it by the tick's k
demonstrations via ``Optimizer.step_k``), beta decays per consumed item
(decay ** S per tick), the hard expert budget is enforced at tick
granularity (the first ``remaining`` deferred lanes, in lane order, get
the expert; the rest fall back to the last student's prediction, counted
and costed as last-level exits), and annotations land in the ring in
lane order.  Under ``sample_actions`` every lane draws its float32 action
uniforms from its tick's ``action`` generator, and a lane defers where
its draw is below the gate's probability.

The base form commits every tick synchronously (the reference's
``max_delay=0``, ``pipeline_depth=0``, per-tick commits, no mesh).  The
async expert queue, route pipelining, per-lane commits, lane sharding,
fault requeues, autoscaling, admission and checkpoints are not ported
yet (ROADMAP).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cascade import (
    CascadeConfig, _Level, build_levels, make_history)
from repro_torch.core.deferral import reexploration_floor
from repro_torch.core.rng import sample_cache_indices, tick_rngs
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class _PendingTick:
    """One routed tick's expert annotations, ready to commit: the called
    lanes' feature rows per level, the route-time probs / dprob of every
    level (gate calibration inputs), and the tick's own cache-sampling
    generators."""

    called: np.ndarray            # (S,) bool — lanes annotated this tick
    sel_c: np.ndarray             # called lane indices
    labels: np.ndarray            # (k,) expert labels of sel_c
    feats: List[np.ndarray]       # per-level (S, ...) host feature rows
    probs: np.ndarray             # (nlev, S, C) route-time student probs
    dprob: np.ndarray             # (nlev, S) route-time deferral probs
    cache_rngs: list              # per-level np generators (lane-0 tick)
    wall: float = 0.0             # wall-clock at submit (latency stats)


@dataclass
class _InFlightTick:
    """One tick between its dispatch (draws, jump mask, level-0 forward)
    and its resolve (the walk, the expert, the commit)."""

    t: int                        # tick number assigned at dispatch
    indices: List[int]            # per-lane stream indices
    docs: list                    # per-lane raw docs
    S: int                        # lanes in this tick (<= n_streams)
    jump: np.ndarray              # (nlev, S) bool DAgger jump mask
    u_act: np.ndarray             # (nlev, S) float32 sampled-action draws
    budget_ok: bool               # route-time hard-budget gate
    cache_rngs: list              # per-level cache-sampling generators
    feats_cache: list             # per-level lazily built feature rows
    handles: Optional[tuple]      # level-0 (probs, dprob) device pair
    beta_after: List[float]       # per-level beta after this tick's decay


class BatchedCascadeEngine:
    """Lockstep multi-stream engine for Algorithm 1.

    ``process_tick(indices, docs)`` advances every lane by one item; lane
    s of tick t handles ``docs[s]``; a tick's deferred lanes go to the
    expert as one ``expert.submit_many(indices, docs)`` request.
    Runs on ``device`` (CUDA by default; ``device="cpu"`` explicitly).
    """

    def __init__(self, config: CascadeConfig, expert, n_streams: int = 64,
                 updates_per_tick: str = "single",
                 history_limit: Optional[int] = None,
                 device: DeviceLike = None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if updates_per_tick not in ("single", "scaled"):
            raise ValueError(
                f"updates_per_tick must be 'single' or 'scaled', "
                f"got {updates_per_tick!r}")
        self.device = resolve_device(device)
        self.cfg = config
        self.expert = expert
        self.n_streams = n_streams
        self.updates_per_tick = updates_per_tick
        # identical construction to OnlineCascade (same initial state)
        self.levels: List[_Level] = build_levels(config, self.device)
        nlev = len(self.levels)
        self._bs_list = [min(lvl.spec.batch_size, lvl.spec.cache_size)
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
        self.commit_stats = {"lanes": 0, "age_sum": 0, "wall_sum": 0.0}
        self._beta: List[float] = [config.beta0] * nlev
        self._items = 0

    def _init_ring(self) -> None:
        """Device ring buffers (zeroed) + host mirrors of fill/ptr."""
        self._cache_x = [torch.from_numpy(lvl.cache_x).to(self.device)
                         for lvl in self.levels]
        self._cache_y = [torch.from_numpy(lvl.cache_y).to(self.device)
                         for lvl in self.levels]
        self._cache_n = [0] * len(self.levels)
        self._cache_ptr = [0] * len(self.levels)

    def reset(self):
        """Back to tick 0 of a fresh stream."""
        for lvl in self.levels:
            lvl.reset()
        self._init_ring()
        self.t = 0
        self.expert_calls[:] = 0
        self.total_cost[:] = 0
        self.level_counts[:] = 0
        self.items_seen[:] = 0
        self.J_cum[:] = 0
        if self.history is not None:
            for v in self.history.values():
                v.clear()
        self.commit_stats = {"lanes": 0, "age_sum": 0, "wall_sum": 0.0}
        self._beta = [self.cfg.beta0] * len(self.levels)
        self._items = 0

    def close(self) -> None:
        """Shut down the expert's worker pool, if it has one
        (idempotent; the pool is rebuilt lazily on the next submit)."""
        close = getattr(self.expert, "close", None)
        if close is not None:
            close()

    # -- aggregates -----------------------------------------------------
    @property
    def expert_calls_total(self) -> int:
        """Expert calls summed over lanes."""
        return int(self.expert_calls.sum())

    def _budget_exhausted(self) -> bool:
        hb = self.cfg.hard_budget
        return hb is not None and self.expert_calls_total >= hb

    def _bucket(self, n: int) -> int:
        """Padded batch size for a subset of n lanes: powers of two from 8
        up to at least n, capped at n_streams (exactly 1 when S == 1 —
        the reference's per-item shape, which keeps S=1 bitwise)."""
        b = 1
        while b < max(8, n):
            b *= 2
        return min(b, self.n_streams)

    # -- the tick -------------------------------------------------------
    def process_tick(self, indices: Sequence[int], docs) -> dict:
        """Advance every lane by one item.  len(docs) may be < n_streams
        on the final partial tick of a stream."""
        return self._route_resolve(self._route_dispatch(indices, docs))

    def _dispatch_level(self, i: int, fi: np.ndarray, sel: np.ndarray):
        """Pad the gathered lane subset ``fi[sel]`` to its bucket and run
        the level-i route pass; returns the (probs, dprob) device pair.
        Shared by the level-0 dispatch, the walk, and the every-gate
        calibration forwards so the pad/bucket rule cannot drift."""
        lvl = self.levels[i]
        B = self._bucket(sel.size)
        xb = np.zeros((B,) + fi.shape[1:], fi.dtype)
        xb[:sel.size] = fi[sel]
        return lvl.route_pass(lvl.params, lvl.dparams,
                              torch.from_numpy(xb).to(self.device))

    def _route_dispatch(self, indices: Sequence[int],
                        docs) -> _InFlightTick:
        """Draws, masks, the beta schedule, and the level-0 forward."""
        cfg = self.cfg
        nlev = len(self.levels)
        S = len(docs)
        if S > self.n_streams:
            raise ValueError(f"tick of {S} items > n_streams={self.n_streams}")
        self.t += 1
        t = self.t
        feats_cache: list = [None] * nlev
        u_jump = np.empty((nlev, S))
        u_act = np.empty((nlev, S), np.float32)
        cache_rngs = None
        for s in range(S):
            r = tick_rngs(cfg.seed, s, t, nlev)
            u_jump[:, s] = r.jump.random(nlev)
            u_act[:, s] = r.action.random(nlev).astype(np.float32)
            if s == 0:
                cache_rngs = r.cache

        budget_ok = not self._budget_exhausted()
        jump = (u_jump < np.array(self._beta)[:, None]) & budget_ok

        # level 0's gather mask (lanes that did not jump) is known before
        # any dprob returns: launch its forward now
        sel0 = np.flatnonzero(~jump[0])
        handles = None
        if sel0.size:
            fi = np.stack([self.levels[0].featurize(d) for d in docs])
            feats_cache[0] = fi
            handles = self._dispatch_level(0, fi, sel0)

        # beta decays per consumed ITEM (decay^S per tick); the
        # re-exploration floor applies once per tick at the post-tick
        # item count
        self._items += S
        for i, lvl in enumerate(self.levels):
            self._beta[i] = max(
                self._beta[i] * lvl.spec.beta_decay ** S,
                reexploration_floor(lvl.spec.beta_floor, self._items))

        return _InFlightTick(
            t=t, indices=[int(i) for i in indices], docs=list(docs), S=S,
            jump=jump, u_act=u_act, budget_ok=budget_ok,
            cache_rngs=cache_rngs, feats_cache=feats_cache,
            handles=handles, beta_after=list(self._beta))

    def _route_resolve(self, rec: _InFlightTick) -> dict:
        """The vectorised walk, the expert call, the commit, accounting."""
        cfg = self.cfg
        nlev = len(self.levels)
        S = rec.S
        docs = rec.docs
        feats_cache = rec.feats_cache

        def feats(i):
            if feats_cache[i] is None:
                feats_cache[i] = np.stack(
                    [self.levels[i].featurize(d) for d in docs])
            return feats_cache[i]

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
                probs_d, dprob_d = rec.handles
            else:
                probs_d, dprob_d = self._dispatch_level(i, feats(i), sel)
            probs_np = probs_d.cpu().numpy()[:sel.size]
            dprob_np = dprob_d.cpu().numpy()[:sel.size]
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
            x = torch.from_numpy(feats(nlev - 1)[s]).to(self.device)
            predictions[s] = int(np.argmax(
                last.predict(last.params, x).cpu().numpy()))

        levels_out = np.where(called, nlev,
                              np.where(overflow, nlev - 1, exit_level))
        cost_out = (cost_h + np.where(called, cfg.expert_cost, 0.0)
                    + np.where(overflow, last.spec.cost, 0.0))

        y_full = np.zeros(S, np.int32)
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
            # the tick's pre-update students
            for i in range(nlev):
                missing = np.flatnonzero(called & ~eval_mask[i])
                if missing.size == 0:
                    continue
                probs_d, dprob_d = self._dispatch_level(
                    i, scatter_feats(i), missing)
                probs_h[i, missing] = probs_d.cpu().numpy()[:missing.size]
                dprob_h[i, missing] = dprob_d.cpu().numpy()[:missing.size]

            wall = time.time()
            ticket = self.expert.submit_many([rec.indices[s] for s in sel_c],
                                             [docs[s] for s in sel_c])
            y_lab = np.asarray(ticket.result(), np.int32)
            y_full[sel_c] = y_lab
            predictions[sel_c] = y_lab
            self._commit(_PendingTick(
                called=called, sel_c=sel_c, labels=y_lab,
                feats=[scatter_feats(i) for i in range(nlev)],
                probs=probs_h, dprob=dprob_h, cache_rngs=rec.cache_rngs,
                wall=wall))

        for lvl, b in zip(self.levels, rec.beta_after):
            lvl.beta = b

        J_t = cfg.mu * cost_out
        self.expert_calls[:S] += called.astype(np.int64)
        self.total_cost[:S] += cost_out
        self.level_counts[np.arange(S), levels_out] += 1
        self.items_seen[:S] += 1
        self.J_cum[:S] += J_t
        if self.history is not None:
            self.history["level"].append(levels_out.copy())
            self.history["pred"].append(predictions.astype(np.int64))
            self.history["expert_called"].append(called.copy())
            self.history["cost"].append(cost_out.copy())
            self.history["J"].append(J_t.copy())
        return {
            "indices": np.asarray(rec.indices, np.int64),
            "tick": rec.t,
            "predictions": predictions.astype(np.int64),
            "levels": levels_out,
            "expert_called": called,
            "cost_units": cost_out,
            "expert_labels": np.where(called, y_full,
                                      np.int32(-1)).astype(np.int32),
        }

    # -- commit ---------------------------------------------------------
    def _commit(self, rec: _PendingTick) -> None:
        """Apply a tick's annotations: ring-buffer scatter plus the
        per-tick weighted student / deferral updates, sampling with the
        tick's own cache generators."""
        cfg = self.cfg
        dev = self.device
        nlev = len(self.levels)
        sel_c = rec.sel_c
        k = sel_c.size
        S = rec.called.shape[0]

        # host mirrors first: sampling sees the post-insert fill level
        ptr_pre = list(self._cache_ptr)
        idx_t = []
        for i, lvl in enumerate(self.levels):
            size = lvl.spec.cache_size
            self._cache_n[i] = min(self._cache_n[i] + k, size)
            self._cache_ptr[i] = (self._cache_ptr[i] + k) % size
            idx_t.append(torch.from_numpy(sample_cache_indices(
                rec.cache_rngs[i], self._cache_n[i],
                self._bs_list[i]).astype(np.int64)).to(dev))

        # ring-buffer insert: called lanes take consecutive slots after
        # ptr, in lane order; if k > size only the last `size` survive
        # (the sequential FIFO's overwrite order)
        order = np.arange(k)
        for i, lvl in enumerate(self.levels):
            size = lvl.spec.cache_size
            keep = order >= k - size
            slots = torch.from_numpy(
                (ptr_pre[i] + order[keep]) % size).to(dev)
            rows = np.ascontiguousarray(rec.feats[i][sel_c[keep]])
            ys = np.ascontiguousarray(rec.labels[keep])
            self._cache_x[i].index_copy_(0, slots,
                                         torch.from_numpy(rows).to(dev))
            self._cache_y[i].index_copy_(0, slots,
                                         torch.from_numpy(ys).to(dev))

        # reach[l] = prod_{k<l} dprob[k], float32 left fold like the
        # sequential reference's running product
        reach = np.ones((nlev, S), np.float32)
        for i in range(1, nlev):
            reach[i] = reach[i - 1] * rec.dprob[i - 1]
        k_arr = (torch.tensor(float(k), dtype=torch.float32, device=dev)
                 if self.updates_per_tick == "scaled" and k > 1 else None)
        B_c = self._bucket(k)
        for i, lvl in enumerate(self.levels):
            xb = self._cache_x[i][idx_t[i]]
            yb = self._cache_y[i][idx_t[i]]
            w = torch.ones((self._bs_list[i],), dtype=torch.float32,
                           device=dev)
            lvl.apply_student_update(xb, yb, w, k_arr)
            probs_b = np.zeros((B_c, cfg.n_classes), np.float32)
            probs_b[:k] = rec.probs[i, sel_c]
            y_b = np.zeros(B_c, np.int32)
            y_b[:k] = rec.labels
            reach_b = np.zeros(B_c, np.float32)
            reach_b[:k] = reach[i, sel_c]
            w_b = np.zeros(B_c, np.float32)
            w_b[:k] = 1.0
            lvl.apply_deferral_update(
                torch.from_numpy(probs_b).to(dev),
                torch.from_numpy(y_b).to(dev),
                torch.from_numpy(reach_b).to(dev),
                torch.from_numpy(w_b).to(dev), k_arr)
        # commits are synchronous in the base form: annotation age 0
        self.commit_stats["lanes"] += k
        self.commit_stats["wall_sum"] += k * (time.time() - rec.wall)

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

    def run(self, stream, log_every: int = 0) -> dict:
        """Serve an entire stream, tick-major: tick T covers items
        [T*S, T*S + S) with lane s = offset.  Returns OnlineCascade-style
        summary metrics plus throughput and per-stream accounting."""
        S = self.n_streams
        n = len(stream)
        preds = np.zeros(n, np.int32)
        t0 = time.time()
        for start in range(0, n, S):
            stop = min(start + S, n)
            idxs = list(range(start, stop))
            out = self.process_tick(idxs, [stream.docs[i] for i in idxs])
            preds[idxs] = out["predictions"]
            if log_every and (stop // log_every) > (start // log_every):
                acc = float(np.mean(preds[:stop] == stream.labels[:stop]))
                print(f"[{stop}/{n}] acc={acc:.4f} "
                      f"expert_calls={self.expert_calls_total}")
        dt = time.time() - t0
        return {
            "accuracy": float(np.mean(preds == stream.labels)),
            "expert_calls": self.expert_calls_total,
            "total_cost_units": float(self.total_cost.sum()),
            "level_fractions": (self.level_counts.sum(axis=0)
                                / max(n, 1)).tolist(),
            "predictions": preds,
            "items_per_sec": n / max(dt, 1e-9),
            "per_stream": self.stream_metrics(),
        }
