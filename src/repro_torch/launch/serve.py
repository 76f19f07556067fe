"""Streaming cascade server on the PyTorch port (port of
``repro.launch.serve``, the flags of the ported slices).

Two engines:

* ``--engine batched`` (default): ``BatchedCascadeEngine`` serves S
  concurrent stream lanes in lockstep — per-level batched forwards over
  the gathered alive subset, one batched expert call per tick, per-tick
  weighted updates — with the engine matrix: ``--async-delay`` (the
  async expert queue), ``--pipeline-depth`` (pipelined route passes),
  ``--expert-workers`` / ``--expert-backend`` (the expert pool),
  ``--per-lane-commit``, ``--expert-timeout`` (fault requeues) and
  ``--autoscale`` (the expert fleet); live-state checkpoints
  (``--checkpoint-every`` / ``--checkpoint-path``, ``--restore``); and
  the continuous-batching front-end (``--arrivals lockstep|poisson|
  burst`` over a pool of ``--lane-budget`` lanes, ``--admission queue|
  shed``, ``--queue-limit``, ``--arrival-rate``, ``--request-len``,
  ``--burst-size``), which reports time-to-answer p50 / p99, occupancy,
  shed requests and goodput.
* ``--engine sequential``: the per-item Algorithm-1 loop
  (``OnlineCascade``), with micro-batched expert calls via a probe/replay
  pass.

Sanitizers (``repro_torch.analysis.sanitize``, either engine):
``--sanitize determinism,locks,retrace`` serves under the named runtime
sanitizers, enabled before the engine is built, and reports on them
after the run; ``--trace-out PATH`` writes the determinism trace as
JSON-lines, which ``Trace.load`` / ``diff_traces`` of either package
read.

Ladders: ``--ladder default`` is the paper's ``lr -> tinytf`` (dense
students); ``kernel`` is ``lr -> tinytf_flash -> ssm`` at the default
widths, whose upper levels launch the CUDA kernels; ``kernel-ci`` is the
same ladder at the CI widths.  Experts: ``--expert model`` (the default)
trains a ``tinytf`` stand-in LLM on the stream's ground truth before
serving; ``--expert simulated`` replays the stream's precomputed
noisy-teacher labels.  Runs on the CUDA card unless ``--device cpu`` is
given; the device is checked before the expert is trained.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --dataset imdb \
      --samples 2048 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --expert simulated \
      --samples 320 --batch 16 --async-delay 2 --expert-workers 4 \
      --per-lane-commit --pipeline-depth 2
  PYTHONPATH=src python -m repro_torch.launch.serve --ladder kernel \
      --expert simulated --dataset imdb --samples 2048 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --ladder kernel \
      --expert simulated --dataset imdb --samples 2048 --batch 64 \
      --arrivals poisson --arrival-rate 8 --request-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --expert simulated \
      --samples 320 --batch 16 --checkpoint-every 8 \
      --checkpoint-path build/live     # then the same with --restore build/live
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --ladder kernel-ci --expert simulated --samples 64 --batch 8 \
      --sanitize determinism --trace-out build/a.jsonl
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.analysis import sanitize as _san
from repro_torch.core import (BatchedCascadeEngine, CascadeFrontEnd,
                              OnlineCascade, SimulatedExpert,
                              default_cascade_config, kernel_cascade_config,
                              train_model_expert)
from repro_torch.core.rng import tick_rngs
from repro_torch.data import arrival_schedule, make_stream
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models.kernel_students import TINY_SSM_CI, TINY_TF_CI

LADDERS = ("default", "kernel", "kernel-ci")
ARRIVALS = ("none", "lockstep", "poisson", "burst")


def _ladder_config(ladder: str, n_classes: int, mu: float, seed: int,
                   expert_cost: float):
    if ladder not in LADDERS:
        raise ValueError(f"unknown ladder {ladder!r} ({' | '.join(LADDERS)})")
    if ladder == "default":
        return default_cascade_config(n_classes=n_classes, mu=mu, seed=seed,
                                      expert_cost=expert_cost)
    spec_kw = ({"tf_flash_spec": TINY_TF_CI, "ssm_spec": TINY_SSM_CI}
               if ladder == "kernel-ci" else {})
    return kernel_cascade_config(n_classes=n_classes, mu=mu, seed=seed,
                                 expert_cost=expert_cost, **spec_kw)


def _make_expert(stream, n_classes: int, expert_kind: str, samples: int,
                 seed: int, device, workers=1, backend: str = "thread"):
    """The expert and its training seconds (0 for the simulated one)."""
    if expert_kind == "model":
        print("training stand-in LLM expert ...", flush=True)
        t0 = time.time()
        expert = train_model_expert(stream, n_classes, epochs=2,
                                    max_samples=min(4000, samples),
                                    seed=seed, workers=workers,
                                    backend=backend, device=device)
        sync(expert.device)
        dt = time.time() - t0
        print(f"expert trained in {dt:.1f}s", flush=True)
        return expert, dt
    if expert_kind != "simulated":
        raise ValueError(f"unknown expert {expert_kind!r} "
                         "(model | simulated)")
    if backend != "thread":
        print(f"(simulated expert ignores --expert-backend {backend}: "
              "table lookups need no process pool)")
    return SimulatedExpert(stream, "gpt-3.5-turbo", workers=workers), 0.0


def parse_autoscale(spec: str):
    """Parse ``--autoscale``: '' -> None, 'auto' -> (1, 8), 'LO:HI' ->
    (LO, HI).  The engine scales the expert pool within these bounds off
    queue depth, deterministically at tick boundaries."""
    if not spec:
        return None
    if spec == "auto":
        return (1, 8)
    lo, _, hi = spec.partition(":")
    try:
        return (int(lo), int(hi))
    except ValueError:
        raise SystemExit(
            f"--autoscale expects 'auto' or 'LO:HI', got {spec!r}")


class _BatchProxy:
    """Expert proxy serving precomputed labels to the cascade during the
    replay pass of a micro-batch; falls back to a single expert call when
    the routing probe mispredicted (rare: post-update gate flips)."""

    def __init__(self, expert):
        self.expert = expert
        self.cost = expert.cost
        self.table = {}
        self.fallback_calls = 0

    def label(self, idx: int, doc) -> int:
        """Serve item ``idx``'s precomputed label (or fall back live)."""
        if idx in self.table:
            return int(self.table[idx])
        self.fallback_calls += 1
        return int(self.expert.label(idx, doc))


def probe_route(cascade: OnlineCascade, doc, tick: int) -> bool:
    """Predict whether processing ``doc`` at ``tick`` would consult the
    expert, WITHOUT mutating the learned state.  The per-tick pre-split
    RNG discipline (core.rng) lets the probe reproduce the exact DAgger
    jump draws — and, under ``cfg.sample_actions``, the exact
    sampled-action draws — that the replay pass will see.  Its forwards
    are real and count in the levels' ``forwards``."""
    cfg = cascade.cfg
    n_levels = len(cascade.levels)
    rngs = tick_rngs(cfg.seed, cascade.stream_id, tick, n_levels)
    u_jump = rngs.jump.random(n_levels)
    u_act = rngs.action.random(n_levels) if cfg.sample_actions else None
    for i, lvl in enumerate(cascade.levels):
        if not cascade._budget_exhausted() and u_jump[i] < lvl.beta:
            return True                      # DAgger jump
        _, dprob = cascade._predict_and_defer(i, lvl.featurize(doc))
        if cfg.sample_actions:
            # float32 comparison, identical to OnlineCascade.process
            defer = float(np.float32(u_act[i])) < dprob
        else:
            defer = dprob > 0.5
        if cascade._budget_exhausted() and i == n_levels - 1:
            defer = False
        if not defer:
            return False
    return True


def _report(metrics: dict, n: int, dt: float, lanes: str,
            served: int = None) -> None:
    """``n`` items in the stream, ``served`` of them by this call (fewer
    after a restore; expert calls and level fractions cover all n)."""
    served = n if served is None else served
    frac = metrics["expert_calls"] / n
    print(f"\nserved {served} queries in {dt:.1f}s "
          f"({served / max(dt, 1e-9):.0f} items/s, {lanes})")
    print(f"accuracy={metrics['accuracy']:.4f}  "
          f"expert_calls={metrics['expert_calls']} "
          f"({frac:.1%} of stream)  cost_saving={1-frac:.1%}")
    print(f"level fractions: "
          f"{[round(float(f), 3) for f in metrics['level_fractions']]}")


def _save_trace(engine, trace_out: str) -> None:
    """Write the engine's determinism trace to ``trace_out``, if both
    exist.  Two runs' saved traces (``--expert-workers 1`` against ``4``,
    ``--pipeline-depth 0`` against ``2``, the card against the CPU, or
    either package's engine) feed ``Trace.load`` / ``diff_traces`` for a
    first-divergence report at (tick, lane, level, attr) granularity."""
    if not trace_out:
        return
    tr = _san.trace_of(engine)
    if tr is None:
        print("--trace-out set but no determinism trace was recorded "
              "(enable with --sanitize determinism)")
        return
    tr.save(trace_out)
    print(f"determinism trace: {len(tr)} tick record(s) -> {trace_out}")


def _sanitizer_reports(modes) -> None:
    """Post-run reports of the enabled runtime sanitizers."""
    if "retrace" in modes:
        rep = _san.retrace_report()
        print(f"retrace sanitizer: {sum(rep.values())} signature(s) across "
              f"{len(rep)} staged function(s): {dict(sorted(rep.items()))}")
        flagged = _san.retrace_check(limit=16)
        for name, n in sorted(flagged.items()):
            print(f"  UNEXPECTED RETRACES: {name} saw {n} signatures — a "
                  "shape/dtype is leaking into its signature")
    if "locks" in modes:
        violations = _san.lock_order_violations()
        print(f"lock sanitizer: clean run, "
              f"{len(violations)} order violation(s)")
        for v in violations:
            print(f"  {v}")


def _serve_frontend(engine, stream, arrivals: str, *, admission: str,
                    queue_limit: int, arrival_rate: float,
                    request_len: int, burst_size: int, seed: int,
                    trace_out: str = "") -> dict:
    """The continuous-batching path: a seeded arrival schedule through
    the admission front-end, with a per-stream latency report.  Returns
    the front-end's ``metrics()`` plus accuracy over the served items,
    wall seconds, goodput and the front-end (``"frontend"``)."""
    if arrivals == "lockstep":
        kw = {"n_lanes": engine.n_streams}
    elif arrivals == "poisson":
        kw = {"rate": arrival_rate, "mean_len": request_len, "seed": seed}
    else:
        kw = {"burst": burst_size, "mean_len": request_len, "seed": seed,
              "every": max(1, int(round(burst_size / arrival_rate)))}
    requests = arrival_schedule(arrivals, len(stream), **kw)
    fe = CascadeFrontEnd(engine, stream, admission=admission,
                         queue_limit=queue_limit)
    t0 = time.time()
    fe.serve(requests)
    sync(engine.device)
    dt = time.time() - t0
    _save_trace(engine, trace_out)
    m = fe.metrics()
    served = m["predictions"] >= 0
    acc = (float(np.mean(m["predictions"][served]
                         == stream.labels[served]))
           if served.any() else 0.0)
    cs = engine.commit_stats
    goodput = m["items_done"] / max(dt, 1e-9)
    print(f"\nserved {m['items_done']} items of {m['requests']} "
          f"requests in {dt:.1f}s over {m['ticks']} ticks "
          f"(arrivals={arrivals}, lanes={engine.n_streams}, "
          f"admission={admission}, device={engine.device})")
    print(f"answered={m['answered']} shed={m['shed']}  "
          f"goodput={goodput:.0f} items/s  "
          f"occupancy={m['occupancy_mean']:.2f}/{engine.n_streams} "
          f"(idle ticks={m['idle_ticks']})")
    print(f"time-to-answer p50={m['tta_p50']:.0f} "
          f"p99={m['tta_p99']:.0f} ticks  "
          f"mean queue delay={m['queue_delay_mean']:.2f} ticks")
    if cs["lanes"]:
        print(f"annotation commits: {cs['lanes']} lanes, "
              f"mean age {cs['age_sum'] / cs['lanes']:.2f} ticks")
    print(f"accuracy={acc:.4f} over served items  "
          f"expert_calls={engine.expert_calls_total}")
    m.update(accuracy=acc, wall_s=dt, goodput=goodput,
             expert_calls=engine.expert_calls_total, frontend=fe)
    return m


def serve_stream_batched(dataset: str, samples: int, mu: float,
                         batch: int = 64, expert_kind: str = "model",
                         seed: int = 0, log_every: int = 500,
                         updates_per_tick: str = "single",
                         ladder: str = "default",
                         device: DeviceLike = None, async_delay: int = 0,
                         pipeline_depth: int = 0, expert_workers: int = 1,
                         per_lane: bool = False,
                         expert_backend: str = "thread",
                         expert_timeout=None, autoscale=None,
                         arrivals: str = "none", lane_budget: int = 0,
                         admission: str = "queue", queue_limit: int = 0,
                         arrival_rate: float = 1.0, request_len: int = 8,
                         burst_size: int = 8, checkpoint_every: int = 0,
                         checkpoint_path: str = "", restore: str = "",
                         trace_out: str = ""):
    """Default serving path: the batched multi-stream engine, with the
    engine matrix's options (``async_delay`` = the engine's
    ``max_delay``; ``autoscale`` = (lo, hi) fleet bounds, the expert
    built with ``workers="auto"``).  ``checkpoint_every`` saves live
    state to ``checkpoint_path`` every that many ticks, and ``restore``
    resumes from such a checkpoint at its tick.  ``arrivals`` other than
    "none" serves a seeded arrival schedule through the admission
    front-end over a pool of ``lane_budget`` lanes (default ``batch``)
    under ``admission`` "queue" or "shed" (``queue_limit``).
    ``trace_out`` writes the determinism trace (``--sanitize
    determinism``) after the run.  Returns the
    engine's ``run`` metrics (or, with arrivals, the front-end's) plus
    the engine itself (``"engine"``: its levels' forward counts,
    per-stream accounting, its expert, its pipeline / commit / fault
    stats) and the expert's training seconds (``"expert_train_s"``)."""
    if arrivals not in ARRIVALS:
        raise ValueError(f"unknown arrivals {arrivals!r} "
                         f"({' | '.join(ARRIVALS)})")
    dev = resolve_device(device)
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert, train_s = _make_expert(
        stream, stream.spec.n_classes, expert_kind, samples, seed, dev,
        workers="auto" if autoscale else expert_workers,
        backend=expert_backend)
    cfg = _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                         expert.cost)
    # history_limit=0: serving reads only aggregate metrics; the
    # front-end keeps the commit log, which its per-stream records read
    engine = BatchedCascadeEngine(cfg, expert,
                                  n_streams=lane_budget or batch,
                                  updates_per_tick=updates_per_tick,
                                  max_delay=async_delay,
                                  pipeline_depth=pipeline_depth,
                                  per_lane=per_lane, history_limit=0,
                                  commit_log=arrivals != "none" or None,
                                  expert_timeout=expert_timeout,
                                  autoscale=autoscale, device=dev)
    if restore:
        engine.restore_state(restore)
        print(f"restored live state from {restore} (resuming at tick "
              f"{engine.t}, item {engine.t * engine.n_streams})")
    first = engine.t * engine.n_streams
    t0 = time.time()
    try:
        if arrivals != "none":
            metrics = _serve_frontend(
                engine, stream, arrivals, admission=admission,
                queue_limit=queue_limit, arrival_rate=arrival_rate,
                request_len=request_len, burst_size=burst_size, seed=seed,
                trace_out=trace_out)
            metrics["engine"] = engine
            metrics["expert_train_s"] = train_s
            return metrics
        metrics = engine.run(stream, log_every=log_every,
                             checkpoint_every=checkpoint_every,
                             checkpoint_path=checkpoint_path or None)
    finally:
        engine.close()
    sync(dev)
    dt = time.time() - t0
    _save_trace(engine, trace_out)
    lanes = (f"batch={batch} ladder={ladder} expert={expert_kind} "
             f"device={dev}")
    if async_delay:
        lanes += f" async_delay={async_delay}"
    if pipeline_depth:
        st = engine.pipeline_stats
        lanes += (f" pipeline_depth={pipeline_depth} "
                  f"(refetches={st['refetches']} "
                  f"fences={st['update_fences'] + st['budget_fences']})")
    if expert_workers > 1 or per_lane:
        lanes += (f" expert_workers={expert_workers}"
                  f" commit={'lane' if per_lane else 'tick'}")
    cs = engine.commit_stats
    if cs["lanes"]:
        print(f"annotation commits: {cs['lanes']} lanes, "
              f"mean age {cs['age_sum'] / cs['lanes']:.2f} ticks "
              f"(max {cs['age_max']}), "
              f"mean latency {cs['wall_sum'] / cs['lanes'] * 1e3:.1f} ms")
    if pipeline_depth:
        print(f"pipeline stats: {engine.pipeline_stats}")
    fs = engine.fault_stats
    if any(fs.values()):
        print(f"fault stats: timeouts={fs['timeouts']} "
              f"worker_deaths={fs['worker_deaths']} "
              f"requeues={fs['requeues']} "
              f"dropped_annotations={fs['dropped_annotations']} "
              f"fleet resizes={len(engine.fleet_log)} "
              f"(final width {engine.expert.workers})")
    if checkpoint_every and checkpoint_path:
        lanes += f" checkpoint_every={checkpoint_every}"
    _report(metrics, len(stream), dt, lanes, served=len(stream) - first)
    metrics["engine"] = engine
    metrics["expert_train_s"] = train_s
    return metrics


def serve_stream(dataset: str, samples: int, mu: float,
                 microbatch: int = 16, expert_kind: str = "model",
                 seed: int = 0, log_every: int = 500,
                 ladder: str = "default", device: DeviceLike = None,
                 trace_out: str = ""):
    """Sequential Algorithm-1 loop (``OnlineCascade``) with probe/replay
    expert micro-batching; ``trace_out`` as ``serve_stream_batched``'s."""
    dev = resolve_device(device)
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert, _ = _make_expert(stream, stream.spec.n_classes, expert_kind,
                             samples, seed, dev)
    proxy = _BatchProxy(expert)
    cfg = _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                         expert.cost)
    cascade = OnlineCascade(cfg, proxy, history_limit=0, device=dev)

    preds = np.zeros(len(stream), np.int32)
    t0 = time.time()
    expert_batch_sizes = []
    i = 0
    while i < len(stream):
        j = min(i + microbatch, len(stream))
        batch_idx = list(range(i, j))
        # pass 1 (probe): which queries will reach the expert.  Item k of
        # the batch is processed at tick cascade.t + k + 1; the pre-split
        # tick keys make the probe's jump draws exact
        need = [k for off, k in enumerate(batch_idx)
                if probe_route(cascade, stream.docs[k],
                               cascade.t + off + 1)]
        # one batched expert call for just the deferred subset
        if need:
            labels = expert.label_batch(need, [stream.docs[k] for k in need])
            for k, y in zip(need, labels):
                proxy.table[k] = int(y)
            expert_batch_sizes.append(len(need))
        # pass 2 (replay): stream-order Algorithm 1 with online updates
        for k in batch_idx:
            preds[k] = cascade.process(k, stream.docs[k])["prediction"]
        # the replayed micro-batch's labels are spent
        for k in batch_idx:
            proxy.table.pop(k, None)
        i = j
        if log_every and i % max(log_every, microbatch) < microbatch:
            acc = float(np.mean(preds[:i] == stream.labels[:i]))
            print(f"[{i}/{len(stream)}] acc={acc:.4f} "
                  f"expert_calls={cascade.expert_calls}", flush=True)
    sync(dev)
    dt = time.time() - t0
    _save_trace(cascade, trace_out)
    metrics = {"accuracy": float(np.mean(preds == stream.labels)),
               "expert_calls": cascade.expert_calls,
               "level_fractions": (cascade.level_counts
                                   / max(len(stream), 1)).tolist(),
               "predictions": preds,
               "fallback_calls": proxy.fallback_calls,
               "mean_expert_batch": (float(np.mean(expert_batch_sizes))
                                     if expert_batch_sizes else 0.0)}
    _report(metrics, len(stream), dt,
            f"sequential ladder={ladder} expert={expert_kind} device={dev}")
    print(f"mean expert batch={metrics['mean_expert_batch']:.1f}  "
          f"probe mispredicts (single-call fallbacks)="
          f"{proxy.fallback_calls}")
    return metrics


def main(argv=None):
    """CLI entry point: parse serving flags and run the chosen engine."""
    ap = argparse.ArgumentParser(
        description="Streaming cascade server (online cascade learning, "
                    "PyTorch/CUDA port)")
    ap.add_argument("--dataset", default="hatespeech",
                    choices=["imdb", "hatespeech", "isear", "fever"],
                    help="which simulated stream corpus to serve")
    ap.add_argument("--samples", type=int, default=2000,
                    help="stream length in items (queries served)")
    ap.add_argument("--mu", type=float, default=3e-7,
                    help="cost weighting factor mu (Eq. 1): larger mu "
                         "closes the deferral gates sooner")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"],
                    help="'batched' = BatchedCascadeEngine (S lanes in "
                         "lockstep); 'sequential' = per-item OnlineCascade "
                         "with probe/replay expert micro-batching")
    ap.add_argument("--batch", type=int, default=64,
                    help="concurrent stream lanes S (batched engine); S=1 "
                         "is bit-identical to the sequential loop")
    ap.add_argument("--updates", default="single",
                    choices=["single", "scaled"],
                    help="per-tick update scheduling (batched engine): "
                         "'scaled' lr-scales the one weighted step by the "
                         "tick's expert-demo count (Optimizer.step_k)")
    ap.add_argument("--async-delay", type=int, default=0,
                    help="bounded annotation delay in ticks (batched "
                         "engine): >=1 overlaps the expert forward with "
                         "student compute — deferred lanes answer "
                         "provisionally and annotations commit exactly "
                         "that many ticks later; 0 = synchronous")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="route-pipeline depth P (batched engine): >=1 "
                         "keeps up to P ticks' level-0 forwards in "
                         "flight while older ticks' host routing "
                         "resolves; predictions, levels and expert calls "
                         "are identical for any P; 0 = unpipelined")
    ap.add_argument("--expert-workers", type=int, default=1,
                    help="expert annotation pool size W (batched "
                         "engine): >=2 shards each deferred batch over W "
                         "workers with per-item ticket completion; "
                         "routing is invariant to W")
    ap.add_argument("--expert-backend", default="thread",
                    choices=["thread", "process"],
                    help="expert pool backend (--expert model): 'thread' "
                         "(each worker on its own CUDA stream) or "
                         "'process' (spawned children, each with its own "
                         "CUDA context, rebuilt if one dies)")
    ap.add_argument("--expert-timeout", type=float, default=None,
                    help="per-shard annotation deadline in seconds "
                         "(batched engine): a shard that misses it is "
                         "requeued, then dropped (counted in the fault "
                         "stats); default = wait forever")
    ap.add_argument("--autoscale", default="",
                    help="elastic expert-fleet bounds 'LO:HI' (or 'auto' "
                         "= 1:8): the engine resizes the pool off pending "
                         "queue depth at tick boundaries; empty = fixed "
                         "--expert-workers pool")
    ap.add_argument("--per-lane-commit", action="store_true",
                    help="per-lane commit granularity (batched engine, "
                         "with --async-delay >= 2): each lane's "
                         "annotation commits on a deterministic "
                         "sub-deadline as a per-item update; results are "
                         "bitwise invariant to worker count and latency")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save live engine state every N ticks to "
                         "--checkpoint-path (classic serving path): "
                         "params, optimizer / deferral state, rings, the "
                         "pending annotation queue and the stats; "
                         "resuming with --restore reproduces the "
                         "uninterrupted run bitwise; 0 = off")
    ap.add_argument("--checkpoint-path", default="",
                    help="checkpoint directory for --checkpoint-every "
                         "(written atomically; also what --restore "
                         "takes)")
    ap.add_argument("--restore", default="",
                    help="resume serving from a live-state checkpoint "
                         "(written by either package): the engine picks "
                         "up at the saved tick")
    ap.add_argument("--arrivals", default="none", choices=list(ARRIVALS),
                    help="continuous-batching front-end (batched "
                         "engine): requests arrive on this seeded "
                         "schedule, claim a lane from the pool, run to "
                         "their own length and retire; 'none' = classic "
                         "lockstep serving, 'lockstep' = every request at "
                         "t=0 (bitwise the classic run), 'poisson' / "
                         "'burst' = open-loop staggered traffic")
    ap.add_argument("--lane-budget", type=int, default=0,
                    help="lane-pool capacity (concurrent streams); "
                         "0 = --batch")
    ap.add_argument("--admission", default="queue",
                    choices=["queue", "shed"],
                    help="overload policy for --arrivals serving: 'queue' "
                         "waits arrivals FCFS without bound; 'shed' drops "
                         "arrivals beyond --queue-limit waiting requests "
                         "(recorded, never served)")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="waiting-request capacity under --admission shed "
                         "(beyond the free lanes)")
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="offered load for --arrivals poisson / burst, in "
                         "requests per tick")
    ap.add_argument("--request-len", type=int, default=8,
                    help="mean request length in items (geometric) for "
                         "--arrivals poisson / burst")
    ap.add_argument("--burst-size", type=int, default=8,
                    help="requests per burst for --arrivals burst")
    ap.add_argument("--microbatch", type=int, default=16,
                    help="expert micro-batch size (sequential engine): "
                         "the probe/replay pass batches this many items' "
                         "deferred expert calls into one forward")
    ap.add_argument("--expert", default="model",
                    choices=["model", "simulated"],
                    help="'model' trains an in-repo transformer as the "
                         "LLM stand-in (real expert compute); 'simulated' "
                         "replays the stream's precomputed noisy-teacher "
                         "annotations (zero compute)")
    ap.add_argument("--ladder", default="default", choices=list(LADDERS),
                    help="'default' = lr -> tinytf dense students; "
                         "'kernel' = lr -> tinytf_flash -> ssm at the "
                         "default widths (CUDA kernels on the card); "
                         "'kernel-ci' = the same ladder at the CI widths")
    ap.add_argument("--seed", type=int, default=0,
                    help="stream/cascade RNG seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; raises without "
                         "a card) or 'cpu'")
    ap.add_argument("--log-every", type=int, default=500,
                    help="print running accuracy every N items (0 = off)")
    ap.add_argument("--sanitize", default="",
                    help="comma list of runtime sanitizers to serve under "
                         "(repro_torch.analysis.sanitize): 'determinism' "
                         "records the per-tick trace (save it with "
                         "--trace-out, diff two runs with diff_traces), "
                         "'locks' enforces the expert pool's # guarded-by: "
                         "annotations at runtime and catches lock-order "
                         "cycles, 'retrace' counts the distinct call "
                         "signatures of each staged function")
    ap.add_argument("--trace-out", default="",
                    help="write the determinism trace to this JSON-lines "
                         "path after serving (needs --sanitize "
                         "determinism)")
    args = ap.parse_args(argv)
    modes = {m.strip() for m in args.sanitize.split(",") if m.strip()}
    newly = modes - _san.active_modes()
    # before the engine is built: the levels probe their steps at build
    _san.enable(modes)
    try:
        _serve(args)
        if modes:
            _sanitizer_reports(modes)
    finally:
        _san.disable(newly)


def _serve(args) -> None:
    if args.engine == "batched":
        serve_stream_batched(args.dataset, args.samples, args.mu,
                             batch=args.batch, expert_kind=args.expert,
                             seed=args.seed, log_every=args.log_every,
                             updates_per_tick=args.updates,
                             ladder=args.ladder, device=args.device,
                             async_delay=args.async_delay,
                             pipeline_depth=args.pipeline_depth,
                             expert_workers=args.expert_workers,
                             per_lane=args.per_lane_commit,
                             expert_backend=args.expert_backend,
                             expert_timeout=args.expert_timeout,
                             autoscale=parse_autoscale(args.autoscale),
                             arrivals=args.arrivals,
                             lane_budget=args.lane_budget,
                             admission=args.admission,
                             queue_limit=args.queue_limit,
                             arrival_rate=args.arrival_rate,
                             request_len=args.request_len,
                             burst_size=args.burst_size,
                             checkpoint_every=args.checkpoint_every,
                             checkpoint_path=args.checkpoint_path,
                             restore=args.restore, trace_out=args.trace_out)
    else:
        serve_stream(args.dataset, args.samples, args.mu,
                     microbatch=args.microbatch, expert_kind=args.expert,
                     seed=args.seed, log_every=args.log_every,
                     ladder=args.ladder, device=args.device,
                     trace_out=args.trace_out)


if __name__ == "__main__":
    main()
