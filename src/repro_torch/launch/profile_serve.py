"""Where the serving time goes on the card.

Serves a ladder (the kernel ladder by default, or the paper's
``default`` one) with ``BatchedCascadeEngine`` on the CUDA device, under
any of the engine's serving options (``--async-delay``,
``--pipeline-depth``, ``--expert-workers``, ``--per-lane-commit``,
``--expert-timeout``, ``--autoscale``, ``--hard-budget``; the simulated
expert or, with ``--expert model``, the trained model expert), and
records a steady window (after ``--warmup-ticks``) under
``torch.profiler``.  Pipelined runs are driven through ``submit_tick``;
the window ends with ``drain`` and ``flush``.  Reports, as one JSON
object on the last line:

* the window's wall time per tick and items per second;
* the device's busy time (the union of all kernel intervals) and its
  idle share of the window;
* device time by kernel, the port's kernels and the matrix products
  (cuBLAS / CUTLASS) grouped, the top kernels by name;
* host wall time spent in the commits (ring scatter + the autograd
  student / gate updates, per tick or per lane) versus the rest of the
  tick (route passes, featurization, routing, the expert);
* the engine's ``pipeline_stats``, ``commit_stats`` and ``fault_stats``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --samples 2048 --batch 64 --ladder kernel
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --ladder default --hard-budget 0 --pipeline-depth 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import BatchedCascadeEngine
from repro_torch.data import make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (_ladder_config, _make_expert,
                                      parse_autoscale)

# kernel-name marks of the port's CUDA kernels, both variants
OURS = {"flash_fwd_kernel": "flash_attention",
        "flash_tc_kernel": "flash_attention",
        "flash_tiled_kernel": "flash_attention",
        "decode_kernel": "decode_attention",
        "decode_combine": "decode_attention", "ssd_kernel": "ssd_scan",
        "gmm_kernel": "moe_gmm", "gmm_tc_": "moe_gmm"}
GEMM_MARKS = ("gemm", "cutlass", "sm90_xmma", "cublas")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _group(name: str) -> str:
    for mark, kernel in OURS.items():
        if mark in name:
            return kernel
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "matmul (cuBLAS/CUTLASS)"
    return "other"


def profiled_run(eng: BatchedCascadeEngine, stream, warmup_ticks: int):
    """Serve ``stream`` on ``eng`` (tick-major, ``eng.n_streams`` lanes)
    and profile every tick after the warm-up.  Returns the report and the
    stream's predictions."""
    batch = eng.n_streams
    n = len(stream)
    preds = np.full(n, -1, np.int64)
    commit_s = [0.0]

    def timed(fn):
        def wrapped(*args):
            t0 = time.perf_counter()
            fn(*args)
            commit_s[0] += time.perf_counter() - t0
        return wrapped

    eng._commit = timed(eng._commit)
    eng._commit_lane = timed(eng._commit_lane)

    def serve(idxs):
        docs = [stream.docs[i] for i in idxs]
        outs = (eng.submit_tick(idxs, docs) if eng.pipeline_depth
                else [eng.process_tick(idxs, docs)])
        for out in outs:
            preds[out["indices"]] = out["predictions"]

    ticks = [list(range(s, min(s + batch, n))) for s in range(0, n, batch)]
    for idxs in ticks[:warmup_ticks]:
        serve(idxs)
    torch.cuda.synchronize()
    window = ticks[warmup_ticks:]
    commit_s[0] = 0.0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for idxs in window:
            serve(idxs)
        for out in eng.drain():
            preds[out["indices"]] = out["predictions"]
        eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in dev_events)
    by_name, by_group = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        g = _group(e.name)
        k, tot = by_group.get(g, (0, 0.0))
        by_group[g] = (k + 1, tot + d)
    n_items = sum(len(t) for t in window)
    n_win = max(len(window), 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rep = {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "batch": batch, "window_ticks": len(window),
        "window_items": n_items,
        "max_delay": eng.max_delay, "pipeline_depth": eng.pipeline_depth,
        "per_lane": eng.per_lane,
        "expert_workers": int(getattr(eng.expert, "workers", 1)),
        "hard_budget": eng.cfg.hard_budget,
        "wall_ms_per_tick": wall * 1e3 / n_win,
        "items_per_sec": n_items / max(wall, 1e-9),
        "host_commit_share": commit_s[0] / max(wall, 1e-9),
        "device_events": len(dev_events),
        "device_busy_ms_per_tick": busy_us / 1e3 / n_win,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall) if dev_events
        else None,
        "kernel_ms_per_tick_by_group": {
            g: tot / 1e3 / n_win for g, (k, tot) in sorted(by_group.items())},
        "launches_per_tick_by_group": {
            g: k / n_win for g, (k, _) in sorted(by_group.items())},
        "top_kernels_ms_per_tick": [
            (name[:80], tot / 1e3 / n_win) for name, tot in top],
        "expert_calls": eng.expert_calls_total,
        "accuracy": float(np.mean(preds == stream.labels)),
        "level_fractions": (eng.level_counts.sum(axis=0)
                            / max(eng.items_seen.sum(), 1)).tolist(),
        "pipeline_stats": dict(eng.pipeline_stats),
        "commit_stats": dict(eng.commit_stats),
        "fault_stats": dict(eng.fault_stats),
    }
    return rep, preds


def profile(dataset: str, samples: int, batch: int, ladder: str,
            warmup_ticks: int, mu: float = 3e-7, seed: int = 0,
            expert_kind: str = "simulated", async_delay: int = 0,
            pipeline_depth: int = 0, expert_workers: int = 1,
            per_lane: bool = False, expert_backend: str = "thread",
            expert_timeout=None, autoscale=None,
            hard_budget=None) -> dict:
    """Serve ``samples`` items; profile every tick after the warm-up."""
    dev = resolve_device("cuda")
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert, train_s = _make_expert(
        stream, stream.spec.n_classes, expert_kind, samples, seed, dev,
        workers="auto" if autoscale else expert_workers,
        backend=expert_backend)
    cfg = dataclasses.replace(
        _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                       expert.cost), hard_budget=hard_budget)
    eng = BatchedCascadeEngine(cfg, expert, n_streams=batch,
                               max_delay=async_delay,
                               pipeline_depth=pipeline_depth,
                               per_lane=per_lane, history_limit=0,
                               expert_timeout=expert_timeout,
                               autoscale=autoscale, device=dev)
    try:
        rep, _ = profiled_run(eng, stream, warmup_ticks)
    finally:
        eng.close()
    rep.update(ladder=ladder, dataset=dataset, expert=expert_kind,
               expert_train_s=train_s)
    return rep


def main(argv=None):
    """CLI entry point."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="imdb")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ladder", default="kernel",
                    choices=["kernel", "kernel-ci", "default"])
    ap.add_argument("--warmup-ticks", type=int, default=4)
    ap.add_argument("--expert", default="simulated",
                    choices=["simulated", "model"])
    ap.add_argument("--async-delay", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=0)
    ap.add_argument("--expert-workers", type=int, default=1)
    ap.add_argument("--expert-backend", default="thread",
                    choices=["thread", "process"])
    ap.add_argument("--per-lane-commit", action="store_true")
    ap.add_argument("--expert-timeout", type=float, default=None)
    ap.add_argument("--autoscale", default="")
    ap.add_argument("--hard-budget", type=int, default=None,
                    help="the cascade's hard expert budget (0: the "
                         "converged regime, no expert traffic)")
    ap.add_argument("--out", default="",
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)
    rep = profile(args.dataset, args.samples, args.batch, args.ladder,
                  args.warmup_ticks, expert_kind=args.expert,
                  async_delay=args.async_delay,
                  pipeline_depth=args.pipeline_depth,
                  expert_workers=args.expert_workers,
                  per_lane=args.per_lane_commit,
                  expert_backend=args.expert_backend,
                  expert_timeout=args.expert_timeout,
                  autoscale=parse_autoscale(args.autoscale),
                  hard_budget=args.hard_budget)
    text = json.dumps(rep)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
