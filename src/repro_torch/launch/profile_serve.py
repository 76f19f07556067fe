"""Where the serving time goes on the card.

Serves a ladder (the kernel ladder by default, or the paper's
``default`` one) with ``BatchedCascadeEngine`` and the simulated expert
on the CUDA device and records a steady window (after ``--warmup-ticks``) under
``torch.profiler``.  Reports, as one JSON object on the last line:

* the window's wall time per tick and items per second;
* the device's busy time (the union of all kernel intervals) and its
  idle share of the window;
* device time by kernel, the port's kernels and the matrix products
  (cuBLAS / CUTLASS) grouped, the top kernels by name;
* host wall time spent in the per-tick commit (ring scatter + the
  autograd student / gate updates) versus the rest of the tick (route
  passes, featurization, routing, the expert).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --samples 2048 --batch 64 --ladder kernel
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.core import BatchedCascadeEngine, SimulatedExpert
from repro_torch.data import make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.serve import _ladder_config

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


def profile(dataset: str, samples: int, batch: int, ladder: str,
            warmup_ticks: int, mu: float = 3e-7, seed: int = 0) -> dict:
    """Serve ``samples`` items; profile every tick after the warm-up."""
    dev = resolve_device("cuda")
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert = SimulatedExpert(stream, "gpt-3.5-turbo")
    cfg = _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                         expert.cost)
    eng = BatchedCascadeEngine(cfg, expert, n_streams=batch,
                               history_limit=0, device=dev)
    commit_s = [0.0]
    commit = eng._commit

    def timed_commit(rec):
        t0 = time.perf_counter()
        commit(rec)
        commit_s[0] += time.perf_counter() - t0

    eng._commit = timed_commit
    ticks = [list(range(s, min(s + batch, samples)))
             for s in range(0, samples, batch)]
    for idxs in ticks[:warmup_ticks]:
        eng.process_tick(idxs, [stream.docs[i] for i in idxs])
    torch.cuda.synchronize()
    window = ticks[warmup_ticks:]
    commit_s[0] = 0.0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for idxs in window:
            eng.process_tick(idxs, [stream.docs[i] for i in idxs])
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
        n, tot = by_group.get(g, (0, 0.0))
        by_group[g] = (n + 1, tot + d)
    n_items = sum(len(t) for t in window)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "ladder": ladder, "batch": batch, "dataset": dataset,
        "window_ticks": len(window), "window_items": n_items,
        "wall_ms_per_tick": wall * 1e3 / max(len(window), 1),
        "items_per_sec": n_items / max(wall, 1e-9),
        "host_commit_share": commit_s[0] / max(wall, 1e-9),
        "device_events": len(dev_events),
        "device_busy_ms_per_tick": busy_us / 1e3 / max(len(window), 1),
        "device_idle_share": (1.0 - busy_us / 1e6 / wall) if dev_events
        else None,
        "kernel_ms_per_tick_by_group": {
            g: tot / 1e3 / max(len(window), 1)
            for g, (n, tot) in sorted(by_group.items())},
        "launches_per_tick_by_group": {
            g: n / max(len(window), 1) for g, (n, _) in
            sorted(by_group.items())},
        "top_kernels_ms_per_tick": [
            (name[:80], tot / 1e3 / max(len(window), 1))
            for name, tot in top],
        "expert_calls": eng.expert_calls_total,
        "level_fractions": (eng.level_counts.sum(axis=0)
                            / max(eng.items_seen.sum(), 1)).tolist(),
    }


def main(argv=None):
    """CLI entry point."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="imdb")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ladder", default="kernel",
                    choices=["kernel", "kernel-ci", "default"])
    ap.add_argument("--warmup-ticks", type=int, default=4)
    ap.add_argument("--out", default="",
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)
    rep = profile(args.dataset, args.samples, args.batch, args.ladder,
                  args.warmup_ticks)
    text = json.dumps(rep)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
