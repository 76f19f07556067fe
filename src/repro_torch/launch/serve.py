"""Streaming cascade server on the PyTorch port (port of
``repro.launch.serve``, the flags of the kernel-ladder slice).

Two engines:

* ``--engine batched`` (default): ``BatchedCascadeEngine`` serves S
  concurrent stream lanes in lockstep — per-level batched forwards over
  the gathered alive subset (the upper levels through the CUDA kernels),
  one batched expert call per tick, per-tick weighted updates.
* ``--engine sequential``: the per-item Algorithm-1 loop
  (``OnlineCascade``).

The ladder is ``lr -> tinytf_flash -> ssm`` at the default widths
(``--ladder kernel``) or at the CI widths (``--ladder kernel-ci``); the
expert is the stream's simulated annotator.  Runs on the CUDA card unless
``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --ladder kernel \
      --dataset imdb --samples 2048 --batch 64
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import (BatchedCascadeEngine, OnlineCascade,
                              SimulatedExpert, kernel_cascade_config)
from repro_torch.data import make_stream
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models.kernel_students import TINY_SSM_CI, TINY_TF_CI


def _ladder_config(ladder: str, n_classes: int, mu: float, seed: int,
                   expert_cost: float):
    if ladder not in ("kernel", "kernel-ci"):
        raise ValueError(f"unknown ladder {ladder!r} (kernel | kernel-ci)")
    spec_kw = ({"tf_flash_spec": TINY_TF_CI, "ssm_spec": TINY_SSM_CI}
               if ladder == "kernel-ci" else {})
    return kernel_cascade_config(n_classes=n_classes, mu=mu, seed=seed,
                                 expert_cost=expert_cost, **spec_kw)


def _report(metrics: dict, n: int, dt: float, lanes: str) -> None:
    frac = metrics["expert_calls"] / n
    print(f"\nserved {n} queries in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.0f} items/s, {lanes})")
    print(f"accuracy={metrics['accuracy']:.4f}  "
          f"expert_calls={metrics['expert_calls']} "
          f"({frac:.1%} of stream)  cost_saving={1-frac:.1%}")
    print(f"level fractions: "
          f"{[round(float(f), 3) for f in metrics['level_fractions']]}")


def serve_stream_batched(dataset: str, samples: int, mu: float,
                         batch: int = 64, seed: int = 0,
                         log_every: int = 500,
                         updates_per_tick: str = "single",
                         ladder: str = "kernel",
                         device: DeviceLike = None):
    """Default serving path: the batched multi-stream engine on the
    kernel ladder.  Returns the engine's ``run`` metrics plus the engine
    itself (``"engine"``: its levels' forward counts, per-stream
    accounting)."""
    dev = resolve_device(device)
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert = SimulatedExpert(stream, "gpt-3.5-turbo")
    cfg = _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                         expert.cost)
    # history_limit=0: serving reads only aggregate metrics
    engine = BatchedCascadeEngine(cfg, expert, n_streams=batch,
                                  updates_per_tick=updates_per_tick,
                                  history_limit=0, device=dev)
    t0 = time.time()
    metrics = engine.run(stream, log_every=log_every)
    sync(dev)
    dt = time.time() - t0
    cs = engine.commit_stats
    if cs["lanes"]:
        print(f"annotation commits: {cs['lanes']} lanes, "
              f"mean age {cs['age_sum'] / cs['lanes']:.2f} ticks, "
              f"mean latency {cs['wall_sum'] / cs['lanes'] * 1e3:.1f} ms")
    _report(metrics, len(stream), dt,
            f"batch={batch} ladder={ladder} device={dev}")
    metrics["engine"] = engine
    return metrics


def serve_stream(dataset: str, samples: int, mu: float, seed: int = 0,
                 log_every: int = 500, ladder: str = "kernel",
                 device: DeviceLike = None):
    """Sequential Algorithm-1 loop (``OnlineCascade``) on the ladder."""
    dev = resolve_device(device)
    stream = make_stream(dataset, seed=seed, n_samples=samples)
    expert = SimulatedExpert(stream, "gpt-3.5-turbo")
    cfg = _ladder_config(ladder, stream.spec.n_classes, mu, seed,
                         expert.cost)
    cascade = OnlineCascade(cfg, expert, history_limit=0, device=dev)
    t0 = time.time()
    metrics = cascade.run(stream, log_every=log_every)
    sync(dev)
    _report(metrics, len(stream), time.time() - t0,
            f"sequential ladder={ladder} device={dev}")
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
                         "lockstep); 'sequential' = per-item OnlineCascade")
    ap.add_argument("--batch", type=int, default=64,
                    help="concurrent stream lanes S (batched engine); S=1 "
                         "is bit-identical to the sequential loop")
    ap.add_argument("--updates", default="single",
                    choices=["single", "scaled"],
                    help="per-tick update scheduling (batched engine): "
                         "'scaled' lr-scales the one weighted step by the "
                         "tick's expert-demo count (Optimizer.step_k)")
    ap.add_argument("--expert", default="simulated", choices=["simulated"],
                    help="the stream's precomputed noisy-teacher labels")
    ap.add_argument("--ladder", default="kernel",
                    choices=["kernel", "kernel-ci"],
                    help="'kernel' = lr -> tinytf_flash -> ssm at the "
                         "default widths; 'kernel-ci' = the same ladder at "
                         "the CI widths")
    ap.add_argument("--seed", type=int, default=0,
                    help="stream/cascade RNG seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; raises without "
                         "a card) or 'cpu'")
    ap.add_argument("--log-every", type=int, default=500,
                    help="print running accuracy every N items (0 = off)")
    args = ap.parse_args(argv)
    if args.engine == "batched":
        serve_stream_batched(args.dataset, args.samples, args.mu,
                             batch=args.batch, seed=args.seed,
                             log_every=args.log_every,
                             updates_per_tick=args.updates,
                             ladder=args.ladder, device=args.device)
    else:
        serve_stream(args.dataset, args.samples, args.mu, seed=args.seed,
                     log_every=args.log_every, ladder=args.ladder,
                     device=args.device)


if __name__ == "__main__":
    main()
