"""One-card dry-run (port of ``repro.launch.dryrun``, without its mesh):
count every (arch x shape) on ``meta`` at full width, run its probes on
the card, and write the reference's roofline record.

The reference lowers and compiles each combination for 512 TPU devices
and reads XLA's cost and memory analyses.  Here ``metrics.cost.
CostCounter`` counts the step itself (FLOPs by dtype, bytes accessed,
kernel launches by variant, live / peak bytes of the storages it
creates) while the step runs on ``meta`` tensors: the zoo's own
``train_loss`` + backward + ``adamw``, ``prefill`` or ``decode_step``,
with the kernel ops' ``meta`` shape functions standing in for their
launches.

Cost extrapolation: a ``meta`` run's Python time grows with the depth,
the SSD's chunks and the MoE groups, so the step is counted at small
probes, (periods P, batch B) in {2, 3} x {1, 2} (``_probe_points`` says
why not the reference's P in {1, 2}), and extended along the reference's
bilinear law cost(P, B) = a0 + a1*P + (c0 + c1*P)*B (linear in P where
the batch cannot vary), applied to FLOPs, bytes, launches and, unlike
the reference (which reads memory from the full-depth compile), to the
peak bytes too, phase by phase.  The law is exact for work that is
affine in depth and batch; a MoE decode step's capacity is not (it
rounds up to 4 tokens an expert), so there its FLOPs are a floor.

On the card (the default device) each probe also runs for real, where
its counted peak fits in 90% of the card's memory: seeded weights at
full width, seeded inputs, one warm-up, one run under the same counter
(its FLOPs and launches must equal the ``meta`` count of the probe; its
``max_memory_allocated`` is held against the counted peak), then timed
runs with CUDA events.  Time and peak are extended along the same law
into the record's ``measured`` block.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --device meta   # no card
Options: --opt-dtype bfloat16  --no-remat  --loss-chunk N  --no-extrapolate
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import time
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import (get_config, get_smoke_config,
                                 list_architectures)
from repro_torch.device import resolve_device
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape, input_specs
from repro_torch.launch.shapes import resolve_config
from repro_torch.metrics.cost import (CostCounter, phase, tree_bytes,
                                      tree_storages)
from repro_torch.metrics.roofline import (H100, HW, compute_seconds,
                                          model_flops_6nd, roofline_terms)
from repro_torch.models import transformer as tf_model
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

FIT_SHARE = 0.9          # a card probe runs only where its peak fits here
PROBE_PERIODS = (2, 3)   # the depths the law is fitted at (_probe_points)
PROBE_BATCHES = (1, 2)
# How far a card probe may stand from its meta count (``probe_problems``),
# fixed before the first run on the card: FLOPs by dtype and launches by
# variant exactly; bytes accessed within 1% (a launcher's own
# ``.contiguous()`` or scratch may differ); ``max_memory_allocated``
# within 5% + 256 MiB of the counted peak (the caching allocator rounds
# each block up, by up to 1 MiB where it does not split a cached block,
# and library workspaces are not counted); the bound's share of the
# measured time at most 1.05 (above 1 the count is short).
SEED = 0                 # the card's weights and inputs
AGREE = {"bytes": 0.01, "peak_rel": 0.05, "peak_abs": 256 * 2 ** 20,
         "share": 1.05}


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def make_train_step(cfg, opt, remat: bool = True, loss_chunk: int = 0):
    """Build the (params, opt_state, batch) -> (loss, params, opt_state)
    train step: ``train_loss``, its backward, one optimizer step."""
    def train_step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with phase("forward"):
            loss, _ = tf_model.train_loss(params, batch, cfg, remat=remat,
                                          loss_chunk=loss_chunk)
        with phase("backward"):
            loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        with phase("optimizer"), torch.no_grad():
            params, opt_state = opt.step(params, grads, opt_state)
        return loss.detach(), params, opt_state
    return train_step


def make_prefill_step(cfg, cache_len: Optional[int] = None):
    """Build the (params, batch) -> (logits, cache) prefill step."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return tf_model.prefill(params, batch, cfg, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg):
    """Build the single-token (params, cache, tokens, pos) step; ``pos``
    is the Python int ``decode_step`` takes."""
    def decode_step(params, cache, tokens, pos):
        with torch.no_grad():
            return tf_model.decode_step(params, cache, tokens, pos, cfg)
    return decode_step


# ---------------------------------------------------------------------------
# Arguments: meta stand-ins, or seeded values on the card
# ---------------------------------------------------------------------------
def _with_periods(cfg, n_periods: int):
    new = dataclasses.replace(cfg, n_layers=len(cfg.period) * n_periods)
    if cfg.encoder is not None:
        new = dataclasses.replace(
            new, encoder=dataclasses.replace(cfg.encoder,
                                             n_layers=n_periods))
    return new


def _materialize(tree, gen, cfg, seq: int, name: str = ""):
    """Seeded values on ``gen``'s device for a tree of ``meta`` inputs:
    tokens uniform over the vocabulary, floats standard normal, and each
    ring cache's ``pos`` full (positions seq - W .. seq - 1 at slot
    p % W), as a cache that has seen ``seq`` tokens holds them."""
    if isinstance(tree, dict):
        return {k: _materialize(v, gen, cfg, seq, k) for k, v in tree.items()}
    dev = gen.device
    if name == "pos" and tree.ndim:
        W = tree.shape[-1]
        p = torch.arange(seq - W, seq, dtype=torch.int32, device=dev)
        ring = torch.empty(W, dtype=torch.int32, device=dev)
        ring[(p % W).long()] = p
        return ring.expand(tree.shape).contiguous()
    if not tree.is_floating_point():
        return torch.randint(0, cfg.vocab, tree.shape, generator=gen,
                             dtype=tree.dtype, device=dev)
    return torch.randn(tree.shape, generator=gen, dtype=tree.dtype,
                       device=dev)


def build_step(cfg, shape: InputShape, device, *, opt_dtype="float32",
               remat=True, loss_chunk=0):
    """The step function of ``shape.kind`` and its arguments: ``meta``
    stand-ins (``init_params(None)``, ``input_specs``) on ``meta``, seeded
    weights and inputs at the same shapes on another device."""
    specs = input_specs(cfg, shape)
    cfg = resolve_config(cfg, shape)
    dev = torch.device(device)
    if dev.type == "meta":
        params = tf_model.init_params(None, cfg)
        inputs = specs
    else:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = tf_model.init_params(gen, cfg)
        inputs = _materialize(specs, gen, cfg, shape.seq)
    if shape.kind == "train":
        opt = adamw(3e-4, state_dtype=opt_dtype)
        step = make_train_step(cfg, opt, remat=remat, loss_chunk=loss_chunk)
        return step, (params, opt.init(params), inputs["batch"])
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, inputs["batch"])
    return make_decode_step(cfg), (params, inputs["cache"], inputs["tokens"],
                                   shape.seq - 1)


# ---------------------------------------------------------------------------
# Counting and probing
# ---------------------------------------------------------------------------
def _flat(summary: dict, args_b: int, out_b: int) -> Dict[str, float]:
    """A count as one flat dict of numbers (the law extends each key)."""
    flat = {f"flops:{d}": f for d, f in summary["flops"].items()}
    for k, by in summary["launches"].items():
        flat.update({f"launches:{k}:{v}": n for v, n in by.items()})
    flat.update({f"peak:{k}": v for k, v in summary["phase_peaks"].items()})
    flat.update(bytes_accessed=summary["bytes_accessed"],
                peak_bytes=summary["peak_bytes"], argument_bytes=args_b,
                output_bytes=out_b)
    return flat


def count_step(step, args) -> Dict[str, float]:
    """Run ``step(*args)`` under a ``CostCounter``: its counts, the bytes
    of its arguments and of the outputs that are not arguments."""
    arg_keys = tree_storages(args)
    args_b = tree_bytes(args)
    with CostCounter() as counter:
        out = step(*args)
    return _flat(counter.summary(), args_b, tree_bytes(out, arg_keys))


def count_extended(cfg, build) -> Dict[str, float]:
    """The count of the step ``build(cfg) -> (step, args)`` (on ``meta``)
    at ``cfg``'s depth: counted there where its period repeats at most
    ``PROBE_PERIODS[1]`` times, else at those depths and extended in P
    along the law."""
    if cfg.n_periods <= PROBE_PERIODS[1]:
        return count_step(*build(cfg))
    pts = {(p, 1): count_step(*build(_with_periods(cfg, p)))
           for p in PROBE_PERIODS}
    return _law(pts, cfg.n_periods, 1)


def bound_s(count: Dict[str, float], hw: HW = H100) -> float:
    """The least time the card could take a counted step: its FLOPs at
    their dtypes' peaks, or its arguments and outputs once over HBM,
    whichever is longer (the record's max(compute_s, memory_floor_s))."""
    floor = (count["argument_bytes"] + count["output_bytes"]) / hw.hbm_bw
    return max(compute_seconds(_by_kind(count, "flops:"), hw), floor)


def _card_probe(cfg, shape, opts, counted, reps):
    """One probe on the card: warm-up, a run under the counter (with the
    peak of ``max_memory_allocated`` above what was allocated before it),
    then ``reps`` runs, each timed with CUDA events (the median is the
    probe's ms).  ``counted`` is the probe's ``meta`` count."""
    step, args = build_step(cfg, shape, "cuda", **opts)
    step(*args)
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = count_step(step, args)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated() - base
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    keys = [k for k in set(card) | set(counted)
            if k.startswith(("flops:", "launches:"))]
    return {"ms": ms, "ms_reps": times, "peak_bytes": measured_peak,
            "counted_peak_bytes": counted["peak_bytes"],
            "bytes_accessed": card["bytes_accessed"],
            "counted_bytes_accessed": counted["bytes_accessed"],
            "count_equal": all(card.get(k, 0) == counted.get(k, 0)
                               for k in keys),
            "card_count": {k: card[k] for k in sorted(card)}}


def _law(points: Dict[Tuple[int, int], Dict[str, float]], n_periods: int,
         b_full: int) -> Dict[str, float]:
    """Extend each key of the probes' counts to (n_periods, b_full): the
    bilinear law cost(P, B) = A(P) + C(P)*B, A and C affine in P, over
    four probes (p1, p2) x (b1, b2); affine in P over two at b_full; the
    count itself over one.  A step's peak is the largest of its phases'
    (``metrics.cost.phase``), each extended on its own: where the peak
    moves from one phase to another between probes, a law over the
    whole peak would not hold."""
    keys = sorted({k for v in points.values() for k in v})
    ps = sorted({p for p, _ in points})
    bs = sorted({b for _, b in points})

    def in_p(v1, v2, n):
        return v1 + (n - ps[0]) * (v2 - v1) / (ps[1] - ps[0])

    out = {}
    for k in keys:
        v = {pb: c.get(k, 0) for pb, c in points.items()}
        if len(points) == 1:
            (out[k],) = v.values()
        elif len(bs) == 1:
            out[k] = in_p(v[ps[0], bs[0]], v[ps[1], bs[0]], n_periods)
        else:
            slope = {p: (v[p, bs[1]] - v[p, bs[0]]) / (bs[1] - bs[0])
                     for p in ps}
            base = {p: v[p, bs[0]] - slope[p] * bs[0] for p in ps}
            out[k] = (in_p(base[ps[0]], base[ps[1]], n_periods)
                      + in_p(slope[ps[0]], slope[ps[1]], n_periods) * b_full)
    phases = [out[k] for k in keys if k.startswith("peak:")]
    if phases:
        out["peak_bytes"] = max(phases)
    return out


def probe_problems(row: dict) -> list:
    """What in one card probe of a record's ``probes`` breaks ``AGREE``
    (empty when it holds, or when the probe did not run)."""
    if "ms" not in row:
        return []
    bad = []
    if not row["count_equal"]:
        bad.append("FLOPs or launches differ from the meta count")
    nb, cb = row["bytes_accessed"], row["counted_bytes_accessed"]
    if abs(nb - cb) > AGREE["bytes"] * cb:
        bad.append(f"bytes accessed {nb:.6g} vs counted {cb:.6g}")
    mp, cp = row["peak_bytes"], row["counted_peak_bytes"]
    if abs(mp - cp) > AGREE["peak_rel"] * cp + AGREE["peak_abs"]:
        bad.append(f"max_memory_allocated {mp:.6g} vs counted {cp:.6g}")
    if not row["share"] <= AGREE["share"]:
        bad.append(f"bound / measured {row['share']:.4g} > {AGREE['share']}")
    return bad


def _probe_points(cfg, shape, extrapolate: bool):
    """The (periods, batch) probes and the law's name.  Depth is probed
    at 2 and 3 periods, not the reference's 1 and 2: one period's caches
    are views (``transformer._stack``), two or more are stacked copies,
    so a one-period probe lies off the law its bytes follow."""
    if extrapolate and cfg.n_periods > PROBE_PERIODS[1]:
        if shape.batch >= 2:
            return ([(p, b) for b in PROBE_BATCHES for p in PROBE_PERIODS],
                    "bilinear(P,B)")
        return [(p, shape.batch) for p in PROBE_PERIODS], "linear(P)"
    return [(cfg.n_periods, shape.batch)], False


def _card_name() -> dict:
    """The card's name, and its power limit where ``nvidia-smi`` reads
    it."""
    out = {"kind": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except FileNotFoundError:
        pass
    return out


def _by_kind(flat: Dict[str, float], prefix: str) -> Dict[str, float]:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _launches(flat: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for k, n in _by_kind(flat, "launches:").items():
        name, variant = k.split(":")
        out.setdefault(name, {})[variant] = n
    return out


def dryrun_one(arch: str, shape_name: Union[str, InputShape], *,
               opt_dtype: str = "float32", remat: bool = True,
               loss_chunk: int = 0, extrapolate: bool = True,
               device="cuda", smoke: bool = False, reps: int = 3,
               hw: HW = H100, verbose: bool = True) -> dict:
    """Count one combination on ``meta`` (and, on the card, run its
    probes); returns the roofline record.  ``device`` is ``"cuda"`` (the
    default; raises without a card) or ``"meta"`` (counts only).
    ``smoke`` takes the architecture's smoke config and ``shape_name``
    may be an ``InputShape`` of one's own (the tests' small sizes)."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"the dry-run counts on meta or runs on the card, "
                         f"not on {dev.type}")
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    cfg = resolve_config((get_smoke_config if smoke else get_config)(arch),
                         shape)
    opts = dict(opt_dtype=opt_dtype, remat=remat, loss_chunk=loss_chunk)
    pts, extrapolated = _probe_points(cfg, shape, extrapolate)
    n_periods, b_full = cfg.n_periods, shape.batch

    t0 = time.time()
    counts, card = {}, {}
    for p, b in pts:
        cfg_p = _with_periods(cfg, p)
        sh = dataclasses.replace(shape, batch=b)
        counts[p, b] = count_step(*build_step(cfg_p, sh, "meta", **opts))
        if verbose:
            need = counts[p, b]["argument_bytes"] + counts[p, b]["peak_bytes"]
            print(f"  probe P={p} B={b}: meta count {time.time() - t0:.1f} s"
                  f", peak {need / 1e9:.3f} GB", flush=True)
    count_s = time.time() - t0
    if dev.type == "cuda":
        limit = FIT_SHARE * torch.cuda.get_device_properties(0).total_memory
        for (p, b), c in counts.items():
            need = c["argument_bytes"] + c["peak_bytes"]
            if need > limit:
                card[p, b] = {"skipped": f"does not fit on one card: counted "
                              f"peak {need / 1e9:.2f} GB > {FIT_SHARE:.0%} "
                              f"of {limit / FIT_SHARE / 1e9:.2f} GB"}
                continue
            card[p, b] = _card_probe(_with_periods(cfg, p),
                                     dataclasses.replace(shape, batch=b),
                                     opts, c, reps)
            if verbose:
                r = card[p, b]
                print(f"  probe P={p} B={b} on the card: {r['ms']:.4f} ms, "
                      f"peak {r['peak_bytes'] / 1e9:.3f} GB (counted "
                      f"{r['counted_peak_bytes'] / 1e9:.3f}), count equal "
                      f"{r['count_equal']}", flush=True)

    full = _law(counts, n_periods, b_full)
    flops = _by_kind(full, "flops:")
    flops_dev = sum(flops.values())
    bytes_dev = full["bytes_accessed"]
    terms = roofline_terms(flops, bytes_dev, 0.0, hw)
    args_b, out_b = full["argument_bytes"], full["output_bytes"]
    peak_b = full["peak_bytes"]
    # the floor: what must cross HBM at least once, the arguments and the
    # outputs that are not arguments (the port's steps donate nothing)
    bytes_floor = args_b + out_b
    terms["memory_floor_s"] = bytes_floor / hw.hbm_bw
    per_dev_hbm = args_b + peak_b

    if shape.kind == "train":
        model_flops = model_flops_6nd(cfg, shape.batch * shape.seq)
    elif shape.kind == "prefill":
        model_flops = model_flops_6nd(cfg, shape.batch * shape.seq) / 3.0
    else:
        model_flops = model_flops_6nd(cfg, shape.batch) / 3.0

    def probe_row(p, b):
        row = {"periods": p, "batch": b, "count": counts[p, b]}
        c = card.get((p, b))
        if c is None:
            return row
        row.update(c)
        if "ms" in c:
            row["bound_s"] = bound_s(counts[p, b], hw)
            row["share"] = row["bound_s"] / (c["ms"] / 1e3)
        return row

    result = {
        "arch": arch, "shape": shape.name, "mesh": "1", "n_devices": 1,
        "kind": shape.kind,
        "flops_per_device": flops_dev,
        "flops_by_dtype": flops,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": 0.0,
        "collectives": {},
        "roofline": terms,
        "model_flops": model_flops,
        "hlo_flops_global": flops_dev,
        "model_flops_ratio": (model_flops / flops_dev if flops_dev
                              else None),
        "memory": {"argument_size_in_bytes": args_b,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": max(peak_b - out_b, 0),
                   "alias_size_in_bytes": 0,
                   "generated_code_size_in_bytes": None},
        "memory_source": ("counted on meta: the peak of the storages the "
                          "step creates, extended from the probes phase "
                          "by phase along the same law" if extrapolated else
                          "counted on meta at full depth and batch"),
        "bytes_floor_per_device": bytes_floor,
        "hbm_per_device_gb": per_dev_hbm / 1e9,
        "fits_hbm": bool(per_dev_hbm <= hw.hbm_bytes),
        "launches": _launches(full),
        "lower_s": round(count_s, 2),       # the meta counts' seconds
        "compile_s": None,                  # nothing is compiled
        "extrapolated": extrapolated,
        "options": {"moe_mode": None, "zero": False,
                    "opt_dtype": opt_dtype, "remat": remat,
                    "seq_parallel": False, "loss_chunk": loss_chunk,
                    "shard_params_data": False},
        "hw": hw.name, "device": dev.type,
        "probes": [probe_row(p, b) for p, b in pts],
    }
    if dev.type == "cuda":
        result["measured"] = _measured(result, card, n_periods, b_full,
                                       peak_b)
    if verbose:
        print(f"== {arch} x {shape.name} on one {hw.name} ({dev.type}) ==")
        print(f"count (extrapolated={extrapolated}): flops={flops_dev:.4e} "
              f"{ {d: f'{f:.3e}' for d, f in flops.items()} } "
              f"bytes={bytes_dev:.4e} launches={result['launches']}")
        print(f"roofline: compute={terms['compute_s']:.6f}s "
              f"memory={terms['memory_s']:.6f}s "
              f"(floor {terms['memory_floor_s']:.6f}s) "
              f"dominant={terms['dominant']}")
        print(f"hbm={result['hbm_per_device_gb']:.3f} GB "
              f"fits={result['fits_hbm']} count {count_s:.1f} s",
              flush=True)
        if "measured" in result:
            print(f"measured: {result['measured']}", flush=True)
    return result


def _measured(result, card, n_periods, b_full, counted) -> dict:
    """The card's numbers at full size, where every probe ran: the probes'
    times extended along the law, with the bound's share of that time;
    ``counted``, the peak the step creates (extended phase by phase),
    times the probes' largest measured / counted peak.  A time the law
    extends below a probe's own (host time that does not grow with B, or
    falls: cuBLAS takes another kernel at one row) is no estimate, and
    the record says so."""
    out = {**_card_name(), "ms": None, "share": None,
           "peak_bytes": None, "counted_peak_bytes": None,
           "skipped": [dict(periods=p, batch=b, why=c["skipped"])
                       for (p, b), c in card.items() if "skipped" in c]}
    if out["skipped"]:
        out["note"] = "does not fit on one card"
        return out
    ms = _law({k: {"ms": c["ms"]} for k, c in card.items()}, n_periods,
              b_full)["ms"]
    ratio = max(c["peak_bytes"] / c["counted_peak_bytes"]
                for c in card.values())
    out.update(peak_bytes=counted * ratio, counted_peak_bytes=counted,
               peak_ratio=ratio)
    if ms < max(c["ms"] for c in card.values()):
        out["note"] = (f"the probes' times do not follow the law (extended "
                       f"to {ms:.6g} ms): not extended")
        return out
    t = result["roofline"]
    out.update(ms=ms, share=max(t["compute_s"], t["memory_floor_s"])
               / (ms / 1e3))
    return out


def main(argv=None):
    """CLI driver: dry-run the requested (arch, shape) grid."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-dtype", type=str, default="float32")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--out", type=str, default="build/dryrun")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="cuda (the default; raises without a card): count "
                    "on meta and run the probes on the card; meta: count "
                    "only")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in list_architectures() for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    failures = []
    for arch, shape in combos:
        fname = os.path.join(args.out, f"{arch}__{shape}{args.tag}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"skip existing {fname}")
            continue
        try:
            res = dryrun_one(arch, shape, opt_dtype=args.opt_dtype,
                             remat=not args.no_remat,
                             loss_chunk=args.loss_chunk,
                             extrapolate=not args.no_extrapolate,
                             device=args.device)
        except torch.cuda.OutOfMemoryError:
            raise
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((arch, shape, repr(e)[:500]))
            print(f"FAILED {arch} x {shape}: {e!r}", flush=True)
            continue
        with open(fname, "w") as f:
            json.dump(res, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nAll {len(combos)} dry-runs succeeded.")


if __name__ == "__main__":
    main()
