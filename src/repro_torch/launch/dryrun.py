"""The dry-run (port of ``repro.launch.dryrun``): count every (arch x
shape) on ``meta`` at full width, on one card or for one device of a
mesh, run its probes on the card, and write the reference's roofline
record.

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

Over a mesh (``--mesh 16x16``, ``--multipod`` for 2x16x16; the
reference's options ``--moe-mode``, ``--zero``, ``--seq-parallel`` and
``shard_params_data``) the record is one device's: the step runs over
the mesh's ranks in one process (``models.sharded``, ``launch.train``'s
``mesh_step``), the parameters and the optimizer state placed by the
reference's rules (``param_pspecs``, ``zero_shard_specs``), the batch
split as ``batch_pspecs`` says and a decode step's cache as the
reference's ``cache_pspecs`` says (``shard_cache``; ``cache_layouts``
sets each leaf's bytes beside the spec's).  The counter holds each op
and storage to the rank it belongs to, and the record takes one rank's
FLOPs, bytes, launches and collective bytes (by kind, forward and
backward) and the largest any one rank holds (``count_mesh_step``).  Every data rank runs
the same shapes, so a production mesh is counted over its ranks at data
index 0 only (``data_slice``: 16 ranks stand for 256 or 512);
tests/test_torch_dryrun_mesh.py holds that to all the ranks of small
meshes.  Probes are at batch dp and 2·dp, as in the reference; a
production mesh's are counted at once, a process each
(``count_probes``).  A mesh
of at most ``CARD_RANKS`` ranks also runs its probes with every rank on
card 0 (its FLOPs, launches and collective bytes must equal the count);
a production mesh is counted on ``meta`` only.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --device meta   # no card
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
      --mesh 16x16 --device meta
Options: --opt-dtype bfloat16  --no-remat  --loss-chunk N  --no-extrapolate
         --mesh DxM | --multipod  --moe-mode tensor|expert  --zero
         --seq-parallel
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
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
from repro_torch.sharding.specs import (_axes, _div, _entry, _zip_specs,
                                        batch_axes, cache_pspecs)
from repro_torch.tree import tree_leaves, tree_map

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
# Sharding spec builders (the reference's rules; a spec is a tuple, one
# entry a dim: None, an axis name, or a tuple of names).  The cache's,
# ``cache_pspecs``, live in ``sharding.specs``: the meshed decode step
# holds its cache by them.
# ---------------------------------------------------------------------------
def batch_pspecs(batch_struct, mesh):
    """Specs sharding every batch leaf's dim 0 over the batch axes (dim 1
    where dim 0 does not divide)."""
    baxes = batch_axes(mesh)

    def one(leaf):
        dims = [None] * len(leaf.shape)
        if baxes and _div(leaf.shape[0], mesh, baxes):
            dims[0] = _entry(baxes)
        elif len(leaf.shape) >= 2 and baxes and _div(leaf.shape[1], mesh,
                                                     baxes):
            dims[1] = _entry(baxes)
        return tuple(dims)

    return tree_map(one, batch_struct)


def zero_shard_specs(specs, struct, mesh):
    """ZeRO-style sharding: the batch axes on the first unsharded,
    divisible dim of each leaf (the optimizer's moments; with
    ``shard_params_data`` the weights too)."""
    baxes = batch_axes(mesh)
    if not baxes:
        return specs

    def one(path, leaf, spec):
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (d, s) in enumerate(zip(leaf.shape, dims)):
            if s is None and _div(d, mesh, baxes):
                dims[i] = _entry(baxes)
                break
        return tuple(dims)

    return _zip_specs(one, struct, specs)


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


# ---------------------------------------------------------------------------
# The mesh half: one rank's count of a step over a mesh
# ---------------------------------------------------------------------------
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def parse_mesh(mesh: Union[None, str, Tuple[int, ...]],
               multi_pod: bool = False) -> Optional[Tuple[int, ...]]:
    """``"16x16"`` / ``(16, 16)`` / ``multi_pod`` (2x16x16) -> the mesh's
    shape, None for the one-card mode."""
    if multi_pod:
        return (2, 16, 16)
    if mesh is None:
        return None
    shape = tuple(int(x) for x in mesh.split("x")) if isinstance(mesh, str) \
        else tuple(int(x) for x in mesh)
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"a mesh is (data, model) or (pod, data, model), "
                         f"got {mesh!r}")
    return shape


def mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(str(n) for n in shape)


def data_slice(mesh):
    """``mesh`` with only its ranks at index 0 of its leading batch axes
    ('pod', 'data') run: the first size / dp ranks in row-major order.
    The others are counted, not run: a collective over a batch axis
    stands in for the absent ranks' parts with a present one's (shapes
    only, on ``meta``), which is exact for a count because every data
    rank runs the same shapes (tests/test_torch_dryrun_mesh.py holds it
    to all the ranks)."""
    from repro_torch.launch.mesh import Mesh
    lead = 0
    while lead < len(mesh.axis_names) and \
            mesh.axis_names[lead] in ("pod", "data"):
        lead += 1
    if any(a in ("pod", "data") for a in mesh.axis_names[lead:]):
        raise ValueError(f"the batch axes must lead: {mesh.axis_names}")
    dp = math.prod(mesh.devices.shape[:lead])
    return Mesh(mesh.devices, mesh.axis_names, run=mesh.size // dp)


def make_count_mesh(shape: Tuple[int, ...], device, sliced: bool = True):
    """The (data, model) or (pod, data, model) mesh of ``shape`` with
    every slot on ``device``; ``sliced``: only the ranks at data index 0
    run (``data_slice``)."""
    from repro_torch.launch.mesh import make_mesh
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    mesh = make_mesh(shape, axes, device)
    return data_slice(mesh) if sliced else mesh


def _rank_tensors(x) -> list:
    """Rank 0's tensors of a step's arguments or outputs (a per-rank list
    is rank 0's entry; a ``Sharded`` or ``RankCaches`` its first part)."""
    from repro_torch.models.sharded import RankCaches
    from repro_torch.sharding.collectives import Sharded
    if isinstance(x, (Sharded, RankCaches)):
        return tree_leaves(x.parts[0])
    if isinstance(x, tuple):
        return [t for v in x for t in _rank_tensors(v)]
    if isinstance(x, list):
        return tree_leaves(x[0])
    return tree_leaves(x)


def _nbytes(tensors, exclude=()) -> int:
    seen = set(exclude)
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _split_bytes(tree, specs, mesh) -> float:
    """Bytes of one rank's share of whole tensors laid out by ``specs``."""
    out = []
    _zip_specs(lambda path, t, spec: out.append(
        t.numel() * t.element_size() / math.prod(
            mesh.shape[a] for e in spec for a in _axes(e)
            if a in mesh.axis_names)), tree, specs)
    return sum(out)


def build_mesh_step(cfg, shape: InputShape, mesh, device, *,
                    opt_dtype="float32", remat=True, loss_chunk=0,
                    zero=False, shard_params_data=False):
    """The step of ``shape.kind`` over ``mesh`` (installed here; the
    caller uninstalls it) and its arguments: each rank's parameters
    from ``place`` (a storage of its own each, so that a count holds
    each rank's), its optimizer state (``zero``: the moments split over
    the data axes too), and the whole batch, or each rank's cache
    (``models.sharded.shard_cache``).  ``shard_params_data`` (serving)
    also splits the weights over the data axes, all-gathered at the
    step's entry.  Returns (step, args, one rank's argument bytes)."""
    from repro_torch.launch.train import (gather_zero, mesh_init,
                                          mesh_step)
    from repro_torch.models.sharded import shard_cache
    from repro_torch.sharding import specs as shd
    if shard_params_data and shape.kind == "train":
        raise ValueError("shard_params_data is for serving: a training "
                         "step's weights are the optimizer's (use zero)")
    ins = input_specs(cfg, shape)
    cfg = resolve_config(cfg, shape)
    dev = torch.device(device)
    shd.set_mesh(mesh)
    if dev.type == "meta":
        params, inputs = tf_model.init_params(None, cfg), ins
    else:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = tf_model.init_params(gen, cfg)
        inputs = _materialize(ins, gen, cfg, shape.seq)
    mode = cfg.moe.sharding_mode if cfg.moe is not None else "tensor"
    pspecs = shd.param_pspecs(params, mode)
    held = zero_shard_specs(pspecs, params, mesh) if shard_params_data \
        else pspecs
    mspecs = zero_shard_specs(pspecs, params, mesh) if zero else None
    parts = [tree_map(lambda t: t.clone(), p)
             for p in shd.place(params, held, mesh)]
    del params
    if shape.kind == "train":
        opt = adamw(3e-4, state_dtype=opt_dtype)
        state = mesh_init(opt, parts, pspecs, mspecs)

        def train_step(parts, state, batch):
            ps = [tree_map(lambda p: p.detach().requires_grad_(True), r)
                  for r in parts]
            with phase("forward"):
                loss, _ = tf_model.train_loss(ps, batch, cfg, remat=remat,
                                              loss_chunk=loss_chunk)
            with phase("backward"):
                loss.backward()
            grads = tree_map(lambda p: p.grad, ps)
            with phase("optimizer"), torch.no_grad():
                new, st = mesh_step(opt, ps, grads, state, pspecs, mspecs)
            return loss.detach(), new, st

        batch = inputs["batch"]
        args_b = (_nbytes(_rank_tensors((parts, state)))
                  + _split_bytes(batch, batch_pspecs(batch, mesh), mesh))
        return train_step, (parts, state, batch), args_b

    def weights(parts):
        return gather_zero(parts, pspecs, held) if shard_params_data \
            else parts

    if shape.kind == "prefill":
        def prefill_step(parts, batch):
            with torch.no_grad():
                return tf_model.prefill(weights(parts), batch, cfg)

        batch = inputs["batch"]
        args_b = (_nbytes(_rank_tensors((parts,)))
                  + _split_bytes(batch, batch_pspecs(batch, mesh), mesh))
        return prefill_step, (parts, batch), args_b

    def decode_step(parts, cache, tokens, pos):
        with torch.no_grad():
            return tf_model.decode_step(weights(parts), cache, tokens, pos,
                                        cfg)

    cache = shard_cache(inputs["cache"], cfg)
    tok = inputs["tokens"]
    args_b = (_nbytes(_rank_tensors((parts, cache)))
              + _split_bytes(tok, batch_pspecs(tok, mesh), mesh))
    return decode_step, (parts, cache, tok, shape.seq - 1), args_b


def count_mesh_step(step, args, args_b: float,
                    counter: Optional[CostCounter] = None
                    ) -> Dict[str, float]:
    """Run a meshed ``step(*args)`` under a ``CostCounter`` over the
    installed mesh's ranks: one rank's counts, its argument bytes
    ``args_b`` and the bytes of its outputs that are not arguments.

    The rank is rank 0: its FLOPs, bytes, launches and collective
    results (``by_rank``; it alone seeds the loss's backward, a few
    scalar ops), plus its 1/n of the ops that belong to no one rank (a
    backward's masks built from nothing: one set per rank).  The peak is
    the largest any one rank holds.  The ranks run the same shapes, so
    this is each device's count (``tests/test_torch_dryrun_mesh.py``
    holds a mesh's data slice to all its ranks).  ``counter``: a
    ``CostCounter`` over the ranks run to count in (a new one)."""
    from repro_torch.sharding.specs import get_mesh, rank_devices
    n = len(rank_devices(get_mesh()))
    counter = counter or CostCounter(n_ranks=n)
    for a in args:
        if isinstance(a, list) or hasattr(a, "parts"):
            for r in range(n):
                counter.own(a[r] if isinstance(a, list) else a.parts[r], r)
    arg_ids = {id(t) for t in _rank_tensors(tuple(args))}
    with counter:
        out = step(*args)
    summary = counter.summary()
    empty = {"flops": {}, "bytes": 0, "launches": {}, "collectives": {}}
    own = summary["by_rank"].get("0", empty)
    shared = summary["by_rank"].get("shared", empty)
    flat = {f"flops:{d}": own["flops"].get(d, 0) + shared["flops"].get(d, 0)
            / n for d in set(own["flops"]) | set(shared["flops"])}
    flat.update({f"launches:{k}": c for k, c in own["launches"].items()})
    flat.update({f"collective:{k}": b
                 for k, b in own["collectives"].items()})
    flat["collective_ops"] = summary["collective_ops"] / n
    flat.update({f"peak:{k}": v for k, v in summary["phase_peaks"].items()})
    flat.update(bytes_accessed=own["bytes"] + shared["bytes"] / n,
                peak_bytes=summary["peak_bytes"], argument_bytes=args_b,
                output_bytes=_nbytes(_rank_tensors(out), arg_ids))
    return flat


def _collectives(flat: Dict[str, float]) -> Dict[str, float]:
    """The record's ``collectives``: result bytes per device by kind (the
    reference's five, the two the port never runs at 0) and the count."""
    got = _by_kind(flat, "collective:")
    out = {k: got.get(k, 0.0) for k in COLLECTIVE_KINDS}
    out["count"] = flat.get("collective_ops", 0.0)
    return out


def cache_layouts(cfg, shape: InputShape, mesh) -> Dict[str, dict]:
    """Each cache leaf of a decode shape: the reference's spec
    (``cache_pspecs``), its bytes a device under it and as the port's
    decode step holds it (``shard_cache``, on ``meta``), and whether
    they differ."""
    from repro_torch.models.sharded import shard_cache
    from repro_torch.sharding import specs as shd
    cache = input_specs(cfg, shape)["cache"]
    ref = cache_pspecs(cache, mesh)
    prev = shd.get_mesh()
    shd.set_mesh(mesh)
    try:
        port = shard_cache(cache, resolve_config(cfg, shape)).parts[0]
    finally:
        shd.set_mesh(prev)
    out = {}
    for b, leaves in cache.items():
        for name, t in leaves.items():
            rb = _split_bytes(t, ref[b][name], mesh)
            pb = _nbytes([port[b][name]])
            out[f"{b}/{name}"] = {"reference_spec": list(ref[b][name]),
                                  "reference_bytes_per_device": rb,
                                  "port_bytes_per_device": pb,
                                  "differ": rb != pb}
    return out


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
    times = _events_ms(step, args, reps)
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


def _events_ms(step, args, reps) -> list:
    """``reps`` runs of ``step(*args)``, each timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


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


def below_zero(full: Dict[str, float]) -> list:
    """A note for each count the law extends below zero: the probes do not
    follow the law there (or a probe's count is wrong).  The record keeps
    the raw value."""
    return [f"the law extends {k} below zero ({v!r}): the probes do not "
            f"follow it" for k, v in sorted(full.items()) if v < 0]


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


def _probe_points(cfg, shape, extrapolate: bool, dp: int = 1):
    """The (periods, batch) probes and the law's name.  Depth is probed
    at 2 and 3 periods, not the reference's 1 and 2: one period's caches
    are views (``transformer._stack``), two or more are stacked copies,
    so a one-period probe lies off the law its bytes follow.  Over a
    mesh of ``dp`` data ranks the batch is probed at dp and 2·dp, as in
    the reference, where it splits evenly and reaches 2·dp."""
    if extrapolate and cfg.n_periods > PROBE_PERIODS[1]:
        if shape.batch >= 2 * dp and shape.batch % dp == 0:
            return ([(p, b * dp) for b in PROBE_BATCHES
                     for p in PROBE_PERIODS], "bilinear(P,B)")
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
               multi_pod: bool = False, mesh=None,
               moe_mode: Optional[str] = None, zero: bool = False,
               opt_dtype: str = "float32", remat: bool = True,
               seq_parallel: bool = False, loss_chunk: int = 0,
               shard_params_data: bool = False, extrapolate: bool = True,
               device="cuda", smoke: bool = False, reps: int = 3,
               hw: HW = H100, verbose: bool = True) -> dict:
    """Count one combination on ``meta`` (and, on the card, run its
    probes); returns the roofline record.  ``device`` is ``"cuda"`` (the
    default; raises without a card) or ``"meta"`` (counts only).
    ``smoke`` takes the architecture's smoke config and ``shape_name``
    may be an ``InputShape`` of one's own (the tests' small sizes).

    Without ``mesh`` or ``multi_pod``, one card holds the whole step.
    With ``mesh`` ("16x16", (1, 2), ...) or ``multi_pod`` (2x16x16) the
    record is one device's of that mesh (``_dryrun_mesh``), under the
    reference's options ``moe_mode``, ``zero``, ``seq_parallel`` and
    ``shard_params_data``."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"the dry-run counts on meta or runs on the card, "
                         f"not on {dev.type}")
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if moe_mode and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding_mode=moe_mode))
    cfg = resolve_config(cfg, shape)
    opts = dict(opt_dtype=opt_dtype, remat=remat, loss_chunk=loss_chunk)
    mesh_shape = parse_mesh(mesh, multi_pod)
    if mesh_shape is not None:
        return _dryrun_mesh(arch, cfg, shape, mesh_shape, dict(
            opts, zero=zero, shard_params_data=shard_params_data),
            dict(moe_mode=moe_mode, zero=zero, seq_parallel=seq_parallel,
                 shard_params_data=shard_params_data), dev, extrapolate,
            reps, hw, verbose)
    if moe_mode or zero or seq_parallel or shard_params_data:
        raise ValueError("moe_mode, zero, seq_parallel and "
                         "shard_params_data are options of a mesh")
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
    peak_b = full["peak_bytes"]

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

    result = _record(
        arch, cfg, shape, full, hw, "1", 1, {}, count_s, extrapolated,
        {"moe_mode": None, "zero": False, "opt_dtype": opt_dtype,
         "remat": remat, "seq_parallel": False, "loss_chunk": loss_chunk,
         "shard_params_data": False}, dev,
        "counted on meta: the peak of the storages the step creates, "
        "extended from the probes phase by phase along the same law"
        if extrapolated else "counted on meta at full depth and batch")
    result["probes"] = [probe_row(p, b) for p, b in pts]
    if dev.type == "cuda":
        result["measured"] = _measured(result, card, n_periods, b_full,
                                       peak_b)
    if verbose:
        print(f"== {arch} x {shape.name} on one {hw.name} ({dev.type}) ==")
        _print(result)
        if "measured" in result:
            print(f"measured: {result['measured']}", flush=True)
    return result


def _record(arch, cfg, shape, full, hw, mesh, n_dev, colls, count_s,
            extrapolated, options, dev, memory_source) -> dict:
    """The reference's record of one device's extended count ``full``
    (``colls``: its collectives by kind, {} on one card)."""
    flops = _by_kind(full, "flops:")
    flops_dev = sum(flops.values())
    bytes_dev = full["bytes_accessed"]
    coll_dev = sum(colls.get(k, 0.0) for k in COLLECTIVE_KINDS)
    terms = roofline_terms(flops, bytes_dev, coll_dev, hw)
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
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh,
        "n_devices": n_dev, "kind": shape.kind,
        "flops_per_device": flops_dev,
        "flops_by_dtype": flops,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": colls,
        "roofline": terms,
        "model_flops": model_flops,
        "hlo_flops_global": flops_dev * n_dev,
        "model_flops_ratio": (model_flops / (flops_dev * n_dev)
                              if flops_dev else None),
        "memory": {"argument_size_in_bytes": args_b,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": max(peak_b - out_b, 0),
                   "alias_size_in_bytes": 0,
                   "generated_code_size_in_bytes": None},
        "memory_source": memory_source,
        "bytes_floor_per_device": bytes_floor,
        "hbm_per_device_gb": per_dev_hbm / 1e9,
        "fits_hbm": bool(per_dev_hbm <= hw.hbm_bytes),
        "launches": _launches(full),
        "lower_s": round(count_s, 2),       # the meta counts' seconds
        "compile_s": None,                  # nothing is compiled
        "extrapolated": extrapolated,
        "options": options,
        "hw": hw.name, "device": dev.type,
    }


def _print(rec) -> None:
    t = rec["roofline"]
    print(f"count (extrapolated={rec['extrapolated']}): flops/dev="
          f"{rec['flops_per_device']:.4e} "
          f"{ {d: f'{f:.3e}' for d, f in rec['flops_by_dtype'].items()} } "
          f"bytes/dev={rec['bytes_per_device']:.4e} "
          f"launches={rec['launches']}")
    if rec["collectives"]:
        print(f"collectives/dev: {rec['collectives']}")
    print(f"roofline: compute={t['compute_s']:.6f}s "
          f"memory={t['memory_s']:.6f}s (floor {t['memory_floor_s']:.6f}s) "
          f"collective={t['collective_s']:.6f}s dominant={t['dominant']}")
    print(f"hbm/dev={rec['hbm_per_device_gb']:.3f} GB "
          f"fits={rec['fits_hbm']} count {rec['lower_s']:.1f} s", flush=True)


# the most ranks a card probe of a mesh puts on card 0: a production
# mesh's 256 or 512 ranks on one card would measure nothing per device
CARD_RANKS = 8


def _count_on_mesh(cfg, shape, mesh, device, seq_parallel, opts):
    from repro_torch.sharding import specs as shd
    shd.set_seq_parallel(seq_parallel)
    try:
        return count_mesh_step(*build_mesh_step(cfg, shape, mesh, device,
                                                **opts))
    finally:
        shd.set_mesh(None)
        shd.set_seq_parallel(False)


def _count_probe(cfg, shape, mesh_shape, seq_parallel, opts):
    """One probe counted on ``meta`` over ``mesh_shape``'s data slice."""
    return _count_on_mesh(cfg, shape, make_count_mesh(mesh_shape, "meta"),
                          "meta", seq_parallel, opts)


def count_probes(probes: dict, jobs: int) -> dict:
    """``_count_probe(*args)`` for each ``{key: args}``, up to ``jobs`` at
    once, each in a process of its own (in this one where ``jobs`` is
    1)."""
    if jobs <= 1 or len(probes) <= 1:
        return {k: _count_probe(*a) for k, a in probes.items()}
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(min(jobs, len(probes)), mp_context=(
            multiprocessing.get_context("spawn"))) as pool:
        futures = {k: pool.submit(_count_probe, *a)
                   for k, a in probes.items()}
        return {k: f.result() for k, f in futures.items()}


def _card_mesh_probe(cfg, shape, mesh_shape, seq_parallel, opts, counted,
                     reps):
    """One probe with every rank on card 0: warm-up, a run under the
    counter (its FLOPs, launches and collective bytes must equal the
    ``meta`` count's), then ``reps`` runs timed with CUDA events.  The
    card holds all the ranks at once, so its peak and time are not one
    device's.  ``launches_every_rank``: the counted run's launches over
    all the ranks, by kernel and variant."""
    from repro_torch.sharding import specs as shd
    mesh = make_count_mesh(mesh_shape, "cuda:0", sliced=False)
    shd.set_seq_parallel(seq_parallel)
    try:
        step, args, args_b = build_mesh_step(cfg, shape, mesh, "cuda:0",
                                              **opts)
        step(*args)
        torch.cuda.synchronize()
        counter = CostCounter(n_ranks=math.prod(mesh_shape))
        card = count_mesh_step(step, args, args_b, counter)
        torch.cuda.synchronize()
        every_rank = counter.summary()["launches"]
        times = _events_ms(step, args, reps)
    finally:
        shd.set_mesh(None)
        shd.set_seq_parallel(False)
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    keys = [k for k in set(card) | set(counted)
            if k.startswith(("flops:", "launches:", "collective:"))]
    return {"ms": statistics.median(times), "ms_reps": times,
            "ranks_on_one_card": math.prod(mesh_shape),
            "launches_every_rank": every_rank,
            "bytes_accessed": card["bytes_accessed"],
            "counted_bytes_accessed": counted["bytes_accessed"],
            "count_equal": all(card.get(k, 0) == counted.get(k, 0)
                               for k in keys),
            "card_count": {k: card[k] for k in sorted(card)}}


def _dryrun_mesh(arch, cfg, shape, mesh_shape, opts, options, dev,
                 extrapolate, reps, hw, verbose) -> dict:
    """``dryrun_one`` over a mesh: each probe counted on ``meta`` over the
    mesh's data slice (``data_slice``), extended along the law, and,
    for a mesh of at most ``CARD_RANKS`` ranks, run with every rank on
    card 0 (``_card_mesh_probe``)."""
    n_dev = math.prod(mesh_shape)
    dp = math.prod(mesh_shape[:-1])
    name = mesh_name(mesh_shape)
    seq_parallel = options["seq_parallel"]
    pts, extrapolated = _probe_points(cfg, shape, extrapolate, dp)
    n_periods, b_full = cfg.n_periods, shape.batch
    t0 = time.time()
    card = {}
    # a production mesh's probe takes seconds to count: one process each
    jobs = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1) if n_dev > CARD_RANKS else 1
    counts = count_probes({(p, b): (
        _with_periods(cfg, p), dataclasses.replace(shape, batch=b),
        mesh_shape, seq_parallel, opts) for p, b in pts}, jobs)
    count_s = time.time() - t0
    if verbose:
        print(f"  {len(pts)} probes on {name} counted in {count_s:.1f} s "
              f"over {n_dev // dp} of {n_dev} ranks ({min(jobs, len(pts))} "
              f"at once)", flush=True)
    card_note = None
    if dev.type == "cuda":
        if n_dev > CARD_RANKS:
            card_note = (f"no card probe: {n_dev} ranks on one card would "
                         f"measure nothing per device; counted on meta "
                         f"only")
        else:
            limit = FIT_SHARE * torch.cuda.get_device_properties(
                0).total_memory
            for (p, b), c in counts.items():
                need = n_dev * (c["argument_bytes"] + c["peak_bytes"])
                if need > limit:
                    card[p, b] = {"skipped": f"{n_dev} ranks do not fit on "
                                  f"one card: {need / 1e9:.2f} GB"}
                    continue
                card[p, b] = _card_mesh_probe(
                    _with_periods(cfg, p), dataclasses.replace(shape,
                                                               batch=b),
                    mesh_shape, seq_parallel, opts, c, reps)
    full = _law(counts, n_periods, b_full)
    notes = below_zero(full)
    if cfg.moe is not None and extrapolated:
        notes.append("a MoE step's capacity rounds up to 4 tokens an "
                     "expert, so its cost is not affine in B or P: the "
                     "law's FLOPs, bytes and collective term are a floor")
    if card_note:
        notes.append(card_note)
    result = _record(
        arch, cfg, shape, full, hw, name, n_dev, _collectives(full),
        count_s, extrapolated, {**options, "opt_dtype": opts["opt_dtype"],
                                "remat": opts["remat"],
                                "loss_chunk": opts["loss_chunk"]}, dev,
        "counted on meta: the largest one rank holds of the storages the "
        "step creates (each storage live on the ranks it belongs to), "
        "extended phase by phase along the law")
    result.update(
        counted_ranks=n_dev // dp,
        card_probe=card_note or ("run" if card else "not run: meta"),
        notes=notes,
        probes=[{"periods": p, "batch": b, "count": counts[p, b],
                 **card.get((p, b), {})} for p, b in pts])
    if shape.kind == "decode":
        layouts = cache_layouts(cfg, shape, make_count_mesh(
            mesh_shape, "meta"))
        result["cache_layouts"] = layouts
        result["cache_bytes_per_device"] = {
            who: sum(v[f"{who}_bytes_per_device"] for v in layouts.values())
            for who in ("port", "reference")}
    if verbose:
        print(f"== {arch} x {shape.name} on {name} ({n_dev} devices, "
              f"{dev.type}) ==")
        _print(result)
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
    ap.add_argument("--mesh", type=str, default=None,
                    help="count one device of a (data x model) or (pod x "
                    "data x model) mesh, e.g. 16x16 (default: one card)")
    ap.add_argument("--multipod", action="store_true",
                    help="the 2x16x16 mesh")
    ap.add_argument("--moe-mode", type=str, default=None,
                    choices=["tensor", "expert"])
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--opt-dtype", type=str, default="float32")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--out", type=str, default=None,
                    help="default build/dryrun (one card), "
                    "build/dryrun_mesh (a mesh)")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="cuda (the default; raises without a card): count "
                    "on meta and run the probes on the card; meta: count "
                    "only")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    meshed = args.mesh is not None or args.multipod
    if not meshed and (args.moe_mode or args.zero or args.seq_parallel):
        ap.error("--moe-mode, --zero and --seq-parallel need --mesh or "
                 "--multipod")
    out_dir = args.out or ("build/dryrun_mesh" if meshed else "build/dryrun")
    # the reference's names: a 2x16x16 record ends in _mp
    tag = args.tag + ("_mp" if args.multipod else "")

    os.makedirs(out_dir, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in list_architectures() for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    failures = []
    for arch, shape in combos:
        fname = os.path.join(out_dir, f"{arch}__{shape}{tag}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"skip existing {fname}")
            continue
        try:
            res = dryrun_one(arch, shape, multi_pod=args.multipod,
                             mesh=args.mesh, moe_mode=args.moe_mode,
                             zero=args.zero, seq_parallel=args.seq_parallel,
                             opt_dtype=args.opt_dtype,
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
