"""The dry-run's mesh half on the CPU: the spec builders against the
reference's, each collective's bytes forward and backward, one rank's
count (the ranks' symmetry, a mesh's data slice against all its
ranks), ``shard_cache`` and the 16x16 / 2x16x16 records.

The reference's ``batch_pspecs`` / ``cache_pspecs`` /
``zero_shard_specs`` read only a mesh's ``shape`` and ``axis_names``, so
they run here on a stand-in of the production meshes; importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the process, which
``_reference_dryrun`` puts back.  The port counts on ``meta``.
Tolerances, each with its reason:

* specs, record keys, collective bytes (closed forms), the ranks'
  counts against each other and a data slice's against all the ranks':
  equal (the same integer arithmetic over the same ops);
* a meshed prefill's caches against ``shard_cache`` of the unsharded
  prefill's: 1e-4, ``tests/test_torch_zoo.py``'s ``MODEL_TOL`` (the
  same products in another order); ``gather_cache(shard_cache(c))``:
  bitwise.
"""
import ast
import dataclasses
import os
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import shapes as j_shapes  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.sharding import param_pspecs as j_param_pspecs  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_architectures)
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.launch.shapes import input_specs  # noqa: E402
from repro_torch.metrics.cost import CostCounter  # noqa: E402
from repro_torch.models import sharded  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ARCHS = list_architectures()
ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = 1e-4
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture
def mesh():
    def install(shape, axes=("data", "model"), device="cpu"):
        m = make_mesh(shape, axes, device)
        specs.set_mesh(m)
        return m
    yield install
    specs.set_mesh(None)
    specs.set_seq_parallel(False)


# ---------------------------------------------------------------------------
# the spec builders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_builders_match_the_reference(arch, mesh_name):
    """``batch_pspecs`` of every train / prefill batch, ``cache_pspecs``
    of every decode cache, ``zero_shard_specs`` over the parameters in
    both MoE modes: the reference's specs as tuples."""
    ref = _reference_dryrun()
    shape, axes = MESHES[mesh_name]
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=axes)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for name, sh in INPUT_SHAPES.items():
        want = j_shapes.input_specs(jcfg, j_shapes.INPUT_SHAPES[name])
        got = input_specs(cfg, sh)
        if "batch" in want:
            assert _tuples(ref.batch_pspecs(want["batch"], stand_in)) == \
                dryrun.batch_pspecs(got["batch"], stand_in), name
        else:
            assert _tuples(ref.cache_pspecs(want["cache"], stand_in)) == \
                dryrun.cache_pspecs(got["cache"], stand_in), name
    jstruct = jax.eval_shape(lambda k: j_tf.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    params = t_tf.init_params(None, cfg)
    for mode in ("tensor", "expert"):
        assert _tuples(ref.zero_shard_specs(
            j_param_pspecs(jstruct, moe_mode=mode), jstruct, stand_in)) \
            == dryrun.zero_shard_specs(specs.param_pspecs(params, mode),
                                       params, stand_in), mode


# ---------------------------------------------------------------------------
# the collectives' bytes
# ---------------------------------------------------------------------------
# (kind, its function, dual, per-rank part shape, fwd / bwd result shape)
_CASES = {
    "all-reduce": (lambda p: col.all_reduce(p, "model"), "all-reduce",
                   (4, 6), (4, 6)),
    "all-gather": (lambda p: col.all_gather(p, "model", dim=0),
                   "reduce-scatter", (8, 6), (4, 6)),
    "reduce-scatter": (lambda p: col.reduce_scatter(p, "model", dim=0),
                       "all-gather", (2, 6), (4, 6)),
}


@pytest.mark.parametrize("kind", list(_CASES))
def test_collective_bytes_forward_and_backward(kind, mesh):
    """Over (data 2, model 2), parts of (4, 6) fp32: each of the 4 ranks
    counts its result's bytes (the reference's convention), in the
    forward and again, as the dual collective, in the backward; the
    collectives' own adds and copies are no FLOPs and no bytes; values
    and gradients are the plain composition's."""
    mesh((2, 2))
    fn, dual, fwd_shape, bwd_shape = _CASES[kind]
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn((4, 6), generator=gen).requires_grad_()
             for _ in range(4)]
    weights = [torch.randn(fwd_shape, generator=gen) for _ in range(4)]
    counter = CostCounter(n_ranks=4)
    with counter:
        out = fn(parts)
        fwd = dict(counter.collectives)
        assert dict(counter.flops) == {} and counter.bytes_accessed == 0
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        loss.backward()
    per = {"fwd": 4 * int(np.prod(fwd_shape)), "bwd": 4 * int(np.prod(
        bwd_shape))}
    assert fwd == {kind: 4 * per["fwd"]}
    bwd = {k: v - fwd.get(k, 0) for k, v in counter.collectives.items()}
    assert {k: v for k, v in bwd.items() if v} == {dual: 4 * per["bwd"]}
    assert counter.collective_ops == 8
    for r in range(4):
        got = counter.by_rank[r]["collectives"]
        assert got[kind] == per["fwd"] + (per["bwd"] if dual == kind else 0)
    # the plain composition: model pairs (0, 1) and (2, 3)
    pairs = [(0, 1), (0, 1), (2, 3), (2, 3)]
    ref_parts = [p.detach().clone().requires_grad_() for p in parts]
    want = []
    for r, (a, b) in enumerate(pairs):
        if kind == "all-reduce":
            want.append(ref_parts[a] + ref_parts[b])
        elif kind == "all-gather":
            want.append(torch.cat([ref_parts[a], ref_parts[b]]))
        else:
            want.append((ref_parts[a] + ref_parts[b]).chunk(2)[r % 2])
    sum((o * w).sum() for o, w in zip(want, weights)).backward()
    for o, w in zip(out, want):
        assert torch.equal(o.detach(), w.detach())
    for p, q in zip(parts, ref_parts):
        assert torch.allclose(p.grad, q.grad, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one rank's count
# ---------------------------------------------------------------------------
SMALL = {k: InputShape(f"small_{k}", k, 32, 4)
         for k in ("train", "prefill", "decode")}


def _count(arch, kind, mesh_shape, sliced, counter=None, forward=False,
           mode=None, **opts):
    cfg = get_smoke_config(arch)
    if mode is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding_mode=mode))
    m = dryrun.make_count_mesh(mesh_shape, "meta", sliced)
    try:
        step, args, args_b = dryrun.build_mesh_step(cfg, SMALL[kind], m,
                                                    "meta", **opts)
        if forward:
            def step(parts, state, batch):
                return t_tf.train_loss(parts, batch, cfg, remat=True)
        if counter is None:
            counter = CostCounter(n_ranks=len(specs.rank_devices(m)))
        return dryrun.count_mesh_step(step, args, args_b, counter), counter
    finally:
        specs.set_mesh(None)


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("internlm2-1.8b", "mixtral-8x22b", "mamba2-370m",
                     "seamless-m4t-medium")
    for k in ("train", "prefill", "decode")])
def test_ranks_do_the_same_work(arch, kind):
    """Over (data 2, model 2) on meta, each rank's share of a forward
    (the training loss's, a prefill, a decode step), counted where it
    runs (``rank_map``) and by the storages it reads: the same FLOPs
    by dtype, bytes, launches by variant and collective bytes on every
    rank, and nothing that belongs to no one rank."""
    _, counter = _count(arch, kind, (2, 2), sliced=False,
                        forward=kind == "train")
    by = counter.summary()["by_rank"]
    assert set(by) <= {"0", "1", "2", "3", "shared"}
    for r in ("1", "2", "3"):
        assert by[r] == by["0"], r
    assert by["0"]["flops"] and by["0"]["collectives"]
    shared = by.get("shared", {"flops": {}, "bytes": 0, "launches": {}})
    assert not shared["flops"] and not shared["bytes"] \
        and not shared["launches"]


@pytest.mark.parametrize("arch,kind,mode,opts,mesh_shape", [
    ("internlm2-1.8b", "train", None, {}, (2, 2)),
    ("internlm2-1.8b", "train", None, {"zero": True}, (2, 2)),
    ("internlm2-1.8b", "train", None, {"zero": True}, (2, 2, 2)),
    ("mixtral-8x22b", "train", "tensor", {"zero": True}, (2, 2)),
    ("mixtral-8x22b", "train", "expert", {}, (2, 2)),
    ("mamba2-370m", "train", None, {"zero": True}, (2, 2)),
    ("seamless-m4t-medium", "train", None, {}, (2, 2)),
    ("internlm2-1.8b", "prefill", None, {"shard_params_data": True},
     (2, 2)),
    ("mixtral-8x22b", "prefill", "expert", {}, (2, 2)),
    ("mamba2-370m", "decode", None, {"shard_params_data": True}, (2, 2)),
    ("seamless-m4t-medium", "decode", None, {}, (2, 2)),
    ("llama-3.2-vision-11b", "prefill", None, {"shard_params_data": True},
     (2, 2, 2)),
])
def test_a_data_slice_counts_as_all_ranks(arch, kind, mode, opts,
                                          mesh_shape):
    """The dry-run counts a production mesh over its ranks at data index
    0 only (``dryrun.data_slice``): one rank's FLOPs by dtype, bytes,
    launches by variant, peak (each phase's), argument and output bytes
    and every collective kind equal those of the same mesh with every
    rank run, with ``zero`` and ``shard_params_data`` on and off, over
    (data, model) and (pod, data, model)."""
    every, _ = _count(arch, kind, mesh_shape, False, mode=mode, **opts)
    sliced, counter = _count(arch, kind, mesh_shape, True, mode=mode,
                             **opts)
    assert counter.n_ranks == mesh_shape[-1]
    assert sliced == every
    assert any(k.startswith("collective:") and v for k, v in every.items())
    if opts:
        kinds = {k for k, v in every.items() if k.startswith("collective:")
                 and v}
        assert "collective:all-gather" in kinds


def test_probes_counted_at_once_count_alike():
    """``count_probes``: a production mesh's probes, each counted in a
    process of its own, count as in one process, key for key."""
    cfg = get_smoke_config("internlm2-1.8b")
    probes = {(p, b): (dryrun._with_periods(cfg, p), dataclasses.replace(
        SMALL["train"], batch=b), (2, 2), False, dict(
        opt_dtype="float32", remat=True, loss_chunk=0, zero=True,
        shard_params_data=False)) for p in (2, 3) for b in (2, 4)}
    one = dryrun.count_probes(probes, 1)
    assert dryrun.count_probes(probes, 4) == one
    assert all(c["collective:reduce-scatter"] > 0 for c in one.values())


def test_a_law_below_zero_is_noted():
    """A count the law extends below zero stays in the record, raw, and
    a note says the probes do not follow the law there."""
    full = dryrun._law({(2, 1): {"collective:all-gather": 10.0},
                        (3, 1): {"collective:all-gather": 4.0}}, 8, 1)
    assert full["collective:all-gather"] == -26.0
    (note,) = dryrun.below_zero(full)
    assert "collective:all-gather" in note and "-26.0" in note
    assert dryrun.below_zero({"flops:float32": 0.0}) == []


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_cache_inverts_gather_cache(arch, mesh):
    """``gather_cache(shard_cache(c)) == c`` bit for bit, and
    ``shard_cache`` of the unsharded fp32 prefill's cache is the meshed
    prefill's, over (data 2, model 2) (a MoE model's capacity is a data
    shard's, so it is held over (model 4)) and (model 4)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = t_tf.init_params(gen, cfg)
    batch = {"tokens": torch.from_numpy(next(lm_batches(
        cfg.vocab, 2, 40, 1, seed=0))["tokens"])}
    if cfg.encoder is not None:
        batch["frames"] = torch.randn((2, 48, cfg.d_model), generator=gen)
    if cfg.vision_stub:
        batch["image_embeds"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.d_model), generator=gen)
    with torch.no_grad():
        _, cache = t_tf.prefill(params, batch, cfg)
    shapes = [(1, 4)] + ([] if cfg.moe is not None else [(2, 2)])
    for shape in shapes:
        m = mesh(shape)
        ranks = sharded.shard_cache(cache, cfg)
        back = sharded.gather_cache(ranks, cfg)
        for b in cache:
            for n in cache[b]:
                assert torch.equal(back[b][n], cache[b][n]), (shape, b, n)
        with torch.no_grad():
            _, meshed = t_tf.prefill(specs.place(
                params, specs.param_pspecs(params), m), batch, cfg)
        assert meshed.batch == ranks.batch
        for got, want in zip(ranks.parts, meshed.parts):
            for b in want:
                for n, t in want[b].items():
                    np.testing.assert_allclose(
                        got[b][n].float().numpy(), t.float().numpy(),
                        rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=f"{b}/{n}")
        specs.set_mesh(None)


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------
def _reference_record_keys():
    """The keys of the reference's record and of its ``options``, read
    from ``dryrun_one``'s source (calling it lowers for 512 devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_one")
    result = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    keys = [k.value for k in result.keys]
    options = result.values[keys.index("options")]
    return set(keys), {k.value for k in options.keys}


def test_mesh_records_have_the_reference_keys(tmp_path):
    """``--mesh 16x16`` (the CLI) and ``multi_pod`` records on meta: the
    reference's keys and options, the option values given, per-device
    counts (one device's FLOPs times the devices near the one-card
    count, not the one-card count), a collective term by kind, and for
    a decode cache both layouts side by side."""
    keys, opts = _reference_record_keys()
    dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh",
                 "16x16", "--device", "meta", "--out", str(tmp_path)])
    rec = __import__("json").loads(
        (tmp_path / "qwen3-8b__decode_32k.json").read_text())
    small = InputShape("prefill_32k", "prefill", 64, 32)
    pod = dryrun.dryrun_one("qwen3-8b", small, multi_pod=True,
                            device="meta", zero=False, verbose=False)
    one = dryrun.dryrun_one("qwen3-8b", small, device="meta",
                            verbose=False)
    for r, name, n in ((rec, "16x16", 256), (pod, "2x16x16", 512)):
        assert keys <= set(r) and set(r["options"]) == opts
        assert r["mesh"] == name and r["n_devices"] == n
        assert r["collective_bytes_per_device"] > 0
        assert set(r["collectives"]) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute", "count"}
        assert r["collective_bytes_per_device"] == sum(
            v for k, v in r["collectives"].items() if k != "count")
        assert r["roofline"]["collective_s"] > 0
        assert r["hlo_flops_global"] == r["flops_per_device"] * n
        assert r["card_probe"].startswith("not run")
    assert rec["options"]["moe_mode"] is None and rec["counted_ranks"] == 16
    assert 1.0 <= pod["hlo_flops_global"] / one["flops_per_device"] <= 1.5
    assert pod["flops_per_device"] < one["flops_per_device"] / 300
    layouts = rec["cache_layouts"]
    # qwen3-8b: 8 kv heads do not divide over model 16; the reference
    # splits the length over 'model', and so does the port's decode step
    assert layouts["b0/k"]["reference_spec"] == [None, "data", "model",
                                                 None, None]
    assert not layouts["b0/k"]["differ"]
    assert layouts["b0/k"]["port_bytes_per_device"] == \
        layouts["b0/k"]["reference_bytes_per_device"]


def test_mesh_options_need_a_mesh():
    with pytest.raises(ValueError, match="options of a mesh"):
        dryrun.dryrun_one("qwen3-8b", "decode_32k", zero=True,
                          device="meta")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                     "--zero", "--device", "meta"])
    with pytest.raises(ValueError, match="for serving"):
        dryrun.dryrun_one("internlm2-1.8b", SMALL["train"], smoke=True,
                          mesh="1x2", shard_params_data=True,
                          device="meta")
