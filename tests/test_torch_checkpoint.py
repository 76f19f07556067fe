"""The port's checkpoints (``repro_torch.checkpoint``) and live-state
save / restore in both engines, against the JAX package on the CPU.

* The format: round trips (nested trees of torch tensors and numpy
  arrays, bf16 / fp16 bitwise, empty roots, a list of more than 10
  elements in numeric order, metadata), and every damage case raises
  ``CheckpointError``.
* Both directions across frameworks: a tree written by
  ``repro.checkpoint`` reads back through the port's reader and the
  reverse, keys, dtypes, shapes and values equal; one engine state saved
  by both packages has the same manifest keys and metadata keys; a JAX
  Mixtral smoke-config parameter checkpoint (bf16) loads through
  ``bridge.load_zoo_params`` bitwise.
* Resume: the sequential engine and the batched engine at the
  reference's corners (S1, D2, D2-lane, D2-P1) resume bitwise in a fresh
  engine; saving with ticks in flight raises; a fingerprint mismatch
  raises; ``run(checkpoint_every=)`` + restore finishes the stream as
  the uninterrupted run does.
* Cross-framework resume, at D0 and D2-lane: the JAX engine saves at
  tick ``CUT`` and the port finishes the stream with the routing of the
  JAX engine's uninterrupted run (``diff_traces`` names the first
  divergence) and state close at rtol 1e-4 / atol 1e-5; and the roles
  swapped.

Setup: the CI-sized kernel ladder of ``tests/test_torch_engine.py``,
``hatespeech``, S = 4-8 lanes, 32-64 items; one reference engine per
module, reconfigured and reset for each run.
"""
import json
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as JC  # noqa: E402
import repro.core as J  # noqa: E402
from repro.analysis.sanitize import diff_traces  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_async import (EXPERT, Reference, port_cfg,  # noqa: E402
                              states_equal, streams)
from test_torch_engine import ATOL, RTOL, _cfgs, _records  # noqa: E402


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------
_BITS = np.array([0x0000, 0x0001, 0x7F80, 0x7FC1, 0x8000, 0x3F80, 0xFF80,
                  0x0080], np.uint16)


def _tree_nested():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3),
                       "layers": [{"a": torch.ones(2, dtype=torch.bfloat16)},
                                  {"a": np.zeros((2,), np.int64)}]},
            "step": torch.tensor(7, dtype=torch.int32),
            "flag": np.array([True, False]),
            "skip": None}


ROUND_TRIPS = {
    "nested": (_tree_nested, {"arch": "test", "n": 3}),
    "bf16": (lambda: {"x": torch.from_numpy(_BITS.view(np.int16))
                      .view(torch.bfloat16)}, {}),
    "fp16": (lambda: {"x": torch.from_numpy(_BITS.view(np.float16))}, {}),
    "empty-dict": (lambda: {}, {"i": 0}),
    "empty-list": (lambda: [], {"i": 1}),
    "none": (lambda: None, {"i": 2}),
    "long-list": (lambda: {"lst": [np.full((2,), i, np.int32)
                                   for i in range(13)]}, {}),
    "metadata": (lambda: {"x": np.zeros((1,), np.float32)},
                 {"t": 42, "beta": [0.5, 0.25],
                  "nested": {"a": [1, 2], "b": "s"}, "f": 1.5,
                  "flag": True, "none": None}),
}


def _bits(x):
    """A leaf's raw bytes and dtype name (bf16: the uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    return np.asarray(x), np.asarray(x).dtype.name


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_round_trip(tmp_path, case):
    make, meta = ROUND_TRIPS[case]
    tree = make()
    path = str(tmp_path / case)
    save_checkpoint(path, tree, metadata=meta)
    got, got_meta = restore_checkpoint(path)
    assert got_meta == meta
    if case in ("empty-dict", "empty-list", "none"):
        assert got == tree and type(got) is type(tree)
        return
    want, flat = _flatten(tree), _flatten(got)
    assert set(flat) == set(want)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for k, v in want.items():
        a, dtype = _bits(v)
        assert manifest["keys"][k]["dtype"] == dtype
        assert manifest["keys"][k]["shape"] == list(a.shape)
        b = flat[k]
        assert isinstance(b, np.ndarray) and b.shape == a.shape
        assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), k
    if case == "long-list":
        assert [int(x[0]) for x in got["lst"]] == list(range(13))
    if case == "bf16":
        t, _ = restore_checkpoint(path, bf16="torch")
        assert t["x"].dtype == torch.bfloat16
        assert torch.equal(t["x"].view(torch.int16), tree["x"].view(
            torch.int16))


def _damage_missing(path):
    return str(path) + "-nope"


def _damage_manifest(path):
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("{not json")
    return path


def _damage_arrays(path):
    os.remove(os.path.join(path, "arrays.npz"))
    return path


def _damage_truncate(path):
    npz = os.path.join(path, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    return path


def _damage_mismatch(path):
    data = dict(np.load(os.path.join(path, "arrays.npz")))
    data.pop("y")
    np.savez(os.path.join(path, "arrays"), **data)
    return path


DAMAGE = {"missing": (_damage_missing, "manifest"),
          "corrupt-manifest": (_damage_manifest, "corrupted manifest"),
          "missing-arrays": (_damage_arrays, "missing"),
          "truncated": (_damage_truncate, "corrupted array store"),
          "manifest-array-mismatch": (_damage_mismatch, "missing")}


@pytest.mark.parametrize("case", list(DAMAGE))
def test_damage_raises(tmp_path, case):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"x": torch.arange(1024, dtype=torch.float32),
                           "y": np.ones((2,), np.float32)})
    damage, match = DAMAGE[case]
    with pytest.raises(CheckpointError, match=match):
        restore_checkpoint(damage(path))


# ---------------------------------------------------------------------------
# the format across frameworks
# ---------------------------------------------------------------------------
def _jax_tree():
    return {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "h": jnp.asarray(_BITS).view(jnp.bfloat16),
            "layers": [{"a": jnp.full((3,), i, jnp.int32)}
                       for i in range(12)],
            "count": jnp.zeros((), jnp.int32)}


def test_jax_written_tree_reads_in_port(tmp_path):
    path = str(tmp_path / "j")
    tree = _jax_tree()
    JC.save_checkpoint(path, tree, metadata={"by": "jax"})
    got, meta = restore_checkpoint(path)
    assert meta == {"by": "jax"}
    assert got["count"].dtype == np.int32 and got["count"].shape == ()
    assert got["h"].dtype == np.uint16
    assert np.array_equal(got["h"], _BITS)
    assert np.array_equal(got["w"], np.asarray(tree["w"]))
    assert [int(x["a"][0]) for x in got["layers"]] == list(range(12))
    t, _ = restore_checkpoint(path, bf16="torch")
    assert torch.equal(t["h"].view(torch.int16),
                       torch.from_numpy(_BITS.view(np.int16)))


def test_port_written_tree_reads_in_jax(tmp_path):
    path = str(tmp_path / "p")
    tree = _tree_nested()
    tree["long"] = [torch.full((2,), i) for i in range(11)]
    save_checkpoint(path, tree, metadata={"by": "torch"})
    got, meta = JC.restore_checkpoint(path)
    assert meta == {"by": "torch"}
    assert got["params"]["layers"][0]["a"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got["params"]["layers"][0]["a"])
                          .view(np.uint16),
                          tree["params"]["layers"][0]["a"]
                          .view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(got["params"]["w"], tree["params"]["w"].numpy())
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    assert [int(x[0]) for x in got["long"]] == list(range(11))
    assert "skip" not in got


def test_jax_zoo_checkpoint_loads_bitwise(tmp_path):
    """A bf16 Mixtral smoke-config parameter checkpoint written by the
    JAX package loads through ``bridge.load_zoo_params`` bit for bit."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import transformer as j_tf
    from repro_torch.configs import get_smoke_config
    arch = "mixtral-8x22b"
    jparams = j_tf.init_params(jax.random.PRNGKey(0), j_smoke(arch))
    path = str(tmp_path / "zoo")
    JC.save_checkpoint(path, jparams, metadata={"arch": arch})
    tree, meta = restore_checkpoint(path, bf16="torch")
    assert meta == {"arch": arch}
    params = bridge.load_zoo_params(tree, get_smoke_config(arch), "cpu")
    pairs = list(zip(tree_leaves(params), jax.tree.leaves(jparams)))
    assert {a.dtype for a, _ in pairs} == {torch.bfloat16, torch.float32}
    for a, b in pairs:
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert np.array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# engines: helpers
# ---------------------------------------------------------------------------
# CUT (S = 4) and XCUT (S = 8) each leave a per-lane record of the
# D2-lane corner partly committed at the save
N, S, CUT, XCUT = 64, 4, 6, 3
# corners of the reference's resume pin (tests/test_checkpoint.py), at
# the port's CI ladder: (engine options, expert options, items, lanes, cut)
CORNERS = {
    "S1": ({}, {}, 32, 1, 16),
    "D2": ({"max_delay": 2}, {"workers": 2, "latency": 1}, N, S, CUT),
    "D2-lane": ({"max_delay": 2, "per_lane": True},
                {"workers": 2, "latency": 1}, N, S, CUT),
    "D2-P1": ({"max_delay": 2, "pipeline_depth": 1}, {"workers": 2}, N, S,
              CUT),
}


def port_engine(ps, n_streams, ex=None, **opts):
    return P.BatchedCascadeEngine(
        port_cfg(), P.SimulatedExpert(ps, EXPERT, **(ex or {})),
        n_streams=n_streams, device="cpu", **opts)


def run_ticks(eng, stream, lo, hi):
    """Serve ticks [lo, hi) (tick t = items [t*S, (t+1)*S)); returns the
    outputs that resolved."""
    S_ = eng.n_streams
    outs = []
    for t in range(lo, hi):
        idxs = list(range(t * S_, (t + 1) * S_))
        docs = [stream.docs[i] for i in idxs]
        if eng.pipeline_depth:
            outs.extend(eng.submit_tick(idxs, docs))
        else:
            outs.append(eng.process_tick(idxs, docs))
    return outs


def collate(outs):
    outs = sorted(outs, key=lambda o: o["tick"])
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])
            for k in ("predictions", "levels", "expert_called")}


def resumed_pair(build, stream, n_ticks, cut, path):
    """An uninterrupted run and one saved at tick ``cut``, restored into
    a fresh engine and finished; returns (full, outs, resumed, outs)."""
    full = build()
    fo = run_ticks(full, stream, 0, n_ticks) + full.drain()
    full.flush()
    part = build()
    po = run_ticks(part, stream, 0, cut) + part.drain()
    part.save_state(path)
    part.close()
    res = build()
    res.restore_state(path)
    ro = run_ticks(res, stream, cut, n_ticks) + res.drain()
    res.flush()
    return full, fo, res, po + ro


def _trace(history, t0):
    """State-free trace records of a history whose first tick is t0 + 1."""
    recs = _records(history)
    for r in recs:
        r["t"] += t0
    return recs


def _state_leaves(levels):
    """Every learned leaf as numpy, JAX or port levels alike."""
    out = []
    for lvl in levels:
        for attr in P.STATE_ATTRS:
            tree = getattr(lvl, attr)
            leaves = (tree_leaves(bridge.to_numpy(tree))
                      if isinstance(tree_leaves(tree)[0], torch.Tensor)
                      else [np.asarray(x) for x in jax.tree.leaves(tree)])
            out.extend(leaves)
    return out


def _assert_leaves_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def ref():
    return Reference()


# ---------------------------------------------------------------------------
# the sequential engine
# ---------------------------------------------------------------------------
def _seq(ps):
    return P.OnlineCascade(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                           device="cpu")


def test_sequential_save_restore_bitwise(tmp_path):
    _, ps = streams(32)
    full = _seq(ps)
    preds_full = [full.process(i, ps.docs[i])["prediction"]
                  for i in range(32)]
    part = _seq(ps)
    for i in range(16):
        part.process(i, ps.docs[i])
    path = str(tmp_path / "seq")
    part.save_state(path)
    res = _seq(ps)
    res.restore_state(path)
    assert res.t == part.t == 16
    preds_res = [res.process(i, ps.docs[i])["prediction"]
                 for i in range(16, 32)]
    assert preds_res == preds_full[16:]
    assert states_equal(full.levels, res.levels)
    assert (full.expert_calls, full.total_cost, full.J_cum) == \
        (res.expert_calls, res.total_cost, res.J_cum)
    for a, b in zip(full.levels, res.levels):
        assert a.beta == b.beta and a.cache_n == b.cache_n
        assert np.array_equal(a.cache_x, b.cache_x)
    # the JAX sequential engine reads the same checkpoint
    js, _ = streams(32)
    je = J.OnlineCascade(_cfgs()[0], J.SimulatedExpert(js, EXPERT))
    je.restore_state(path)
    assert je.t == 16 and je.expert_calls == part.expert_calls
    # and a fingerprint mismatch raises
    other = P.OnlineCascade(replace(port_cfg(), seed=99),
                            P.SimulatedExpert(ps, EXPERT), device="cpu")
    with pytest.raises(CheckpointError, match="mismatch on seed"):
        other.restore_state(path)


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("corner", list(CORNERS))
def test_engine_resume_bitwise(tmp_path, corner):
    opts, ex, n, lanes, cut = CORNERS[corner]
    _, ps = streams(n)
    full, fo, res, ro = resumed_pair(
        lambda: port_engine(ps, lanes, ex, **opts), ps, n // lanes, cut,
        str(tmp_path / "ck"))
    a, b = collate(fo), collate(ro)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert states_equal(full.levels, res.levels)
    assert np.array_equal(full.expert_calls, res.expert_calls)
    assert np.array_equal(full.total_cost, res.total_cost)
    assert full.commit_log == res.commit_log
    for i in range(len(full.levels)):
        assert torch.equal(full._cache_x[i], res._cache_x[i])
    if corner == "D2-lane":
        # the checkpoint caught a per-lane record partway through
        with open(tmp_path / "ck" / "manifest.json") as f:
            meta = json.load(f)["metadata"]
        assert meta["n_pending"] > 0
        assert any(0 < pm["committed"] for pm in meta["pending"])


def test_engine_save_needs_drained_ring_and_same_config(tmp_path):
    _, ps = streams(32)
    eng = port_engine(ps, S, pipeline_depth=2)
    run_ticks(eng, ps, 0, 4)
    assert eng._ring
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.save_state(str(tmp_path / "ck"))
    eng.drain()
    eng.save_state(str(tmp_path / "ck"))
    for other in (port_engine(ps, 8), port_engine(ps, S, max_delay=1)):
        with pytest.raises(CheckpointError, match="mismatch"):
            other.restore_state(str(tmp_path / "ck"))


def test_run_checkpoint_every_then_restore(tmp_path):
    _, ps = streams(N)
    path = str(tmp_path / "live")
    full = port_engine(ps, S, max_delay=2)
    m_full = full.run(ps)
    port_engine(ps, S, max_delay=2).run(ps, checkpoint_every=6,
                                        checkpoint_path=path)
    res = port_engine(ps, S, max_delay=2)
    res.restore_state(path)
    assert res.t == 12
    m_res = res.run(ps)
    first = 12 * S
    assert np.array_equal(m_res["predictions"][first:],
                          m_full["predictions"][first:])
    assert states_equal(full.levels, res.levels)
    assert np.array_equal(full.expert_calls, res.expert_calls)


# ---------------------------------------------------------------------------
# across frameworks
# ---------------------------------------------------------------------------
XCORNERS = {"D0": ({}, {}),
            "D2-lane": ({"max_delay": 2, "per_lane": True},
                        {"workers": 2, "latency": 1})}


def test_manifests_of_one_state_agree(ref, tmp_path):
    """The JAX engine's checkpoint, restored into the port and saved
    again, has the reference's key set, dtypes, shapes, metadata keys
    and arrays."""
    opts, ex = XCORNERS["D2-lane"]
    js, ps = streams(N)
    pe = port_engine(ps, 8, ex, **opts)
    je = ref.start(pe, J.SimulatedExpert(js, EXPERT, **ex), **opts)
    run_ticks(je, js, 0, XCUT)
    je.save_state(str(tmp_path / "j"))
    pe.restore_state(str(tmp_path / "j"))
    pe.save_state(str(tmp_path / "p"))
    mans = []
    for who in ("j", "p"):
        with open(tmp_path / who / "manifest.json") as f:
            mans.append(json.load(f))
    assert mans[0]["keys"] == mans[1]["keys"]
    assert set(mans[0]["metadata"]) == set(mans[1]["metadata"])
    assert mans[1]["metadata"]["n_pending"] > 0
    for key in ("t", "beta", "cache_n", "cache_ptr", "route_beta",
                "route_items", "commit_log", "pending", "fault_stats",
                "pipeline_stats", "fleet_log"):
        assert mans[0]["metadata"][key] == mans[1]["metadata"][key], key
    a = np.load(tmp_path / "j" / "arrays.npz")
    b = np.load(tmp_path / "p" / "arrays.npz")
    for k in mans[0]["keys"]:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("corner", list(XCORNERS))
def test_cross_framework_resume(ref, tmp_path, corner):
    """JAX saves at tick CUT and the port finishes, with the routing of
    the JAX engine's uninterrupted run; then the port saves and the JAX
    engine finishes, with the routing of the port's uninterrupted run."""
    opts, ex = XCORNERS[corner]
    n, lanes, cut = N, 8, XCUT
    js, ps = streams(n)

    def jax_expert():
        return J.SimulatedExpert(js, EXPERT, **ex)

    # the JAX engine, uninterrupted, from the reference's initial state
    pe_full = port_engine(ps, lanes, ex, **opts)
    je = ref.start(pe_full, jax_expert(), **opts)
    jm = je.run(js)
    j_trace = _trace(je.history, 0)
    j_leaves = _state_leaves(je.levels)
    j_calls = je.expert_calls_total

    # JAX -> port
    je = ref.start(port_engine(ps, lanes, ex, **opts), jax_expert(), **opts)
    run_ticks(je, js, 0, cut)
    je.drain()
    je.save_state(str(tmp_path / "j"))
    pe = port_engine(ps, lanes, ex, **opts)
    pe.restore_state(str(tmp_path / "j"))
    pm = pe.run(ps)
    div = diff_traces(j_trace[cut:], _trace(pe.history, cut))
    assert div is None, div.describe()
    assert np.array_equal(pm["predictions"][cut * lanes:],
                          jm["predictions"][cut * lanes:])
    assert pe.expert_calls_total == j_calls
    _assert_leaves_close(j_leaves, _state_leaves(pe.levels))

    # port -> JAX: the port's own uninterrupted run is the yardstick
    pm_full = pe_full.run(ps)
    p_trace = _trace(pe_full.history, 0)
    assert diff_traces(j_trace, p_trace) is None
    pp = port_engine(ps, lanes, ex, **opts)
    ref.start(pp, jax_expert(), **opts)          # pp from the JAX init
    run_ticks(pp, ps, 0, cut)
    pp.drain()
    pp.save_state(str(tmp_path / "p"))
    je = ref.start(port_engine(ps, lanes, ex, **opts), jax_expert(), **opts)
    je.restore_state(str(tmp_path / "p"))
    jm2 = je.run(js)
    div = diff_traces(p_trace[cut:], _trace(je.history, cut))
    assert div is None, div.describe()
    assert np.array_equal(jm2["predictions"][cut * lanes:],
                          pm_full["predictions"][cut * lanes:])
    assert je.expert_calls_total == pe_full.expert_calls_total
    _assert_leaves_close(_state_leaves(pe_full.levels),
                         _state_leaves(je.levels))
