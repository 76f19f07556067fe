"""Lane sharding in the port (``repro_torch.launch.mesh``,
``repro_torch.sharding``, ``BatchedCascadeEngine(mesh=)``) on the CPU.

* The mesh and the lane rules: ``parse_mesh_spec`` against the
  reference's axes, sizes and error text; ``lane_count`` / ``lane_spec``
  against ``repro.sharding`` on a 1-device JAX mesh, and by axis-name
  arithmetic beyond it; ``put_lanes`` splits a divisible dim 0 and
  replicates one that does not divide; ``_bucket`` equal to the
  reference's own method at every (lane devices, S, n).
* The engine with ``mesh`` = 8 CPU shards against the UNMESHED JAX
  engine on the same tick keys (the JAX package's own 8-device engine
  runs in a subprocess that this sandbox cannot run): the CI kernel
  ladder at S = 8 and the default ladder (``lr -> tinytf``) at S = 16.
  Routing (level, expert called, prediction) identical on every tick and
  lane; ``params`` / ``dparams`` allclose at the reference's mesh
  tolerance, rtol 1e-4 / atol 1e-6 (``tests/harness.py``), to the JAX
  engine on the default ladder and to the unmeshed port engine on both;
  on the kernel ladder the unmeshed port is itself 2.9e-6 past that
  atol on one ``tinytf_flash`` weight (the two packages' gradients sum
  in another order), so there the JAX engine is held at the
  cross-package tolerance of ``tests/test_torch_engine.py`` (atol 1e-5).
* A non-power-of-two mesh (data = 3, S = 24) and the serving matrix's
  cells — the async queue with pipelined route passes, per-lane commits
  over a 2-worker pool, the admission front-end (lockstep and Poisson),
  a ``FlakyExpert`` that recovers, a checkpoint resume on the mesh
  (bitwise) and an unmeshed checkpoint restored into a meshed engine —
  each against its unmeshed port twin, whose determinism trace it equals
  on routing, RNG draws and ring mirrors.
* Every shard's replica is bitwise the canonical state after a run,
  after ``reset`` and after ``restore_state``.
* The CLI: ``--mesh data=8`` prints the unmeshed run's accuracy, expert
  calls and level fractions; ``--mesh data=3 --batch 64`` raises.

About 30 s on one worker (two reference engines; the rest is the port).
"""
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import repro.core as J  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro.analysis.sanitize import diff_traces  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.data as PD  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.analysis import sanitize as san  # noqa: E402
from repro_torch.bridge import to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,  # noqa: E402
                                     parse_mesh_spec)
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_async import EXPERT, port_cfg, states_equal, streams  # noqa: E402
from test_torch_engine import _assert_same_routing, _bridge  # noqa: E402
import test_torch_default_ladder as DL  # noqa: E402
import test_torch_engine as EN  # noqa: E402

MESH_RTOL, MESH_ATOL = 1e-4, 1e-6     # tests/harness.py MESH_RTOL / ATOL
ROUTE_ATTRS = ("params", "dparams")


def cpu_mesh(n, axes=("data",), shape=None):
    return make_mesh(shape or (n,), axes, "cpu")


# ---------------------------------------------------------------------------
# the mesh and the lane rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,axes,shape", [
    ("data=8", ("data",), (8,)),
    ("pod=2,data=4", ("pod", "data"), (2, 4)),
    ("data=2, model=4", ("data", "model"), (2, 4)),
    ("data=1,model=1", ("data", "model"), (1, 1)),
])
def test_parse_mesh_spec_axes_and_sizes(spec, axes, shape):
    m = parse_mesh_spec(spec, "cpu")
    assert m.axis_names == axes and tuple(m.shape.values()) == shape
    assert m.devices.shape == shape and m.size == int(np.prod(shape))
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    if np.prod(shape) <= len(jax.devices()):
        ref = jmesh.parse_mesh_spec(spec)
        assert tuple(ref.axis_names) == m.axis_names
        assert dict(ref.shape) == m.shape
    assert parse_mesh_spec("") is None and parse_mesh_spec(None) is None


@pytest.mark.parametrize("bad", ["data", "data=0", "=2", "data=x",
                                 "data=2,"])
def test_parse_mesh_spec_errors_are_the_references(bad):
    with pytest.raises(ValueError) as ej:
        jmesh.parse_mesh_spec(bad)
    with pytest.raises(ValueError) as ep:
        parse_mesh_spec(bad, "cpu")
    assert str(ep.value) == str(ej.value)


def test_mesh_devices_must_exist():
    n = len(jax.devices()) + 1
    with pytest.raises(ValueError) as ej:
        jax.make_mesh((n,), ("data",))
    with pytest.raises(ValueError) as ep:
        make_mesh((n,), ("data",), ["cpu"] * (n - 1))
    assert str(ep.value) == str(ej.value)
    # an explicit list is used as given, its first prod(shape) devices
    assert make_mesh((2,), ("data",), ["cpu"] * 3).size == 2
    assert make_host_mesh(["cpu"] * 3).shape == {"data": 3, "model": 1}
    if not torch.cuda.is_available():
        # the default devices are the CUDA cards; missing cards raise,
        # also where the caller names them
        for fn in (lambda: parse_mesh_spec("data=2"),
                   lambda: make_mesh((2,), ("data",),
                                     ["cuda:0", "cuda:0"]),
                   lambda: make_host_mesh()):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()


@pytest.mark.parametrize("axes", [("data", "model"), ("model", "x"),
                                  ("pod", "data", "model"), ("data",),
                                  ("model",), ("data", "pod")])
def test_lane_rules_match_reference(axes):
    devs = np.array(jax.devices()[:1]).reshape((1,) * len(axes))
    jm = JMesh(devs, axes)
    pm = make_mesh((1,) * len(axes), axes, "cpu")
    spec = jshd.lane_spec(jm)          # P(('data',)) may print P('data')
    entry = spec[0] if len(spec) else ()
    assert shd.lane_spec(pm) == ((entry,) if isinstance(entry, str)
                                 else tuple(entry))
    assert shd.lane_count(pm) == jshd.lane_count(jm) == 1
    assert shd.batch_axes(pm) == jshd.batch_axes(jm)


@pytest.mark.parametrize("axes,shape,count", [
    (("data",), (8,), 8), (("data", "model"), (4, 2), 4),
    (("pod", "data", "model"), (2, 3, 2), 6), (("model",), (4,), 1),
    (("data", "pod"), (3, 2), 6)])
def test_lane_count_and_devices_by_axis_arithmetic(axes, shape, count):
    # integer stand-ins for devices: shard s sits at s unravelled over
    # ('pod', 'data') and at index 0 of every other axis
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    m = Mesh(ids, axes)
    assert shd.lane_count(m) == count
    lanes = shd.lane_spec(m)
    sizes = [m.shape[a] for a in lanes]
    want = []
    for s in range(count):
        at = dict(zip(lanes, np.unravel_index(s, sizes)))
        want.append(int(ids[tuple(int(at.get(a, 0)) for a in axes)]))
    assert shd.lane_devices(m) == want
    assert len(set(want)) == count


def test_put_lanes_splits_or_replicates():
    m = cpu_mesh(4)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = shd.put_lanes(x, m)
    assert [p.shape[0] for p in parts] == [2] * 4
    assert np.array_equal(np.concatenate([p.numpy() for p in parts]), x)
    y = np.arange(6, dtype=np.int32)              # 6 rows over 4 shards
    assert all(np.array_equal(p.numpy(), y) for p in shd.put_lanes(y, m))
    z = shd.put_lanes(np.float32(3.0), m)         # a scalar: replicated
    assert [float(t) for t in z] == [3.0] * 4
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    reps = shd.put_replicated(tree, m)
    assert len(reps) == 4
    assert reps[0]["w"].data_ptr() != reps[1]["w"].data_ptr()
    assert reps[0]["w"].data_ptr() != tree["w"].data_ptr()
    tree["w"] += 2
    shd.refresh_replicas(reps, tree)
    assert all(torch.equal(r["w"], tree["w"]) for r in reps)
    shd.set_mesh(m)
    try:
        assert shd.get_mesh() is m and shd.batch_axes() == ("data",)
    finally:
        shd.set_mesh(None)
    assert shd.get_mesh() is None and shd.batch_axes() is None


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_bucket_is_the_references(d):
    for S in (8, 24, 48, 64):
        if S % d:
            continue
        fake = SimpleNamespace(_n_lane_devices=d, n_streams=S)
        for n in range(S + 1):
            got = P.BatchedCascadeEngine._bucket(fake, n)
            assert got == J.BatchedCascadeEngine._bucket(fake, n), (d, S, n)
            assert got % d == 0
    eng = P.BatchedCascadeEngine(port_cfg(), None, n_streams=24,
                                 mesh=cpu_mesh(3))
    assert eng._n_lane_devices == 3 and eng._bucket(1) == 12
    assert eng.device == torch.device("cpu")


def test_engine_rejects_bad_meshes():
    with pytest.raises(ValueError, match="must be a positive multiple of "
                                         "the mesh's lane-device count 3"):
        P.BatchedCascadeEngine(port_cfg(), None, n_streams=64,
                               mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match="first device"):
        P.BatchedCascadeEngine(port_cfg(), None, n_streams=8,
                               mesh=cpu_mesh(2), device="meta")


# ---------------------------------------------------------------------------
# against the unmeshed JAX engine
# ---------------------------------------------------------------------------
def _assert_mesh_close(j_levels, p_levels, atol=MESH_ATOL):
    for i, (jl, pl) in enumerate(zip(j_levels, p_levels)):
        for attr in ROUTE_ATTRS:
            la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                np.asarray, getattr(jl, attr)))
            lb = tree_leaves(to_numpy(getattr(pl, attr)))
            assert len(la) == len(lb), (i, attr)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(
                    y, x, rtol=MESH_RTOL, atol=atol,
                    err_msg=f"level {i} ({pl.spec.kind}) {attr}")


def _assert_replicas_bitwise(eng):
    for i, lvl in enumerate(eng.levels):
        want = tree_leaves((lvl.params, lvl.dparams))
        assert len(eng._replicas[i]) == shd.lane_count(eng.mesh)
        for rep in eng._replicas[i]:
            got = tree_leaves(rep)
            assert len(got) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), i


@pytest.mark.parametrize("ladder,S", [("kernel-ci", 8), ("default", 16)])
def test_meshed_engine_matches_unmeshed_jax(ladder, S):
    mod = EN if ladder == "kernel-ci" else DL
    jcfg, pcfg = mod._cfgs()
    js, ps = EN._streams() if mod is EN else DL._streams(96)
    je = J.BatchedCascadeEngine(jcfg, J.SimulatedExpert(js), n_streams=S)
    pe = P.BatchedCascadeEngine(pcfg, P.SimulatedExpert(ps), n_streams=S,
                                device="cpu", mesh=cpu_mesh(8))
    twin = P.BatchedCascadeEngine(pcfg, P.SimulatedExpert(ps),
                                  n_streams=S, device="cpu")
    _bridge(je, pe)
    _bridge(je, twin)
    jm, pm, tm = je.run(js), pe.run(ps), twin.run(ps)
    _assert_twins(twin, tm, pe, pm)
    _assert_same_routing(je.history, pe.history)
    assert np.array_equal(jm["predictions"], pm["predictions"])
    assert jm["expert_calls"] == pm["expert_calls"]
    assert jm["level_fractions"] == pm["level_fractions"]
    levels = np.concatenate([np.asarray(x) for x in pe.history["level"]])
    assert (levels < len(pe.levels)).any()      # students answer too
    assert pe._cache_n == je._cache_n and pe._cache_ptr == je._cache_ptr
    for i in range(len(pe.levels)):
        assert np.array_equal(np.asarray(je._cache_x[i]),
                              pe._cache_x[i].numpy())
    _assert_mesh_close(je.levels, pe.levels,
                       EN.ATOL if ladder == "kernel-ci" else MESH_ATOL)
    # one forward a dispatch, at the global bucket (a multiple of 8)
    for lvl in pe.levels:
        assert lvl.forwards > 0 and all(
            b % 8 == 0 for b in lvl.forwards_by_batch)


# ---------------------------------------------------------------------------
# meshed against the unmeshed port twin
# ---------------------------------------------------------------------------
def _engine(ps, S, mesh=None, ex=None, expert=None, **opts):
    expert = expert or P.SimulatedExpert(ps, EXPERT, **(ex or {}))
    return P.BatchedCascadeEngine(port_cfg(), expert, n_streams=S,
                                  device="cpu", mesh=mesh, **opts)


def _state_free(trace):
    return [{k: v for k, v in r.items() if k != "state"}
            for r in trace.ticks]


def _assert_twins(a, ma, b, mb):
    """Meshed ``b`` against its unmeshed twin ``a``: routing, predictions,
    expert calls, rings, host counters identical; state at the mesh
    tolerance; replicas bitwise."""
    _assert_same_routing(a.history, b.history)
    assert np.array_equal(ma["predictions"], mb["predictions"])
    assert ma["expert_calls"] == mb["expert_calls"]
    assert a._cache_n == b._cache_n and a._cache_ptr == b._cache_ptr
    for i in range(len(a.levels)):
        assert torch.equal(a._cache_x[i], b._cache_x[i])
        assert torch.equal(a._cache_y[i], b._cache_y[i])
    assert a.pipeline_stats == b.pipeline_stats
    assert a.fault_stats == b.fault_stats
    assert a.commit_log == b.commit_log
    # one forward a dispatch (the buckets differ where the lane count is
    # not a power of two)
    assert [lvl.forwards for lvl in a.levels] == \
        [lvl.forwards for lvl in b.levels]
    if shd.lane_count(b.mesh) & (shd.lane_count(b.mesh) - 1) == 0:
        assert [lvl.forwards_by_batch for lvl in a.levels] == \
            [lvl.forwards_by_batch for lvl in b.levels]
    for la, lb in zip(a.levels, b.levels):
        for attr in P.STATE_ATTRS:
            for x, y in zip(tree_leaves(getattr(la, attr)),
                            tree_leaves(getattr(lb, attr))):
                np.testing.assert_allclose(y.numpy(), x.numpy(),
                                           rtol=MESH_RTOL, atol=MESH_ATOL,
                                           err_msg=attr)
    _assert_replicas_bitwise(b)


def _traced_run(eng, ps):
    with san.determinism_trace():
        m = eng.run(ps)
    return m, san.trace_of(eng)


def test_non_power_of_two_mesh_matches_unmeshed():
    S = 24
    _, ps = streams(16 * S)
    a, b = _engine(ps, S), _engine(ps, S, mesh=cpu_mesh(3))
    (ma, ta), (mb, tb) = _traced_run(a, ps), _traced_run(b, ps)
    _assert_twins(a, ma, b, mb)
    assert diff_traces(_state_free(ta), _state_free(tb)) is None
    for lvl in b.levels:
        assert set(lvl.forwards_by_batch) <= {12, 24}
    assert 0 < mb["expert_calls"] < len(ps)       # students answer too


CELLS = {
    "async-D2-P2": (dict(max_delay=2, pipeline_depth=2), {}),
    "per-lane-W2": (dict(max_delay=2, per_lane=True), {"workers": 2}),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_serving_cell_matches_unmeshed(cell):
    opts, ex = CELLS[cell]
    _, ps = streams(128)
    a = _engine(ps, 8, ex=ex, **opts)
    b = _engine(ps, 8, mesh=cpu_mesh(8), ex=ex, **opts)
    (ma, ta), (mb, tb) = _traced_run(a, ps), _traced_run(b, ps)
    _assert_twins(a, ma, b, mb)
    assert diff_traces(_state_free(ta), _state_free(tb)) is None
    if opts.get("pipeline_depth"):
        # the learning regime: commits land while ticks are in flight
        st = b.pipeline_stats
        assert st["refetches"] + st["update_fences"] > 0
    assert b.commit_stats["lanes"] == a.commit_stats["lanes"] > 0


def test_flaky_expert_recovers_on_the_mesh():
    _, ps = streams(128)

    def flaky():
        return P.FlakyExpert(P.SimulatedExpert(ps, EXPERT, workers=2),
                             schedule=lambda seq, j: (
                                 "die" if (seq, j) == (3, 0) else
                                 "timeout" if j == 0 and seq % 5 == 0
                                 and seq < 40 else None))

    opts = dict(max_delay=2, expert_timeout=0.01, max_requeues=3)
    a = _engine(ps, 8, expert=flaky(), **opts)
    b = _engine(ps, 8, mesh=cpu_mesh(8), expert=flaky(), **opts)
    ma, mb = a.run(ps), b.run(ps)
    _assert_twins(a, ma, b, mb)
    fs = b.fault_stats
    assert fs["worker_deaths"] == 1 and fs["timeouts"] > 0
    assert fs["dropped_annotations"] == 0


@pytest.mark.parametrize("schedule", ["lockstep", "poisson"])
def test_admission_front_end_on_the_mesh(schedule):
    S, n = 8, 96
    _, ps = streams(n)
    reqs = (PD.lockstep_requests(n, S) if schedule == "lockstep" else
            PD.poisson_requests(n, rate=0.7, mean_len=5, seed=3))
    runs = []
    for mesh in (None, cpu_mesh(8)):
        eng = _engine(ps, S, mesh=mesh, commit_log=True, max_delay=2,
                      pipeline_depth=2)
        fe = P.CascadeFrontEnd(eng, ps)
        fe.serve(reqs)
        runs.append((eng, fe, fe.metrics()))
    (a, fa, ma), (b, fb, mb) = runs
    assert np.array_equal(ma["predictions"], mb["predictions"])
    assert (ma["ticks"], ma["idle_ticks"], ma["answered"]) == \
        (mb["ticks"], mb["idle_ticks"], mb["answered"])
    for rid, ra in fa.records.items():
        rb = fb.records[rid]
        assert (ra.admit, ra.lane, ra.done, ra.predictions, ra.levels,
                ra.commit_ticks) == (rb.admit, rb.lane, rb.done,
                                     rb.predictions, rb.levels,
                                     rb.commit_ticks)
    _assert_same_routing(a.history, b.history)
    _assert_replicas_bitwise(b)


def test_resume_on_the_mesh_is_bitwise(tmp_path):
    S, cut = 8, 12
    _, ps = streams(128)
    opts = dict(max_delay=2, pipeline_depth=2)
    path = str(tmp_path / "ckpt")
    full = _engine(ps, S, mesh=cpu_mesh(8), **opts)
    m_full = full.run(ps, checkpoint_every=cut, checkpoint_path=path)
    resumed = _engine(ps, S, mesh=cpu_mesh(8), **opts)
    resumed.restore_state(path)
    assert resumed.t == cut
    _assert_replicas_bitwise(resumed)
    m_res = resumed.run(ps)
    assert np.array_equal(m_full["predictions"][cut * S:],
                          m_res["predictions"][cut * S:])
    assert full.expert_calls_total == resumed.expert_calls_total
    assert states_equal(full.levels, resumed.levels)
    for i in range(len(full.levels)):
        assert torch.equal(full._cache_x[i], resumed._cache_x[i])
    _assert_replicas_bitwise(resumed)
    # reset brings the replicas back to the initial state
    resumed.reset()
    _assert_replicas_bitwise(resumed)
    assert states_equal(resumed.levels, _engine(ps, S).levels)


def test_unmeshed_checkpoint_restores_into_a_meshed_engine(tmp_path):
    S, cut = 8, 4
    _, ps = streams(128)
    head = _engine(ps, S, max_delay=1)
    head.run(_Prefix(ps, cut * S))
    path = head.save_state(str(tmp_path / "plain"))
    tails = []
    for mesh in (None, cpu_mesh(8)):
        eng = _engine(ps, S, mesh=mesh, max_delay=1)
        eng.restore_state(path)
        tails.append((eng, eng.run(ps)))
    (a, ma), (b, mb) = tails
    _assert_twins(a, ma, b, mb)
    assert b.t == a.t == len(ps) // S
    # and back: the meshed engine's checkpoint restores unmeshed
    path2 = b.save_state(str(tmp_path / "meshed"))
    c = _engine(ps, S, max_delay=1)
    c.restore_state(path2)
    assert states_equal(b.levels, c.levels)


class _Prefix:
    """The first ``n`` items of a stream, as a stream."""

    def __init__(self, stream, n):
        self.docs = stream.docs[:n]
        self.labels = stream.labels[:n]

    def __len__(self):
        return len(self.docs)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(argv)
    out = buf.getvalue()
    return [ln for ln in out.splitlines()
            if ln.startswith(("accuracy=", "level fractions:"))], out


def test_serve_cli_mesh_prints_the_unmeshed_run():
    base = ["--device", "cpu", "--ladder", "kernel-ci", "--expert",
            "simulated", "--samples", "64", "--batch", "8", "--log-every",
            "0"]
    plain, _ = _cli(base)
    meshed, out = _cli(base + ["--mesh", "data=8"])
    assert len(plain) == 2 and meshed == plain
    assert "mesh={'data': 8}" in out
    with pytest.raises(ValueError, match="multiple of the mesh's "
                                         "lane-device count 3"):
        _cli(base[:-4] + ["--batch", "64", "--log-every", "0", "--mesh",
                          "data=3"])
