"""The port's parameter rules, placement, production mesh and collectives
on the CPU.

* ``param_pspecs``: for every leaf of all ten smoke configs, in tensor
  and expert mode, the reference's ``param_pspecs`` (reference shapes
  from ``jax.eval_shape`` of its ``init_params``), entry for entry;
* ``place`` / ``gather_tree``: an indivisible dim raises, naming the
  leaf; placing and gathering back is the identity, bit for bit; summing
  the replicas adds each rank's copy;
* ``make_production_mesh``: the reference's shapes and axis names, every
  slot on ``meta``; too few devices raise the reference's text;
* the collectives over CPU ranks: ``constrain`` is a no-op without a
  mesh and keeps an indivisible dim whole; all-reduce, all-gather,
  reduce-scatter and the partial sum's resolution equal their plain
  definitions bit for bit; ``constrain_tokens`` takes the reference's
  layouts (batch over the data axes, else the sequence; with
  ``SEQ_PARALLEL`` the sequence over 'model' as well).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.sharding import param_pspecs as j_param_pspecs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import list_architectures  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = tuple(list_architectures())


@pytest.fixture
def mesh():
    """Install a mesh of CPU ranks for one test; uninstall after."""
    def install(shape, axes, seq_parallel=False):
        m = make_mesh(shape, axes, "cpu")
        specs.set_mesh(m)
        specs.set_seq_parallel(seq_parallel)
        return m
    yield install
    specs.set_mesh(None)
    specs.set_seq_parallel(False)


def _ref_specs(arch, mode):
    shapes = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0),
                                                     j_get_smoke(arch)))
    flat = jax.tree_util.tree_flatten_with_path(
        j_param_pspecs(shapes, moe_mode=mode),
        is_leaf=lambda s: isinstance(s, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in flat}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("mode", ["tensor", "expert"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_are_the_reference(arch, mode):
    mine = _paths(specs.param_pspecs(t_tf.init_params(
        None, get_smoke_config(arch)), moe_mode=mode))
    ref = _ref_specs(arch, mode)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        assert isinstance(v, tuple) and v == ref[k], (k, v, ref[k])


def _smoke_params(arch):
    return t_tf.init_params(torch.Generator().manual_seed(0),
                            get_smoke_config(arch))


def test_place_raises_on_an_indivisible_dim_naming_the_leaf():
    m = make_mesh((4,), ("model",), "cpu")
    tree = {"blk": {"w": torch.zeros(6, 10), "ok": torch.zeros(8)}}
    with pytest.raises(ValueError, match=r"blk/w: dim 1 of size 10"):
        specs.place(tree, {"blk": {"w": (None, "model"),
                                   "ok": ("model",)}}, m)
    # an axis the mesh lacks splits nothing (the reference's rule)
    parts = specs.place({"w": torch.zeros(6, 10)}, {"w": ("data", None)}, m)
    assert [tuple(p["w"].shape) for p in parts] == [(6, 10)] * 4


@pytest.mark.parametrize("arch,mode,shape,axes", [
    ("mixtral-8x22b", "tensor", (2, 2), ("data", "model")),
    ("mixtral-8x22b", "expert", (4,), ("model",)),
    ("jamba-1.5-large-398b", "tensor", (1, 4), ("data", "model")),
    ("seamless-m4t-medium", "tensor", (2, 1, 2), ("pod", "data", "model")),
])
def test_place_then_gather_is_the_identity(arch, mode, shape, axes):
    params = _smoke_params(arch)
    m = make_mesh(shape, axes, "cpu")
    spec = specs.param_pspecs(params, moe_mode=mode)
    parts = specs.place(params, spec, m)
    assert len(parts) == m.size
    # each rank holds 1/model of a split leaf, and tensors of its own
    path = next(k for k in _paths(params) if k.endswith("attn/wq"))
    wq = _paths(parts[0])[path]
    assert wq.shape[-1] * m.shape["model"] == _paths(params)[path].shape[-1]
    assert wq.is_contiguous()
    assert parts[0]["final_norm"]["scale"] is not \
        parts[1]["final_norm"]["scale"]
    back = specs.gather_tree(parts, spec, m)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_gather_tree_sums_the_replicas():
    m = make_mesh((2, 2), ("data", "model"), "cpu")
    spec = {"w": (None, "model"), "s": (None,)}
    parts = [{"w": torch.full((2, 3), float(r)), "s": torch.full((4,), 1.0)}
             for r in range(4)]
    got = specs.gather_tree(parts, spec, m, sum_replicas=True)
    # rank r = 2 * data + model; model shard j is held by ranks j and 2 + j
    assert torch.equal(got["w"], torch.cat([torch.full((2, 3), 2.0),
                                            torch.full((2, 3), 4.0)], 1))
    assert torch.equal(got["s"], torch.full((4,), 4.0))
    first = specs.gather_tree(parts, spec, m)
    assert torch.equal(first["w"][:, :3], torch.zeros(2, 3))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod, devices="meta")
    if multi_pod:
        assert m.axis_names == ("pod", "data", "model")
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
    else:
        assert m.axis_names == ("data", "model")
        assert m.shape == {"data": 16, "model": 16}
    assert {d.type for d in m.devices.flat} == {"meta"}
    with pytest.raises(ValueError, match=r"Number of devices 4 must be >= "
                                         r"the product of mesh_shape"):
        make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * 4)


def test_production_mesh_places_a_full_width_tree_on_meta():
    """The rules divide every leaf of the full-width Mixtral at the
    production mesh's model=16 (the dry-run's case): the ranks' shards
    are 1/16 of the split dims, with no storage."""
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x22b")
    params = t_tf.init_params(None, cfg)
    m = make_production_mesh(devices="meta")
    parts = specs.place(params, specs.param_pspecs(params), m)
    w = parts[17]["blocks"]["b0"]["moe"]["w_in"]
    assert tuple(w.shape) == (56, 8, 6144, 16384 // 16)
    assert w.device.type == "meta"


def test_constrain_is_a_noop_without_a_mesh():
    specs.set_mesh(None)
    x = torch.arange(12.0).reshape(3, 4)
    assert col.constrain(x, ("data", None)) is x
    assert col.constrain_tokens(x) is x
    assert col.unshard(x) is x


def test_constrain_keeps_an_indivisible_dim_whole(mesh):
    mesh((1, 4), ("data", "model"))
    x = torch.arange(12.0).reshape(3, 4)
    y = col.constrain(x, ("model", "model"))
    assert y.spec == ((), ("model",))
    assert [tuple(p.shape) for p in y.parts] == [(3, 1)] * 4
    assert torch.equal(col.unshard(y), x)


def test_collectives_are_their_plain_definitions(mesh):
    mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(4, 6, generator=gen) for _ in range(4)]
    red = col.all_reduce(parts, "model")
    assert torch.equal(red[0], parts[0] + parts[1])
    assert torch.equal(red[3], parts[2] + parts[3])
    assert torch.equal(col.all_reduce(parts, "data", op="max")[1],
                       torch.maximum(parts[1], parts[3]))
    gat = col.all_gather(parts, ("data", "model"), dim=1)
    assert all(torch.equal(g, torch.cat(parts, 1)) for g in gat)
    rs = col.reduce_scatter(parts, "model", dim=0)
    assert torch.equal(rs[1], (parts[0] + parts[1])[2:])
    # a pending sum resolved by a constraint: all-reduce where the target
    # keeps its dims whole, reduce-scatter where it splits one over the
    # summed axis
    x = col.Sharded(parts, ((), ()), partial="model")
    whole = col.constrain(x, (None, None))
    assert whole.partial is None and torch.equal(whole.parts[2], red[2])
    scat = col.constrain(x, (None, "model"))
    assert torch.equal(scat.parts[1], red[1][:, 3:])


def test_constrain_tokens_takes_the_reference_layouts(mesh):
    mesh((2, 2), ("data", "model"))
    assert col.token_spec((4, 8, 16)) == (("data",), None, None)
    # batch 1 (long context): the sequence over the data axes instead
    assert col.token_spec((1, 8, 16)) == (None, ("data",), None)
    assert col.token_spec((3, 5, 16)) == (None, None, None)
    x = torch.arange(4 * 8.0).reshape(4, 8, 1)
    y = col.constrain_tokens(x)
    assert torch.equal(y.parts[3], x[2:])
    mesh((2, 2), ("data", "model"), seq_parallel=True)
    assert col.token_spec((4, 8, 16)) == (("data",), ("model",), None)
    y = col.constrain_tokens(x)
    assert torch.equal(y.parts[3], x[2:, 4:])
    assert torch.equal(col.unshard(y), x)
    # a mesh with no data axis leaves tokens whole, SEQ_PARALLEL or not
    mesh((2,), ("model",), seq_parallel=True)
    assert col.token_spec((4, 8, 16)) == (None, None, None)
