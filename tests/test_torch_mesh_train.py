"""Training over a mesh on the CPU: ``launch.train``'s ``mesh_step`` and
``train(mesh=)`` against the reference's step math.

The models start from the reference's own ``init_params(PRNGKey(0))``
at the smoke config in fp32 (``bridge.load_zoo_params``), are placed by
``param_pspecs`` over a (data 2, model 2) mesh of CPU ranks and take one
meshed AdamW step (the reference's defaults: b2 0.95, weight decay 0.1,
clip 1.0).  The reference's own ``train`` builds its host mesh with
``jax.make_mesh``, whose Explicit axes fail under the installed JAX, so
the port is held to the reference's step math instead: ``jax.
value_and_grad`` of ``train_loss`` and ``adamw``'s step, unsharded.  A
data axis is held as ``tests/test_torch_model_sharding.py`` holds it:
only the MoE couples a batch's rows (its capacity is a data shard's),
so for a MoE model the reference is the mean of its loss and gradient
over the two batch slices, which is what its own meshed step computes.
One CPU thread, as in ``tests/test_torch_train.py``.

Tolerances, each with its reason (``tests/test_torch_train.py``'s):

* the loss: 1e-5 relative (the same fp32 arithmetic in another order);
* the reduced gradient, gathered, against the reference's: 1e-4 x
  max|reference leaf| (two layers of fp32 products and their
  transposes, summed over the replicas in another order);
* one AdamW step (lr 1e-3): 0.1 lr per weight (a first Adam step moves
  each weight by about lr x sign(g); where |g| is within the packages'
  gradient rounding of zero the direction can tilt).  It is blind to
  the gradient's scale, so the reduced gradient and the clip's norm are
  held to the reference's on their own;
* the clip's norm against the gathered gradient's: 1e-6 relative (one
  fp32 sum of squares in another order); against the reference's
  pre-clip norm: 1e-4 relative (the gradients' own tolerance);
* the replicas of a leaf, a one-slot mesh against the unsharded loop,
  a checkpoint read back: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim.optimizers import clip_by_global_norm as j_clip  # noqa: E402,E501
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.dryrun import zero_shard_specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.optimizers import _clip_scale  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

B, S = 2, 32
LR, STEP_TOL, LOSS_TOL, NORM_TOL = 1e-3, 0.1, 1e-5, 1e-6
GRAD_TOL = 1e-4
MOE_ARCHS = ("mixtral-8x22b", "jamba-1.5-large-398b", "dbrx-132b")
_J_INIT = jax.jit(j_tf.init_params, static_argnums=1)
_REF = {}


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _with_mode(cfg, mode):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, sharding_mode=mode))


def _reference(arch, n_slices):
    """The reference's params, batch, loss, gradient and one AdamW step:
    on the whole batch, or the mean over ``n_slices`` batch slices."""
    key = (arch, n_slices)
    if key not in _REF:
        jcfg = _fp32(j_get_smoke(arch))
        jp = _J_INIT(jax.random.PRNGKey(0), jcfg)
        cfg = _fp32(get_smoke_config(arch))
        batch = next(lm_batches(jcfg.vocab, B, S, 1, seed=0))
        batch.update({k: v.numpy() for k, v in
                      t_train.memory_stub(cfg, B, S, "cpu").items()})
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: j_tf.train_loss(p, b, jcfg, remat=False),
            has_aux=True))
        step = B // n_slices
        outs = [grad(jp, {k: jnp.asarray(v[i:i + step])
                          for k, v in batch.items()})
                for i in range(0, B, step)]
        loss = float(np.mean([float(o[0][0]) for o in outs]))
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[o[1] for o in outs])
        jopt = j_adamw(LR)
        new, _ = jax.jit(jopt.step)(jp, grads, jopt.init(jp))
        _REF[key] = (jax.tree.map(np.asarray, jp), batch, loss,
                     [np.asarray(t) for t in jax.tree.leaves(new)],
                     jax.tree.map(np.asarray, grads))
    return _REF[key]


@pytest.fixture
def mesh():
    def install(shape, axes=("data", "model")):
        m = make_mesh(shape, axes, "cpu")
        specs.set_mesh(m)
        return m
    yield install
    specs.set_mesh(None)


def _placed(arch, mode, m):
    cfg = _with_mode(_fp32(get_smoke_config(arch)), mode)
    tree, batch, loss, new, grads = _reference(
        arch, m.shape["data"] if arch in MOE_ARCHS else 1)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    pspecs = specs.param_pspecs(params, mode)
    return cfg, params, pspecs, batch, loss, new, grads


def _gathered_grads(parts, reduced, lspecs, m):
    """The whole gradient tree from each rank's reduced leaves, laid out
    by ``lspecs`` (the moments' specs: zero's slices gathered too)."""
    return specs.gather_tree(
        [t_train.tree_unflatten(p, g) for p, g in zip(parts, reduced)],
        lspecs, m)


def _assert_grads_match(got, ref_grads):
    ref_leaves = jax.tree.leaves(ref_grads)
    got = tree_leaves(got)
    assert len(got) == len(ref_leaves)
    for i, (g, r) in enumerate(zip(got, ref_leaves)):
        assert g.shape == r.shape, i
        assert float(np.abs(g.numpy() - r).max()) \
            <= GRAD_TOL * np.abs(r).max(), i


def _assert_replicas_bitwise(parts, pspecs, m):
    """Every rank that holds a leaf's shard holds the same bits."""
    spec_l = t_train.spec_leaves(parts[0], pspecs)
    leaves = [tree_leaves(p) for p in parts]
    for i, spec in enumerate(spec_l):
        axes = tuple(a for e in spec for a in specs._axes(e)
                     if a in m.axis_names)
        held = {}
        for r in range(m.size):
            key = specs.rank_index(m, r, axes)
            if key in held:
                assert torch.equal(leaves[r][i], held[key]), (i, r)
            else:
                held[key] = leaves[r][i]


@pytest.mark.parametrize("arch,mode,zero", [
    ("internlm2-1.8b", "tensor", False), ("internlm2-1.8b", "tensor", True),
    ("mixtral-8x22b", "tensor", False), ("mixtral-8x22b", "expert", False),
    ("mamba2-370m", "tensor", False), ("seamless-m4t-medium", "tensor",
                                       False)])
def test_meshed_adamw_step_matches_the_reference(arch, mode, zero, mesh):
    """(data 2, model 2): the loss, the reduced gradient (gathered), then
    every gathered weight after one meshed AdamW step against the
    reference's; every replica of a weight, and of its moments, bitwise
    the same; with ``zero`` the moments split over 'data' as well."""
    m = mesh((2, 2))
    cfg, params, pspecs, batch, ref_loss, ref_new, ref_grads = _placed(
        arch, mode, m)
    mspecs = zero_shard_specs(pspecs, params, m) if zero else None
    parts = specs.place(params, pspecs, m)
    opt = adamw(LR)
    state = t_train.mesh_init(opt, parts, pspecs, mspecs)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _, grads = t_train.loss_and_grads(parts, tb, cfg, remat=False)
    assert abs(float(loss) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    with torch.no_grad():
        reduced = t_train.reduce_grads(grads, pspecs, mspecs)
        _assert_grads_match(_gathered_grads(parts, reduced, mspecs or pspecs,
                                            m), ref_grads)
        new, state = t_train.mesh_step(opt, parts, grads, state, pspecs,
                                       mspecs)
    assert all(int(st["count"]) == 1 for st in state)
    _assert_replicas_bitwise(new, pspecs, m)
    for mom in ("m", "v"):
        _assert_replicas_bitwise(
            [{"w": st[mom]} for st in state],
            {"w": t_train.spec_leaves(params, mspecs or pspecs)}, m)
    got = tree_leaves(specs.gather_tree(new, pspecs, m))
    assert len(got) == len(ref_new)
    for i, (p, r) in enumerate(zip(got, ref_new)):
        assert p.shape == r.shape, i
        assert float(np.abs(p.numpy() - r).max()) <= STEP_TOL * LR, i


def test_clip_norm_counts_each_shard_once(mesh):
    """The clip is active (the norm exceeds adamw's 1.0), and the norm
    every rank steps with is the gathered gradient's, each shard's
    squares once; summing each rank's squares would count a replicated
    leaf four times and a model-split one twice.  The norm is also held
    to the reference's pre-clip norm of its own gradient."""
    m = mesh((2, 2))
    cfg, params, pspecs, batch, _, _, ref_grads = _placed(
        "internlm2-1.8b", "tensor", m)
    parts = specs.place(params, pspecs, m)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    _, _, grads = t_train.loss_and_grads(parts, tb, cfg, remat=False)
    with torch.no_grad():
        reduced = t_train.reduce_grads(grads, pspecs)
        norms = t_train.grad_norm(reduced, t_train.spec_leaves(params,
                                                               pspecs))
    logical = _gathered_grads(parts, reduced, pspecs, m)
    _assert_grads_match(logical, ref_grads)
    want = float(_clip_scale(logical, 1.0)[1])
    ref_norm = float(j_clip(ref_grads, 1.0)[1])
    assert want > 1.0 and ref_norm > 1.0
    assert all(torch.equal(n, norms[0]) for n in norms)
    assert abs(float(norms[0]) - want) <= NORM_TOL * want
    assert abs(float(norms[0]) - ref_norm) <= GRAD_TOL * ref_norm
    # every leaf is held at least twice over the four ranks
    naive = sum(float(torch.sum(torch.square(g)))
                for g_r in reduced for g in g_r)
    assert naive >= 2 * want ** 2 * (1 - NORM_TOL)


def test_one_slot_mesh_is_the_unsharded_loop_bitwise():
    """``train(mesh=)`` with one slot, and the default host mesh of
    ``device="cpu"``, take PR 23's loop: the same bits as
    ``loss_and_grads`` + ``adamw`` from the same seed."""
    arch, steps = "mamba2-370m", 3
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = t_train.tf_model.init_params(gen, cfg)
    opt = adamw(LR)
    state = opt.init(params)
    want = []
    for b in lm_batches(cfg.vocab, B, S, steps, 0):
        loss, _, grads = t_train.loss_and_grads(
            params, {k: torch.from_numpy(v) for k, v in b.items()}, cfg,
            remat=False)
        with torch.no_grad():
            params, state = opt.step(params, grads, state)
        want.append(float(loss))
    for m in (make_mesh((1, 1), ("data", "model"), "cpu"), None):
        losses, got = t_train.train(arch, steps=steps, batch=B, seq=S,
                                    lr=LR, log_every=0, device="cpu",
                                    mesh=m, return_params=True)
        assert losses == want
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(got), tree_leaves(params)))


def test_meshed_checkpoint_is_the_gathered_tree(tmp_path):
    """``--ckpt`` of a (data 2, model 2) run writes the gathered tree in
    the unmeshed run's format: the same paths, shapes and dtypes, read
    back bit for bit; the loss falls as without the mesh."""
    arch = "internlm2-1.8b"
    m = make_mesh((2, 2), ("data", "model"), "cpu")
    losses, params = t_train.train(arch, steps=4, batch=B, seq=S, lr=1e-2,
                                   log_every=0, device="cpu", mesh=m,
                                   ckpt=str(tmp_path / "meshed"),
                                   return_params=True)
    assert losses[-1] < losses[0]
    t_train.train(arch, steps=1, batch=B, seq=S, log_every=0, device="cpu",
                  ckpt=str(tmp_path / "plain"))
    tree, meta = restore_checkpoint(str(tmp_path / "meshed"), bf16="torch")
    plain, _ = restore_checkpoint(str(tmp_path / "plain"), bf16="torch")
    assert meta == {"arch": arch, "steps": 4, "final_loss": losses[-1]}
    got = bridge.load_zoo_params(tree["params"], get_smoke_config(arch),
                                 "cpu")
    ref = tree_leaves(bridge.load_zoo_params(plain["params"],
                                             get_smoke_config(arch), "cpu"))
    for a, b, c in zip(tree_leaves(got), tree_leaves(params), ref):
        assert torch.equal(a, b)
        assert a.shape == c.shape and a.dtype == c.dtype
    assert specs.get_mesh() is None
    assert tree_map(lambda t: t.shape, got) == tree_map(lambda t: t.shape,
                                                        params)
