"""The zoo's model sharding on the CPU: ``prefill``, ``decode_step`` and
``train_loss`` over a mesh of CPU ranks against the JAX package.

The models start from the reference's own ``init_params(PRNGKey(0))``
at the smoke config through ``bridge.load_zoo_params``, are placed with
``sharding.place(params, param_pspecs(params, mode), mesh)`` and run
with the mesh installed; prompts come from ``lm_batches`` (numpy,
seeded), B = 2 x S = 40, and 4 greedy decode steps follow (the ring
wraps).  What a meshed run is held to:

* no data axis ((data 1, model 2), (model 4)): the reference's unsharded
  functions;
* a data axis of d: the reference's unsharded run on each of the d
  batch slices, which is what the reference's own meshed run computes
  (its MoE takes capacity per data shard).  Only the MoE couples a
  batch's rows, so for a model without MoE the whole batch's run is
  that reference;
* bf16 on (data 2, model 2): the reference's own meshed prefill, run in
  a subprocess over 4 virtual CPU devices.

Tolerances, each with its reason:

* fp32 logits, every gathered cache leaf and greedy tokens: 1e-4 and
  equal, ``tests/test_torch_zoo.py``'s ``MODEL_TOL`` (the same products
  as the unsharded port, the row-parallel ones as a sum of 2 or 4
  partial products);
* the loss and every gathered gradient leaf: ``tests/test_torch_train.
  py``'s 1e-5 relative and 1e-4 x max|reference leaf|;
* bf16 against the reference's meshed prefill: 6e-2, the tolerance the
  reference gives its own prefill / decode paths against each other.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import list_architectures  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import sharded  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = tuple(list_architectures())
MOE_ARCHS = ("mixtral-8x22b", "jamba-1.5-large-398b", "dbrx-132b")
B, S, S_ENC, N_DECODE = 2, 40, 48, 4
MODEL_TOL, BF16_TOL = 1e-4, 6e-2
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
TRAIN_S = 32
ROOT = os.path.join(os.path.dirname(__file__), "..")

_J_PREFILL = jax.jit(j_tf.prefill, static_argnames=("cfg",))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnames=("cfg",))
_J_INIT = jax.jit(j_tf.init_params, static_argnums=1)
_PARAMS, _REF = {}, {}


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _with_mode(cfg, mode):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, sharding_mode=mode))


def _jparams(arch, fp32=True):
    key = (arch, fp32)
    if key not in _PARAMS:
        jcfg = _fp32(j_get_smoke(arch)) if fp32 else j_get_smoke(arch)
        jp = _J_INIT(jax.random.PRNGKey(0), jcfg)
        _PARAMS[key] = (jcfg, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[key]


def _batch(cfg, seed=0):
    batch = {"tokens": next(lm_batches(cfg.vocab, B, S, 1,
                                       seed=seed))["tokens"]}
    if cfg.encoder is not None or cfg.vision_stub:
        n = cfg.n_image_tokens if cfg.vision_stub else S_ENC
        mem = np.random.default_rng(seed + 100).standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)
        batch["frames" if cfg.encoder is not None else "image_embeds"] = mem
    return batch


def _reference(arch, rows):
    """The reference's unsharded fp32 prefill and 4 greedy decode steps
    on the batch rows ``rows`` (computed once per arch and rows)."""
    key = (arch, rows)
    if key not in _REF:
        jcfg, jp, _ = _jparams(arch)
        jb = {k: jnp.asarray(v[rows[0]:rows[1]])
              for k, v in _batch(jcfg).items()}
        last, cache = _J_PREFILL(jp, jb, cfg=jcfg)
        out = {"last": np.asarray(last), "cache": jax.tree.map(np.asarray,
                                                               cache),
               "tokens": [], "logits": []}
        tok = jnp.argmax(last, -1)
        for step in range(N_DECODE):
            out["tokens"].append(np.asarray(tok))
            logits, cache = _J_DECODE(jp, cache, tok[:, None],
                                      jnp.int32(S + step), cfg=jcfg)
            out["logits"].append(np.asarray(logits))
            tok = jnp.argmax(logits, -1)
        out["final_cache"] = jax.tree.map(np.asarray, cache)
        _REF[key] = out
    return _REF[key]


def _expected(arch, n_slices):
    """The reference run on each of ``n_slices`` batch slices, joined
    along the batch (the whole batch's run for one slice, or for a model
    whose rows nothing couples)."""
    if n_slices == 1 or arch not in MOE_ARCHS:
        return _reference(arch, (0, B))
    step = B // n_slices
    parts = [_reference(arch, (i, i + step)) for i in range(0, B, step)]

    def join(*xs, axis=0):
        return np.concatenate(xs, axis=axis)

    def join_cache(*cs):
        return {b: {n: (cs[0][b][n] if n == "pos"
                        else join(*(c[b][n] for c in cs), axis=1))
                    for n in cs[0][b]} for b in cs[0]}

    return {"last": join(*(p["last"] for p in parts)),
            "cache": join_cache(*(p["cache"] for p in parts)),
            "final_cache": join_cache(*(p["final_cache"] for p in parts)),
            "tokens": [join(*t) for t in zip(*(p["tokens"] for p in parts))],
            "logits": [join(*t) for t in zip(*(p["logits"] for p in parts))]}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_cache(cache, want, cfg, tol):
    got = sharded.gather_cache(cache, cfg)
    assert set(got) == set(want)
    for b in got:
        assert set(got[b]) == set(want[b]), b
        for name, leaf in got[b].items():
            assert tuple(leaf.shape) == want[b][name].shape, (b, name)
            if name == "pos":
                assert np.array_equal(leaf.numpy(), want[b][name])
            else:
                _close(leaf, want[b][name], tol)


@pytest.fixture
def mesh():
    def install(shape, axes, seq_parallel=False):
        m = make_mesh(shape, axes, "cpu")
        specs.set_mesh(m)
        specs.set_seq_parallel(seq_parallel)
        return m
    yield install
    specs.set_mesh(None)
    specs.set_seq_parallel(False)


def _serve_meshed(arch, m, mode="tensor"):
    """Prefill + 4 decode steps of ``arch`` over the installed mesh ``m``
    against the reference on each data slice; the port is fed the
    reference's greedy tokens and its own argmax must equal them."""
    cfg = _with_mode(_fp32(get_smoke_config(arch)), mode)
    _, _, tree = _jparams(arch)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    placed = specs.place(params, specs.param_pspecs(params, mode), m)
    dp = m.shape.get("data", 1)
    want = _expected(arch, dp if B % dp == 0 else 1)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        last, cache = t_tf.prefill(placed, tb, cfg)
        assert isinstance(last, col.Sharded)
        _close(col.unshard(last), want["last"], MODEL_TOL)
        _close_cache(cache, want["cache"], cfg, MODEL_TOL)
        tok = col.unshard(last).argmax(-1)
        for step in range(N_DECODE):
            assert np.array_equal(tok.numpy(), want["tokens"][step]), step
            logits, cache = t_tf.decode_step(
                placed, cache, torch.tensor(want["tokens"][step])[:, None],
                S + step, cfg)
            _close(col.unshard(logits), want["logits"][step], MODEL_TOL)
            tok = col.unshard(logits).argmax(-1)
        _close_cache(cache, want["final_cache"], cfg, MODEL_TOL)


_MODEL2 = [(a, "tensor") for a in ARCHS] + [("mixtral-8x22b", "expert")]


@pytest.mark.parametrize("arch,mode", _MODEL2)
def test_model2_serves_as_the_unsharded_reference(arch, mode, mesh):
    """(data 1, model 2): every architecture, Mixtral in both MoE
    modes."""
    _serve_meshed(arch, mesh((1, 2), ("data", "model")), mode)


@pytest.mark.parametrize("arch,mode", [
    ("internlm2-1.8b", "tensor"), ("llama-3.2-vision-11b", "tensor"),
    ("mixtral-8x22b", "expert")])
def test_model4_gathers_the_kv_heads_it_reads(arch, mode, mesh):
    """(model 4): 2 kv heads over 4 ranks, so wk / wv's column shards are
    half a kv head: the prefill gathers wk / wv and each rank computes
    the one kv head its query head reads, and the cache's length is
    split over 'model' (each rank all kv heads of its 10 slots); a
    decode step gathers the new token's k / v columns and the queries
    and merges the ranks' partial states (the vision model's CROSS
    layers too); Mixtral's 4 experts go one a rank.  No data axis: the
    MoE takes the local path."""
    m = mesh((4,), ("model",))
    cfg = get_smoke_config(arch)
    assert cfg.attn.n_kv_heads % 4 != 0
    _serve_meshed(arch, m, mode)


@pytest.mark.parametrize("arch,mode", [
    ("mixtral-8x22b", "tensor"), ("mixtral-8x22b", "expert"),
    ("jamba-1.5-large-398b", "tensor"), ("seamless-m4t-medium", "tensor")])
def test_data2_model2_is_the_reference_on_each_batch_slice(arch, mode,
                                                             mesh):
    _serve_meshed(arch, mesh((2, 2), ("data", "model")), mode)


@pytest.mark.parametrize("arch,mode", [
    ("internlm2-1.8b", "tensor"), ("mixtral-8x22b", "expert"),
    ("jamba-1.5-large-398b", "tensor"), ("seamless-m4t-medium", "tensor")])
def test_seq_parallel_serves_as_without_it(arch, mode, mesh):
    """``SEQ_PARALLEL`` on: the residual stream holds S/2 tokens a rank
    between blocks (reduce-scatter at a block's exit, all-gather at the
    next one's entry); the results are the reference's all the same."""
    m = mesh((1, 2), ("data", "model"), seq_parallel=True)
    assert col.token_spec((B, S, 8)) == (("data",), ("model",), None)
    _serve_meshed(arch, m, mode)


_TRAIN = {}


def _train_reference(arch):
    if arch not in _TRAIN:
        jcfg, jp, tree = _jparams(arch)
        cfg = _fp32(get_smoke_config(arch))
        batch = next(lm_batches(jcfg.vocab, B, TRAIN_S, 1, seed=0))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: j_tf.train_loss(
                p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                remat=False), has_aux=True))(jp)
        _TRAIN[arch] = (cfg, tree, batch, float(loss),
                        {k: float(v) for k, v in metrics.items()},
                        [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _TRAIN[arch]


@pytest.mark.parametrize("arch,mode,remat,loss_chunk", [
    ("internlm2-1.8b", "tensor", False, 0),
    ("mixtral-8x22b", "tensor", True, 0),
    ("mixtral-8x22b", "expert", False, 8),
    ("mamba2-370m", "tensor", True, 8)])
def test_train_loss_and_gathered_grads_match_the_reference(
        arch, mode, remat, loss_chunk, mesh):
    """(data 1, model 2): the loss, its xent and aux, and every gradient
    leaf (each rank's, gathered with the replicas' summed) against
    ``jax.grad`` of the reference's; remat and the chunked loss replay
    or split the collectives."""
    m = mesh((1, 2), ("data", "model"))
    cfg, tree, batch, ref_loss, ref_metrics, ref_grads = \
        _train_reference(arch)
    cfg = _with_mode(cfg, mode)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    spec = specs.param_pspecs(params, mode)
    placed = [tree_map(lambda t: t.detach().requires_grad_(True), p)
              for p in specs.place(params, spec, m)]
    loss, metrics = t_tf.train_loss(
        placed, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        remat=remat, loss_chunk=loss_chunk)
    loss.backward()
    assert abs(float(loss.detach()) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    for k in ("xent", "aux"):
        assert abs(float(metrics[k].detach()) - ref_metrics[k]) \
            <= LOSS_TOL * abs(ref_loss), k
    grads = specs.gather_tree(
        [tree_map(lambda t: t.grad, p) for p in placed], spec, m,
        sum_replicas=True)
    got = tree_leaves(grads)
    assert len(got) == len(ref_grads)
    for i, (g, r) in enumerate(zip(got, ref_grads)):
        assert g.shape == r.shape, i
        assert float(np.abs(g.numpy() - r).max()) \
            <= GRAD_TOL * np.abs(r).max(), i


_REF_MESHED = r"""
import sys
import numpy as np
import jax
from repro import sharding as shd
from repro.configs import get_smoke_config
from repro.data.streams import lm_batches
from repro.models import moe
from repro.models import transformer as tf
import dataclasses
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
shd.set_mesh(mesh)
for mode, group, dtype in MODES:
    moe.MOE_GROUP = group
    cfg = get_smoke_config("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, sharding_mode=mode))
    params = tf.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.device_put(params, shd.tree_named_shardings(
        mesh, shd.param_pspecs(params, moe_mode=mode)))
    tokens = next(lm_batches(cfg.vocab, 4, 32, 1, seed=0))["tokens"]
    last, _ = jax.jit(tf.prefill, static_argnames=("cfg",))(
        params, {"tokens": jax.numpy.asarray(tokens)}, cfg=cfg)
    np.save(f"{sys.argv[1]}_{mode}_{group}_{dtype}.npy",
            np.asarray(last.astype(jax.numpy.float32)))
"""
# (MoE mode, dispatch group, dtype): at 16 a data shard's 64 tokens are
# 4 groups in tensor mode and one ungrouped dispatch in expert mode.  A
# group's capacity is then 12 slots, so a routing tie that bf16 rounding
# flips re-queues the group's later tokens: those cases run in fp32.
_MESHED_CASES = (("tensor", 2048, "bfloat16"), ("expert", 2048, "bfloat16"),
                 ("tensor", 16, "float32"), ("expert", 16, "float32"))


@pytest.fixture(scope="module", autouse=True)
def reference_meshed(tmp_path_factory):
    """Start the reference's meshed prefills (a subprocess of ~12 s) with
    the module's first test, so that they run beside the in-process
    tests; the test that reads them waits for it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4").strip(),
        PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
        + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path_factory.mktemp("reference_meshed") / "ref")
    code = _REF_MESHED.replace("MODES", repr(_MESHED_CASES))
    proc = subprocess.Popen([sys.executable, "-c", code, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_data2_model2_bf16_prefill_is_the_reference_meshed_prefill(
        reference_meshed, mesh, monkeypatch):
    """The reference's own meshed prefill (bf16 smoke Mixtral, 4 x 32
    tokens, on an Auto-axis (data 2, model 2) ``jax.sharding.Mesh`` over
    4 virtual CPU devices, both MoE modes) against the port's; also, in
    fp32, with a dispatch group of 16 tokens in both packages, where
    tensor mode groups each data shard's tokens and expert mode does
    not."""
    proc, out = reference_meshed
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    m = mesh((2, 2), ("data", "model"))
    tokens = torch.from_numpy(next(lm_batches(512, 4, 32, 1,
                                              seed=0))["tokens"])
    for mode, group, dtype in _MESHED_CASES:
        monkeypatch.setattr(t_moe, "MOE_GROUP", group)
        fp32 = dtype == "float32"
        _, _, tree = _jparams("mixtral-8x22b", fp32=fp32)
        cfg = get_smoke_config("mixtral-8x22b")
        cfg = _with_mode(_fp32(cfg) if fp32 else cfg, mode)
        params = bridge.load_zoo_params(tree, cfg, "cpu")
        placed = specs.place(params, specs.param_pspecs(params, mode), m)
        with torch.no_grad():
            last, _ = t_tf.prefill(placed, {"tokens": tokens}, cfg)
        _close(col.unshard(last),
               np.load(f"{out}_{mode}_{group}_{dtype}.npy"),
               MODEL_TOL if fp32 else BF16_TOL)


def test_no_mesh_leaves_the_unsharded_path_bitwise(mesh):
    """With no mesh installed the public functions take the unsharded
    path: the same bits before and after a meshed run, plain tensors and
    the unsharded cache tree."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    _, _, tree = _jparams("jamba-1.5-large-398b", fp32=False)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])

    def run(p):
        with torch.no_grad():
            last, cache = t_tf.prefill(p, {"tokens": tokens}, cfg)
            logits, cache = t_tf.decode_step(p, cache,
                                             last.argmax(-1)[:, None], S, cfg)
        return [last, logits] + tree_leaves(cache)

    before = run(params)
    m = mesh((1, 2), ("data", "model"))
    with torch.no_grad():
        meshed, _ = t_tf.prefill(specs.place(params, specs.param_pspecs(
            params), m), {"tokens": tokens}, cfg)
    assert isinstance(meshed, col.Sharded)
    specs.set_mesh(None)
    after = run(params)
    assert all(isinstance(t, torch.Tensor) for t in after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    loss, _ = t_tf.train_loss(params, {k: torch.from_numpy(v) for k, v in
                                       next(lm_batches(cfg.vocab, B, 32, 1,
                                                       seed=0)).items()},
                              cfg, remat=False)
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0
