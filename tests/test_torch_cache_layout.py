"""The meshed decode step's cache layout on the CPU: the reference's
``cache_pspecs``, the decode-attention kernel's partial twin and a decode
step that gathers activations only, against the JAX package.

* The partial twin (``decode_attention_partial_ref``, and the public op
  ``decode_attention_partial`` that runs it on a CPU tensor), merged with
  ``combine_partials`` over slot ranges of unequal lengths, one of them
  all empty, or with no valid slot at all, equals the reference's
  ``decode_attention_ref`` on the same numpy inputs: 1e-5 in fp32, and
  ``tests/test_torch_kernels.py``'s 2e-2 in bf16 (the ranges' sums are
  taken in another order).
* ``shard_cache`` holds every attention, SSM and conv leaf as
  ``cache_pspecs`` splits it: each rank's bytes equal ``_split_bytes`` of
  the spec, and the dry-run's ``cache_layouts`` reports no difference.
* A meshed ``prefill`` + 4 greedy ``decode_step`` s equal the
  reference's unsharded ones (the logits, and every leaf of the gathered
  cache after prefill and after the last step, the ring wrapping) at
  ``tests/test_torch_model_sharding.py``'s fp32 tolerance, 1e-4, on four
  layouts: the length over 'model' (2 kv heads at model 4; the vision
  model's CROSS layers too), the length over 'data' with the kv heads
  over 'model' (batch 1 at (data 2, model 2)), and the length over
  'data' with every kv head on every model rank (batch 1 at (data 2,
  model 4)).  Each rank's partial state is computed once a layer and
  step where the length is split.  The Mamba half: Jamba at (model 4),
  whose smoke in_proj (552 columns) and conv (288 channels) split into
  138 / 72 a rank across the z | x and x | B boundaries, and mamba2 at
  batch 1 over (data 2, model 2), its conv cache replicated over 'data'.
* A decode step counted on ``meta`` all-gathers only its activations:
  the queries where the length is split over 'model', the new token's
  k / v columns where a rank holds every kv head, a Mamba block's
  projection (d_proj) and conv output (d_xbc); never wk / wv, in_proj
  or conv_w.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref)
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import MAMBA  # noqa: E402
from repro_torch.configs import list_architectures  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partial)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials, decode_attention_partial_ref)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import sharded  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

FP32_TOL, BF16_TOL, MODEL_TOL = 1e-5, 2e-2, 1e-4
S, S_MEM, N_DECODE = 40, 48, 4
LEAVES = ("k", "v", "xk", "xv", "ssm", "conv")


@pytest.fixture
def mesh():
    def install(shape, device="cpu"):
        axes = ("data", "model") if len(shape) == 2 else ("model",)
        m = make_mesh(shape, axes, device)
        specs.set_mesh(m)
        return m
    yield install
    specs.set_mesh(None)


# ---------------------------------------------------------------------------
# the partial twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos_kind", ["lens", "range empty", "none valid"])
@pytest.mark.parametrize("bf16", [False, True])
def test_partial_twin_merged_is_the_reference(pos_kind, bf16):
    """Slot ranges [0, 7), [7, 40), [40, 64) of a 64-slot cache, each
    one's state from the twin (the middle one through the public op),
    merged; "range empty": every slot of [7, 40) is empty, so it must
    weigh 0; "none valid": the cache averages its values."""
    B, W, H, K, hd = 2, 64, 8, 2, 16
    rng = np.random.default_rng(7 + len(pos_kind) + bf16)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, W, K, hd), (B, W, K, hd)))
    ar = np.arange(W)
    if pos_kind == "lens":
        pos = np.where(ar[None] < rng.integers(1, W + 1, (B, 1)), ar[None],
                       -1)
    elif pos_kind == "range empty":
        pos = np.broadcast_to(np.where((ar >= 7) & (ar < 40), -1, ar),
                              (B, W))
    else:
        pos = np.full((B, W), -1)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    qg = tq[:, 0].reshape(B, K, H // K, hd)
    parts = []
    for lo, hi in ((0, 7), (7, 40), (40, W)):
        if lo == 7:
            m, l, acc = decode_attention_partial(tq, tk[:, lo:hi],
                                                 tv[:, lo:hi], tp[:, lo:hi])
            assert m.shape == l.shape == (B, H) and acc.shape == (B, H, hd)
            assert m.dtype == l.dtype == acc.dtype == torch.float32
            parts.append((m.reshape(B, K, H // K), l.reshape(B, K, H // K),
                          acc.reshape(B, K, H // K, hd)))
        else:
            parts.append(decode_attention_partial_ref(
                qg, tk[:, lo:hi], tv[:, lo:hi], tp[:, lo:hi]))
    out = combine_partials(parts, tdt)
    assert out.dtype == tdt
    want = j_decode_ref(jnp.asarray(q, jdt)[:, 0].reshape(B, K, H // K, hd),
                        jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                        jnp.asarray(pos))
    tol = BF16_TOL if bf16 else FP32_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_partial_of_no_slot_weighs_nothing():
    """No slot: M = -inf, L = 0, acc = 0, which adds nothing to a range
    that has slots."""
    B, W, H, K, hd = 1, 8, 4, 2, 8
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, 1, H, hd), generator=gen)
    k, v = (torch.randn((B, W, K, hd), generator=gen) for _ in range(2))
    pos = torch.arange(W, dtype=torch.int32)
    m, l, acc = decode_attention_partial(q, k[:, :0], v[:, :0], pos[:0])
    assert bool(torch.isinf(m).all()) and float(m.max()) < 0
    assert not l.any() and not acc.any()
    whole = decode_attention_partial(q, k, v, pos)
    merged = combine_partials([tuple(t.reshape((B, H) + t.shape[2:])
                                     for t in (m, l, acc)), whole],
                              torch.float32)
    alone = combine_partials([whole], torch.float32)
    assert torch.equal(merged, alone)


# ---------------------------------------------------------------------------
# shard_cache by cache_pspecs
# ---------------------------------------------------------------------------
_MESHES = [((4,), 2), ((2, 2), 1), ((2, 2), 2), ((2, 4), 1)]


@pytest.mark.parametrize("mesh_shape,batch", _MESHES)
@pytest.mark.parametrize("arch", list_architectures())
def test_shard_cache_bytes_are_cache_pspecs(arch, mesh_shape, batch, mesh):
    """Every rank's k / v / xk / xv / ssm / conv bytes are the spec's share of
    the whole leaf (on ``meta``), and ``cache_layouts`` agrees: (model
    4), where 2 kv heads do not divide; (data 2, model 2) at batch 1 and
    2; (data 2, model 4) at batch 1."""
    cfg = get_smoke_config(arch)
    shape = InputShape("decode_small", "decode", 64, batch)
    m = mesh(mesh_shape, "meta")
    cache = t_tf.cache_struct(cfg, batch, 64, memory_len=S_MEM)
    ref = specs.cache_pspecs(cache, m)
    ranks = sharded.shard_cache(cache, cfg)
    for b, leaves in cache.items():
        for name, t in leaves.items():
            if name not in LEAVES:
                continue
            want = dryrun._split_bytes(t, ref[b][name], m)
            for r, part in enumerate(ranks.parts):
                got = part[b][name]
                assert got.numel() * got.element_size() == want, \
                    (b, name, r)
    specs.set_mesh(None)
    layouts = dryrun.cache_layouts(cfg, shape, m)
    for key, row in layouts.items():
        if key.split("/")[1] in LEAVES:
            assert not row["differ"], key
    if arch == "qwen3-8b" and mesh_shape == (4,):
        assert layouts["b0/k"]["reference_spec"] == [None, None, "model",
                                                     None, None]


# ---------------------------------------------------------------------------
# prefill + decode over a mesh against the reference's unsharded run
# ---------------------------------------------------------------------------
_REF = {}


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _batch(cfg, batch):
    out = {"tokens": next(lm_batches(cfg.vocab, batch, S, 1,
                                     seed=3))["tokens"]}
    if cfg.vision_stub:
        out["image_embeds"] = np.random.default_rng(103).standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _reference(arch, batch, moe_group):
    """The reference's unsharded fp32 prefill, in MoE dispatch groups of
    ``moe_group`` tokens, and N_DECODE greedy steps (computed once per
    arch and batch; the prefill traced in a jit of its own, so that no
    other test's trace sees the group)."""
    key = (arch, batch)
    if key not in _REF:
        jcfg = _fp32(j_get_smoke(arch))
        jp = jax.jit(j_tf.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg)
        jb = {k: jnp.asarray(v) for k, v in _batch(jcfg, batch).items()}
        real = j_moe.MOE_GROUP
        try:
            j_moe.MOE_GROUP = moe_group
            last, cache = jax.jit(lambda p, b: j_tf.prefill(p, b, jcfg))(
                jp, jb)
        finally:
            j_moe.MOE_GROUP = real
        out = {"params": jax.tree.map(np.asarray, jp),
               "last": np.asarray(last),
               "cache": jax.tree.map(np.asarray, cache), "tokens": [],
               "logits": []}
        decode = jax.jit(j_tf.decode_step, static_argnames=("cfg",))
        tok = jnp.argmax(last, -1)
        for step in range(N_DECODE):
            out["tokens"].append(np.asarray(tok))
            logits, cache = decode(jp, cache, tok[:, None],
                                   jnp.int32(S + step), cfg=jcfg)
            out["logits"].append(np.asarray(logits))
            tok = jnp.argmax(logits, -1)
        out["final_cache"] = jax.tree.map(np.asarray, cache)
        _REF[key] = out
    return _REF[key]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def _close_cache(cache, want, cfg):
    got = sharded.gather_cache(cache, cfg)
    assert set(got) == set(want)
    for b in got:
        assert set(got[b]) == set(want[b]), b
        for name, leaf in got[b].items():
            assert tuple(leaf.shape) == want[b][name].shape, (b, name)
            if name == "pos":
                assert np.array_equal(leaf.numpy(), want[b][name])
            else:
                _close(leaf, want[b][name])


@pytest.mark.parametrize("arch,mesh_shape,batch,split", [
    ("internlm2-1.8b", (4,), 1, ("model",)),
    ("llama-3.2-vision-11b", (4,), 1, ("model",)),
    ("mixtral-8x22b", (2, 2), 1, ("data",)),
    ("internlm2-1.8b", (2, 4), 1, ("data",)),
    ("jamba-1.5-large-398b", (4,), 2, ("model",)),
    ("mamba2-370m", (2, 2), 1, ())])
def test_meshed_decode_is_the_reference(arch, mesh_shape, batch, split,
                                        mesh, monkeypatch):
    """The port's meshed prefill + decode steps, fed the reference's
    greedy tokens, against the reference's unsharded run: the last
    logits, every step's logits and the gathered caches; the self
    attention's cache length split over ``split``, and a partial state
    per rank, attention layer and step.  Mixtral's batch of 1 prompt
    splits its sequence over 'data' in the prefill, and each data rank's
    MoE dispatches its own S/2 tokens (the reference's ``shard_map``
    blocks), so its reference dispatches in groups of S/2 tokens: the
    unsharded function that run computes.  The Mamba blocks' conv and
    ssm caches are gathered and held like every other leaf."""
    dp = mesh_shape[0] if len(mesh_shape) == 2 else 1
    want = _reference(arch, batch, batch * S // dp)
    cfg = _fp32(get_smoke_config(arch))
    params = bridge.load_zoo_params(want["params"], cfg, "cpu")
    m = mesh(mesh_shape)
    placed = specs.place(params, specs.param_pspecs(params), m)
    calls = []
    real = t_attn.decode_attention_partial
    monkeypatch.setattr(t_attn, "decode_attention_partial",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, batch).items()}
    with torch.no_grad():
        last, cache = t_tf.prefill(placed, tb, cfg)
        _close(col.unshard(last), want["last"])
        _close_cache(cache, want["cache"], cfg)
        for step in range(N_DECODE):
            logits, cache = t_tf.decode_step(
                placed, cache, torch.tensor(want["tokens"][step])[:, None],
                S + step, cfg)
            _close(col.unshard(logits), want["logits"][step])
        _close_cache(cache, want["final_cache"], cfg)
    n_split = 0
    for b, leaves in cache.specs.items():
        for name in ("k", "xk"):
            if name in leaves:
                length = sharded._kv(leaves[name]).length
                if name == "k":
                    assert length == split, (b, length)
                n_split += bool(length)
    assert len(calls) == m.size * cfg.n_periods * n_split * N_DECODE
    assert {shape[1] for shape in calls} <= {S // 2, S // 4,
                                             cfg.n_image_tokens // 4}


# ---------------------------------------------------------------------------
# a decode step's collectives, counted on meta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mesh_shape,batch", [
    ("qwen3-8b", (1, 4), 2), ("mixtral-8x22b", (2, 2), 1),
    ("internlm2-1.8b", (2, 4), 1), ("jamba-1.5-large-398b", (1, 4), 2),
    ("mamba2-370m", (2, 2), 1)])
def test_decode_step_gathers_activations_only(arch, mesh_shape, batch,
                                              monkeypatch):
    """One rank's all-gather bytes in a decode step on ``meta``: at
    (model 4) the length is split over 'model', so each attention layer
    gathers the queries (B, 1, H, hd) and the new token's k and v (B, 1,
    K·hd); at (data 2, model 2) batch 1 the kv heads divide and nothing is
    gathered; at (data 2, model 4) batch 1 each rank holds every kv head
    of its slots, so each layer gathers the new k and v alone.  Each
    Mamba layer gathers its projection (B, 1, d_proj) and its conv output
    (B, 1, d_xbc) (Jamba's smoke 552 + 288 columns, mamba2's the same).
    Every gathered part is one token's activations: no wk / wv, in_proj
    or conv_w; the all-reduce carries the merge of the ranks' states."""
    cfg = get_smoke_config(arch)
    a = cfg.attn
    shape = InputShape("decode_small", "decode", 64, batch)
    m = make_mesh(mesh_shape, ("data", "model"), "meta")
    rows = batch // m.shape["data"] if batch % m.shape["data"] == 0 \
        else batch
    parts = []
    real = col.all_gather
    monkeypatch.setattr(col, "all_gather", lambda ps, *args, **kw: parts.
                        extend(tuple(p.shape) for p in ps) or real(
                            ps, *args, **kw))
    step, args, args_b = dryrun.build_mesh_step(cfg, shape, m, "meta")
    try:
        flat = dryrun.count_mesh_step(step, args, args_b)
    finally:
        specs.set_mesh(None)
    el = torch.finfo(cfg.torch_dtype).bits // 8
    n_attn = cfg.n_periods * sum(k != MAMBA for k in cfg.period)
    n_mamba = cfg.n_layers - n_attn
    attn_cols = 0 if a is None else a.head_dim * {
        "qwen3-8b": a.n_heads + 2 * a.n_kv_heads, "mixtral-8x22b": 0,
        "internlm2-1.8b": 2 * a.n_kv_heads,
        "jamba-1.5-large-398b": a.n_heads + 2 * a.n_kv_heads}[arch]
    mamba_cols = 0
    if cfg.ssm is not None:
        d_in, n_heads, d_xbc = t_ssm.dims(cfg)
        mamba_cols = (2 * d_in + 2 * cfg.ssm.d_state + n_heads) + d_xbc
    want = rows * el * (n_attn * attn_cols + n_mamba * mamba_cols)
    assert flat.get("collective:all-gather", 0.0) == want
    assert all(p[:2] == (rows, 1) for p in parts), parts
    assert flat.get("launches:decode_attention:partial", 0) == n_attn
