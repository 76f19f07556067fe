"""The zoo's forward, prefill, decode and loss over a mesh (the port of
the reference's ``constrain`` / ``constrain_tokens`` points in
``repro.models.transformer``, ``moe`` and ``ssm``, as explicit
collectives).

``transformer.forward`` / ``train_loss`` / ``encode`` / ``prefill`` /
``decode_step`` come here when a mesh is installed
(``sharding.set_mesh``); their ``params`` are then each rank's shard,
``sharding.place(params, param_pspecs(params, moe_mode), mesh)``.  One
process runs each layer rank by rank (``collectives.rank_map``), and the
ranks meet only at the collectives.  The residual stream is a
``Sharded`` in ``constrain_tokens``' layout: the batch split over the
data axes where it divides (else the sequence), with
``SEQ_PARALLEL`` the sequence also over 'model'.  At a block's entry it
is all-gathered to whole sequences; each rank runs the unsharded block
functions on its shard, with a shard-local config; the row-parallel
outputs are all-reduced (reduce-scattered under sequence parallelism) at
the block's exit.

* Attention: wq / wk / wv column-parallel, wo row-parallel: rank j runs
  heads [j, j+1) x H/m and kv heads [j, j+1) x K/m.  Where 'model' does
  not divide the kv heads (2 kv heads at model=4; 8 at the production
  mesh's 16), the rule still splits wk / wv by columns, so a rank holds
  part of a kv head.  The whole-sequence paths (forward, prefill, the
  loss) then all-gather wk / wv over 'model' and each rank takes the one
  kv head its query heads read (q head h reads h // (H/K)); a decode
  step gathers activations instead (below).
* Dense MLP: w_gate / w_in column-parallel, w_out row-parallel.
* MoE: ``moe.moe_ffn_sharded`` (tensor or expert mode).
* Mamba2: in_proj's columns are [z | x | B | C | dt] and conv's are
  [x | B | C], split contiguously by the rule, which does not align with
  heads; A_log, D, dt_bias, gate_norm and out_proj's rows are split by
  heads.  The whole-sequence paths (forward, prefill, the loss)
  all-gather in_proj and conv and each rank takes the columns of its
  heads (z, x and dt) and the shared B and C; a decode step gathers
  activations instead (below).  The gated RMSNorm's mean over all of
  d_inner is an all-reduce of the sum of squares.
* Embedding and head: vocab-parallel.  The lookup zeroes ids outside a
  rank's rows and the ranks all-reduce; logits stay split over vocab
  (``constrain(logits, (batch, None, "model"))``), and the loss is exact
  over the shards: the max and the sum of exponentials all-reduced, the
  gold logit from the rank that holds it.

Prefill returns each rank's caches (``RankCaches``); ``gather_cache``
rebuilds the unsharded cache from them, and ``shard_cache`` is its
inverse, each rank's cache from a whole one (what a decode step over a
mesh takes).  The layout is the reference's ``cache_pspecs``
(``sharding.specs``) for every leaf:

* k / v / xk / xv (B, W, K, hd): the batch over the data axes where it
  divides, else the length W over them; the kv heads over 'model' where
  they divide, else the length over 'model' (each rank all K heads of
  its W/m slots), or, where the data axes split the length already,
  every kv head on every model rank.  ``pos`` is whole on every rank.
* ssm: the batch and the SSD heads; conv (B, d_conv-1, d_xbc): the
  batch and a contiguous 1/m of the [x | B | C] channels.

The prefill computes its attention as the whole-sequence paths do and
then lays its k / v out so: a rank's slots of the length split over the
data axes are a slice of what it computed; where every model rank holds
all K heads, the rank that owns each kv head (the first whose query
heads read it) places it in a zero (B, W, K, hd) and the ranks
reduce-scatter over 'model' along W (all-reduce where W stays whole).
Its conv state, the last d_conv-1 rows of the pre-conv [x | B | C],
is made whole by an all-gather of each rank's heads' x channels over
'model' (every rank holds B and C), and each rank keeps its contiguous
share of the channels.

A decode step gathers activations, never weights.  Each rank projects
its column shards of q, k and v; where it holds more kv heads than its
columns give, the new token's k / v columns are all-gathered over
'model', (B, 1, K·hd/m) each; where the length is split over 'model',
so are its queries, (B, 1, H/m, hd).  The rank owning slot pos % W
writes it (into a copy, as the unsharded step does), each rank runs the
decode-attention kernel's ``"partial"`` variant over its own slots and
the ranks that split the length merge their (m, l, acc) with the
kernel's combine arithmetic: an all-reduce of the max, then one of
(l, acc) rescaled, (B, H, hd + 2) floats in all; each rank keeps its
H/m heads for the row-parallel wo.  A CROSS layer's decode does the
same over xk / xv.

A Mamba2 block's decode step does the same.  Each rank projects with
its in_proj columns and the projection is all-gathered over 'model',
(B, 1, d_proj): the one place z, x, B, C and dt are whole.  Each rank
convolves its contiguous [x | B | C] channels with its conv_w / conv_b
and its conv-cache shard (the conv is depthwise: no channel mixes) and
the conv output is all-gathered, (B, 1, d_xbc).  Each rank then takes,
by global column, its heads' z, x and dt and all of B and C for its
heads' SSD step on its ssm shard; the gated RMSNorm and out_proj's rows
follow as in the whole-sequence paths.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ATTN, CROSS, MAMBA, ModelConfig
from repro_torch.metrics.cost import quiet
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import rope
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_shard,
                                       lm_logits_shard, rms_norm_headwise)
from repro_torch.models.moe import moe_ffn_sharded
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Sharded
from repro_torch.sharding.specs import (_axes, _axis_size, cache_pspecs,
                                        gather_tree, get_mesh, place,
                                        rank_devices)

MODEL = "model"


@dataclasses.dataclass
class RankCaches:
    """``prefill``'s caches over a mesh: one tree a rank (the unsharded
    cache's structure, each leaf the rank's part of it), the axes the
    batch is split over, and the whole stacked tree's ``cache_pspecs``,
    by which every leaf is held."""

    parts: list
    batch: Tuple[str, ...]
    specs: dict


# ---------------------------------------------------------------------------
# the shard-local pieces
# ---------------------------------------------------------------------------
def _m() -> int:
    return col.axis_size(MODEL)


def _j(r: int) -> int:
    return col.axis_rank(r, MODEL)


def _attn_layout(cfg: ModelConfig):
    """(the shard-local config, the GQA group size where the kv heads must
    be gathered, else None)."""
    a, m = cfg.attn, _m()
    H, K = a.n_heads, a.n_kv_heads
    if H % m:
        raise ValueError(f"{cfg.name}: {H} query heads do not divide over "
                         f"model={m}")
    hl = H // m
    if K % m == 0:
        kl, group = K // m, None
    else:
        group = H // K
        if group % hl:
            raise ValueError(f"{cfg.name}: a rank's {hl} query heads read "
                             f"more than one of {K} kv heads at model={m}")
        kl = 1
    local = dataclasses.replace(cfg, attn=dataclasses.replace(
        a, n_heads=hl, n_kv_heads=kl))
    return local, group


def _kv_head(r: int, cfg: ModelConfig, group: int) -> int:
    """The kv head rank r's query heads read where they share one."""
    return (_j(r) * (cfg.attn.n_heads // _m())) // group


def _rank_attn(ps, name: str, cfg: ModelConfig, group: Optional[int]):
    """Each rank's params of attention ``name``; where the kv heads do not
    divide over 'model', wk / wv are all-gathered and replaced by the
    columns of the kv head the rank reads (the whole-sequence paths'
    weight gather: forward, prefill and the loss)."""
    if group is None:
        return [p[name] for p in ps]
    hd = cfg.attn.head_dim
    wk = col.all_gather([p[name]["wk"] for p in ps], MODEL, dim=-1)
    wv = col.all_gather([p[name]["wv"] for p in ps], MODEL, dim=-1)
    out = []
    for r, p in enumerate(ps):
        c0 = _kv_head(r, cfg, group) * hd
        out.append({**p[name], "wk": wk[r][:, c0:c0 + hd].contiguous(),
                    "wv": wv[r][:, c0:c0 + hd].contiguous()})
    return out


def _mamba_dims(cfg: ModelConfig):
    """(d_inner, SSD heads, d_xbc) of ``cfg`` and their shares of a rank;
    raises where 'model' does not divide the heads or the columns of
    in_proj or conv_w (naming the leaf, as ``place`` does)."""
    s, m = cfg.ssm, _m()
    d_in, n_heads, d_xbc = ssm_mod.dims(cfg)
    if n_heads % m:
        raise ValueError(f"{cfg.name}: {n_heads} SSD heads do not divide "
                         f"over model={m}")
    for leaf, n in (("mamba/in_proj", 2 * d_in + 2 * s.d_state + n_heads),
                    ("mamba/conv_w", d_xbc)):
        if n % m:
            raise ValueError(f"{cfg.name} {leaf}: {n} columns do not divide "
                             f"over model={m}")
    return d_in, n_heads, d_xbc, d_in // m, n_heads // m, d_xbc // m


def _rank_mamba(ps, cfg: ModelConfig):
    """Each rank's Mamba2 params as a block of its own heads: in_proj's
    [z_j | x_j | B | C | dt_j] and conv's [x_j | B | C] columns from the
    all-gathered leaves, the per-head leaves as placed (the
    whole-sequence paths' weight gather)."""
    d_in, _, _, dl, hl, _ = _mamba_dims(cfg)
    N = cfg.ssm.d_state
    w = col.all_gather([p["mamba"]["in_proj"] for p in ps], MODEL, dim=1)
    cw = col.all_gather([p["mamba"]["conv_w"] for p in ps], MODEL, dim=1)
    cb = col.all_gather([p["mamba"]["conv_b"] for p in ps], MODEL, dim=0)
    def one(r, p, wr, cwr, cbr):
        j, dev = _j(r), wr.device
        z = torch.arange(j * dl, (j + 1) * dl, device=dev)
        bc = torch.arange(2 * N, device=dev)
        dt = torch.arange(j * hl, (j + 1) * hl, device=dev)
        cols = torch.cat([z, d_in + z, 2 * d_in + bc, 2 * d_in + 2 * N + dt])
        ccols = torch.cat([z, d_in + bc])
        return {**p["mamba"], "in_proj": wr[:, cols],
                "conv_w": cwr[:, ccols], "conv_b": cbr[ccols]}

    return col.rank_map(one, ps, w, cw, cb)


def _gate_out(mp, ys, cfg: ModelConfig) -> List[torch.Tensor]:
    """The ranks' out_proj addends of their heads' gated ``ys``: the
    gated RMSNorm's sum of squares over d_inner all-reduced."""
    d_in = ssm_mod.dims(cfg)[0]
    ss = col.all_reduce([torch.sum(torch.square(y), dim=-1, keepdim=True)
                         for y in ys], MODEL)
    return col.rank_map(lambda r, p, y, s: ssm_mod.gate_out(
        p, y, s / d_in, cfg), mp, ys, ss)


def _mamba(mp, x: Sharded, cfg: ModelConfig):
    """Each rank's Mamba2 block (``_rank_mamba``'s params) on ``x`` (whole
    sequences): (the ranks' out_proj addends, their (conv, ssm) states,
    the conv state in ``_rank_mamba``'s [x_j | B | C] channels)."""
    pre = col.rank_map(lambda r, p, xr: ssm_mod.mamba_scan(
        p, xr, cfg, ssd_impl=ssm_mod.ssd_kernel), mp, x.parts)
    return (_gate_out(mp, [y for y, _ in pre], cfg),
            [(conv, ssm.float()) for _, (conv, ssm) in pre])


def _lay_out_conv(convs, spec, cfg: ModelConfig):
    """Each rank's prefill conv state ``convs[r]`` (B, d_conv-1, its
    heads' x channels, then every B and C channel) in the layout of
    ``spec``: the x channels all-gathered over 'model' and the B and C
    ones every rank holds make the whole [x | B | C] state, of which each
    rank keeps its contiguous share (all of it where the channels stay
    whole)."""
    d_in, _, _, dl, _, cl = _mamba_dims(cfg)
    xs = col.all_gather([t[..., :dl] for t in convs], MODEL, dim=-1)
    split = MODEL in _axes(spec[-1])

    def keep(r, x, t):
        full = torch.cat([x, t[..., dl:]], dim=-1)
        return full[..., _j(r) * cl:(_j(r) + 1) * cl].contiguous() \
            if split else full

    return col.rank_map(keep, xs, convs)


def _mamba_decode(ps, x: Sharded, cfg: ModelConfig, cs):
    """One token's Mamba2 block over the placed column shards and each
    rank's conv / ssm cache (the unsharded ``mamba_decode_scan`` and gate
    over the layout in the module's docstring): the ranks' out_proj
    addends and their new caches.  Every slice of z, x, B, C and dt is
    taken from a gathered tensor by global column: a rank's in_proj
    columns may end inside z and start inside x, and a head's dt may lie
    on another rank than its x."""
    d_in, _, _, dl, hl, cl = _mamba_dims(cfg)
    N = cfg.ssm.d_state
    xn = _norm(ps, "norm1", x, cfg)
    u = col.all_gather(col.rank_map(lambda r, p, xr: xr @ p["mamba"][
        "in_proj"], ps, xn), MODEL, dim=-1)               # (B, 1, d_proj)

    def conv(r, p, ur, c):
        c0 = d_in + _j(r) * cl
        return ssm_mod._causal_conv(ur[..., c0:c0 + cl], p["mamba"]["conv_w"],
                                    p["mamba"]["conv_b"], c["conv"])

    convs = col.rank_map(conv, ps, u, cs)
    xbc = col.all_gather([o for o, _ in convs], MODEL, dim=-1)  # (B,1,d_xbc)

    def ssd(r, p, ur, xr, c):
        j, xr = _j(r), F.silu(xr)
        dt0 = 2 * d_in + 2 * N + j * hl
        return ssm_mod.decode_ssd(
            p["mamba"], ur[..., j * dl:(j + 1) * dl],
            xr[..., j * dl:(j + 1) * dl], xr[..., d_in:d_in + N],
            xr[..., d_in + N:], ur[..., dt0:dt0 + hl], cfg, c["ssm"])

    pre = col.rank_map(ssd, ps, u, xbc, cs)
    outs = _gate_out([p["mamba"] for p in ps], [y for y, _ in pre], cfg)
    return outs, [{"conv": cv, "ssm": h.float()}
                  for (_, cv), (_, h) in zip(convs, pre)]


def _zeros() -> List[torch.Tensor]:
    """A 0-d float32 zero on each rank (made in its own ``rank_map``
    slot, so a count holds each rank's on that rank)."""
    return col.rank_map(lambda r: torch.zeros(
        (), device=rank_devices(get_mesh())[r]))


def _whole_seq(h: Sharded) -> Sharded:
    """``h`` with each rank's sequences whole (its batch rows kept)."""
    return col.constrain(h, (h.spec[0],) + (None,) * (h.ndim - 1))


def _residual(x: Sharded, addends: List[torch.Tensor]) -> Sharded:
    """x + the all-reduce over 'model' of the ranks' addends."""
    return x + Sharded(col.all_reduce(addends, MODEL), x.spec)


def _norm(ps, name: str, x: Sharded, cfg: ModelConfig) -> List:
    return col.rank_map(lambda r, p, xr: apply_norm(p[name], xr, cfg),
                        ps, x.parts)


def _ffn(ps, x: Sharded, cfg: ModelConfig, i: int):
    """(the FFN's output, reduced, or None; each rank's aux or None)."""
    kind = tf._ffn_kind(cfg, i)
    if kind is None:
        return None, None
    xn = Sharded(_norm(ps, "norm2", x, cfg), x.spec)
    if kind == "moe":
        return moe_ffn_sharded(xn, [p["moe"] for p in ps], cfg)
    out = col.rank_map(lambda r, p, xr: apply_mlp(p["mlp"], xr, cfg),
                       ps, xn.parts)
    return Sharded(out, x.spec, partial=MODEL), None


# ---------------------------------------------------------------------------
# periods and stacks
# ---------------------------------------------------------------------------
def _period_full(pps, h: Sharded, cfg: ModelConfig, memory, mode: str,
                 cache_len: int = 0, specs=None):
    """One period over every rank (the unsharded ``_apply_period_full``).
    Returns (h, each rank's aux, each rank's caches, laid out by
    ``specs``, the whole cache's ``cache_pspecs``)."""
    lcfg, group = (_attn_layout(cfg) if cfg.attn is not None
                   else (cfg, None))
    aux = _zeros()
    caches = [{} for _ in pps]
    for i, kind in enumerate(cfg.period):
        ps = [pp[f"b{i}"] for pp in pps]
        x = _whole_seq(h)
        cs = [{} for _ in ps]
        if kind in (ATTN, CROSS):
            causal = cfg.attn.causal if kind == ATTN else True
            att = _rank_attn(ps, "attn", cfg, group)
            res = col.rank_map(lambda r, p, a, xr: tf._self_attn_full(
                {**p, "attn": a}, xr, lcfg, causal=causal), ps, att, x.parts)
            x = _residual(x, [o for o, _ in res])
            if mode == "prefill":
                built = col.rank_map(lambda r, kv: tf._build_kv_cache(
                    kv[0], kv[1], lcfg, cache_len), [kv for _, kv in res])
                for name in ("k", "v"):
                    laid = _lay_out([b[name] for b in built],
                                    specs[f"b{i}"][name], cfg, group)
                    for b, t in zip(built, laid):
                        b[name] = t
                for c, b in zip(cs, built):
                    c.update(b)
        if kind == CROSS:
            mem = col.constrain(memory, (x.spec[0], None, None))
            xatt = _rank_attn(ps, "cross_attn", cfg, group)
            res = col.rank_map(lambda r, p, a, xr, mr: tf._cross_attn(
                {**p, "cross_attn": a}, xr, lcfg, memory=mr), ps, xatt,
                x.parts, mem.parts)
            x = _residual(x, [o for o, _ in res])
            if mode == "prefill":
                for n, name in enumerate(("xk", "xv")):
                    laid = _lay_out([kv[n] for _, kv in res],
                                    specs[f"b{i}"][name], cfg, group)
                    for c, t in zip(cs, laid):
                        c[name] = t
        elif kind == MAMBA:
            xn = Sharded(_norm(ps, "norm1", x, cfg), x.spec)
            outs, states = _mamba(_rank_mamba(ps, cfg), xn, cfg)
            x = _residual(x, outs)
            if mode == "prefill":
                laid = _lay_out_conv([conv for conv, _ in states],
                                     specs[f"b{i}"]["conv"], cfg)
                for c, conv, (_, ssm) in zip(cs, laid, states):
                    c["conv"], c["ssm"] = conv, ssm
        delta, a = _ffn(ps, x, cfg, i)
        h = col.constrain_tokens(x)
        if delta is not None:
            h = h + col.constrain_tokens(delta)
        if a is not None:
            aux = [t + ai for t, ai in zip(aux, a)]
        if mode == "prefill":
            for c, ci in zip(caches, cs):
                c[f"b{i}"] = ci
    return h, aux, caches


def _period_decode(pps, h: Sharded, cfg: ModelConfig, caches, pos: int,
                   specs):
    """One period, one token, over every rank; ``specs``: the cache's
    ``cache_pspecs``.  Returns (h, each rank's new cache)."""
    group = _attn_layout(cfg)[1] if cfg.attn is not None else None
    new = [{} for _ in pps]
    for i, kind in enumerate(cfg.period):
        ps = [pp[f"b{i}"] for pp in pps]
        cs = [c[f"b{i}"] for c in caches]
        sp = specs[f"b{i}"]
        x = _whole_seq(h)
        if kind in (ATTN, CROSS):
            outs, ncs = _self_decode(ps, x, cfg, cs, pos, _kv(sp["k"]), group)
            x = _residual(x, outs)
        if kind == CROSS:
            # the memory's k / v are cached: wk / wv are not read
            x = _residual(x, _cross_decode(ps, x, cfg, cs, _kv(sp["xk"]),
                                           group))
            for nc, c in zip(ncs, cs):
                nc["xk"], nc["xv"] = c["xk"], c["xv"]
        elif kind == MAMBA:
            outs, ncs = _mamba_decode(ps, x, cfg, cs)
            x = _residual(x, outs)
        delta, _ = _ffn(ps, x, cfg, i)
        h = col.constrain_tokens(x)
        if delta is not None:
            h = h + col.constrain_tokens(delta)
        for n, nc in zip(new, ncs):
            n[f"b{i}"] = nc
    return h, new


# ---------------------------------------------------------------------------
# the attention caches' layout, and a decode step over it
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _KV:
    """How the ranks hold one attention cache leaf (B, W, K, hd), read off
    its ``cache_pspecs`` entry: the mesh axes its length W is split over
    (() whole), and whether its kv heads are split over 'model' (else
    every rank holds all K)."""

    length: Tuple[str, ...]
    heads: bool


def _kv(spec) -> _KV:
    """The layout of a stacked leaf's spec, (Pd, B, W, K, hd)."""
    mesh = get_mesh()
    axes = [tuple(a for a in _axes(e) if a in mesh.axis_names)
            for e in spec]
    return _KV(axes[2], MODEL in axes[3] or _m() == 1)


def _first_slot(r: int, held: int, lay: _KV) -> int:
    """The first of the whole cache's slots rank r holds ``held`` of."""
    return col.axis_rank(r, lay.length) * held


def _lay_out(ts, spec, cfg: ModelConfig, group: Optional[int]):
    """Each rank's prefill cache leaf ``ts[r]`` (its batch rows, the whole
    length, the kv heads its attention computed: its K/m, or the one its
    query heads read) in the layout of ``spec``.  A length split over
    the data axes is a slice of what every rank holds; where every model
    rank holds all K heads, each head's owner (the first rank whose
    query heads read it) places it in zeros and the model ranks
    reduce-scatter along the length (all-reduce where it stays whole),
    exact since every element has one nonzero addend."""
    lay = _kv(spec)
    if lay.length and MODEL not in lay.length:
        n = _axis_size(get_mesh(), lay.length)
        ts = col.rank_map(lambda r, t: t.narrow(
            1, _first_slot(r, t.shape[1] // n, lay),
            t.shape[1] // n).contiguous(), ts)
    if lay.heads:
        return ts
    K, hl = cfg.attn.n_kv_heads, cfg.attn.n_heads // _m()

    def place_head(r, t):
        full = t.new_zeros(t.shape[:2] + (K,) + t.shape[3:])
        if _j(r) * hl % group == 0:
            full[:, :, _kv_head(r, cfg, group)] = t[:, :, 0]
        return full

    full = col.rank_map(place_head, ts)
    if MODEL in lay.length:
        return col.reduce_scatter(full, MODEL, dim=1)
    return col.all_reduce(full, MODEL)


def _merge(parts, axes, dtype) -> List[torch.Tensor]:
    """The decode-attention kernel's combine across the ranks that split
    a cache's length: M = the max of their m, then one all-reduce of
    (l, acc) x e^(m - M); each rank's output acc / max(L, 1e-30), (B, 1,
    H, hd) in ``dtype``.  A rank whose slots are all empty (m = -1e30)
    weighs 0 beside one that holds a valid slot."""
    M = col.all_reduce([m for m, _, _ in parts], axes, op="max")

    def scaled(r, part, mr):
        m, l, acc = part
        w = torch.exp(m - mr)[..., None]
        return torch.cat([l[..., None] * w, acc * w], dim=-1)

    la = col.all_reduce(col.rank_map(scaled, parts, M), axes)
    return col.rank_map(lambda r, t: (t[..., 1:] / t[..., :1].clamp_min(
        1e-30)).to(dtype)[:, None], la)


def _attend(qs, ks, vs, poss, lay: _KV, cfg: ModelConfig,
            group: Optional[int]) -> List[torch.Tensor]:
    """Each rank's one-token attention output for its H/m query heads,
    (B, 1, H/m, hd): ``qs`` its queries, ``ks`` / ``vs`` its cache as it
    holds it, ``poss`` its slots' positions (masks folded in).  Where
    the length is split over 'model' the queries are all-gathered over
    it; where a rank holds every kv head and only its own queries, those
    read the one kv head ``_kv_head`` names.  A length split runs the
    kernel's ``"partial"`` variant on each rank's slots and merges the
    ranks' states (``_merge``)."""
    hl = cfg.attn.n_heads // _m()
    over_model = MODEL in lay.length
    if over_model:
        qs = col.all_gather(qs, MODEL, dim=2)
    elif not lay.heads:
        ks = [k.narrow(2, _kv_head(r, cfg, group), 1)
              for r, k in enumerate(ks)]
        vs = [v.narrow(2, _kv_head(r, cfg, group), 1)
              for r, v in enumerate(vs)]
    if not lay.length:
        return col.rank_map(lambda r, q, k, v, p: attn_mod.decode_attention(
            q, k, v, p), qs, ks, vs, poss)
    parts = col.rank_map(lambda r, q, k, v, p: attn_mod.
                         decode_attention_partial(q, k, v, p),
                         qs, ks, vs, poss)
    outs = _merge(parts, lay.length, qs[0].dtype)
    if over_model:
        outs = col.rank_map(lambda r, o: o[:, :, _j(r) * hl:(_j(r) + 1)
                                           * hl], outs)
    return outs


def _self_decode(ps, x: Sharded, cfg: ModelConfig, cs, pos: int, lay: _KV,
                 group: Optional[int]):
    """One token's self-attention over each rank's ring cache (the
    unsharded ``_self_attn_decode`` over the layout ``lay``): the ranks'
    wo addends and their new caches, each a copy with slot pos % W
    written by the rank that holds it and ``pos`` (whole on every rank)
    updated.  Where a rank holds more kv heads than its columns of wk /
    wv give, the new token's k / v columns are all-gathered over
    'model'."""
    a = cfg.attn
    hd, hl = a.head_dim, a.n_heads // _m()

    def at(t):
        return torch.full((1,), pos, dtype=torch.int32, device=t.device)

    def project(r, p, xr):
        xn = apply_norm(p["norm1"], xr, cfg)
        w = p["attn"]
        q = (xn @ w["wq"]).reshape(xr.shape[0], 1, hl, hd)
        if a.qk_norm:
            q = rms_norm_headwise(q, w["q_scale"])
        return rope(q, at(xr), a.rope_theta), xn @ w["wk"], xn @ w["wv"]

    qkv = col.rank_map(project, ps, x.parts)
    kc, vc = [t[1] for t in qkv], [t[2] for t in qkv]
    if not lay.heads:
        kc = col.all_gather(kc, MODEL, dim=-1)
        vc = col.all_gather(vc, MODEL, dim=-1)

    def write(r, p, c, kr, vr):
        B = kr.shape[0]
        k = kr.reshape(B, 1, -1, hd)
        if a.qk_norm:
            k = rms_norm_headwise(k, p["attn"]["k_scale"])
        k = rope(k, at(kr), a.rope_theta)
        ck, cv, cpos = (c[n].clone() for n in ("k", "v", "pos"))
        held = ck.shape[1]
        lo, slot = _first_slot(r, held, lay), pos % cpos.shape[0]
        cpos[slot] = pos
        if lo <= slot < lo + held:
            ck[:, slot - lo] = k[:, 0]
            cv[:, slot - lo] = vr.reshape(B, -1, hd)
        return {"k": ck, "v": cv, "pos": cpos}

    new = col.rank_map(write, ps, cs, kc, vc)

    def slots(r, c):
        lo, held = _first_slot(r, c["k"].shape[1], lay), c["k"].shape[1]
        return attn_mod.fold_positions(c["pos"][lo:lo + held], pos,
                                       a.window)

    outs = _attend([t[0] for t in qkv], [c["k"] for c in new],
                   [c["v"] for c in new], col.rank_map(slots, new), lay, cfg,
                   group)
    return col.rank_map(lambda r, p, o: tf._attn_out(p["attn"], o, cfg),
                        ps, outs), new


def _cross_decode(ps, x: Sharded, cfg: ModelConfig, cs, lay: _KV,
                  group: Optional[int]) -> List[torch.Tensor]:
    """One token's cross-attention over each rank's part of the memory's
    cached k / v (the unsharded ``_cross_attn`` with ``mem_kv``: slot
    positions arange(Skv), every one valid): the ranks' wo addends."""
    a = cfg.attn
    hd, hl = a.head_dim, a.n_heads // _m()
    qs = col.rank_map(lambda r, p, xr: (apply_norm(p["norm_x"], xr, cfg)
                                        @ p["cross_attn"]["wq"]).reshape(
        xr.shape[0], 1, hl, hd), ps, x.parts)

    def slots(r, c):
        held = c["xk"].shape[1]
        lo = _first_slot(r, held, lay)
        return torch.arange(lo, lo + held, dtype=torch.int32,
                            device=c["xk"].device)

    outs = _attend(qs, [c["xk"] for c in cs], [c["xv"] for c in cs],
                   col.rank_map(slots, cs), lay, cfg, group)
    return col.rank_map(lambda r, p, o: tf._attn_out(p["cross_attn"], o,
                                                     cfg), ps, outs)


def _stack_full(blocks, h: Sharded, cfg: ModelConfig, memory, mode: str,
                cache_len: int = 0, remat: bool = False, specs=None):
    """The loop over periods; with ``remat`` each period (its
    collectives included) is checkpointed and recomputed in the
    backward, whole: stopping early would skip the last rank's final
    products alone (the ranks run one after another), and the ranks
    would no longer do the same work."""
    aux = _zeros()
    caches = []
    for i in range(tf._n_stacked(blocks[0])):
        args = ([tf._take(b, i) for b in blocks], h, cfg, memory, mode,
                cache_len, specs)
        if remat:
            with set_checkpoint_early_stop(False):
                h, aux_i, c = checkpoint(_period_full, *args,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            h, aux_i, c = _period_full(*args)
        aux = [a + b for a, b in zip(aux, aux_i)]
        caches.append(c)
    per_rank = [tf._stack([c[r] for c in caches]) for r in range(len(blocks))]
    return h, aux, per_rank


def _stack_decode(blocks, h: Sharded, cfg: ModelConfig, cache: RankCaches,
                  pos: int):
    caches = []
    for i in range(tf._n_stacked(blocks[0])):
        h, nc = _period_decode([tf._take(b, i) for b in blocks], h, cfg,
                               [tf._take(c, i) for c in cache.parts], pos,
                               cache.specs)
        caches.append(nc)
    return h, RankCaches([tf._stack([c[r] for c in caches])
                          for r in range(len(blocks))], cache.batch,
                         cache.specs)


# ---------------------------------------------------------------------------
# embedding, head and loss
# ---------------------------------------------------------------------------
def _embed(params, tokens) -> Sharded:
    """The vocab-parallel lookup of whole sequences (a rank's addend must
    cover the same tokens as the other model ranks'), then
    ``constrain_tokens``."""
    tok = col.constrain(tokens, (col.token_spec(tokens.shape)[0], None))
    rows = params[0]["embed"]["table"].shape[0]
    parts = col.rank_map(lambda r, p, t: embed_shard(p["embed"], t,
                                                     _j(r) * rows),
                         params, tok.parts)
    return col.constrain_tokens(Sharded(parts, tok.spec + ((),),
                                        partial=MODEL))


def _vocab_cols(params) -> int:
    p = params[0]
    return (p["lm_head"]["w"].shape[1] if "lm_head" in p
            else p["embed"]["table"].shape[0])


def _logits(params, h: Sharded, cfg: ModelConfig) -> Sharded:
    """Each rank's vocab columns of the logits of ``h`` (whole
    sequences): (batch, None, 'model') as the reference constrains them."""
    cols = _vocab_cols(params)
    parts = col.rank_map(lambda r, p, hr: lm_logits_shard(
        p.get("lm_head", {}), p["embed"], hr, cfg, _j(r) * cols),
        params, h.parts)
    return Sharded(parts, (h.spec[0], (), (MODEL,) if _m() > 1 else ()))


def _token_losses(logits: Sharded, targets: List[torch.Tensor]):
    """Each rank's logz - gold (B_loc, S) from vocab-split logits."""
    cols = logits.parts[0].shape[-1]
    mx = col.all_reduce([lg.detach().amax(-1) for lg in logits.parts],
                        MODEL, op="max")
    se = col.all_reduce([torch.exp(lg - m[..., None]).sum(-1)
                         for lg, m in zip(logits.parts, mx)], MODEL)

    def gold(r, lg, t):
        local = t.long() - _j(r) * cols
        ok = (local >= 0) & (local < cols)
        g = torch.gather(lg, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros_like(g))

    gd = col.all_reduce(col.rank_map(gold, logits.parts, targets), MODEL)
    return [m + torch.log(s) - g for m, s, g in zip(mx, se, gd)]


def _batch_sum(parts, bspec) -> List[torch.Tensor]:
    """Sum each rank's per-token values over its rows and over the data
    ranks that split the batch (a replicated batch is summed once)."""
    sums = [p.sum() for p in parts]
    return col.all_reduce(sums, bspec) if bspec else sums


def _rows(x, bspec):
    """A whole (B, ...) input split over the batch like the tokens."""
    return col.constrain(x, (bspec,) + (None,) * (x.ndim - 1)).parts


# ---------------------------------------------------------------------------
# public API (through transformer's)
# ---------------------------------------------------------------------------
def encode(params, frames, cfg: ModelConfig) -> Sharded:
    enc_cfg = tf._encoder_cfg(cfg)
    h = col.constrain_tokens(frames.to(cfg.torch_dtype))
    h, _, _ = _stack_full([p["encoder"]["blocks"] for p in params], h,
                          enc_cfg, memory=None, mode="train")
    return Sharded(col.rank_map(lambda r, p, hr: apply_norm(
        p["encoder"]["final_norm"], hr, cfg), params, h.parts), h.spec)


def _memory_from_batch(params, batch, cfg: ModelConfig):
    if cfg.encoder is not None:
        return encode(params, batch["frames"], cfg)
    if cfg.vision_stub:
        return col.replicate(batch["image_embeds"].to(cfg.torch_dtype))
    return None


def _hidden_for_loss(params, batch, cfg: ModelConfig, remat: bool):
    memory = _memory_from_batch(params, batch, cfg)
    h = _embed(params, batch["tokens"])
    h, aux, _ = _stack_full([p["blocks"] for p in params], h, cfg, memory,
                            mode="train", remat=remat)
    h = _whole_seq(h)
    return Sharded(_norm(params, "final_norm", h, cfg), h.spec), aux


def forward(params, batch, cfg: ModelConfig, remat: bool = False):
    h, aux = _hidden_for_loss(params, batch, cfg, remat)
    return _logits(params, h, cfg), aux[0]


def train_loss(params, batch, cfg: ModelConfig, remat: bool = True,
               loss_chunk: int = 0):
    """The loss of every rank's tokens, exact over the vocab shards and
    averaged over the whole batch; rank 0's copy is returned (it depends
    on every rank's work through the collectives, so its backward
    reaches every rank's parameters)."""
    mask = batch.get("mask")
    if loss_chunk > 0 and mask is not None:
        raise ValueError("the chunked loss averages over every token; it "
                         "takes no mask")
    h, aux = _hidden_for_loss(params, batch, cfg, remat)
    bspec = h.spec[0]
    B, S, _ = h.shape
    targets = _rows(batch["targets"], bspec)
    if loss_chunk <= 0:
        losses = _token_losses(_logits(params, h, cfg), targets)
        if mask is None:
            xent = [t / (B * S) for t in _batch_sum(losses, bspec)]
        else:
            masks = [mk.float() for mk in _rows(mask, bspec)]
            num = _batch_sum([lo * mk for lo, mk in zip(losses, masks)],
                             bspec)
            den = _batch_sum(masks, bspec)
            xent = [n / torch.clamp(d, min=1.0) for n, d in zip(num, den)]
    else:
        if S % loss_chunk:
            raise ValueError(f"sequence {S} is not a multiple of loss_chunk "
                             f"{loss_chunk}")

        def chunk_loss(c0, hs, ts):
            hb = Sharded([t[:, c0:c0 + loss_chunk] for t in hs], h.spec)
            losses = _token_losses(_logits(params, hb, cfg),
                                   [t[:, c0:c0 + loss_chunk] for t in ts])
            return tuple(_batch_sum(losses, bspec))

        total = _zeros()
        for c0 in range(0, S, loss_chunk):
            part = checkpoint(chunk_loss, c0, h.parts, targets,
                              use_reentrant=False, preserve_rng_state=False)
            total = [t + c for t, c in zip(total, part)]
        xent = [t / (B * S) for t in total]
    total = col.rank_map(lambda r, x, a: x + a, xent, aux)
    return total[0], {"xent": xent[0], "aux": aux[0]}


def prefill(params, batch, cfg: ModelConfig, cache_len: Optional[int] = None):
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if cache_len is None:
        cache_len = S if cfg.attn is None or cfg.attn.window is None \
            else min(S, cfg.attn.window)
    memory = _memory_from_batch(params, batch, cfg)
    specs = _cache_specs(cfg, tokens.shape[0], cache_len,
                         memory.shape[1] if memory is not None else 0)
    h = _embed(params, tokens)
    h, _, caches = _stack_full([p["blocks"] for p in params], h, cfg,
                               memory, mode="prefill", cache_len=cache_len,
                               specs=specs)
    h = _whole_seq(h)
    last = Sharded(col.rank_map(lambda r, p, hr: apply_norm(
        p["final_norm"], hr[:, -1:], cfg), params, h.parts), h.spec)
    logits = _logits(params, last, cfg)
    return _first_position(logits), RankCaches(caches, h.spec[0], specs)


def _cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                 memory_len: int):
    """``cache_pspecs`` of the whole cache ``prefill`` builds: its rings
    hold ``cache_len`` slots (``cache_struct``'s tree with no window to
    cap them, on ``meta``: a count holds none of it as allocated)."""
    if cfg.attn is not None:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=None))
    with quiet():
        struct = tf.cache_struct(cfg, batch, cache_len, memory_len)
    return cache_pspecs(struct, get_mesh())


def _first_position(logits: Sharded) -> Sharded:
    return Sharded([t[:, 0] for t in logits.parts],
                   (logits.spec[0], logits.spec[2]))


def decode_step(params, cache: RankCaches, tokens, pos, cfg: ModelConfig):
    pos = int(pos)
    h = _embed(params, tokens)
    h, cache = _stack_decode([p["blocks"] for p in params], h, cfg, cache,
                             pos)
    h = _whole_seq(h)
    h = Sharded(_norm(params, "final_norm", h, cfg), h.spec)
    return _first_position(_logits(params, h, cfg)), cache


# ---------------------------------------------------------------------------
# the unsharded cache from the ranks', and the ranks' from a whole one
# ---------------------------------------------------------------------------
def shard_cache(cache, cfg: ModelConfig) -> RankCaches:
    """Each rank's cache from the unsharded tree ``cache``, on its device,
    in a storage of its own, every leaf split as ``cache_pspecs`` says
    (``sharding.place``).  ``gather_cache``'s inverse."""
    mesh = get_mesh()
    specs = cache_pspecs(cache, mesh)
    some = next(t for b in cache.values() for n, t in b.items()
                if n != "pos")
    bspec = tuple(col.token_spec((some.shape[1], 1, 1))[0] or ())
    placed = place(cache, specs, mesh)
    parts = col.rank_map(lambda r: {b: {n: t.clone() for n, t in
                                        leaves.items()}
                                    for b, leaves in placed[r].items()})
    return RankCaches(parts, bspec, specs)


def gather_cache(cache: RankCaches, cfg: ModelConfig):
    """The unsharded cache tree from each rank's (on rank 0's device), by
    the spec of each leaf (``sharding.gather_tree``: the split dims
    concatenated in rank order, a replicated part taken from the first
    rank that holds it)."""
    return gather_tree(cache.parts, cache.specs, get_mesh())
