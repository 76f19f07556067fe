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
  part of a kv head: wk / wv are all-gathered over 'model' and each rank
  takes the one kv head its query heads read (q head h reads h // (H/K)).
  Its caches hold that head.
* Dense MLP: w_gate / w_in column-parallel, w_out row-parallel.
* MoE: ``moe.moe_ffn_sharded`` (tensor or expert mode).
* Mamba2: in_proj's columns are [z | x | B | C | dt] and conv's are
  [x | B | C], split contiguously by the rule, which does not align with
  heads.  Both are all-gathered and each rank takes the columns of its
  heads (z, x and dt) and the shared B and C; the SSD scan, A_log, D,
  dt_bias, gate_norm and out_proj's rows are the rank's heads' own.  The
  gated RMSNorm's mean over all of d_inner is an all-reduce of the sum
  of squares.  A rank's conv state is its [x_j | B | C] channels.
* Embedding and head: vocab-parallel.  The lookup zeroes ids outside a
  rank's rows and the ranks all-reduce; logits stay split over vocab
  (``constrain(logits, (batch, None, "model"))``), and the loss is exact
  over the shards: the max and the sum of exponentials all-reduced, the
  gold logit from the rank that holds it.

Prefill returns each rank's caches (``RankCaches``); ``gather_cache``
rebuilds the unsharded cache from them, and ``shard_cache`` is its
inverse, each rank's cache from a whole one (what a decode step over a
mesh takes).  The layout is the port's own: the batch over the data
axes where it divides, else whole; kv heads over 'model', or the one
gathered head a rank reads where 'model' does not divide them; SSD
heads and the conv state's x channels over 'model', B and C's channels
on every rank.  The reference's ``cache_pspecs`` instead split the
cache length over 'model' (kv heads that do not divide) or over the
data axes (batch 1); ``launch/dryrun.py`` records both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ATTN, CROSS, MAMBA, ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_shard,
                                       lm_logits_shard)
from repro_torch.models.moe import moe_ffn_sharded
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Sharded
from repro_torch.sharding.specs import _axis_size, get_mesh, rank_devices

MODEL = "model"


@dataclasses.dataclass
class RankCaches:
    """``prefill``'s caches over a mesh: one tree a rank (the unsharded
    cache's structure, holding the rank's batch rows, kv heads, SSD
    heads and conv channels) and the axes the batch is split over."""

    parts: list
    batch: Tuple[str, ...]


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
    columns of the kv head the rank reads."""
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


def _rank_mamba(ps, cfg: ModelConfig):
    """Each rank's Mamba2 params as a block of its own heads: in_proj's
    [z_j | x_j | B | C | dt_j] and conv's [x_j | B | C] columns from the
    all-gathered leaves, the per-head leaves as placed."""
    s, m = cfg.ssm, _m()
    d_in, n_heads, _ = ssm_mod.dims(cfg)
    if n_heads % m:
        raise ValueError(f"{cfg.name}: {n_heads} SSD heads do not divide "
                         f"over model={m}")
    dl, hl, N = d_in // m, n_heads // m, s.d_state
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


def _mamba(mp, x: Sharded, cfg: ModelConfig, states=None, decode=False):
    """Each rank's Mamba2 block on ``x`` (whole sequences): (the ranks'
    out_proj addends, their (conv, ssm) states)."""
    d_in = ssm_mod.dims(cfg)[0]
    if decode:
        pre = col.rank_map(lambda r, p, xr, st: ssm_mod.mamba_decode_scan(
            p, xr, cfg, st[0], st[1]), mp, x.parts, states)
    else:
        pre = col.rank_map(lambda r, p, xr: ssm_mod.mamba_scan(
            p, xr, cfg, ssd_impl=ssm_mod.ssd_kernel), mp, x.parts)
    ys = [y for y, _ in pre]
    ss = col.all_reduce([torch.sum(torch.square(y), dim=-1, keepdim=True)
                         for y in ys], MODEL)
    outs = col.rank_map(lambda r, p, y, s: ssm_mod.gate_out(
        p, y, s / d_in, cfg), mp, ys, ss)
    return outs, [(conv, ssm.float()) for _, (conv, ssm) in pre]


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
                 cache_len: int = 0):
    """One period over every rank (the unsharded ``_apply_period_full``).
    Returns (h, each rank's aux, each rank's caches)."""
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
                for c, (_, (xk, xv)) in zip(cs, res):
                    c["xk"], c["xv"] = xk, xv
        elif kind == MAMBA:
            xn = Sharded(_norm(ps, "norm1", x, cfg), x.spec)
            outs, states = _mamba(_rank_mamba(ps, cfg), xn, cfg)
            x = _residual(x, outs)
            if mode == "prefill":
                for c, (conv, ssm) in zip(cs, states):
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


def _period_decode(pps, h: Sharded, cfg: ModelConfig, caches, pos: int):
    """One period, one token, over every rank.  Returns (h, each rank's
    new cache)."""
    lcfg, group = (_attn_layout(cfg) if cfg.attn is not None
                   else (cfg, None))
    new = [{} for _ in pps]
    for i, kind in enumerate(cfg.period):
        ps = [pp[f"b{i}"] for pp in pps]
        cs = [c[f"b{i}"] for c in caches]
        x = _whole_seq(h)
        if kind in (ATTN, CROSS):
            att = _rank_attn(ps, "attn", cfg, group)
            res = col.rank_map(lambda r, p, a, xr, c: tf._self_attn_decode(
                {**p, "attn": a}, xr, lcfg, c, pos), ps, att, x.parts, cs)
            x = _residual(x, [o for o, _ in res])
            ncs = [nc for _, nc in res]
        if kind == CROSS:
            # the memory's k / v are cached: wk / wv are not read
            xatt = [p["cross_attn"] for p in ps]
            res = col.rank_map(lambda r, p, a, xr, c: tf._cross_attn(
                {**p, "cross_attn": a}, xr, lcfg, mem_kv=(c["xk"], c["xv"])),
                ps, xatt, x.parts, cs)
            x = _residual(x, [o for o, _ in res])
            for nc, c in zip(ncs, cs):
                nc["xk"], nc["xv"] = c["xk"], c["xv"]
        elif kind == MAMBA:
            xn = Sharded(_norm(ps, "norm1", x, cfg), x.spec)
            outs, states = _mamba(_rank_mamba(ps, cfg), xn, cfg,
                                  [(c["conv"], c["ssm"]) for c in cs],
                                  decode=True)
            x = _residual(x, outs)
            ncs = [{"conv": conv, "ssm": ssm} for conv, ssm in states]
        delta, _ = _ffn(ps, x, cfg, i)
        h = col.constrain_tokens(x)
        if delta is not None:
            h = h + col.constrain_tokens(delta)
        for n, nc in zip(new, ncs):
            n[f"b{i}"] = nc
    return h, new


def _stack_full(blocks, h: Sharded, cfg: ModelConfig, memory, mode: str,
                cache_len: int = 0, remat: bool = False):
    """The loop over periods; with ``remat`` each period (its
    collectives included) is checkpointed and recomputed in the
    backward, whole: stopping early would skip the last rank's final
    products alone (the ranks run one after another), and the ranks
    would no longer do the same work."""
    aux = _zeros()
    caches = []
    for i in range(tf._n_stacked(blocks[0])):
        args = ([tf._take(b, i) for b in blocks], h, cfg, memory, mode,
                cache_len)
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
                               [tf._take(c, i) for c in cache.parts], pos)
        caches.append(nc)
    return h, RankCaches([tf._stack([c[r] for c in caches])
                          for r in range(len(blocks))], cache.batch)


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
    h = _embed(params, tokens)
    h, _, caches = _stack_full([p["blocks"] for p in params], h, cfg,
                               memory, mode="prefill", cache_len=cache_len)
    h = _whole_seq(h)
    last = Sharded(col.rank_map(lambda r, p, hr: apply_norm(
        p["final_norm"], hr[:, -1:], cfg), params, h.parts), h.spec)
    logits = _logits(params, last, cfg)
    return _first_position(logits), RankCaches(caches, h.spec[0])


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
    """Each rank's cache from the unsharded tree ``cache`` (its batch rows
    where the batch divides over the data axes, as ``decode_step``'s
    tokens split; its kv heads, SSD heads and conv channels), on its
    device: ``gather_cache``'s inverse."""
    mesh = get_mesh()
    m = _m()
    group = _attn_layout(cfg)[1] if cfg.attn is not None else None
    d_in = ssm_mod.dims(cfg)[0] if cfg.ssm is not None else 0
    some = next(t for b in cache.values() for n, t in b.items()
                if n != "pos")
    bspec = col.token_spec((some.shape[1], 1, 1))[0] or ()

    def one(r, name, t):
        if name == "pos":
            return t.clone()
        if bspec:
            rows = t.shape[1] // _axis_size(mesh, bspec)
            t = t.narrow(1, col.axis_rank(r, bspec) * rows, rows)
        j = _j(r)
        if name in ("k", "v", "xk", "xv"):
            if group is None:
                kl = t.shape[3] // m
                return t.narrow(3, j * kl, kl).contiguous()
            return t.narrow(3, _kv_head(r, cfg, group), 1).contiguous()
        if name == "ssm":
            hl = t.shape[2] // m
            return t.narrow(2, j * hl, hl).contiguous()
        if name == "conv":
            dl = d_in // m
            return torch.cat([t[..., j * dl:(j + 1) * dl], t[..., d_in:]],
                             dim=-1)
        return t.contiguous()

    parts = col.rank_map(lambda r: {b: {n: one(r, n, t).to(
        rank_devices(mesh)[r]) for n, t in leaves.items()}
        for b, leaves in cache.items()})
    return RankCaches(parts, tuple(bspec))


def gather_cache(cache: RankCaches, cfg: ModelConfig):
    """The unsharded cache tree from each rank's (on rank 0's device):
    batch rows concatenated over the data ranks; kv heads, SSD heads and
    the conv state's x channels over the model ranks (a kv head shared
    by several ranks taken from the first); B and C's conv channels from
    model rank 0."""
    mesh = get_mesh()
    dev = rank_devices(mesh)[0]
    m = _m()
    group = _attn_layout(cfg)[1] if cfg.attn is not None else None
    d_in = ssm_mod.dims(cfg)[0] if cfg.ssm is not None else 0
    batch_groups = {}
    for r in range(mesh.size):
        batch_groups.setdefault(col.axis_rank(r, cache.batch), []).append(r)
    rows = [g for _, g in sorted(batch_groups.items())] \
        if cache.batch else [list(range(mesh.size))]

    def over_model(ranks, name, leaf):
        by_j = {}
        for r in ranks:
            by_j.setdefault(_j(r), leaf(r).to(dev))
        parts = [by_j[j] for j in range(m)]
        if name in ("k", "v", "xk", "xv"):
            if group is None:
                return torch.cat(parts, dim=3)
            K = cfg.attn.n_kv_heads
            owner = {}
            for r in ranks:
                owner.setdefault(_kv_head(r, cfg, group), _j(r))
            return torch.cat([by_j[owner[k]] for k in range(K)], dim=3)
        if name == "ssm":
            return torch.cat(parts, dim=2)
        if name == "conv":
            dl = d_in // m
            return torch.cat([p[..., :dl] for p in parts]
                             + [parts[0][..., dl:]], dim=-1)
        return parts[0]                                    # pos

    out = {}
    for b, leaves in cache.parts[0].items():
        out[b] = {}
        for name in leaves:
            blocks = [over_model(g, name,
                                 lambda r: cache.parts[r][b][name])
                      for g in rows]
            out[b][name] = blocks[0] if name == "pos" \
                else torch.cat(blocks, dim=1)
    return out
