"""Model assembly for the zoo's serving path (port of
``repro.models.transformer``): period blocks, stacks over periods, and
the LM API.

Every architecture is a repeating ``period`` of blocks (see
``configs.base``).  Parameters and KV caches are stacked over
``n_periods`` on a leading axis, in the reference's tree
(``blocks/b0/...``), and the reference's ``lax.scan`` over periods is a
loop over that axis.  Attention runs on the port's flash-attention
kernel (causal prefill, the encoder, cross-attention prefill) and its
decode-attention kernel (the ring cache, cross-attention decode over the
memory), MoE FFNs on its ``moe_gmm`` kernel, MAMBA blocks' prefill on
its ``ssd_scan`` kernel (``models.ssm.ssd_kernel``, which returns the
state each MAMBA cache starts from); everything else, the MAMBA decode
step included, is plain PyTorch.

Public API (all functional: inputs are not modified):
  init_params(gen, cfg)                        -> params
  forward(params, batch, cfg)                  -> (logits, aux)
  encode(params, frames, cfg)                  -> memory         (encdec)
  prefill(params, batch, cfg, cache_len)       -> (last_logits, cache)
  decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
  train_loss(params, batch, cfg, remat, loss_chunk) -> (loss, metrics)
  cache_struct(cfg, batch, cache_len, memory_len) -> prefill's cache tree
                                                     on the meta device

A batch carries the memory of a ``CROSS`` model beside its tokens: the
encoder's ``frames`` (B, S_enc, d_model) or the vision stub's
``image_embeds`` (B, n_image_tokens, d_model), the modality front ends
being the reference's sanctioned stubs.

Over a mesh: with one installed (``sharding.set_mesh``), ``encode``,
``forward``, ``train_loss``, ``prefill`` and ``decode_step`` take each
rank's parameters (``sharding.place(params, param_pspecs(params,
moe_mode), mesh)``) and run ``models.sharded``, where the reference's
sharding constraints are explicit collectives: their outputs are then
``Sharded`` (``sharding.collectives.unshard`` gives the whole value)
and the cache is each rank's (``sharded.gather_cache``).  With none
installed, nothing here changes.

Training: ``train_loss(params, batch, cfg, remat, loss_chunk)`` ->
(loss, {"xent", "aux"}), differentiable with autograd.  The kernels
compute forwards only; on the card each kernel op that needs a gradient
launches its kernel and differentiates its plain twin
(``kernels.autograd``), as the reference differentiates its plain
composition.  ``remat`` checkpoints each period
(``torch.utils.checkpoint``, non-reentrant: nothing inside a period is
saved, the reference's ``nothing_saveable``), so its kernels launch again
in the backward's recompute.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

import repro_torch.device  # noqa: F401  (IEEE fp32 products, no TF32)
from repro_torch.configs.base import ATTN, CROSS, MAMBA, ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (cross_attention, encoder_attention,
                                          prefill_attention,
                                          ring_decode_attention, rope)
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed, init_embed, init_lm_head,
    init_mlp, init_norm, lm_logits, param_device, rms_norm_headwise,
    softmax_xent)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.sharding.specs import get_mesh
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_attn(gen, cfg: ModelConfig, cross: bool = False):
    a = cfg.attn
    d = cfg.d_model
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(gen, d, a.n_heads * a.head_dim, dt),
        "wk": dense_init(gen, d, a.n_kv_heads * a.head_dim, dt),
        "wv": dense_init(gen, d, a.n_kv_heads * a.head_dim, dt),
        "wo": dense_init(gen, a.n_heads * a.head_dim, d, dt),
    }
    if a.qk_norm and not cross:
        p["q_scale"] = torch.ones((a.head_dim,), device=param_device(gen))
        p["k_scale"] = torch.ones((a.head_dim,), device=param_device(gen))
    return p


def _ffn_kind(cfg: ModelConfig, period_idx: int) -> Optional[str]:
    if cfg.moe is not None and period_idx in cfg.moe_period_idx:
        return "moe"
    if cfg.d_ff > 0:
        return "mlp"
    return None


def _init_block(gen, cfg: ModelConfig, period_idx: int):
    kind = cfg.period[period_idx]
    dev = param_device(gen)
    p = {"norm1": init_norm(cfg, device=dev)}
    if kind == ATTN:
        p["attn"] = _init_attn(gen, cfg)
    elif kind == CROSS:
        p["attn"] = _init_attn(gen, cfg)
        p["norm_x"] = init_norm(cfg, device=dev)
        p["cross_attn"] = _init_attn(gen, cfg, cross=True)
    elif kind == MAMBA:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg)
    ffn = _ffn_kind(cfg, period_idx)
    if ffn == "moe":
        p["norm2"] = init_norm(cfg, device=dev)
        p["moe"] = init_moe(gen, cfg)
    elif ffn == "mlp":
        p["norm2"] = init_norm(cfg, device=dev)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _init_period_stack(gen, cfg: ModelConfig, n_periods: int):
    """Stacked params: {'b{i}': leaves with leading (n_periods,) dim}."""
    blocks = {}
    for i in range(len(cfg.period)):
        per = [_init_block(gen, cfg, i) for _ in range(n_periods)]
        blocks[f"b{i}"] = _stack(per)
    return blocks


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig):
    """Full zoo-model parameter tree (embed, block stack, head, encoder),
    drawn from ``gen`` on its device; ``gen=None`` gives the tree's
    shapes and dtypes on the ``meta`` device.  Same shapes, dtypes and
    stds as the reference; not its ``jax.random`` numbers."""
    params = {
        "embed": init_embed(gen, cfg),
        "final_norm": init_norm(cfg, device=param_device(gen)),
        "blocks": _init_period_stack(gen, cfg, cfg.n_periods),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(gen, cfg)
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": _init_period_stack(gen, _encoder_cfg(cfg),
                                         cfg.encoder.n_layers),
            "final_norm": init_norm(cfg, device=param_device(gen)),
        }
    return params


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack as a config: one non-causal ATTN block a
    period, dense FFN, no window."""
    a = dataclasses.replace(cfg.attn, causal=False, window=None)
    return dataclasses.replace(
        cfg, period=(ATTN,), moe_period_idx=(), moe=None, attn=a,
        n_layers=cfg.encoder.n_layers)


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------
def _project_qkv(p, x, cfg: ModelConfig, positions, with_rope=True,
                 cross=False):
    a = cfg.attn
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, a.n_heads, a.head_dim)
    k = (x @ p["wk"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    v = (x @ p["wv"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    if a.qk_norm and not cross:
        q = rms_norm_headwise(q, p["q_scale"])
        k = rms_norm_headwise(k, p["k_scale"])
    if with_rope:
        q = rope(q, positions, a.rope_theta)
        k = rope(k, positions, a.rope_theta)
    return q, k, v


def _attn_out(p, out, cfg: ModelConfig):
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def _self_attn_full(p, h, cfg: ModelConfig, causal=True, q_offset=0):
    """Full-sequence self-attention (prefill / teacher-forced forward /
    the encoder's non-causal one).  Returns (out, (k, v)) so prefill can
    build caches."""
    S = h.shape[1]
    positions = q_offset + torch.arange(S, device=h.device)
    x = apply_norm(p["norm1"], h, cfg)
    q, k, v = _project_qkv(p["attn"], x, cfg, positions)
    if causal:
        out = prefill_attention(q, k, v, window=cfg.attn.window,
                                q_offset=q_offset)
    else:
        out = encoder_attention(q, k, v)
    return _attn_out(p["attn"], out, cfg), (k, v)


def _self_attn_decode(p, h, cfg: ModelConfig, cache, pos: int):
    """One-token self-attention against the (ring-buffer) cache.

    cache: {'k': (B, W, K, hd), 'v': ..., 'pos': (W,) int32}; the new
    cache is a copy with slot ``pos % W`` written."""
    x = apply_norm(p["norm1"], h, cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    q, k, v = _project_qkv(p["attn"], x, cfg, positions)
    W = cache["k"].shape[1]
    slot = pos % W
    ck, cv, cpos = (cache[n].clone() for n in ("k", "v", "pos"))
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    cpos[slot] = pos
    out = ring_decode_attention(q, ck, cv, kv_positions=cpos,
                                q_position=pos, window=cfg.attn.window)
    return _attn_out(p["attn"], out, cfg), {"k": ck, "v": cv, "pos": cpos}


def _cross_attn(p, h, cfg: ModelConfig, memory=None, mem_kv=None):
    """Cross-attention to encoder / image memory, no RoPE on either side.
    Either raw ``memory`` (B, Sm, D) or the cached projections ``mem_kv``
    (k, v).  Returns (out, (k, v))."""
    x = apply_norm(p["norm_x"], h, cfg)
    a = cfg.attn
    B, S, _ = x.shape
    q = (x @ p["cross_attn"]["wq"]).reshape(B, S, a.n_heads, a.head_dim)
    if mem_kv is None:
        Sm = memory.shape[1]
        k = (memory @ p["cross_attn"]["wk"]).reshape(B, Sm, a.n_kv_heads,
                                                     a.head_dim)
        v = (memory @ p["cross_attn"]["wv"]).reshape(B, Sm, a.n_kv_heads,
                                                     a.head_dim)
    else:
        k, v = mem_kv
    out = cross_attention(q, k, v)
    return _attn_out(p["cross_attn"], out, cfg), (k, v)


def _ffn(p, h, cfg: ModelConfig, period_idx: int):
    """Returns (delta, aux_loss)."""
    kind = _ffn_kind(cfg, period_idx)
    if kind is None:
        return torch.zeros_like(h), torch.zeros((), device=h.device)
    x = apply_norm(p["norm2"], h, cfg)
    if kind == "moe":
        return moe_ffn(x, p["moe"], cfg)
    return apply_mlp(p["mlp"], x, cfg), torch.zeros((), device=h.device)


# ---------------------------------------------------------------------------
# Period application (one step of the loop over periods)
# ---------------------------------------------------------------------------
def _apply_period_full(pp, h, cfg: ModelConfig, memory, mode: str,
                       cache_len: int = 0):
    """Apply one period in full-sequence mode.  Returns (h, aux, caches)."""
    aux_total = torch.zeros((), device=h.device)
    caches = {}
    for i, kind in enumerate(cfg.period):
        p = pp[f"b{i}"]
        c = {}
        if kind == ATTN:
            out, (k, v) = _self_attn_full(p, h, cfg, causal=cfg.attn.causal)
            h = h + out
            if mode == "prefill":
                c.update(_build_kv_cache(k, v, cfg, cache_len))
        elif kind == CROSS:
            out, (k, v) = _self_attn_full(p, h, cfg, causal=True)
            h = h + out
            xout, (xk, xv) = _cross_attn(p, h, cfg, memory=memory)
            h = h + xout
            if mode == "prefill":
                c.update(_build_kv_cache(k, v, cfg, cache_len))
                c["xk"], c["xv"] = xk, xv
        elif kind == MAMBA:
            x = apply_norm(p["norm1"], h, cfg)
            if mode == "prefill":
                out, (conv_st, ssm_st) = ssm_mod.mamba_forward(
                    p["mamba"], x, cfg, return_state=True,
                    ssd_impl=ssm_mod.ssd_kernel)
                c["conv"], c["ssm"] = conv_st, ssm_st
            else:
                out = ssm_mod.mamba_forward(p["mamba"], x, cfg,
                                            ssd_impl=ssm_mod.ssd_kernel)
            h = h + out
        delta, aux = _ffn(p, h, cfg, i)
        h = h + delta
        aux_total = aux_total + aux
        if mode == "prefill":
            caches[f"b{i}"] = c
    return h, aux_total, caches


def _build_kv_cache(k, v, cfg: ModelConfig, cache_len: int):
    """Turn prefill K/V (B, S, K, hd) into a ring cache of length cache_len.

    All production shapes keep S a multiple of the window, so the ring
    layout slot = pos % W reduces to a plain slice of the last W tokens.
    """
    S = k.shape[1]
    W = cache_len
    dev = k.device
    if S >= W:
        assert S % W == 0, (S, W)
        ck, cv = k[:, S - W:], v[:, S - W:]
        cpos = torch.arange(S - W, S, dtype=torch.int32, device=dev)
    else:
        pad = W - S
        ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cpos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
    return {"k": ck, "v": cv, "pos": cpos}


def _apply_period_decode(pp, h, cfg: ModelConfig, cache, pos: int):
    """One period, one token.  Returns (h, new_cache)."""
    new_cache = {}
    for i, kind in enumerate(cfg.period):
        p = pp[f"b{i}"]
        c = cache[f"b{i}"]
        if kind == ATTN:
            out, nc = _self_attn_decode(p, h, cfg, c, pos)
            h = h + out
        elif kind == CROSS:
            out, nc = _self_attn_decode(p, h, cfg, c, pos)
            h = h + out
            # the memory's projections are read, not copied: only the
            # self-attention ring is written
            xout, _ = _cross_attn(p, h, cfg, mem_kv=(c["xk"], c["xv"]))
            h = h + xout
            nc["xk"], nc["xv"] = c["xk"], c["xv"]
        elif kind == MAMBA:
            x = apply_norm(p["norm1"], h, cfg)
            out, (conv_st, ssm_st) = ssm_mod.mamba_decode_step(
                p["mamba"], x, cfg, c["conv"], c["ssm"])
            h = h + out
            nc = {"conv": conv_st, "ssm": ssm_st}
        delta, _ = _ffn(p, h, cfg, i)
        h = h + delta
        new_cache[f"b{i}"] = nc
    return h, new_cache


# ---------------------------------------------------------------------------
# Stacks (loops over periods)
# ---------------------------------------------------------------------------
def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _take(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _stack(trees):
    """Stack over a new leading axis; one tree is a view, not a copy (a
    single period of a full-width block needs no second copy)."""
    if len(trees) == 1:
        return tree_map(lambda t: t.unsqueeze(0), trees[0])
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _stack_full(params_blocks, h, cfg: ModelConfig, memory, mode: str,
                cache_len: int = 0, remat: bool = False):
    """Loop over periods; with ``remat`` each period is checkpointed and
    recomputed in the backward (the blocks draw no random numbers, so
    no RNG state is kept)."""
    aux = torch.zeros((), device=h.device)
    caches = []
    for i in range(_n_stacked(params_blocks)):
        args = (_take(params_blocks, i), h, cfg, memory, mode, cache_len)
        if remat:
            h, aux_i, c = checkpoint(_apply_period_full, *args,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            h, aux_i, c = _apply_period_full(*args)
        aux = aux + aux_i
        caches.append(c)
    return h, aux, _stack(caches)


def _stack_decode(params_blocks, h, cfg: ModelConfig, cache, pos: int):
    caches = []
    for i in range(_n_stacked(params_blocks)):
        h, nc = _apply_period_decode(_take(params_blocks, i), h, cfg,
                                     _take(cache, i), pos)
        caches.append(nc)
    return h, _stack(caches)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def _meshed():
    """``models.sharded`` when a mesh is installed, else None."""
    if get_mesh() is None:
        return None
    from repro_torch.models import sharded
    return sharded


def encode(params, frames, cfg: ModelConfig):
    """Encoder forward (enc-dec archs).  frames: (B, S_enc, D) embeddings
    (the modality frontend is the sanctioned stub) -> memory (B, S_enc,
    D) in the model dtype."""
    if _meshed():
        return _meshed().encode(params, frames, cfg)
    enc_cfg = _encoder_cfg(cfg)
    h = frames.to(cfg.torch_dtype)
    h, _, _ = _stack_full(params["encoder"]["blocks"], h, enc_cfg,
                          memory=None, mode="train")
    return apply_norm(params["encoder"]["final_norm"], h, cfg)


def _memory_from_batch(params, batch, cfg: ModelConfig):
    if cfg.encoder is not None:
        return encode(params, batch["frames"], cfg)
    if cfg.vision_stub:
        return batch["image_embeds"].to(cfg.torch_dtype)
    return None


def _hidden_for_loss(params, batch, cfg: ModelConfig, remat: bool):
    """The final norm's output (B, S, d_model) and the aux loss."""
    memory = _memory_from_batch(params, batch, cfg)
    h = embed(params["embed"], batch["tokens"], cfg)
    h, aux, _ = _stack_full(params["blocks"], h, cfg, memory, mode="train",
                            remat=remat)
    return apply_norm(params["final_norm"], h, cfg), aux


def forward(params, batch, cfg: ModelConfig, remat: bool = False):
    """Teacher-forced decoder forward.  Returns (logits, aux)."""
    if _meshed():
        return _meshed().forward(params, batch, cfg, remat)
    h, aux = _hidden_for_loss(params, batch, cfg, remat)
    logits = lm_logits(params.get("lm_head", {}), params["embed"], h, cfg)
    return logits, aux


def train_loss(params, batch, cfg: ModelConfig, remat: bool = True,
               loss_chunk: int = 0):
    """Teacher-forced LM loss.  Returns (xent + aux, {"xent", "aux"}).

    ``loss_chunk`` > 0 computes the softmax cross-entropy in sequence
    chunks, each checkpointed, so the (B, S, vocab) fp32 logits and
    their gradient are never held at once; as in the reference it
    averages over every token, so it takes no ``mask``."""
    if _meshed():
        return _meshed().train_loss(params, batch, cfg, remat, loss_chunk)
    if loss_chunk <= 0:
        logits, aux = forward(params, batch, cfg, remat=remat)
        loss = softmax_xent(logits, batch["targets"], batch.get("mask"))
        return loss + aux, {"xent": loss, "aux": aux}
    if batch.get("mask") is not None:
        raise ValueError("the chunked loss averages over every token; it "
                         "takes no mask")
    h, aux = _hidden_for_loss(params, batch, cfg, remat)
    B, S, _ = h.shape
    if S % loss_chunk:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk "
                         f"{loss_chunk}")
    head = params.get("lm_head", {})

    def chunk_loss(hb, tb):
        logits = lm_logits(head, params["embed"], hb, cfg)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tb[..., None].long())[..., 0]
        return torch.sum(logz - gold)

    total = torch.zeros((), device=h.device)
    for c0 in range(0, S, loss_chunk):
        total = total + checkpoint(
            chunk_loss, h[:, c0:c0 + loss_chunk],
            batch["targets"][:, c0:c0 + loss_chunk], use_reentrant=False,
            preserve_rng_state=False)
    loss = total / (B * S)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(params, batch, cfg: ModelConfig, cache_len: Optional[int] = None):
    """Process the prompt, build caches.  Returns (last_logits, cache).

    cache_len defaults to prompt length (full attention) or the attention
    window (SWA archs).
    """
    if _meshed():
        return _meshed().prefill(params, batch, cfg, cache_len)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if cache_len is None:
        cache_len = S if cfg.attn is None or cfg.attn.window is None \
            else min(S, cfg.attn.window)
    memory = _memory_from_batch(params, batch, cfg)
    h = embed(params["embed"], tokens, cfg)
    h, _, caches = _stack_full(params["blocks"], h, cfg, memory,
                               mode="prefill", cache_len=cache_len)
    h_last = apply_norm(params["final_norm"], h[:, -1:], cfg)
    logits = lm_logits(params.get("lm_head", {}), params["embed"], h_last,
                       cfg)
    return logits[:, 0], caches


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) int; pos: int (the absolute
    position being written).  Returns (logits (B, V), new_cache)."""
    if _meshed():
        return _meshed().decode_step(params, cache, tokens, pos, cfg)
    pos = int(pos)
    h = embed(params["embed"], tokens, cfg)
    h, new_cache = _stack_decode(params["blocks"], h, cfg, cache, pos)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params.get("lm_head", {}), params["embed"], h, cfg)
    return logits[:, 0], new_cache


# ---------------------------------------------------------------------------
# Cache specs (for dry-runs: meta tensors, no storage)
# ---------------------------------------------------------------------------
def cache_struct(cfg: ModelConfig, batch: int, cache_len: int,
                 memory_len: int = 0):
    """The tree ``prefill`` would emit, as ``meta``-device tensors of its
    shapes and dtypes (the reference's ``ShapeDtypeStruct`` tree)."""
    P = cfg.n_periods
    dt = cfg.torch_dtype
    a = cfg.attn

    def leaf(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    for i, kind in enumerate(cfg.period):
        W = cache_len if a is None or a.window is None \
            else min(cache_len, a.window)
        c = {}
        if kind in (ATTN, CROSS):
            c["k"] = leaf((P, batch, W, a.n_kv_heads, a.head_dim))
            c["v"] = leaf((P, batch, W, a.n_kv_heads, a.head_dim))
            c["pos"] = leaf((P, W), torch.int32)
        if kind == CROSS:
            c["xk"] = leaf((P, batch, memory_len, a.n_kv_heads, a.head_dim))
            c["xv"] = leaf((P, batch, memory_len, a.n_kv_heads, a.head_dim))
        if kind == MAMBA:
            s = cfg.ssm
            _, n_heads, d_xbc = ssm_mod.dims(cfg)
            c["conv"] = leaf((P, batch, s.d_conv - 1, d_xbc))
            c["ssm"] = leaf((P, batch, n_heads, s.head_dim, s.d_state),
                            torch.float32)
        out[f"b{i}"] = c
    return out
