"""Training driver: train a zoo model on synthetic LM batches (port of
``repro.launch.train``), on a host mesh as the reference does.

``train`` installs ``make_host_mesh()`` (the visible cards as data
ranks, model 1), or the ``mesh=`` it is given, places the parameters by
``param_pspecs`` (``sharding.place``: each rank holds its shard, the
reference's ``device_put`` of the tree) and steps each rank's shard.  A
mesh of one slot takes the unsharded path, bit for bit.

Each step draws a batch from ``lm_batches``, runs ``train_loss`` through
the zoo's teacher-forced forward (attention, MoE and SSD on the port's
kernels on the card, each differentiated through its plain twin; over a
mesh, ``models.sharded``'s explicit collectives),
``loss.backward()``, and one ``adamw`` step (the reference's defaults:
b2 0.95, weight decay 0.1, clip 1.0); the parameters are drawn from a
``torch.Generator`` seeded by ``seed`` on the training device (a mesh's
first).  A CROSS model trains over zero frames or image embeddings, as
in the reference.

Over a mesh (``mesh_step``) the reference's GSPMD adds what the port
does by hand:
* the ranks that hold one shard of a leaf (its replicas, over the mesh
  axes its spec does not name) each hold a partial gradient; they are
  all-reduced over the replica group before the step, so every replica
  steps, and stays, bitwise the same;
* the clip takes the norm of the logical gradient, each shard's
  squares once: every rank sums its shards' squares and the sums are
  all-reduced over the axes the leaves split over (``grad_norm``);
* with ``zero`` (the dry-run's option) the moments also split over the
  data axes (``zero_shard_specs``): the gradient is reduce-scattered
  over them, each rank steps its slice and the parameters are
  all-gathered back.
``--ckpt`` writes the gathered tree, the file an unmeshed run writes.

Usage (the card by default; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --batch 8 --seq 256 --lr 1e-3 --ckpt build/ckpt \\
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device, sync
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf_model
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as col
from repro_torch.sharding import specs as shd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def model_config(arch: str, smoke: bool = True,
                 layers: Optional[int] = None):
    """The smoke or published config of ``arch``; ``layers`` cuts its
    depth (a whole number of periods; widths never change)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is None:
        return cfg
    if layers < 1 or layers % len(cfg.period):
        raise ValueError(f"layers must be a positive multiple of the "
                         f"period ({len(cfg.period)}), got {layers}")
    return dataclasses.replace(cfg, n_layers=layers)


def memory_stub(cfg, batch: int, seq: int, device):
    """The zero memory a CROSS model trains over: ``seq`` frames for an
    encoder-decoder, ``n_image_tokens`` image embeddings for the vision
    stub (the reference's sanctioned stubs); {} otherwise."""
    out = {}
    if cfg.encoder is not None:
        out["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                    dtype=cfg.torch_dtype, device=device)
    if cfg.vision_stub:
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    return out


def loss_and_grads(params, batch, cfg, remat: bool):
    """One teacher-forced step's (loss, metrics, grads): the loss and
    metrics detached, ``grads`` the parameter tree's ``.grad`` after
    ``loss.backward()`` (None where a leaf got no gradient).  With a
    mesh installed ``params`` is each rank's shard, and so is
    ``grads``."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = tf_model.train_loss(params, batch, cfg, remat=remat)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


# ---------------------------------------------------------------------------
# a step over a mesh
# ---------------------------------------------------------------------------
class _Box:
    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


def spec_leaves(tree, specs) -> list:
    """``specs``' entries in ``tree_leaves(tree)`` order."""
    boxed = shd._zip_specs(lambda path, leaf, spec: _Box(spec), tree, specs)
    return [b.spec for b in tree_leaves(boxed)]


def replica_axes(mesh, spec) -> tuple:
    """The mesh axes (of size > 1) a leaf of ``spec`` is replicated over:
    the ranks that differ only along them hold the same shard."""
    used = {a for e in spec for a in shd._axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a not in used and mesh.shape[a] > 1)


def zero_dim(pspec, mspec):
    """(dim, axes) where ``mspec`` splits a dim ``pspec`` keeps whole
    (the data axes ``zero_shard_specs`` adds), else (None, ())."""
    for d, (a, b) in enumerate(zip(pspec, mspec)):
        if a is None and b is not None:
            return d, shd._axes(b)
    return None, ()


def _layout(params, pspecs, mspecs):
    mesh = shd.get_mesh()
    ps = spec_leaves(params[0], pspecs)
    ms = ps if mspecs is None else spec_leaves(params[0], mspecs)
    return mesh, [(p, m) + zero_dim(p, m) for p, m in zip(ps, ms)]


def _slices(r, leaves, layout):
    """Rank r's slice of each of its leaves over the zero axes."""
    out = []
    for t, (_, _, d, za) in zip(leaves, layout):
        if za:
            size = t.shape[d] // shd._axis_size(shd.get_mesh(), za)
            t = t.narrow(d, col.axis_rank(r, za) * size, size)
        out.append(t)
    return out


def mesh_init(opt, params, pspecs, mspecs=None) -> list:
    """Each rank's optimizer state over its shard (with ``mspecs``, the
    zero layout, its slice): ``{"count", "m": [...], "v": [...]}`` with
    the leaves in ``tree_leaves`` order; the count is replicated."""
    _, layout = _layout(params, pspecs, mspecs)
    return col.rank_map(lambda r, p: opt.init(
        _slices(r, tree_leaves(p), layout)), params)


def grad_norm(grads, specs) -> list:
    """Each rank's copy of the logical gradient's l2 norm, float32, from
    its reduced leaves (``grads``: one list of leaves a rank, laid out
    by ``specs``).  Every rank sums the squares of its own shards, one
    scalar for each set of axes a leaf is split over; each scalar is
    all-reduced over its axes (replicas already hold the same shard, so
    each shard counts once), and the scalars are added in one order:
    every rank does the same work and holds the same bits."""
    mesh = shd.get_mesh()
    keys = [tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and
                  any(a in shd._axes(e) for e in spec)) for spec in specs]
    sets = sorted(set(keys))

    def local(r, gs):
        out = [torch.zeros((), dtype=torch.float32, device=gs[0].device)
               for _ in sets]
        for g, k in zip(gs, keys):
            i = sets.index(k)
            out[i] = out[i] + torch.sum(torch.square(g.float()))
        return out

    per = col.rank_map(local, grads)
    total = None
    for i, axes in enumerate(sets):
        part = [p[i] for p in per]
        if axes:
            part = col.all_reduce(part, axes)
        total = part if total is None else col.rank_map(
            lambda r, t, p: t + p, total, part)
    return col.rank_map(lambda r, t: torch.sqrt(t), total)


def reduce_grads(grads, pspecs, mspecs=None) -> list:
    """Each rank's gradient leaves (in ``tree_leaves`` order) with the
    replicas' partial sums combined: reduce-scattered over the zero axes
    of ``mspecs``, then all-reduced over the other replica axes, so
    each holds its shard's (slice's) whole gradient."""
    mesh, layout = _layout(grads, pspecs, mspecs)
    G = [tree_leaves(g) for g in grads]
    for i, (pspec, _, d, za) in enumerate(layout):
        g = [leaves[i] for leaves in G]
        if za:
            g = col.reduce_scatter(g, za, d)
        rep = tuple(a for a in replica_axes(mesh, pspec) if a not in za)
        if rep:
            g = col.all_reduce(g, rep)
        for leaves, t in zip(G, g):
            leaves[i] = t
    return G


def mesh_step(opt, params, grads, state, pspecs, mspecs=None):
    """One optimizer step of each rank's shard over the installed mesh
    (the module doc): ``reduce_grads``, the clip at ``grad_norm``, each
    rank's step on its slice, and the zero slices all-gathered.
    Returns (each rank's params, each rank's state)."""
    _, layout = _layout(params, pspecs, mspecs)
    G = reduce_grads(grads, pspecs, mspecs)
    norm = grad_norm(G, [m for _, m, _, _ in layout])
    stepped = col.rank_map(lambda r, p, g, st, nrm: opt.step(
        _slices(r, tree_leaves(p), layout), g, st, norm=nrm), params, G,
        state, norm)
    new = [tree_unflatten(p, leaves) for p, (leaves, _) in zip(params,
                                                                stepped)]
    return gather_zero(new, pspecs, mspecs), [st for _, st in stepped]


def gather_zero(params, pspecs, zspecs) -> list:
    """Each rank's parameters in the ``pspecs`` layout from its slices in
    ``zspecs``' (split over the data axes as well): every such leaf
    all-gathered over those axes (the parameters themselves where
    ``zspecs`` is None)."""
    if zspecs is None:
        return params
    _, layout = _layout(params, pspecs, zspecs)
    leaves = [tree_leaves(p) for p in params]
    for i, (_, _, d, za) in enumerate(layout):
        if za:
            full = col.all_gather([lv[i] for lv in leaves], za, d)
            for lv, t in zip(leaves, full):
                lv[i] = t
    return [tree_unflatten(p, lv) for p, lv in zip(params, leaves)]


def _host_mesh(dev, mesh):
    if mesh is not None:
        return mesh
    if dev.type == "cuda" and dev.index is None:
        return make_host_mesh()
    return make_host_mesh(dev)


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 256, lr: float = 1e-3, seed: int = 0,
          ckpt: Optional[str] = None, log_every: int = 10,
          remat: bool = False, device="cuda",
          layers: Optional[int] = None, mesh=None,
          dtype: Optional[str] = None, return_params: bool = False):
    """Train a zoo model on synthetic LM batches; returns each step's
    loss (and, with ``return_params``, the final parameters, gathered).
    ``device`` defaults to the card and raises without one: the host
    mesh is the visible cards for a bare ``cuda``, else one slot on
    ``device``; ``mesh`` replaces it.  ``layers`` cuts the depth
    (``model_config``), ``dtype`` overrides the config's."""
    dev = resolve_device(device)
    cfg = model_config(arch, smoke, layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    mesh = _host_mesh(dev, mesh)
    dev = shd.rank_devices(mesh)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tf_model.init_params(gen, cfg)
    opt = adamw(lr)
    extras = memory_stub(cfg, batch, seq, dev)
    meshed = mesh.size > 1
    if meshed:
        mode = cfg.moe.sharding_mode if cfg.moe is not None else "tensor"
        pspecs = shd.param_pspecs(params, mode)
        params = shd.place(params, pspecs, mesh)
        shd.set_mesh(mesh)
        opt_state = mesh_init(opt, params, pspecs)
    else:
        opt_state = opt.init(params)
    losses = []
    try:
        sync(dev)
        t0 = time.perf_counter()
        for i, b in enumerate(lm_batches(cfg.vocab, batch, seq, steps,
                                         seed)):
            arrs = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            arrs.update(extras)
            loss, _, grads = loss_and_grads(params, arrs, cfg, remat)
            with torch.no_grad():
                if meshed:
                    params, opt_state = mesh_step(opt, params, grads,
                                                  opt_state, pspecs)
                else:
                    params, opt_state = opt.step(params, grads, opt_state)
            del grads
            losses.append(float(loss))
            if log_every and (i + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / (i + 1)
                print(f"step {i+1}/{steps} loss={losses[-1]:.4f} "
                      f"({dt:.2f}s/step, {1e3 * dt:.1f} ms a step, "
                      f"{batch * seq / dt:.1f} tokens/s)", flush=True)
    finally:
        if meshed:
            shd.set_mesh(None)
    if meshed and (ckpt or return_params):
        params = shd.gather_tree(params, pspecs, mesh)
    if ckpt:
        save_checkpoint(ckpt, {"params": params},
                        metadata={"arch": arch, "steps": steps,
                                  "final_loss": losses[-1]})
        print(f"checkpoint written to {ckpt}")
    return (losses, params) if return_params else losses


def main():
    """CLI wrapper around ``train``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    args = ap.parse_args()
    losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                   batch=args.batch, seq=args.seq, lr=args.lr,
                   seed=args.seed, ckpt=args.ckpt,
                   log_every=args.log_every, remat=args.remat,
                   device=args.device, layers=args.layers)
    print(f"first loss {losses[0]:.4f} -> final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
