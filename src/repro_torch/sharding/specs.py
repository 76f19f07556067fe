"""Lane-sharding rules (port of the lane half of ``repro.sharding.specs``).

The batched cascade engine's per-lane arrays are lane-major: feature
batches, deferral probs, called masks, expert labels.  Lanes shard over
the batch-like mesh axes ('pod', 'data' — whichever the mesh has); the
shared cascade state (students, deferral gates, optimizer state, the
demonstration rings) is one policy serving every lane, not one per
shard.

The reference hands both to GSPMD on one controller.  The port runs the
same single-controller model by hand: lane shard s of a padded batch of
B rows holds the contiguous rows ``[s·B/N, (s+1)·B/N)`` and runs on its
own device with its own replica of the state, in lane order; outputs
come back to the host and are concatenated in the same order.  A
"replicated" value is held once per lane shard (``put_replicated``),
not once per distinct device, so a mesh whose shards share one device
(the CPU tests; one card) still keeps N copies.

The zoo's model sharding keeps the same model: the parameter rules
(``param_pspecs``, the reference's path regexes) say which dims of a
leaf split over which mesh axes, ``place`` puts each rank's shard on its
device (the reference's ``device_put`` of ``tree_named_shardings``) and
``gather_tree`` is its inverse.  Rank r is the mesh's r-th device in
row-major order.  ``constrain`` / ``constrain_tokens`` and the
collectives they imply are in ``sharding.collectives``; sequence
parallelism is the flag ``SEQ_PARALLEL`` (``set_seq_parallel``).

``host_prefetch``'s counterpart is ``repro_torch.transfer``
``HostPrefetch``; ``LaneGather`` runs one per shard.  The reference's
``jit_cache_scatter`` only donates the demonstration rings to its
scatter; the port donates nothing and keeps the rings on the mesh's
first device, so the engine calls ``core.batched.ring_scatter`` itself.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.transfer import HostPrefetch
from repro_torch.tree import tree_leaves, tree_map

_CURRENT_MESH = None

# Sequence parallelism (Megatron-SP): shard the sequence dim of
# inter-block activations over 'model' as well as the batch over
# (pod, data).  The tensor-parallel all-reduces then become
# reduce-scatter / all-gather pairs and the stored activations shrink by
# the model-axis size.
SEQ_PARALLEL = False


def set_seq_parallel(v: bool) -> None:
    """Toggle the Megatron-SP activation-sharding pattern globally."""
    global SEQ_PARALLEL
    SEQ_PARALLEL = v


def set_mesh(mesh) -> None:
    """Install ``mesh`` as the process-wide default device mesh."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    """The process-wide default device mesh, if one is installed."""
    return _CURRENT_MESH


def batch_axes(mesh=None) -> Optional[Tuple[str, ...]]:
    """The mesh axes a batch dim shards over (the 'pod', 'data' subset),
    or None without a mesh or without such an axis."""
    mesh = mesh or _CURRENT_MESH
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _fits(mesh, dim: int, axes) -> bool:
    size = _axis_size(mesh, axes)
    return size > 0 and dim % size == 0


# ---------------------------------------------------------------------------
# lane sharding (batched cascade engine)
# ---------------------------------------------------------------------------
def lane_count(mesh) -> int:
    """Number of lane shards: the product of the lane axes' sizes."""
    return _axis_size(mesh, batch_axes(mesh))


def lane_spec(mesh) -> Tuple[str, ...]:
    """The axes dim 0 of a lane-major array shards over, as a tuple of
    names (the reference's ``PartitionSpec`` entry; () = replicated)."""
    return batch_axes(mesh) or ()


def lane_devices(mesh) -> List[torch.device]:
    """The device of each lane shard, in lane order: shard s sits at the
    index that s unravels to over the lane axes (in ``lane_spec``
    order), and at index 0 of every other axis."""
    axes = lane_spec(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for s in range(lane_count(mesh)):
        at = dict(zip(axes, np.unravel_index(s, sizes))) if axes else {}
        out.append(mesh.devices[tuple(int(at.get(a, 0))
                                      for a in mesh.axis_names)])
    return out


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for a block (the port's
    kernels launch on the current device's stream); a no-op elsewhere."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def put_lanes(x, mesh, upload: Optional[Callable] = None
              ) -> List[torch.Tensor]:
    """Split a lane-major host array over dim 0 into ``lane_count``
    contiguous shards, shard s on lane device s; where dim 0 does not
    divide (e.g. a partial final tick) every shard holds the whole array
    instead — one replicated placement, ``constrain``'s divisibility
    rule.  ``upload(part, device)`` moves a part (default: a plain copy;
    the engine passes its pinned staging)."""
    x = np.asarray(x)
    devs = lane_devices(mesh)
    if x.ndim and _fits(mesh, x.shape[0], batch_axes(mesh)):
        parts = np.split(x, len(devs))
    else:
        parts = [x] * len(devs)
    up = upload or _upload
    return [up(p, d) for p, d in zip(parts, devs)]


def put_replicated(tree, mesh) -> list:
    """One copy of ``tree`` (a tensor, an array or a nested dict / list /
    tuple of them) per lane shard, on that shard's device, in lane
    order."""
    def put(d):
        return tree_map(lambda t: torch.as_tensor(t).to(d, copy=True), tree)
    return [put(d) for d in lane_devices(mesh)]


def refresh_replicas(replicas: Sequence, tree) -> None:
    """Copy ``tree``'s leaves into each replica's, in place (the replicas
    keep their devices and storage)."""
    src = tree_leaves(tree)
    for rep in replicas:
        dst = tree_leaves(rep)
        if len(dst) != len(src):
            raise ValueError(f"replica has {len(dst)} leaves, the state "
                             f"{len(src)}")
        if dst and dst[0].device == src[0].device:
            torch._foreach_copy_(dst, src)
        else:
            for a, b in zip(dst, src):
                a.copy_(b)


class LaneGather:
    """Device -> host copies of each shard's outputs, started at once
    (one ``HostPrefetch`` a shard); ``result()`` waits for them and
    concatenates each output over the shards, in lane order."""

    __slots__ = ("parts",)

    def __init__(self, shard_outputs: Sequence[Sequence[torch.Tensor]]):
        self.parts = [HostPrefetch(out) for out in shard_outputs]

    def result(self) -> List[np.ndarray]:
        outs = [p.result() for p in self.parts]
        return [np.concatenate(col) for col in zip(*outs)]


# ---------------------------------------------------------------------------
# the engine's staged functions
# ---------------------------------------------------------------------------
def jit_route_pass(fn, mesh=None):
    """The per-level route pass ``fn(params, dparams, xb)``.

    Without a mesh, ``fn`` itself.  With one, a function of per-shard
    lists ``(params, dparams, xb)`` that runs ``fn`` once per lane shard,
    on the shard's device, in lane order, and returns the shards'
    outputs (nothing is gathered: the caller starts the copies to the
    host).  Nothing is donated: each shard's input is a fresh upload
    that dies with the call."""
    if mesh is None:
        return fn
    devs = lane_devices(mesh)

    def sharded(params, dparams, xb):
        outs = []
        for d, p, dp, x in zip(devs, params, dparams, xb):
            with on_device(d):
                outs.append(fn(p, dp, x))
        return outs

    return sharded



# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------
def _axes(axes) -> Tuple[str, ...]:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def rank_devices(mesh) -> List[torch.device]:
    """The device of each rank a step runs, in rank (row-major mesh)
    order (all of them unless the mesh runs fewer, ``Mesh.run``)."""
    return list(mesh.devices.flat)[:getattr(mesh, "run", mesh.size)]


def rank_index(mesh, r: int, axes) -> int:
    """Rank r's row-major index over ``axes`` (0 for no axes); the
    shard of a dim split over ``axes`` that rank r holds."""
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(r, mesh.devices.shape)))
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


# ---------------------------------------------------------------------------
# parameter partition specs (path-based rules)
# ---------------------------------------------------------------------------
# Each rule: (path regex, spec builder taking ndim -> tuple).  The leading
# n_periods stacking dim (present on block params) is always replicated.
# Specs below are for the *unstacked* suffix dims.
_RULES = [
    # embeddings / lm head: shard vocab over model
    (r"embed/table$",        lambda nd: ("model", None)),
    (r"lm_head/w$",          lambda nd: (None, "model")),
    # attention projections
    (r"(attn|self_attn|cross_attn)/wq$", lambda nd: (None, "model")),
    (r"(attn|self_attn|cross_attn)/wk$", lambda nd: (None, "model")),
    (r"(attn|self_attn|cross_attn)/wv$", lambda nd: (None, "model")),
    (r"(attn|self_attn|cross_attn)/wo$", lambda nd: ("model", None)),
    # dense mlp
    (r"mlp/w_gate$",         lambda nd: (None, "model")),
    (r"mlp/w_in$",           lambda nd: (None, "model")),
    (r"mlp/w_out$",          lambda nd: ("model", None)),
    # moe: tensor mode shards expert ff dim; router replicated
    (r"moe/w_gate$",         lambda nd: (None, None, "model")),
    (r"moe/w_in$",           lambda nd: (None, None, "model")),
    (r"moe/w_out$",          lambda nd: (None, "model", None)),
    (r"moe/router$",         lambda nd: (None, None)),
    # mamba: shard d_inner / heads over model
    (r"mamba/in_proj$",      lambda nd: (None, "model")),
    (r"mamba/conv_w$",       lambda nd: (None, "model")),
    (r"mamba/conv_b$",       lambda nd: ("model",)),
    (r"mamba/A_log$",        lambda nd: ("model",)),
    (r"mamba/D$",            lambda nd: ("model",)),
    (r"mamba/dt_bias$",      lambda nd: ("model",)),
    (r"mamba/gate_norm$",    lambda nd: ("model",)),
    (r"mamba/out_proj$",     lambda nd: ("model", None)),
]

_EXPERT_MODE_RULES = [
    # expert-parallel: shard the expert dim instead of ff
    (r"moe/w_gate$",         lambda nd: ("model", None, None)),
    (r"moe/w_in$",           lambda nd: ("model", None, None)),
    (r"moe/w_out$",          lambda nd: ("model", None, None)),
]


def _path_str(path: Sequence) -> str:
    """A leaf's path of dict keys and list indices as "a/b/0/c"."""
    return "/".join(str(p) for p in path)


def spec_for_path(path_str: str, ndim: int, stacked: bool,
                  moe_mode: str = "tensor") -> Tuple:
    """The spec of a parameter path via the placement rule table: one
    entry a dim, an axis name or None (the reference's
    ``PartitionSpec``)."""
    rules = list(_RULES)
    if moe_mode == "expert":
        rules = _EXPERT_MODE_RULES + rules
    for pat, builder in rules:
        if re.search(pat, path_str):
            suffix = builder(ndim)
            if stacked:
                # leading n_periods dim replicated; pad/trim to ndim
                suffix = (None,) + tuple(suffix)
            suffix = tuple(suffix)[:ndim]
            return suffix + (None,) * (ndim - len(suffix))
    return (None,) * ndim


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspecs(params, moe_mode: str = "tensor"):
    """Tree of specs (tuples) matching ``params`` (tensors, or anything
    with a ``shape``)."""
    def one(path, leaf):
        ps = _path_str(path)
        stacked = "/blocks/" in ("/" + ps + "/") or ps.startswith("blocks/")
        return spec_for_path(ps, len(leaf.shape), stacked, moe_mode)
    return _map_path(one, params)


def _div(n, mesh, axes) -> bool:
    """Whether ``axes`` (those the mesh has; none: False) split a dim of
    size n evenly, at least one element a part (the reference's rule for
    the dry-run's specs)."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return False
    size = math.prod(mesh.shape[a] for a in axes)
    return n % size == 0 and n >= size


def _entry(axes):
    return axes if len(axes) > 1 else axes[0]


def cache_leaf_spec(name: str, shape: Sequence[int], mesh) -> Tuple:
    """The spec of one stacked cache leaf ``name`` of ``shape`` (the
    reference's ``cache_pspecs`` rule).  Attention caches (Pd, B, W, K,
    hd): the batch over (pod, data) where it divides, else the length
    W; the kv heads over 'model' where they divide, else the length
    over 'model' where the data axes left it whole (with the length
    over the data axes and heads that do not divide, the cache is
    replicated over 'model').  SSM states (Pd, B, H, hp, N): batch and
    SSD heads.  Conv states (Pd, B, d_conv-1, d_xbc): batch and
    channels.  ``pos`` is replicated."""
    baxes = batch_axes(mesh)
    dims = [None] * len(shape)
    if name in ("k", "v", "xk", "xv"):
        if baxes and _div(shape[1], mesh, baxes):
            dims[1] = _entry(baxes)
        elif baxes and _div(shape[2], mesh, baxes):
            dims[2] = _entry(baxes)
        if _div(shape[3], mesh, ("model",)):
            dims[3] = "model"
        elif dims[2] is None and _div(shape[2], mesh, ("model",)):
            dims[2] = "model"
    elif name in ("ssm", "conv"):
        if baxes and _div(shape[1], mesh, baxes):
            dims[1] = _entry(baxes)
        c = 2 if name == "ssm" else 3
        if _div(shape[c], mesh, ("model",)):
            dims[c] = "model"
    return tuple(dims)


def cache_pspecs(cache_struct, mesh):
    """The reference's KV / SSM cache specs for the stacked cache tree
    ``cache_struct`` (``cache_leaf_spec`` leaf by leaf).  The meshed
    decode step holds its caches so, every leaf
    (``models.sharded.shard_cache``)."""
    def one(path, leaf):
        name = path[-1] if path and isinstance(path[-1], str) else ""
        return cache_leaf_spec(name, leaf.shape, mesh)

    return _map_path(one, cache_struct)


def _zip_specs(fn, tree, specs, path=()):
    """``fn(path, leaf, spec)`` over ``tree``'s leaves; ``specs`` is the
    matching tree whose leaves are spec tuples."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(fn, v, specs[i], path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, specs)


def _split_dims(mesh, path, shape, spec):
    """(dim, axes, parts) for each dim ``spec`` splits; an axis the mesh
    lacks splits nothing, and a dim its axes do not divide raises,
    naming the leaf (``device_put`` of an uneven sharding raises too:
    nothing is placed replicated in its stead)."""
    out = []
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if a in mesh.axis_names)
        n = _axis_size(mesh, axes)
        if n == 1:
            continue
        if shape[d] % n:
            raise ValueError(
                f"{_path_str(path)}: dim {d} of size {shape[d]} does not "
                f"divide evenly over mesh axes {axes} of size {n}")
        out.append((d, axes, n))
    return out


def place(tree, specs, mesh) -> List[Any]:
    """Each rank's shard of ``tree`` on its device, in rank order (the
    reference's ``device_put(tree, tree_named_shardings(mesh, specs))``).

    A dim split over axes of total size n holds its contiguous 1/n part
    at the rank's index over those axes.  Every rank gets tensors of its
    own (a view where a shard needs no copy): a replicated leaf is
    held once per rank, as ``put_replicated`` does, and each rank's copy
    collects the gradient of the work done with it (``gather_tree(...,
    sum_replicas=True)`` adds them).  The shards are built with
    differentiable ops, so a gradient also reaches ``tree``'s own
    leaves."""
    devs = rank_devices(mesh)

    def shard(r, path, leaf, spec):
        t = leaf[...]
        for d, axes, n in _split_dims(mesh, path, leaf.shape, spec):
            size = leaf.shape[d] // n
            t = t.narrow(d, rank_index(mesh, r, axes) * size, size)
        return t.contiguous().to(devs[r])

    return [_zip_specs(lambda *a, r=r: shard(r, *a), tree, specs)
            for r in range(len(devs))]


def gather_tree(parts: Sequence, specs, mesh, sum_replicas: bool = False):
    """The whole tree from each rank's shard (``place``'s inverse), on
    rank 0's device.  Each split dim is concatenated in rank-index
    order.  The ranks that hold one shard are its replicas: by default
    the first one's value is taken; with ``sum_replicas`` they are
    added (the gradient of a replicated parameter is the sum of its
    copies' gradients, what the reference's GSPMD all-reduces)."""
    devs = rank_devices(mesh)

    def one(path, leaf0, spec):
        splits = _split_dims(mesh, path, _global_shape(mesh, leaf0.shape,
                                                        spec), spec)
        leaves = [_leaf_at(parts[r], path) for r in range(len(devs))]
        blocks = {}
        for r, t in enumerate(leaves):
            key = tuple(rank_index(mesh, r, axes) for _, axes, _ in splits)
            t = t.to(devs[0])
            if key not in blocks:
                blocks[key] = t
            elif sum_replicas:
                blocks[key] = blocks[key] + t
        return _assemble(blocks, splits, ())

    return _zip_specs(one, parts[0], specs)


def _global_shape(mesh, shape, spec):
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if a in mesh.axis_names)
        out[d] *= _axis_size(mesh, axes)
    return tuple(out)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assemble(blocks, splits, key):
    """Concatenate ``blocks`` (keyed by each split dim's shard index)
    over the split dims, the first split dim outermost."""
    if len(key) == len(splits):
        return blocks[key]
    d, _, n = splits[len(key)]
    return torch.cat([_assemble(blocks, splits, key + (i,))
                      for i in range(n)], dim=d)
