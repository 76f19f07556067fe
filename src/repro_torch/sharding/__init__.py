"""Sharding rules, mesh placement and the collectives over a mesh's
ranks (see ``specs`` and ``collectives``)."""
from repro_torch.sharding.collectives import (
    Sharded, all_gather, all_reduce, constrain, constrain_tokens,
    reduce_scatter, replicate, token_spec, unshard,
)
from repro_torch.sharding.specs import (
    LaneGather, batch_axes, gather_tree, get_mesh, jit_route_pass,
    lane_count, lane_devices, lane_spec, on_device, param_pspecs, place,
    put_lanes, put_replicated, refresh_replicas, set_mesh, set_seq_parallel,
    spec_for_path,
)

__all__ = [
    "set_mesh", "get_mesh", "batch_axes", "lane_count", "lane_spec",
    "lane_devices", "on_device", "put_lanes", "put_replicated",
    "refresh_replicas", "LaneGather", "jit_route_pass",
    "set_seq_parallel", "spec_for_path", "param_pspecs", "place",
    "gather_tree",
    "Sharded", "constrain", "constrain_tokens", "token_spec", "unshard",
    "replicate", "all_reduce", "all_gather", "reduce_scatter",
]
