"""Lane-sharding rules and mesh placement helpers (see ``specs``)."""
from repro_torch.sharding.specs import (
    LaneGather, batch_axes, get_mesh, jit_route_pass, lane_count,
    lane_devices, lane_spec, on_device, put_lanes, put_replicated,
    refresh_replicas, set_mesh,
)

__all__ = [
    "set_mesh", "get_mesh", "batch_axes", "lane_count", "lane_spec",
    "lane_devices", "on_device", "put_lanes", "put_replicated",
    "refresh_replicas", "LaneGather", "jit_route_pass",
]
