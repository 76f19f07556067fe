"""Device meshes (port of ``repro.launch.mesh``): the cascade's lane
sharding and the zoo's model sharding.

A ``Mesh`` is the port's own small record: axis names, their sizes and
an array of ``torch.device``s in row-major order.  It is not
``torch.distributed.DeviceMesh``: the batched engine shards its lanes,
and the zoo its parameters, from one process, which drives every device
itself (the reference's single-controller model), so no process group
is needed.

Devices default to the visible CUDA cards, each once.  A device repeats
only where the caller asks for it: ``devices="cpu"`` (or one device of
any kind) fills every slot of the mesh with it, and an explicit list may
name a device more than once (``["cuda:0", "cuda:0"]``).  That is the
counterpart of the reference's virtual host devices
(``--xla_force_host_platform_device_count``): how the CPU tests, and a
machine with one card, run N shards.  A CUDA device that does not exist
raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import canonical_device, resolve_device

DevicesLike = Union[None, str, torch.device,
                    Sequence[Union[str, torch.device]]]


class Mesh:
    """``devices`` (an object array of ``torch.device``s of the mesh's
    shape) and ``axis_names``, one name per dim.  ``run``: how many of
    its ranks (the first, in row-major order) a step runs, all by
    default; the dry-run counts a production mesh over fewer
    (``launch.dryrun.data_slice``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 run: Optional[int] = None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims given "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.run = self.size if run is None else int(run)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's
        ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        run = "" if self.run == self.size else f", run={self.run}"
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{run})")


def _visible_cards():
    """The visible CUDA cards, each once (raises without CUDA)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices: DevicesLike, shape: Tuple[int, ...]):
    """The first prod(shape) devices of ``devices``, each checked to
    exist."""
    n = math.prod(shape)
    if devices is None:
        devices = _visible_cards()
    elif isinstance(devices, (str, torch.device)):
        devices = [torch.device(devices)] * n
    else:
        devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {shape}")
    out = [canonical_device(resolve_device(d)) for d in devices[:n]]
    for d in out:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh device {d} does not exist: "
                f"{torch.cuda.device_count()} CUDA device(s) visible")
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: DevicesLike = None) -> Mesh:
    """A mesh with the given axis sizes and names over ``devices`` (the
    visible CUDA cards by default; the first prod(shape) of them)."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    arr = np.empty(math.prod(shape), dtype=object)
    arr[:] = _device_list(devices, shape)
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: DevicesLike = None) -> Mesh:
    """16x16 = 256 slots per pod, over ("data", "model"); 2 pods = 512
    slots over ("pod", "data", "model").  Over the visible cards by
    default (raising where there are fewer); one device given alone
    (``"meta"`` for a count) fills every slot."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(devices: DevicesLike = None) -> Mesh:
    """Every device of ``devices`` (the visible CUDA cards by default;
    one device given alone is one slot) as a (data, model) mesh with
    model = 1."""
    if devices is None:
        devices = _visible_cards()
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    return make_mesh((len(devices), 1), ("data", "model"), devices)


def parse_mesh_spec(spec: str, devices: DevicesLike = None
                    ) -> Optional[Mesh]:
    """``"data=8"`` / ``"pod=2,data=4"`` -> a Mesh with those axes.

    The CLI knob behind ``serve.py --mesh``: axis sizes must multiply to
    at most the number of devices (the visible cards, or ``devices``;
    one device given alone fills every slot).  Returns None for an
    empty / absent spec."""
    if not spec:
        return None
    shape, axes = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size.strip().isdigit() or int(size) < 1:
            raise ValueError(f"bad mesh spec {spec!r}: expected "
                             f"'axis=N[,axis=N...]' with N >= 1, "
                             f"got {part!r}")
        axes.append(name)
        shape.append(int(size))
    return make_mesh(tuple(shape), tuple(axes), devices)
