"""Host <-> device transfers that do not stall the engine's stream.

A copy from pageable host memory (``torch.from_numpy(x).to("cuda")``, or
``t.cpu()``) returns only once all work queued before it on the current
stream is done.  The pipelined engine (``core/batched.py``) keeps route
passes of later ticks in flight while it resolves an earlier one, so
such a copy would wait for every in-flight tick and the pipeline would
overlap nothing.  Two pieces fix that on the card:

* ``PinnedStaging.upload``: host arrays go through pinned staging
  buffers, one pool per (shape, dtype), copied with ``non_blocking=True``
  and fenced by an event, so a buffer is refilled only once its last
  copy has completed (a pool holds one buffer per copy still in flight:
  at least ``pipeline_depth + 1`` of them while P ticks are queued).
  Copies on one stream complete in the order they were queued, so the
  pool is a FIFO and only its oldest buffer is ever tested;
* ``HostPrefetch``: device tensors copied into pinned host tensors with
  ``non_blocking=True`` behind their producing kernels, with an event
  recorded after the copies; ``result()`` waits on that event, never on
  the whole stream (the counterpart of the reference's
  ``sharding.host_prefetch``).  Reading the host tensors without the
  wait would return stale numbers with no error.

Each event is recorded on the stream its copies were queued on (that
of the device they touch), so both also hold for a device other than
the current one: a lane-sharded engine's shards (``repro_torch.sharding``).
On the CPU both are plain: ``upload`` wraps the array without a copy,
and ``HostPrefetch`` reads the tensors as they are.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Sequence, Tuple

import numpy as np
import torch


class PinnedStaging:
    """Uploads of host arrays to ``device`` through pinned buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        # (shape, dtype) -> FIFO of (pinned host tensor, event of its
        # last copy), oldest copy first
        self._pools: Dict[Tuple, Deque[tuple]] = {}

    def upload(self, x: np.ndarray) -> torch.Tensor:
        """``x`` as a tensor on the device, its copy queued on the current
        stream without waiting for the stream."""
        x = np.ascontiguousarray(x)
        if self.device.type != "cuda":
            return torch.from_numpy(x)
        pool = self._pools.setdefault((x.shape, x.dtype.str), deque())
        if pool and pool[0][1].query():      # the oldest copy has landed
            slot = pool.popleft()
        else:
            slot = (torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                                pin_memory=True), torch.cuda.Event())
        slot[0].numpy()[...] = x
        out = slot[0].to(self.device, non_blocking=True)
        slot[1].record(torch.cuda.current_stream(self.device))
        pool.append(slot)
        return out

    def buffers(self) -> int:
        """Pinned buffers held over all pools."""
        return sum(len(p) for p in self._pools.values())


class HostPrefetch:
    """Start device -> host copies of ``tensors`` now; ``result()`` waits
    for them (and only them) and returns numpy arrays."""

    __slots__ = ("tensors", "_host", "_event")

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.tensors = tuple(tensors)
        if self.tensors[0].device.type != "cuda":
            self._host = self.tensors
            self._event = None
            return
        self._host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                           for t in self.tensors)
        for h, t in zip(self._host, self.tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(self.tensors[0].device))

    def result(self) -> List[np.ndarray]:
        """The copied values, once the copies have landed."""
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]
