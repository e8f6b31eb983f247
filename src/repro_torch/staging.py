"""Page-locked staging of host blocks on their way to the card.

A host-to-device copy from pageable memory holds the host until the stream
has reached it: PyTorch issues ``cudaMemcpyAsync`` and then synchronises the
stream.  An ingest loop that copies each block that way stops at every block
until the card has finished the previous one, and the card then idles while
the host prepares the next.

:class:`StagingRing` holds two slots of page-locked host memory.  A block's
arrays are copied into a slot (``np.copyto``, so the caller may overwrite or
free its arrays as soon as the call returns) and from there to the card with
``non_blocking=True`` on the device's current stream, where every later
step of the block runs too.  An event recorded after the slot's copies says
when the slot may be written again; before the host writes into a slot it
waits for that event.  That wait is the only back-pressure: it keeps the
host at most two blocks ahead of the card and the pinned memory bounded.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

SLOTS = 2


class Slot:
    """One block's page-locked buffers on the way to ``device``, one buffer
    a key (grown to the largest array seen, never shrunk), and the event
    recorded after the slot's last copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copied = torch.cuda.Event()
        self.buffers: Dict[str, Tuple[torch.Tensor, np.ndarray]] = {}

    def send(self, key: str, array: np.ndarray) -> torch.Tensor:
        """``array`` on the card, in its own dtype: copied into the buffer
        ``key``, then from it without a synchronise on the device's current
        stream."""
        n = array.size
        pinned, host = self.buffers.get(key, (None, None))
        if host is None or host.dtype != array.dtype or host.size < n:
            like = torch.from_numpy(np.empty(0, array.dtype))
            pinned = torch.empty(n, dtype=like.dtype, pin_memory=True)
            host = pinned.numpy()
            self.buffers[key] = pinned, host
        np.copyto(host[:n].reshape(array.shape), array)
        out = torch.empty(array.shape, dtype=pinned.dtype, device=self.device)
        out.copy_(pinned[:n].view(array.shape), non_blocking=True)
        self.copied.record(torch.cuda.current_stream(self.device))
        return out


class StagingRing:
    """Two :class:`Slot` s taken in turns; none is made before the first
    block (:meth:`take`), so a ring that only CPU tables use holds no
    pinned memory and no event.

    Its counters are plain integers that start at 0 with the ring:

    ``staged_blocks``
        blocks that went through a slot;
    ``staging_waits``
        of those, the blocks whose slot still had a copy pending, so that
        the host waited for the card.  Near one a block: the host runs
        ahead of the card.  Near zero: the card waits for the host.
    """

    def __init__(self):
        self.slots: List[Slot] = []
        self._turn = 0
        self.staged_blocks = 0
        self.staging_waits = 0

    def take(self, device: torch.device) -> Slot:
        """The next slot, once the card has read what it last held."""
        if not self.slots:
            self.slots = [Slot(device) for _ in range(SLOTS)]
        slot = self.slots[self._turn]
        self._turn = (self._turn + 1) % SLOTS
        if not slot.copied.query():
            self.staging_waits += 1
            slot.copied.synchronize()
        self.staged_blocks += 1
        return slot
