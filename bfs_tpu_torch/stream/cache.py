"""The device superblock cache, the port of ``bfs_tpu.stream.cache``.

An LRU of superblock slabs on the device under a byte budget, kept as the
reference keeps it: room is made before an upload, a single entry larger
than the whole budget comes in alone (the oversized allowance), every
eviction is an ``instant`` span marker and a registry counter.  Keys are
the store's content fingerprints, so with verify-on-hit
(``BFS_TPU_TORCH_STREAM_VERIFY=1`` or ``verify=True``) a hit copies the
slab back and fingerprints it: a mismatch drops the entry, counts a
``corrupt_refetch`` and fetches the slab again from the host.

On a card every upload runs on the cache's own copy stream:
``copy_(pinned, non_blocking=True)`` into slabs allocated on that stream,
then an event.  A slab comes back as a :class:`Slab` whose :meth:`Slab.wait`
makes the caller's stream wait for that event before a kernel reads it;
each slab is ``record_stream``-ed onto the stream that asked for it, so a
slab evicted while a kernel may still read it is not handed to the next
upload by the caching allocator.  Eviction drops the cache's reference; a
slab being expanded stays alive until its last reference goes (the budget
is a working-set target, not an allocator limit).  On the CPU an upload is
a copy of the host slab.

One host thread drives it; nothing here locks."""

from __future__ import annotations

from collections import OrderedDict

import torch

from .. import knobs
from ..obs.registry import get_registry
from ..obs.spans import instant
from .store import HostTileStore, superblock_fingerprint

__all__ = ["COUNTER_KEYS", "Slab", "SuperblockCache", "stream_verify_enabled"]

#: The counters every report and ledger row carries, in ledger order.
COUNTER_KEYS = ("hits", "misses", "evictions", "corrupt_refetches", "bytes_streamed")


def stream_verify_enabled(verify: bool | None = None) -> bool:
    """``BFS_TPU_TORCH_STREAM_VERIFY`` (an explicit argument wins)."""
    if verify is not None:
        return bool(verify)
    return knobs.get("BFS_TPU_TORCH_STREAM_VERIFY")


class Slab(tuple):
    """A superblock's device operands ``(tiles, row_idx, col_local)``, the
    event recorded after their upload and the one recorded after their
    last reader was enqueued (both None on the CPU)."""

    def __new__(cls, ops, event=None):
        self = super().__new__(cls, ops)
        self.event = event
        self.read = None
        return self

    def wait(self) -> None:
        """Make the current stream wait for this slab's upload."""
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)

    def retire(self) -> None:
        """Mark the readers enqueued so far on the current stream (a card
        only): :meth:`wait_read` waits for them."""
        if self.event is not None:
            self.read = torch.cuda.Event()
            self.read.record()

    def wait_read(self) -> None:
        """Block the host until the readers marked by :meth:`retire` have
        run: the slab's memory can then go to the next upload."""
        if self.read is not None:
            self.read.synchronize()


class SuperblockCache:
    """LRU of device superblock slabs under a byte budget.

    ``device``: where slabs go (default: the card when the store is
    pinned, else the CPU).  ``copy_stream``: the stream of the uploads
    (default: a new one at the first upload); an engine passes one stream
    to all its caches, so a new cache reuses the device blocks the
    allocator keeps for it."""

    def __init__(self, store: HostTileStore, *, budget_bytes: int | None = None,
                 verify: bool | None = None, device=None, copy_stream=None):
        from ..ops.relay_mxu import stream_cache_budget_bytes

        self.store = store
        self.budget_bytes = stream_cache_budget_bytes() if budget_bytes is None else int(budget_bytes)
        self.verify = stream_verify_enabled(verify)
        self.device = torch.device(device if device is not None
                                   else ("cuda" if store.pinned else "cpu"))
        self._copy_stream = copy_stream
        # fingerprint -> (nbytes, Slab, superblock id), in LRU order; the id is
        # provenance only (identical superblocks share one entry).
        self._resident: OrderedDict[str, tuple[int, Slab, int]] = OrderedDict()
        self._resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.corrupt_refetches = 0
        self.bytes_streamed = 0

    # -- accounting ---------------------------------------------------------------

    def resident_bytes(self) -> int:
        return self._resident_bytes

    def counters(self) -> dict:
        """The counters now; the runner diffs two snapshots per level."""
        return {k: int(getattr(self, k)) for k in COUNTER_KEYS}

    def report(self) -> dict:
        return {
            "budget_bytes": int(self.budget_bytes),
            "resident_bytes": int(self._resident_bytes),
            "resident_entries": len(self._resident),
            "verify": bool(self.verify),
            **self.counters(),
        }

    # -- fetch ----------------------------------------------------------------------

    def get(self, g: int) -> Slab:
        """Superblock ``g``'s device slab: an LRU hit, or the host slab
        uploaded with room made first."""
        key = self.store.fingerprint(g)
        ent = self._resident.get(key)
        if ent is not None:
            if self.verify and not self._verify_entry(key, ent):
                self._drop_corrupt(key, ent, g)  # then fetched again below, counted
            else:
                self._resident.move_to_end(key)
                self._make_room(0, keep=key)  # settles an oversized entry's overshoot
                self.hits += 1
                return ent[1]
        nbytes = self.store.sb_bytes(g)
        self._make_room(nbytes, keep=key)
        slab = self._upload(g, nbytes)
        self._resident[key] = (nbytes, slab, int(g))
        self._resident_bytes += nbytes
        self.misses += 1
        self.bytes_streamed += nbytes
        return slab

    # -- internals -------------------------------------------------------------------

    def _upload(self, g: int, nbytes: int) -> Slab:
        host = self.store.fetch(g)
        if self.device.type != "cuda":
            return Slab(tuple(t.clone() for t in host))
        if not self.store.pinned:
            raise ValueError("a card's superblock cache needs a pinned host store")
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            ops = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in host)
            for dev, src in zip(ops, host):
                dev.copy_(src, non_blocking=True)
            done.record()
        for t in ops:
            t.record_stream(consumer)  # no reuse before the consumer's reads retire
        return Slab(ops, done)

    def _verify_entry(self, key: str, ent: tuple) -> bool:
        _nbytes, slab, _g = ent
        slab.wait()
        return superblock_fingerprint(*(t.cpu() for t in slab)) == key

    def _drop_corrupt(self, key: str, ent: tuple, g: int) -> None:
        nbytes = ent[0]
        del self._resident[key]
        self._resident_bytes -= nbytes
        self.corrupt_refetches += 1
        instant("stream.corrupt_refetch", superblock=int(g), bytes=int(nbytes))
        get_registry().counter("superblock_corrupt_refetches")

    def _make_room(self, incoming: int, *, keep: str) -> None:
        while self._resident and self._resident_bytes + incoming > self.budget_bytes:
            victim = next((k for k in self._resident if k != keep), None)
            if victim is None:
                return  # ``keep`` alone exceeds the budget: it comes in alone
            self._evict(victim)

    def _evict(self, key: str) -> None:
        nbytes, _slab, g = self._resident.pop(key)
        self._resident_bytes -= nbytes
        self.evictions += 1
        instant("stream.evict", superblock=int(g), bytes=int(nbytes))
        get_registry().counter("superblock_evictions")
        get_registry().counter("superblock_evicted_bytes", nbytes)
