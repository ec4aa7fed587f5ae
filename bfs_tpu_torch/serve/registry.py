"""Graph registry: epoch-versioned graphs, budgeted device residency.  The
port of ``bfs_tpu.serve.registry``.

The registry owns what the query server amortizes across queries:

  * host layouts, built once per ``(graph epoch, engine)`` and kept for the
    epoch's life: a :class:`~bfs_tpu_torch.graph.ell.PullGraph`, a
    dst-sorted :class:`~bfs_tpu_torch.graph.csr.DeviceGraph`, or a
    :class:`~bfs_tpu_torch.graph.relay.RelayGraph`; with a
    ``layout_cache`` the pull and relay layouts go through the persistent
    bundle store (:func:`~bfs_tpu_torch.cache.layout.load_or_build_pull`,
    :func:`~bfs_tpu_torch.cache.layout.load_or_build_relay`), so a second
    process loads them instead of building them;
  * device residency, in an LRU keyed ``(name, epoch, engine)`` against an
    explicit byte budget.  The resident unit is the ENGINE
    (:class:`~bfs_tpu_torch.models.bfs.EdgeEngine` for pull and push,
    :class:`~bfs_tpu_torch.models.bfs.RelayEngine` for relay): its device
    tensors and the block loops captured over them, which bind their
    addresses.  Evicting drops the engine whole; the next
    :meth:`GraphRegistry.acquire` builds a new one from the kept host
    layout.  Its bytes are the device tensors it holds
    (:func:`device_bytes`), counted again at every acquire, since loops and
    the batch route index are allocated at first use.

**Epochs.**  ``register(name, graph)`` on an existing name is a hot swap:
it creates a new epoch; later admissions see it; the old epoch's layouts
and engines stay alive as long as in-flight work holds a pin on them
(:meth:`pin` / :meth:`unpin`).  A replaced epoch retires when its last pin
drops (at swap time when it has none).  The budget evictor skips pinned
epochs and counts ``eviction_deferred``.

**Releasing an engine is device work.**  Dropping an engine destroys its
captured graphs and frees its memory; done while another thread captures
a graph, that would invalidate the capture.  So an evicted engine goes to
a graveyard that is emptied under the server's device lock
(:data:`~bfs_tpu_torch.serve.executor.DEVICE_LOCK`): at once when the lock
is free, else by the next acquire, before it ships anything.

``GraphRegistry(device=...)`` names the device the engines live on: the
card unless ``device="cpu"``; without a card and without ``"cpu"`` it
raises.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import knobs
from ..graph.csr import DeviceGraph, Graph, build_device_graph
from ..graph.ell import PullGraph, build_pull_graph
from ..graph.relay import RelayGraph
from ..utils.locks import make_lock
from .executor import DEVICE_LOCK

ENGINES = ("pull", "push", "relay")

#: The knobs an engine resolves at construction, keying the resident LRU:
#: a knob flipped between acquires never reuses an engine built under the
#: old value (the reference keys on its ``BFS_TPU_EXPANSION`` too).  Listed
#: here, where the reference derives its list from the registry; the knob
#: rung (``python -m bfs_tpu_torch.analysis --knobs``, KNB002) proves it
#: equals the knobs that declare ``serve`` in ``affects``.
ENGINE_FLAVOR_ENV = (
    "BFS_TPU_TORCH_DIRECTION",
    "BFS_TPU_TORCH_DIRECTION_ALPHA",
    "BFS_TPU_TORCH_DIRECTION_BETA",
    "BFS_TPU_TORCH_EXPANSION",
)


def _engine_env_fingerprint() -> str:
    """blake2b-6 over the raw serve knob values: the fourth element of the
    resident LRU's key."""
    parts = ";".join(f"{n}={knobs.raw(n)}" for n in ENGINE_FLAVOR_ENV)
    return hashlib.blake2b(parts.encode(), digest_size=6).hexdigest()


@dataclass
class RegisteredGraph:
    """One registered graph EPOCH: the host graph plus lazily built host
    layouts.  ``pins``, ``retired`` and ``released`` are guarded by the
    owning registry's lock."""

    name: str
    graph: Graph | None  # host graph; None when registered from a layout
    num_vertices: int = 0
    num_edges: int = 0
    layouts: dict = field(default_factory=dict)  # engine -> host layout
    epoch: int = 0
    pins: int = 0  # in-flight references
    retired: bool = False  # replaced by a newer epoch
    #: Resources released (``_retire`` ran, or ``unregister`` dropped the
    #: record): a late unpin after unregister must not release it again.
    released: bool = False


def device_bytes(root) -> int:
    """Bytes of the distinct device storages reachable from ``root``
    through the attributes, dicts, lists and tuples of the port's objects
    (an engine: its layout tensors, loop carries, tables)."""
    seen, storages, total = set(), set(), 0
    stack = [root]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in storages:
                storages.add(st.data_ptr())
                total += st.nbytes()
            continue
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif type(x).__module__.startswith("bfs_tpu_torch.") and hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return total


def layout_device_bytes(layout, engine: str) -> int:
    """The device bytes an engine ships from ``layout`` at construction
    (what :func:`device_bytes` counts on a new engine): the room the budget
    makes before the upload.  Push's ``dst`` is int64 on the card."""
    if engine == "pull":
        return 4 * layout.padded_slots
    if engine == "push":
        return 4 * int(layout.src.size) + 8 * int(layout.dst.size)
    rg = layout
    sparse = 4 * int(np.asarray(rg.adj_indptr).size) + 8 * int(np.asarray(rg.adj_dst).size)
    return (int(rg.vperm_masks.nbytes) + int(rg.net_masks.nbytes) + rg.net_size // 8
            + 8 * rg.num_vertices + 4 * int(np.asarray(rg.src_l1).size) + 4 * rg.vr + sparse)


class GraphRegistry:
    """Named graph epochs + memoized host layouts + budgeted residency of
    engines.

    ``device_budget_bytes`` caps the summed bytes of resident engines;
    ``None`` means unlimited.  The budget never blocks the entry being
    acquired: a single engine larger than the budget is admitted alone,
    every other (unpinned) one is evicted around it.
    """

    def __init__(self, *, device_budget_bytes: int | None = None, metrics=None,
                 layout_cache=None, device=None):
        from ..models.bfs import resolve_device

        self.device = resolve_device(device)
        self._lock = make_lock("registry._lock", "rlock")
        self._graphs: dict[str, RegisteredGraph] = {}  # guarded-by: _lock
        # Replaced epochs still pinned by in-flight work, keyed (name, epoch).
        self._retired: dict[tuple[str, int], RegisteredGraph] = {}  # guarded-by: _lock
        # (name, epoch, engine, env fingerprint) -> (bytes, engine); LRU order.
        self._resident: OrderedDict[tuple[str, int, str, str], tuple[int, object]] = \
            OrderedDict()  # guarded-by: _lock
        self._graveyard: list = []  # guarded-by: _lock (evicted engines, freed on the card's lock)
        self.device_budget_bytes = device_budget_bytes
        self.metrics = metrics  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.evictions_deferred = 0  # guarded-by: _lock
        #: Info of the most recent relay layout load or build (builder,
        #: seconds, stage times, cache hit or miss); {} before any.
        self.last_layout_info: dict = {}  # guarded-by: _lock
        if isinstance(layout_cache, str):
            from ..cache.layout import LayoutCache

            layout_cache = LayoutCache(layout_cache)
        self.layout_cache = layout_cache
        # fn(name, epoch) per epoch whose device state is released (swap,
        # last unpin of a replaced epoch, unregister).  A list: servers
        # sharing one registry each subscribe their own.  Listeners must
        # never call back into the registry.
        self._retire_listeners: list = []  # guarded-by: _lock
        # Per-name epoch counters that survive unregister: an in-flight
        # query pinned to epoch N never resolves against a re-registered
        # graph that reused N.
        self._next_epoch: dict[str, int] = {}  # guarded-by: _lock

    def add_retire_listener(self, fn) -> None:
        with self._lock:
            if fn not in self._retire_listeners:
                self._retire_listeners.append(fn)

    def remove_retire_listener(self, fn) -> None:
        with self._lock:
            if fn in self._retire_listeners:
                self._retire_listeners.remove(fn)

    # ------------------------------------------------------------- graphs --
    def register(self, name: str, graph: Graph | DeviceGraph | PullGraph, *,
                 engines: tuple[str, ...] = ()) -> RegisteredGraph:
        """Register ``graph`` under ``name``; optionally build layouts now.

        Accepts a host :class:`Graph` (every engine), or a prebuilt
        :class:`PullGraph` or :class:`DeviceGraph` (that engine only, and
        no oracle fallback without the host graph).  Re-registering a name
        is a hot swap (see the module text)."""
        if isinstance(graph, PullGraph):
            def make(e):
                return RegisteredGraph(name, None, graph.num_vertices, graph.num_edges,
                                       {"pull": graph}, epoch=e)
        elif isinstance(graph, DeviceGraph):
            def make(e):
                return RegisteredGraph(name, None, graph.num_vertices, graph.num_edges,
                                       {"push": graph}, epoch=e)
        elif isinstance(graph, Graph):
            def make(e):
                return RegisteredGraph(name, graph, graph.num_vertices, graph.num_edges,
                                       epoch=e)
        else:
            raise TypeError(f"cannot register {type(graph).__name__}")
        with self._lock:
            old = self._graphs.get(name)
            e = self._next_epoch.get(name, 0)
            self._next_epoch[name] = e + 1
            rec = make(e)
            self._graphs[name] = rec
            if old is not None:
                old.retired = True
                if old.pins <= 0:
                    self._retire(old)
                else:
                    self._retired[(name, old.epoch)] = old
                self._bump("epochs_swapped")
                from ..obs.spans import instant

                instant("registry.swap", graph=name, epoch=rec.epoch,
                        old_epoch=old.epoch, old_pins=old.pins)
        self._bury()
        for engine in engines:
            self._layout_for(rec, engine)
        return rec

    def get(self, name: str) -> RegisteredGraph:
        """The CURRENT epoch for ``name``."""
        with self._lock:
            try:
                return self._graphs[name]
            except KeyError:
                raise KeyError(f"graph {name!r} is not registered") from None

    def pin(self, name: str) -> RegisteredGraph:
        """The current epoch with its pin count raised; balance with
        :meth:`unpin`."""
        with self._lock:
            rec = self.get(name)
            rec.pins += 1
            return rec

    def unpin(self, rec: RegisteredGraph) -> None:
        """Drop one pin; a retired epoch whose last pin drops is released."""
        with self._lock:
            rec.pins -= 1
            if rec.retired and rec.pins <= 0:
                self._retire(rec)
        self._bury()

    def get_epoch(self, name: str, epoch: int) -> RegisteredGraph:
        """A specific epoch, current or retired-but-pinned; KeyError once
        it is gone."""
        with self._lock:
            rec = self._rec_for(name, epoch)
            if rec is None:
                raise KeyError(
                    f"graph {name!r} epoch {epoch} is gone (retired or "
                    "unregistered with no pins outstanding)"
                )
            return rec

    def names(self) -> list[str]:
        with self._lock:
            return list(self._graphs)

    def epoch(self, name: str) -> int:
        return self.get(name).epoch

    def unregister(self, name: str) -> None:
        """Drop a graph entirely, every epoch: its engines evicted, layouts
        forgotten.  Forced: pins do not defer it.  On a server, call
        ``server.unregister``, which also drops its runners and cached
        results."""
        with self._lock:
            for key in [k for k in self._resident if k[0] == name]:
                self._evict(key)
            dropped = []
            rec = self._graphs.pop(name, None)
            if rec is not None:
                dropped.append(rec)
            for k in [k for k in self._retired if k[0] == name]:
                dropped.append(self._retired.pop(k))
            for r in dropped:
                r.retired = True
                r.released = True
                r.layouts.clear()
                for fn in list(self._retire_listeners):
                    fn(name, r.epoch)
        self._bury()

    # bfs_tpu_torch: holds _lock
    def _rec_for(self, name: str, epoch: int) -> RegisteredGraph | None:
        rec = self._graphs.get(name)
        if rec is not None and rec.epoch == epoch:
            return rec
        return self._retired.get((name, epoch))

    # bfs_tpu_torch: holds _lock
    def _retire(self, rec: RegisteredGraph) -> None:
        """Release a replaced epoch (idempotent through ``rec.released``)."""
        if rec.released:
            return
        rec.released = True
        for key in [k for k in self._resident if k[0] == rec.name and k[1] == rec.epoch]:
            self._evict(key)
        self._retired.pop((rec.name, rec.epoch), None)
        rec.layouts.clear()
        self._bump("epochs_retired")
        for fn in list(self._retire_listeners):
            fn(rec.name, rec.epoch)

    # bfs_tpu_torch: holds _lock
    def _bump(self, counter: str, by: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump(counter, by)
        from ..obs.registry import get_registry

        get_registry().counter(counter, by)

    # ------------------------------------------------------------ layouts --
    def layout(self, name: str, engine: str):
        """The memoized host layout of the CURRENT epoch: a
        :class:`PullGraph`, a dst-sorted :class:`DeviceGraph` or a
        :class:`RelayGraph`."""
        return self._layout_for(self.get(name), engine)

    def _layout_for(self, rec: RegisteredGraph, engine: str):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        with self._lock:
            layout = rec.layouts.get(engine)
        if layout is not None:
            return layout
        if rec.graph is None:
            raise ValueError(
                f"graph {rec.name!r} was registered as a prebuilt "
                f"{list(rec.layouts)[0]!r} layout; engine {engine!r} needs the host Graph"
            )
        if engine == "pull":
            layout = self._build_pull(rec.graph)
        elif engine == "push":
            layout = build_device_graph(rec.graph)
        else:
            layout = self._build_relay(rec.graph)
        with self._lock:
            # A lost race builds twice; the first one stored is kept.
            layout = rec.layouts.setdefault(engine, layout)
        return layout

    def layout_info(self) -> dict:
        with self._lock:
            return dict(self.last_layout_info)

    def attach_metrics(self, metrics) -> None:
        """Adopt a metrics sink unless one is already attached."""
        with self._lock:
            if self.metrics is None:
                self.metrics = metrics

    def _note_disk(self, info: dict) -> None:
        with self._lock:
            metrics = self.metrics
        if metrics is not None and info.get("cache") == "hit":
            metrics.bump("layout_disk_hits")
        elif metrics is not None and info.get("cache") == "miss":
            metrics.bump("layout_disk_misses")

    def _build_pull(self, graph: Graph) -> PullGraph:
        if self.layout_cache is None:
            return build_pull_graph(graph)
        from ..cache.layout import load_or_build_pull

        pg, info = load_or_build_pull(graph, cache=self.layout_cache)
        self._note_disk(info)
        return pg

    def _build_relay(self, graph: Graph) -> RelayGraph:
        """The relay layout through :func:`load_or_build_relay` (built on
        the registry's device; from the bundle store when one is given);
        its info is kept in ``last_layout_info``."""
        from ..cache.layout import load_or_build_relay

        with DEVICE_LOCK:
            rg, info = load_or_build_relay(graph, cache=self.layout_cache,
                                           device=self.device)
        self._note_disk(info)
        with self._lock:
            self.last_layout_info = dict(info)
        return rg

    # ---------------------------------------------------------- residency --
    def acquire(self, name: str, engine: str):
        """The engine of the CURRENT epoch of ``name``."""
        return self.acquire_for(self.get(name), engine)

    def acquire_epoch(self, name: str, epoch: int, engine: str):
        """The engine of a specific epoch (a runner bound to a pinned
        snapshot)."""
        return self.acquire_for(self.get_epoch(name, epoch), engine)

    def resident(self, rec: RegisteredGraph, engine: str) -> bool:
        """Is the engine of this epoch resident (no upload on acquire)?"""
        key = (rec.name, rec.epoch, engine, _engine_env_fingerprint())
        with self._lock:
            return key in self._resident

    def acquire_for(self, rec: RegisteredGraph, engine: str):
        """The engine of one epoch, shipped within budget if not resident:
        an :class:`EdgeEngine` for pull and push, a :class:`RelayEngine`
        for relay.  Marks it most recently used and evicts LRU engines
        until the budget holds, skipping pinned epochs."""
        from ..models.bfs import EdgeEngine, RelayEngine

        layout = self._layout_for(rec, engine)
        key = (rec.name, rec.epoch, engine, _engine_env_fingerprint())
        with self._lock:
            hit = self._resident.get(key)
            if hit is None:
                # Room is made BEFORE the upload: victims leave first, or
                # the card would peak at budget + incoming.
                self._make_room(layout_device_bytes(layout, engine), keep=key)
        with DEVICE_LOCK:
            self._bury()
            if hit is not None:
                eng = hit[1]
                nbytes = device_bytes(eng)
                with self._lock:
                    if key in self._resident:
                        self._resident[key] = (nbytes, eng)
                        self._resident.move_to_end(key)
                        # A hit also settles a deferred-eviction overshoot.
                        self._make_room(0, keep=key)
                self._bury()
                return eng
            # The upload runs outside the registry lock: an abandoned
            # worker stuck in it must not freeze every pin and report.
            if engine == "relay":
                eng = RelayEngine(layout, device=self.device)
            else:
                eng = EdgeEngine(layout, engine=engine, device=self.device)
            nbytes = device_bytes(eng)
            with self._lock:
                if key in self._resident:  # lost an upload race: keep the first
                    self._resident.move_to_end(key)
                    self._graveyard.append(eng)
                    eng = self._resident[key][1]
                elif not rec.released:
                    self._resident[key] = (nbytes, eng)
                # else: the epoch was released during the upload (its last
                # unpin, or unregister): the engine goes to this caller
                # only, never into residency.
            self._bury()
            return eng

    # bfs_tpu_torch: holds _lock
    def _pinned(self, key) -> bool:
        rec = self._rec_for(key[0], key[1])
        return rec is not None and rec.pins > 0

    # bfs_tpu_torch: holds _lock
    def _make_room(self, incoming: int, *, keep) -> None:
        if self.device_budget_bytes is None:
            return
        while self._resident and self.resident_bytes() + incoming > self.device_budget_bytes:
            victim = next((k for k in self._resident if k != keep and not self._pinned(k)), None)
            if victim is None:
                if not any(k != keep for k in self._resident):
                    return  # ``keep`` alone over the budget: allowed, not a deferral
                # Every other engine serves an in-flight batch: defer (a
                # transient overshoot the next unpinned acquire settles).
                # Only an upload counts, not the hit path's settle.
                if incoming > 0:
                    self.evictions_deferred += 1
                    self._bump("eviction_deferred")
                    from ..obs.spans import instant

                    instant("registry.evict_deferred", graph=keep[0], engine=keep[2],
                            bytes=incoming)
                return
            self._evict(victim)

    # bfs_tpu_torch: holds _lock
    def _evict(self, key) -> None:
        nbytes, eng = self._resident.pop(key)
        self._graveyard.append(eng)  # freed on the card's lock (_bury)
        self.evictions += 1
        if self.metrics is not None:
            self.metrics.bump("evictions")
        from ..obs.registry import get_registry
        from ..obs.spans import instant

        instant("registry.evict", graph=key[0], engine=key[2], bytes=nbytes)
        get_registry().counter("graph_evictions")
        get_registry().counter("graph_evicted_bytes", nbytes)

    def _bury(self) -> None:
        """Free evicted engines if the card's lock is free (or held by this
        thread); else the next acquire does.  Never called with the
        registry lock held."""
        if not DEVICE_LOCK.acquire(blocking=False):
            return
        try:
            with self._lock:
                dead, self._graveyard = self._graveyard, []
            del dead
        finally:
            DEVICE_LOCK.release()

    def release(self, name: str, engine: str | None = None) -> None:
        """Evict one graph's engines across all epochs (all engines when
        ``engine`` is None); host layouts stay.  Forced: pins do not defer
        it."""
        with self._lock:
            for key in [k for k in self._resident
                        if k[0] == name and (engine is None or k[2] == engine)]:
                self._evict(key)
        self._bury()

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(b for b, _ in self._resident.values())

    def resident_keys(self) -> list[tuple[str, int, str]]:
        """Resident engines as ``(name, epoch, engine)``, in LRU order."""
        with self._lock:
            return [(k[0], k[1], k[2]) for k in self._resident]
