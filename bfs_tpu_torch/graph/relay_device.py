"""Device-side relay layout construction: the port of
``bfs_tpu.graph.relay_device``, the relay layout v4 built by torch programs
on the card.

The host builder (:func:`~bfs_tpu_torch.graph.relay.build_relay_graph`)
runs its stages one after another on the host; this builder runs the same
construction as torch programs on its device and overlaps the tail with
the net route:

  * **width classing**: the ``{2^k, 3*2^(k-1)}`` degree-class rule as an
    exact integer ``searchsorted`` over a static candidate table
    (:func:`relay.width_candidates`), then the per-width histograms, which
    fix every static size (:func:`relay.seg_classes_from_counts`);
  * **relabeling / out positions**: one stable sort per side and a
    boundary ``cummax`` rank;
  * **L1/L2 slots**: one stable sort of the int64 key ``dstn << 32 | src``
    (the one order that must hold: the in-row rank is the canonical
    min-parent), a stable sort by src out-position for the free L2 rank,
    and the class lookup as a ``searchsorted`` over the class starts;
  * **permutation assembly + identity padding**: scatters and a cumsum-rank
    matching of free outputs to free inputs, ascending (the host
    `_pad_identity` tie-break);
  * **mask compaction + stage tables** in one program per network;
  * **sparse CSR**: a stable sort by relabeled src;
  * **overlap**: the vperm assembly, route and compaction and the CSR run
    on a worker thread once the net route has started (the native route is
    a ctypes call, which releases the GIL).

The ``route`` argument (``auto|native|torch``) picks the Beneš router:
the native cycle-walking router, or the torch router
(:func:`route_masks_device`: pointer-jumping orbit-min coloring, the
reference's pure-JAX router, mask for mask).  ``auto`` takes ``native``
where it builds.  The two routers' masks may differ (any valid coloring
routes the permutation); every other field is byte-identical either way.
The host builder is the oracle; these programs run on any device, the
CPU included.

Torch has no dropped scatter: where the reference drops out-of-range
indices, the programs write into one scratch slot past the end and cut it
off.  On a card every host sync of a build goes through :func:`_host_sync`,
which names its reason in ``stage_times["host_syncs"]``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time
from typing import Any

import numpy as np
import torch

from ..ops.packed import i32
from . import benes
from .csr import INF_DIST, DeviceGraph, Graph
from .relay import (
    COMPACT_MIN_D,
    RelayGraph,
    StageSpec,
    _phase,
    _width_class_map,
    extract_edges,
    seg_classes_from_counts,
    width_candidates,
)

#: Candidate widths shipped to the device (int32: degrees to 2^30; a larger
#: degree drops out of the histograms and the build raises).
_CANDIDATES = width_candidates(1 << 30).astype(np.int32)

#: The worker of the overlapped tail (threads start at the first build).
_TRACK_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=2, thread_name_prefix="relay-build"
)

#: Serializes the allowed host syncs of concurrent tracks (the CUDA sync
#: debug mode is process-wide).
_SYNC_LOCK = threading.Lock()


def resolve_route(route: str | None = None) -> str:
    """The route arm: ``native`` or ``torch`` as given; ``None`` or
    ``auto`` takes native where the router builds, else torch."""
    route = route or "auto"
    if route == "auto":
        return "native" if benes.native_available() else "torch"
    if route not in ("native", "torch"):
        raise ValueError(f"unknown route arm {route!r}; use auto|native|torch")
    return route


@contextlib.contextmanager
def _host_sync(device: torch.device, why: str, syncs: dict):
    """Mark a host sync the build needs (``why``): counted in ``syncs``
    and, on a card, let through a sync debug mode of ``error``.  The mode
    is process-wide: while one track holds the lock, a hidden sync of the
    other goes unreported (the card test runs the tracks serialized)."""
    with _SYNC_LOCK:
        syncs[why] = syncs.get(why, 0) + 1
        if device.type != "cuda":
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


# --------------------------------------------------------------------------
# Device programs: plain torch, no host read.
# --------------------------------------------------------------------------

def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _marked(n: int, idx: torch.Tensor) -> torch.Tensor:
    """bool[n], True at ``idx`` (the value a device tensor: a Python
    scalar would be copied from the host, a sync)."""
    out = torch.zeros(n, dtype=torch.bool, device=idx.device)
    out[idx] = torch.ones((), dtype=torch.bool, device=idx.device)
    return out


def _count(n: int, idx: torch.Tensor) -> torch.Tensor:
    """int32[n] occurrence counts of ``idx`` (values in [0, n))."""
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def _degree_hist_program(src, dst, candidates, num_vertices: int):
    """Per-vertex width-class indices and per-width histograms.  A degree
    beyond the table indexes one past it and lands in a scratch slot, so
    ``hist.sum() < V`` flags the overflow, as the reference's dropped
    scatter does."""
    indeg = _count(num_vertices, dst)
    outdeg = _count(num_vertices, src)
    nc = candidates.shape[0]
    in_widx = torch.searchsorted(candidates, indeg.clamp_min(1), out_int32=True)
    out_widx = torch.searchsorted(candidates, outdeg.clamp_min(1), out_int32=True)
    return in_widx, out_widx, _count(nc + 1, in_widx)[:nc], _count(nc + 1, out_widx)[:nc]


def _rank_in_runs(keys_sorted, idx):
    """Stable rank within the equal-key runs of an ascending key array:
    ``idx - run_start`` by a boundary cummax."""
    boundary = torch.ones_like(keys_sorted, dtype=torch.bool)
    boundary[1:] = keys_sorted[1:] != keys_sorted[:-1]
    run_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    return idx - run_start


def _place(widx, va_by_widx):
    """Class-major, original-id-minor placement: class start + stable rank
    within the width group."""
    n = widx.shape[0]
    idx = _iota(n, widx.device)
    ws, order = torch.sort(widx, stable=True)
    out = torch.empty(n, dtype=torch.int32, device=widx.device)
    out[order] = va_by_widx[ws] + _rank_in_runs(ws, idx)
    return out


def _relabel_program(in_widx, out_widx, in_va, out_va, vr: int):
    """old->new relabeling (dst side) and out-order positions (src side)."""
    v = in_widx.shape[0]
    old2new = _place(in_widx, in_va)
    new2old = torch.full((vr,), -1, dtype=torch.int32, device=in_widx.device)
    new2old[old2new] = _iota(v, in_widx.device)
    return new2old, old2new, _place(out_widx, out_va)


def _base_stride(ids, va_bounds, sa, count, width, vmaj):
    """Per-id slot table lookup: the class by ``searchsorted`` over the
    class starts, then rank-major (``base = sa + p``, ``stride = count``)
    or vertex-major (``base = sa + p*width``, ``stride = 1``)."""
    ci = torch.searchsorted(va_bounds, ids, right=True, out_int32=True) - 1
    p = ids - va_bounds[ci]
    vm, s = vmaj[ci], sa[ci]
    base = torch.where(vm, s + p * width[ci], s + p)
    stride = torch.where(vm, 1, count[ci])
    return base, stride


def _slots_program(src, dst, old2new, outpos_of_old, in_tabs, out_tabs, m1: int):
    """L1/L2 slot assignment.

    L1: edges stable-sorted by (relabeled dst, ORIGINAL src), one int64 key
    sort; the in-row rank is the canonical min-parent.  L2: a stable sort
    by src out-position alone, which makes the rank the host's edge-order
    counting rank."""
    e = src.shape[0]
    dev = src.device
    idx = _iota(e, dev)
    dstn = old2new[dst]
    key = (dstn.to(torch.int64) << 32) | src.to(torch.int64)
    key, order1 = torch.sort(key, stable=True)
    ds = (key >> 32).to(torch.int32)
    ss = (key & 0xFFFFFFFF).to(torch.int32)
    del key
    base1, stride1 = _base_stride(ds, *in_tabs)
    l1_sorted = base1 + _rank_in_runs(ds, idx) * stride1
    del ds, base1, stride1
    src_l1 = torch.full((m1,), INF_DIST, dtype=torch.int32, device=dev)
    src_l1[l1_sorted] = ss
    l1_by_edge = torch.empty(e, dtype=torch.int32, device=dev)
    l1_by_edge[order1] = l1_sorted
    del ss, l1_sorted, order1

    sp, order2 = torch.sort(outpos_of_old[src], stable=True)
    base2, stride2 = _base_stride(sp, *out_tabs)
    l2_by_edge = torch.empty(e, dtype=torch.int32, device=dev)
    l2_by_edge[order2] = base2 + _rank_in_runs(sp, idx) * stride2
    return src_l1, l1_by_edge, l2_by_edge, dstn, old2new[src]


def _pad_identity_program(perm, used):
    """`_pad_identity` on the device: identity wiring where both pair
    members are free, then free outputs matched to free inputs ascending
    (cumsum ranks), the host tie-break exactly."""
    n = perm.shape[0]
    idx = _iota(n, perm.device)
    both = (perm < 0) & ~used
    perm = torch.where(both, idx, perm)
    used = used | both
    fo = perm < 0
    fi = ~used
    ro = torch.cumsum(fo, 0, dtype=torch.int32) - 1
    ri = torch.cumsum(fi, 0, dtype=torch.int32) - 1
    pos_by_rank = torch.zeros(n + 1, dtype=torch.int32, device=perm.device)
    pos_by_rank[torch.where(fo, ro, n)] = idx  # slot n: scratch
    target = pos_by_rank[torch.where(fi, ri, 0)]
    out = torch.cat([perm, perm.new_zeros(1)])
    out[torch.where(fi, target, n)] = idx
    return out[:n]


def _net_assembly_program(l1_by_edge, l2_by_edge, n: int):
    """Big-network permutation (L1 slot <- L2 slot), identity-padded."""
    dev = l1_by_edge.device
    net = torch.full((n,), -1, dtype=torch.int32, device=dev)
    net[l1_by_edge] = l2_by_edge
    return _pad_identity_program(net, _marked(n, l2_by_edge))


def _vperm_assembly_program(outpos_of_old, old2new, vp: int, vr: int, out_vb: int):
    """vperm: real out positions <- relabeled owner id, dummy positions
    (ascending) <- the guaranteed-zero inputs [vr, vp)."""
    dev = outpos_of_old.device
    vfront = torch.full((out_vb,), -1, dtype=torch.int32, device=dev)
    vfront[outpos_of_old] = old2new
    real = _marked(out_vb, outpos_of_old)
    dummy_rank = torch.cumsum(~real, 0, dtype=torch.int32) - 1
    vfront = torch.where(real, vfront, vr + dummy_rank)
    vperm = torch.cat([vfront, torch.full((vp - out_vb,), -1, dtype=torch.int32, device=dev)])
    return _pad_identity_program(vperm, _marked(vp, vfront))


def _csr_program(srcn, dstn, l1_by_edge, vr: int):
    """Sparse-path CSR grouped by relabeled src: a stable sort gives the
    host counting sort's edge order."""
    _, order = torch.sort(srcn, stable=True)
    cum = torch.cumsum(_count(vr, srcn), 0, dtype=torch.int32)
    indptr = torch.cat([cum.new_zeros(1), cum, cum[-1:]])
    return indptr, dstn[order], l1_by_edge[order]


def _pack_words(bits):
    """bool[n] -> int32[n/32] bit patterns of the uint32 words, standard
    packing (through int64: torch's uint32 has few ops)."""
    b = bits.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return i32((b << shifts).sum(dim=1))


def _route_level_program(perm, d: int, iters: int):
    """One Beneš level: 2-color the pair constraint cycles and derive the
    two stage masks and the next level's sub-permutation.

    Along a constraint cycle outputs alternate between the output-pair
    matching (``j <-> j^d``) and the shared-input matching (``j <->
    inv[perm[j]^d]``); two steps (``f``) keep the subnetwork side, so each
    cycle splits into two f-orbits.  ``iters`` pointer-jumping doublings of
    ``min`` give each orbit its minimum; the orbit whose minimum is below
    its pair orbit's goes through the upper subnetwork."""
    n = perm.shape[0]
    idx = _iota(n, perm.device)
    inv = torch.empty_like(perm)
    inv[perm] = idx
    f = inv[perm[idx ^ d] ^ d]
    r, g = idx, f
    for _ in range(iters):  # both from the old r and g
        r, g = torch.minimum(r, r.index_select(0, g)), g.index_select(0, g)
    color = r > r[idx ^ d]  # True: through the lower subnetwork
    low = (idx & d) == 0
    obits = color & low
    ibits = color[inv] & low
    dst = torch.where(obits[idx & ~d], idx ^ d, idx)
    i0 = perm[dst]
    perm_next = torch.where(ibits[i0 & ~d], i0 ^ d, i0)
    return _pack_words(ibits), _pack_words(obits), perm_next


def _route_mid_program(perm):
    """The middle (d = 1) stage: swap a pair iff its sub-permutation
    crosses it."""
    idx = _iota(perm.shape[0], perm.device)
    return _pack_words(((idx & 1) == 0) & (perm != idx))


def route_masks_device(perm, *, n: int, device=None) -> torch.Tensor:
    """The torch Beneš router: standard-packed masks as int32 bit patterns
    ``[stages, n/32]`` on ``perm``'s device (or ``device`` for a host
    array) for ``y[j] = x[perm[j]]``, the masks of the reference's
    ``route_masks_device`` bit for bit."""
    if n < 32 or n & (n - 1):
        raise ValueError(f"network size {n} is not a power of two >= 32")
    if not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int32)).to(device)
    perm = perm.to(torch.int32)
    k = n.bit_length() - 1
    masks_in, masks_out = [], []
    for level in range(k - 1):
        d = n >> (level + 1)
        m_in, m_out, perm = _route_level_program(perm, d, max(d.bit_length(), 1))
        masks_in.append(m_in)
        masks_out.append(m_out)
    return torch.stack(masks_in + [_route_mid_program(perm)] + masks_out[::-1])


def _compact_program(masks, n: int):
    """`_compact_and_table`'s stage loop on the device: pair-compact every
    stage with ``d >= COMPACT_MIN_D`` and find each stage's stored nonzero
    word range ``[first, last + 1)`` (``(0, 0)`` when all zero)."""
    parts, nz = [], []
    for s in range(benes.num_stages(n)):
        d = benes.stage_distance(n, s)
        w = masks[s]
        if d >= COMPACT_MIN_D:
            w = w.reshape(-1, 2, d >> 5)[:, 0, :].reshape(-1)
        nzv = (w != 0).to(torch.int32)
        first = torch.argmax(nzv)
        last = w.shape[0] - 1 - torch.argmax(nzv.flip(0))
        rng = torch.stack([first, last + 1])
        parts.append(w)
        nz.append(torch.where(nzv.any(), rng, torch.zeros_like(rng)))
    return torch.cat(parts), torch.stack(nz)


# --------------------------------------------------------------------------
# The builder.
# --------------------------------------------------------------------------

def _class_tables(classes, device):
    """The per-class lookup arrays `_base_stride` reads."""
    return (
        torch.tensor([c.va for c in classes], dtype=torch.int32, device=device),
        torch.tensor([c.sa for c in classes], dtype=torch.int32, device=device),
        torch.tensor([c.count for c in classes], dtype=torch.int32, device=device),
        torch.tensor([c.width for c in classes], dtype=torch.int32, device=device),
        torch.tensor([c.vertex_major for c in classes], dtype=torch.bool, device=device),
    )


def _va_by_widx(classes, widths, device) -> torch.Tensor:
    """Class slot start per candidate-width index (0 where absent)."""
    cmap = _width_class_map(classes)
    out = np.zeros(_CANDIDATES.shape[0], dtype=np.int32)
    for wv in np.asarray(widths).tolist():
        out[int(np.searchsorted(_CANDIDATES, wv))] = cmap[int(wv)].va
    return torch.from_numpy(out).to(device)


def _stage_table(n: int, nz: np.ndarray) -> tuple[StageSpec, ...]:
    """StageSpecs from the compaction program's nonzero ranges, with the
    host builder's 1024-word block quantization where the stored word
    count is block-aligned."""
    table = []
    offset = 0
    for s in range(benes.num_stages(n)):
        d = benes.stage_distance(n, s)
        compact = d >= COMPACT_MIN_D
        nwords = n // 64 if compact else n // 32
        lo, hi = int(nz[s, 0]), int(nz[s, 1])
        if nwords % 1024 == 0 and hi > 0:
            lo = (lo // 1024) * 1024
            hi = ((hi - 1) // 1024 + 1) * 1024
        table.append(StageSpec(d=d, offset=offset, nwords=nwords, compact=compact, lo=lo, hi=hi))
        offset += nwords
    return tuple(table)


def _host(t: torch.Tensor, syncs: dict, why: str) -> np.ndarray:
    """A host numpy copy of a tensor."""
    with _host_sync(t.device, why, syncs):
        return t.cpu().numpy()


def _resolve_device(device) -> torch.device:
    """The card unless the caller names another device; no card and no
    device raises."""
    from ..models.bfs import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_relay_graph_device(
    graph: Graph | DeviceGraph,
    *,
    device=None,
    route: str | None = None,
    stage_times: dict | None = None,
) -> RelayGraph:
    """Build the relay layout with the device pipeline (module docstring):
    byte-identical to :func:`relay.build_relay_graph` under the ``native``
    route, every non-mask field byte-identical under ``torch``.

    Runs on the card unless ``device`` names another (``"cpu"``).
    ``stage_times`` gets each stage's wall seconds (on a card each stage
    ends in a sync), the resolved ``route`` and ``device`` and
    ``host_syncs`` (reason -> count)."""
    dev = _resolve_device(device)
    times: dict[str, Any] = stage_times if stage_times is not None else {}
    route = resolve_route(route)
    if route == "native" and not benes.native_available():
        raise RuntimeError("route='native' needs the native benes router")
    times.update(route=route, device=str(dev))
    syncs: dict[str, int] = {}
    times["host_syncs"] = syncs

    from ..obs.spans import span as obs_span

    def timed(name, fn):
        """Run ``fn`` as build stage ``name``, its wall seconds added to
        ``times`` (on a card the stage ends in a sync)."""
        with _phase(f"dev {name}"):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                with _host_sync(dev, "stage timing", syncs):
                    torch.cuda.synchronize(dev)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    def ingest():
        src_h, dst_h, v, e = extract_edges(graph)
        with _host_sync(dev, "ingest", syncs):
            ts = tuple(torch.from_numpy(a).to(dev) for a in (src_h, dst_h, _CANDIDATES))
        return (*ts, v, e)

    src, dst, cand, v, e = timed("ingest", ingest)
    in_widx, out_widx, in_hist, out_hist = timed(
        "layout.device_hist", lambda: _degree_hist_program(src, dst, cand, v)
    )

    def classes():
        ih = _host(in_hist, syncs, "degree histograms")
        oh = _host(out_hist, syncs, "degree histograms")
        if int(ih.sum()) != v or int(oh.sum()) != v:
            raise RuntimeError(
                "graph degree exceeds the device builder's 2^30 width table; "
                "use the host builder"
            )
        meta = seg_classes_from_counts(
            _CANDIDATES[ih > 0].astype(np.int64), ih[ih > 0].astype(np.int64),
            _CANDIDATES[oh > 0].astype(np.int64), oh[oh > 0].astype(np.int64), v,
        )
        with _host_sync(dev, "class tables", syncs):
            tables = (
                _va_by_widx(meta.in_classes, meta.widths, dev),
                _va_by_widx(meta.out_classes, meta.owidths, dev),
                _class_tables(meta.in_classes, dev),
                _class_tables(meta.out_classes, dev),
            )
        return meta, tables

    meta, (in_va, out_va, in_tabs, out_tabs) = timed("classes", classes)
    new2old, old2new, outpos_of_old = timed(
        "layout.device_relabel",
        lambda: _relabel_program(in_widx, out_widx, in_va, out_va, meta.vr),
    )

    def route_and_compact(perm: torch.Tensor, n: int, name: str):
        """Route one network and compact its masks, on the calling thread."""
        with obs_span(f"layout.device.route_{name}"), _phase(f"dev {name} route"):
            t0 = time.perf_counter()
            if route == "native":
                masks = benes.route_std(_host(perm, syncs, "route input"), trusted=True)
                with _host_sync(dev, "masks to the device", syncs):
                    masks = torch.from_numpy(masks.view(np.int32)).to(dev)
            else:
                masks = route_masks_device(perm, n=n)
                if dev.type == "cuda":
                    with _host_sync(dev, "stage timing", syncs):
                        torch.cuda.synchronize(dev)
            times[f"route_{name}"] = time.perf_counter() - t0
        with _phase(f"dev {name} compact"):
            t0 = time.perf_counter()
            flat, nz = _compact_program(masks, n)
            del masks
            out = flat, _stage_table(n, _host(nz, syncs, "stage ranges"))
            times[f"compact_{name}"] = time.perf_counter() - t0
        return out

    # ---- overlapped tail: net route || (vperm network + sparse CSR) -------
    # The net chain (slots -> assembly -> route -> compaction) stays on this
    # thread; a worker builds, routes and compacts the vperm network and the
    # sparse CSR, started once the net route starts.
    box: dict[str, Any] = {}
    route_started = threading.Event()

    def tail_track():
        route_started.wait()
        if "slots" not in box:
            return  # the main track failed before its route
        l1_by_edge, dstn, srcn = box["slots"]
        vperm = timed(
            "layout.device_vperm_assembly",
            lambda: _vperm_assembly_program(
                outpos_of_old, old2new, meta.vp, meta.vr, meta.out_vb),
        )
        box["vperm"] = route_and_compact(vperm, meta.vp, "vperm")
        del vperm
        box["csr"] = timed(
            "layout.device_csr", lambda: _csr_program(srcn, dstn, l1_by_edge, meta.vr)
        )

    worker = _TRACK_POOL.submit(tail_track)
    try:
        src_l1, l1_by_edge, l2_by_edge, dstn, srcn = timed(
            "layout.device_slots",
            lambda: _slots_program(src, dst, old2new, outpos_of_old, in_tabs, out_tabs,
                                   meta.m1),
        )
        del src, dst
        box["slots"] = (l1_by_edge, dstn, srcn)
        net = timed(
            "layout.device_net_assembly",
            lambda: _net_assembly_program(l1_by_edge, l2_by_edge, meta.n),
        )
        del l2_by_edge
        route_started.set()
        net_masks, net_table = route_and_compact(net, meta.n, "net")
        del net
    except BaseException:
        # Unblock and drain the worker without masking this track's error.
        route_started.set()
        with contextlib.suppress(Exception):
            worker.result()
        raise
    worker.result()  # re-raises a failure of the worker's track
    vperm_masks, vperm_table = box.pop("vperm")
    adj_indptr, adj_dst, adj_slot = box.pop("csr")
    box.clear()

    # ---- finalize: the host-resident layout --------------------------------
    def finalize():
        def host(t):
            return _host(t, syncs, "finalize")

        return RelayGraph(
            num_vertices=v,
            num_edges=e,
            vr=meta.vr,
            new2old=host(new2old),
            old2new=host(old2new),
            vperm_masks=host(vperm_masks).view(np.uint32),
            vperm_table=vperm_table,
            vperm_size=meta.vp,
            out_classes=meta.out_classes,
            out_space=meta.out_vb,
            net_masks=host(net_masks).view(np.uint32),
            net_table=net_table,
            net_size=meta.n,
            m1=meta.m1,
            m2=meta.m2,
            in_classes=meta.in_classes,
            src_l1=host(src_l1),
            adj_indptr=host(adj_indptr).astype(np.int32, copy=False),
            adj_dst=host(adj_dst),
            adj_slot=host(adj_slot),
        )

    return timed("finalize", finalize)
