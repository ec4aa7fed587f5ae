"""Persistent layout-bundle cache: the port of ``bfs_tpu.cache.layout``
(relay and pull bundles, and the tiles and labels sidecars), a layout built
once per graph.

A layout is a pure function of (graph content, layout parameters, layout
code version), so finished layouts are stored as content-addressed bundles
on disk, in the reference's format byte for byte: a bundle that either
package writes loads in the other.

  * **bundle**: one directory ``<root>/<key>/`` holding ``meta.json`` and
    one ``.npy`` file per array.  Arrays over 8 MiB load back as
    ``np.memmap`` views, so a warm load reads headers; the bytes stream in
    when the engine ships them to the card.
  * **key**: ``{kind}_{layout params}_s{STORE_VERSION}_{graph hash}``, the
    graph hash a blake2b over ``(V, E, src, dst)``.
  * **integrity**: every field records dtype, shape and a head+tail
    fingerprint; a failed check drops the bundle and reports a miss.
  * **atomicity**: a bundle is written to a ``.tmp.<pid>`` sibling and
    renamed into place; the first finished rename wins.
  * **tags**: ``tags/<name>.json`` -> key aliases.

One divergence from the reference: :func:`load_or_build_relay` and
:func:`load_or_build_tiles` have no fallback.  The reference builds on the
host when its device builder raises; here a failing device build raises.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any

import numpy as np

from .. import knobs
from ..utils.metrics import bump_artifact

logger = logging.getLogger(__name__)

#: The bundle disk format's version, part of every key (the reference's).
STORE_VERSION = 1

#: Elements hashed from each end of an array for its fingerprint.
_FPR_ELEMS = 16384

#: Arrays at or under this many bytes load eagerly; larger ones memmap.
_MMAP_MIN_BYTES = 1 << 23


def default_root() -> str:
    from ..config import layout_cache_dir

    return layout_cache_dir()


def graph_content_hash(graph) -> str:
    """blake2b-128 over ``(num_vertices, E, src dtype, src bytes, dst
    bytes)`` of anything with ``num_vertices``/``src``/``dst``; memoized
    on the object."""
    cached = getattr(graph, "_content_hash", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    src = np.ascontiguousarray(np.asarray(graph.src).reshape(-1))
    dst = np.ascontiguousarray(np.asarray(graph.dst).reshape(-1))
    h.update(np.int64(graph.num_vertices).tobytes())
    h.update(np.int64(src.shape[0]).tobytes())
    h.update(str(src.dtype).encode())
    h.update(memoryview(src))
    h.update(memoryview(dst))
    digest = h.hexdigest()
    try:
        object.__setattr__(graph, "_content_hash", digest)
    except (AttributeError, TypeError):
        pass
    return digest


#: The knobs each bundle key hashes (the ``layout``, ``tiles`` and
#: ``labels`` domains of the knobs' ``affects``; the knob rung proves
#: them).  None: every builder arm writes the same bytes, so a bundle is a
#: function of the graph and the layout code alone, and the keys stay the
#: reference's.
_LAYOUT_ENV: tuple = ()
_TILES_ENV: tuple = ()
_LABELS_ENV: tuple = ()


def _env_suffix(names: tuple) -> str:
    """The raw values of ``names`` folded into a key: "" for no knob."""
    if not names:
        return ""
    h = hashlib.blake2b(";".join(f"{n}={knobs.raw(n)}" for n in names).encode(), digest_size=6)
    return f"_e{h.hexdigest()}"


def relay_key(graph) -> str:
    from ..graph.relay import COMPACT_MIN_D, LAYOUT_VERSION

    return (
        f"relay_v{LAYOUT_VERSION}c{COMPACT_MIN_D}_s{STORE_VERSION}"
        f"_{graph_content_hash(graph)}{_env_suffix(_LAYOUT_ENV)}"
    )


def pull_key(graph, k: int, row_multiple: int) -> str:
    return (f"pull_k{k}r{row_multiple}_s{STORE_VERSION}_{graph_content_hash(graph)}"
            f"{_env_suffix(_LAYOUT_ENV)}")


def _fingerprint(arr: np.ndarray) -> str:
    """dtype + shape + head/tail sample; reads no more of a memmap."""
    arr = np.asarray(arr)
    h = hashlib.blake2b(digest_size=8)
    h.update(str(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    flat = arr.reshape(-1)
    take = min(int(flat.shape[0]), _FPR_ELEMS)
    h.update(np.ascontiguousarray(flat[:take]).tobytes())
    h.update(np.ascontiguousarray(flat[flat.shape[0] - take :]).tobytes())
    return h.hexdigest()


class LayoutCache:
    """Content-addressed bundle store under one root directory."""

    def __init__(self, root: str | None = None):
        self.root = root or default_root()

    def _dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    def has(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self._dir(key), "meta.json"))

    def save(self, key: str, arrays: dict[str, np.ndarray],
             meta: dict[str, Any] | None = None, *, tag: str | None = None) -> None:
        """Write a bundle atomically; ``meta`` is free-form JSON (build
        seconds, provenance)."""
        final = self._dir(key)
        tmp = f"{final}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        try:
            fields = {}
            for name, arr in arrays.items():
                arr = np.asarray(arr)
                np.save(os.path.join(tmp, f"{name}.npy"), arr)
                fields[name] = {
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "fingerprint": _fingerprint(arr),
                }
            doc = {
                "key": key,
                "store_version": STORE_VERSION,
                "created": time.time(),
                "fields": fields,
                "meta": meta or {},
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            if os.path.isdir(final):
                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
            else:
                try:
                    os.rename(tmp, final)
                except OSError:
                    shutil.rmtree(tmp, ignore_errors=True)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if tag:
            self.tag(tag, key)

    def load(self, key: str, *, mmap: bool = True):
        """``(meta_doc, arrays)`` of a valid bundle, else None.  A field
        that fails its dtype/shape/fingerprint check, or a stale key or
        store version, drops the bundle (a rebuild, never a wrong layout);
        an OS error reports a miss and keeps it."""
        d = self._dir(key)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.isfile(meta_path):
            return None
        try:
            with open(meta_path) as f:
                doc = json.load(f)
            if doc.get("key") != key or doc.get("store_version") != STORE_VERSION:
                raise ValueError("bundle key/store-version mismatch")
            arrays = {}
            for name, spec in doc["fields"].items():
                nbytes = int(
                    np.dtype(spec["dtype"]).itemsize * max(int(np.prod(spec["shape"] or [1])), 1)
                )
                arr = np.load(
                    os.path.join(d, f"{name}.npy"),
                    mmap_mode="r" if (mmap and nbytes > _MMAP_MIN_BYTES) else None,
                )
                if (
                    str(arr.dtype) != spec["dtype"]
                    or list(arr.shape) != spec["shape"]
                    or _fingerprint(arr) != spec["fingerprint"]
                ):
                    raise ValueError(f"integrity check failed on field {name!r}")
                arrays[name] = arr
            return doc, arrays
        except (OSError, MemoryError) as exc:
            logger.warning("layout bundle %s unreadable (kept): %s", key, exc)
            return None
        except Exception as exc:
            logger.warning("dropping corrupt/stale layout bundle %s: %s", key, exc)
            self.invalidate(key)
            return None

    def invalidate(self, key: str) -> None:
        shutil.rmtree(self._dir(key), ignore_errors=True)

    def _tag_path(self, tag: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in tag)
        return os.path.join(self.root, "tags", f"{safe}.json")

    def tag(self, tag: str, key: str) -> None:
        """Alias ``tag`` -> ``key`` (an atomic one-file write)."""
        path = self._tag_path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"key": key}, f)
        os.replace(tmp, path)

    def resolve_tag(self, tag: str) -> str | None:
        """The key a tag points at, iff that bundle exists."""
        try:
            with open(self._tag_path(tag)) as f:
                key = json.load(f)["key"]
        except (OSError, ValueError, KeyError):
            return None
        return key if self.has(key) else None


def _load_or_build(graph, *, cache, tag, kind, key_fn, build_fn, to_arrays,
                   from_arrays, build_meta: dict | None = None):
    """The load-or-build skeleton and its ``info`` contract: ``cache``
    ("hit"/"miss"/"disabled"), ``key``, ``load_seconds`` (hit) or
    ``save_seconds`` (miss), and ``build_seconds`` (on a hit, the cold
    build's, recorded in the bundle).  ``build_meta`` (builder, stage
    seconds) is saved with a built bundle, replayed from it on a hit, and
    merged into the info either way."""
    from ..obs.spans import span as obs_span

    build_meta = build_meta if build_meta is not None else {}
    if cache is None:
        t0 = time.perf_counter()
        with obs_span("layout.build", kind=kind):
            obj = build_fn()
        return obj, {
            "cache": "disabled",
            "build_seconds": time.perf_counter() - t0,
            **build_meta,
        }
    t0 = time.perf_counter()
    key = key_fn()
    with obs_span("layout.bundle_load", kind=kind):
        loaded = cache.load(key)
    if loaded is not None:
        doc, arrays = loaded
        obj = from_arrays(arrays)
        bump_artifact("layout_cache_hits")
        if tag:
            cache.tag(tag, key)
        meta = doc["meta"]
        return obj, {
            "cache": "hit",
            "key": key,
            "load_seconds": time.perf_counter() - t0,
            "build_seconds": float(meta.get("build_seconds", -1.0)),
            **{k: meta[k] for k in ("builder", "build_stages") if k in meta},
        }
    bump_artifact("layout_cache_misses")
    t1 = time.perf_counter()
    with obs_span("layout.build", kind=kind):
        obj = build_fn()
    build_seconds = time.perf_counter() - t1
    t2 = time.perf_counter()
    with obs_span("layout.bundle_save", kind=kind):
        cache.save(
            key,
            to_arrays(obj),
            {
                "kind": kind,
                "build_seconds": build_seconds,
                "num_vertices": int(getattr(obj, "num_vertices", -1)),
                "num_edges": int(getattr(obj, "num_edges", -1)),
                **build_meta,
            },
            tag=tag,
        )
    return obj, {
        "cache": "miss",
        "key": key,
        "build_seconds": build_seconds,
        "save_seconds": time.perf_counter() - t2,
        **build_meta,
    }


def resolve_builder(builder: str | None = None) -> str:
    """Relay builder: explicit arg > ``BFS_TPU_TORCH_LAYOUT_BUILD`` >
    ``device`` (``host`` is the oracle builder)."""
    builder = builder or knobs.get("BFS_TPU_TORCH_LAYOUT_BUILD")
    if builder not in ("device", "host"):
        raise ValueError(f"unknown layout builder {builder!r}; use device|host")
    return builder


def load_or_build_relay(graph, *, cache: LayoutCache | None = None,
                        tag: str | None = None, builder: str | None = None,
                        device=None):
    """``(RelayGraph, info)``: the relay layout, from its bundle or built
    and saved (info contract: :func:`_load_or_build`).

    ``builder`` selects the device pipeline
    (:func:`~bfs_tpu_torch.graph.relay_device.build_relay_graph_device` on
    ``device``, the card unless ``"cpu"``; the default) or the host oracle
    builder.  Their bundles are byte-identical, so the builder never splits
    the cache.  A device build that raises is not retried on the host."""
    from ..graph.relay import build_relay_graph, relay_from_arrays, relay_to_arrays

    builder = resolve_builder(builder)
    stage_times: dict = {}
    build_meta = {"builder": builder, "build_stages": stage_times}

    def build():
        if builder == "device":
            from ..graph.relay_device import build_relay_graph_device

            return build_relay_graph_device(graph, device=device, stage_times=stage_times)
        return build_relay_graph(graph, stage_times=stage_times)

    return _load_or_build(
        graph,
        cache=cache,
        tag=tag,
        kind="relay",
        key_fn=lambda: relay_key(graph),
        build_fn=build,
        to_arrays=relay_to_arrays,
        from_arrays=relay_from_arrays,
        build_meta=build_meta,
    )


def load_or_build_pull(graph, *, k: int | None = None, row_multiple: int = 64,
                       cache: LayoutCache | None = None, tag: str | None = None):
    """``(PullGraph, info)``: the ELL pull layout, from its bundle or built
    and saved (info contract: :func:`_load_or_build`)."""
    from ..graph.ell import DEFAULT_K, build_pull_graph, pull_from_arrays, pull_to_arrays

    k = DEFAULT_K if k is None else int(k)
    return _load_or_build(
        graph,
        cache=cache,
        tag=tag,
        kind="pull",
        key_fn=lambda: pull_key(graph, k, row_multiple),
        build_fn=lambda: build_pull_graph(graph, k=k, row_multiple=row_multiple),
        to_arrays=pull_to_arrays,
        from_arrays=pull_from_arrays,
    )


def tiles_key(rg) -> str:
    """Content key of the MXU arm's tiles bundle, a sidecar beside the relay
    bundle: blake2b over the relay layout's relabeled edges and relabel
    table (what the tile builder reads), the reference's key."""
    from ..graph.adj_tiles import TILES_VERSION

    h = hashlib.blake2b(digest_size=16)
    for arr in (rg.adj_indptr, rg.adj_dst, rg.new2old):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode())
        h.update(memoryview(a))
    h.update(np.int64(rg.vr).tobytes())
    return f"adjtiles_v{TILES_VERSION}_s{STORE_VERSION}_{h.hexdigest()}{_env_suffix(_TILES_ENV)}"


def load_or_build_tiles(rg, *, cache: LayoutCache | None = None,
                        builder: str | None = None, budget_bytes: int | None = None,
                        device="cpu"):
    """``(AdjTiles, info)``: the MXU arm's tiles, from their bundle or built
    (``builder``: :func:`~bfs_tpu_torch.graph.adj_tiles.resolve_tiles_builder`;
    the device builder runs on ``device``) and saved (info contract:
    :func:`_load_or_build`).  ``BFS_TPU_TORCH_TILES_CACHE=1`` uses the
    default store when the caller passes none; otherwise nothing is kept.
    A bundle loads on the CPU (memmapped where large).  A device build that
    raises is not retried on the host.  ``budget_bytes`` gates warm hits
    too: the key does not hold the budget."""
    from ..graph.adj_tiles import (
        build_adj_tiles_from_relay,
        resolve_tiles_builder,
        tiles_from_arrays,
        tiles_to_arrays,
    )

    if cache is None and knobs.get("BFS_TPU_TORCH_TILES_CACHE"):
        cache = LayoutCache()
    builder = resolve_tiles_builder(builder)
    at, info = _load_or_build(
        rg,
        cache=cache,
        tag=None,
        kind="adj_tiles",
        key_fn=lambda: tiles_key(rg),
        build_fn=lambda: build_adj_tiles_from_relay(rg, builder, budget_bytes, device=device),
        to_arrays=tiles_to_arrays,
        from_arrays=tiles_from_arrays,
        build_meta={"builder": builder},
    )
    if budget_bytes is not None and at.nbytes > budget_bytes:
        raise ValueError(
            f"cached adjacency tile layout is {at.nbytes >> 20} MB, over the "
            f"{budget_bytes >> 20} MB budget (tiles_budget_bytes)"
        )
    return at, info


def verify_tiles_bundle(rg, *, cache: LayoutCache | None = None) -> dict:
    """Integrity report of the tiles sidecar bundle of ``rg``, building
    nothing on a miss (``cache_warm --tiles``'s check): the bundle loaded
    (every array fingerprint-checked by :meth:`LayoutCache.load`, so a
    corrupt field reads as ``absent``), then the geometry the streamed host
    store (:mod:`bfs_tpu_torch.stream.store`) leans on: the version and
    shape against the relay layout, a monotone ``sb_indptr`` closing at
    ``nt``, every real tile's row and column id inside the padded spaces.
    JSON-ready; never raises on a bad bundle."""
    from ..graph.adj_tiles import SB_VERTS, TILE, TILES_VERSION, tiles_from_arrays

    cache = cache if cache is not None else LayoutCache()
    key = tiles_key(rg)
    loaded = cache.load(key)
    if loaded is None:
        return {"key": key, "ok": False, "status": "absent"}
    _doc, arrays = loaded
    try:
        at = tiles_from_arrays(arrays)
    except Exception as exc:  # a stale dims row, shape drift
        return {"key": key, "ok": False, "status": f"unreadable: {exc}"}
    problems = []
    if int(arrays["dims"][0]) != TILES_VERSION:
        problems.append(f"tiles version {int(arrays['dims'][0])} != {TILES_VERSION}")
    if at.rows != rg.vr:
        problems.append(f"rows {at.rows} != relay vr {rg.vr}")
    sb = np.asarray(arrays["sb_indptr"]).astype(np.int64)
    if not (np.all(np.diff(sb) >= 0) and int(sb[0]) == 0 and int(sb[-1]) == at.nt):
        problems.append("sb_indptr not a monotone span table closing at nt")
    nt = at.nt
    if nt:
        if int(np.asarray(arrays["row_idx"][:nt]).max()) >= at.rtp // TILE:
            problems.append("real tile row_idx outside the padded row space")
        if int(np.asarray(arrays["col_id"][:nt]).max()) >= at.vtp // TILE:
            problems.append("real tile col_id outside the padded col space")
    return {
        "key": key,
        "ok": not problems,
        "status": "ok" if not problems else "; ".join(problems),
        "num_tiles": int(at.nt),
        "num_superblocks": int(at.vtp // SB_VERTS),
        "tile_bytes": int(at.nbytes),
    }


def labels_key(graph, k: int) -> str:
    """Content key of the landmark distance-label sidecar bundle: (graph
    content, K, label code version), the reference's key.  Landmark
    sampling is seeded from the graph content hash
    (:func:`bfs_tpu_torch.serve.labels.sample_landmarks`), so the key needs
    no landmark list."""
    from ..serve.labels import LABELS_VERSION

    return (f"labels_k{int(k)}_v{LABELS_VERSION}_s{STORE_VERSION}_{graph_content_hash(graph)}"
            f"{_env_suffix(_LABELS_ENV)}")


def load_or_build_labels(graph, k: int, *, cache: LayoutCache | None = None,
                         engine: str = "pull", ckpt_dir: str | os.PathLike | None = None,
                         device=None, sweep=None):
    """``(LabelIndex, info)``: the serve label tier's landmark index, from its
    sidecar bundle or built (:func:`bfs_tpu_torch.serve.labels.build_label_index`
    on ``device``, through ``sweep`` when given) and saved (info contract:
    :func:`_load_or_build`).  The cold sweep is chunk-checkpointed, so a
    killed build resumes; a warm hit never sweeps."""
    from ..serve.labels import build_label_index, labels_from_arrays, labels_to_arrays

    return _load_or_build(
        graph,
        cache=cache,
        tag=None,
        kind="labels",
        key_fn=lambda: labels_key(graph, k),
        build_fn=lambda: build_label_index(graph, k, engine=engine, ckpt_dir=ckpt_dir,
                                           device=device, sweep=sweep),
        to_arrays=labels_to_arrays,
        from_arrays=labels_from_arrays,
        build_meta={"engine": engine, "k": int(k)},
    )


def verify_labels_bundle(graph, k: int, *, cache: LayoutCache | None = None) -> dict:
    """Integrity report of the label sidecar bundle, building nothing on a
    miss: the bundle loaded (every array fingerprint-checked by
    :meth:`LayoutCache.load`), then the invariants the oracle leans on:
    version and shape against the graph, landmark ids in range, each
    landmark at distance 0 from itself and its own parent, the unreachable
    sentinel agreeing between dist and parent.  JSON-ready; never raises on
    a bad bundle."""
    from ..serve.labels import LABEL_INF, LABELS_VERSION, labels_from_arrays

    cache = cache if cache is not None else LayoutCache()
    key = labels_key(graph, k)
    loaded = cache.load(key)
    if loaded is None:
        return {"key": key, "ok": False, "status": "absent"}
    _doc, arrays = loaded
    try:
        idx = labels_from_arrays(arrays)
    except Exception as exc:  # a version bump, shape drift
        return {"key": key, "ok": False, "status": f"unreadable: {exc}"}
    problems = []
    dims = np.asarray(arrays["dims"])
    if int(dims[0]) != LABELS_VERSION:
        problems.append(f"labels version {int(dims[0])} != {LABELS_VERSION}")
    if idx.num_vertices != graph.num_vertices:
        problems.append(f"num_vertices {idx.num_vertices} != graph {graph.num_vertices}")
    if idx.dist.shape != (idx.k, idx.num_vertices):
        problems.append(f"dist shape {idx.dist.shape} != (K, V)")
    if idx.parent.shape != idx.dist.shape:
        problems.append("parent shape differs from dist")
    lm = np.asarray(idx.landmarks)
    if lm.size and (int(lm.min()) < 0 or int(lm.max()) >= idx.num_vertices):
        problems.append("landmark id outside the vertex space")
    if not problems and lm.size:
        rows = np.arange(idx.k)
        if np.asarray(idx.dist)[rows, lm].any():
            problems.append("a landmark is not at distance 0 from itself")
        if (np.asarray(idx.parent)[rows, lm] != lm).any():
            problems.append("a landmark is not its own parent")
        sent = np.asarray(idx.dist) == LABEL_INF
        orphan = np.asarray(idx.parent) < 0
        if (sent != orphan).any():
            problems.append("unreachable sentinel disagrees between dist and parent")
    return {
        "key": key,
        "ok": not problems,
        "status": "ok" if not problems else "; ".join(problems),
        "k": int(idx.k),
        "index_bytes": int(idx.nbytes),
        "device_bytes": int(idx.device_bytes),
    }


# ---------------------------------------------------------------------------
# The expansion probe's verdict memo (the reference's, beside its layout
# bundles): ``probe_phase_kernels`` is a function of the layout's shapes, the
# kernel and probe sources, the torch build, the card and the probe knobs,
# so an engine over a layout already probed there reads the verdict back
# instead of timing the arms again.  Verdicts are small JSON files.
# ---------------------------------------------------------------------------

#: Files whose bytes key the verdict: the kernels the probe times and the
#: probe itself (an arm's code changed: probe again).
_PROBE_SOURCES = (
    "csrc/relay_kernels.cu", "csrc/relay_mxu_kernels.cu", "csrc/control.cuh", "csrc/tma.cuh",
    "ops/relay.py", "ops/relay_cuda.py", "ops/relay_mxu.py", "profiling.py",
)

#: Knobs that key the verdict.
_PROBE_ENV = ("BFS_TPU_TORCH_PHASE_PROBE",)


def probe_verdict_key(eng) -> str:
    """Content key of one engine's probe verdict: the relay layout's
    geometry (the probe's operand shapes) and the carry, the tile
    geometry ``(nt, vtp, rtp)`` when the engine counted tiles, the bytes of
    :data:`_PROBE_SOURCES`, the torch and CUDA versions, the device's name
    and the probe knobs."""
    import torch

    from ..utils.timing import device_name

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.blake2b(digest_size=16)
    for rel in _PROBE_SOURCES:
        try:
            with open(os.path.join(pkg, rel), "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"missing:" + rel.encode())
    rg = eng.relay_graph
    geo = (
        rg.vr, rg.net_size, rg.vperm_size,
        tuple((c.width, c.va, c.vb, c.sa, c.sb, c.vertex_major) for c in rg.in_classes),
        bool(eng.packed),
    )
    tiles = getattr(eng, "tile_geometry", None)
    if tiles is not None:
        geo = geo + tuple(tiles)
    h.update(repr(geo).encode())
    h.update(f"{torch.__version__}|{torch.version.cuda}|{device_name(eng.device)}".encode())
    for knob in _PROBE_ENV:
        h.update(f"{knob}={knobs.raw(knob)}".encode())
    return f"probe_{h.hexdigest()}"


def _probe_dir(root: str | None = None) -> str:
    return os.path.join(root or default_root(), "probe")


def load_probe_verdict(key: str, root: str | None = None) -> dict | None:
    """The verdict saved under ``key``, else None.  A file that does not
    parse or holds another key is deleted and reads as a miss."""
    path = os.path.join(_probe_dir(root), f"{key}.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("key") != key:
            raise ValueError("probe verdict key mismatch")
        verdict = doc["verdict"]
    except OSError:
        return None
    except Exception as exc:
        logger.warning("dropping corrupt probe verdict %s: %s", key, exc)
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    bump_artifact("phase_probe_memo_hits")
    return verdict


def save_probe_verdict(key: str, verdict: dict, root: str | None = None) -> None:
    """Write a verdict atomically (a ``.tmp.<pid>`` sibling renamed into
    place)."""
    d = _probe_dir(root)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{key}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"key": key, "created": time.time(), "verdict": verdict}, f, indent=1,
                  sort_keys=True)
    os.replace(tmp, path)
    bump_artifact("phase_probe_memo_writes")
