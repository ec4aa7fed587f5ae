"""Where ``elem_rowmin_update``'s time goes, by kind of work item.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.elem_rowmin_breakdown [--scale 22] [--seed 0]

Builds the graph and the 64-source batch that ``chip_smoke.py`` builds
(R-MAT, edge factor 6, graph seed 1, sources drawn with ``--seed`` after
its three roots), walks the batch to the superstep with the most trees in
the frontier, and times one ``elem_rowmin_update`` launch (after an L2
flush and a device sleep, ``utils.timing.cold_ms``; mean of 20, the state
restored before each) over the whole work table and over each kind of its
rows alone: rank-major classes walked by
one chunk, rank-major classes split into chunks, vertex-major classes with
a block per vertex or a warp per vertex, and the tail.  A partial table
leaves the other vertices' outputs unwritten; only its time is read.
With ``--sweep`` it also builds copies of ``csrc/relay_elem_kernels.cu``
into the git-ignored build directory with other ``kRowBatch`` (rows a
thread has in flight) and ``kElemBlocksPerSm`` (the launch bounds' blocks
per SM) and times them the same way, then the committed build under other
``ROWMIN_CHUNK_ROWS`` (how finely rank-major rows are split into chunks;
the work table reads it when it is built)
and ``ELEM_NARROW_PASSES`` (passes of a one-chunk class's block).
Prints one line per kind and build, the card's name and power limit, and
one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import RelayEngine, build_relay_graph, canonical_bfs, INF_DIST
from ..graph import generators
from ..ops import relay_cuda as K
from ..ops import relay_elem as RE
from ..utils import cuda_build
from ..utils.timing import card_line, cold_ms

#: (kRowBatch, kElemBlocksPerSm) of the copies ``--sweep`` times.
SWEEP = ((2, 6), (4, 6), (8, 6), (4, 5))
CHUNK_ROWS = (16, 32)
NARROW_PASSES = (1, 2, 4, 8)

KINDS = {
    "rank-major, one chunk": lambda r: r[0] == 0 and r[7] == 1,
    "rank-major, chunked": lambda r: r[0] == 0 and r[7] > 1,
    "vertex-major, warp per vertex": lambda r: r[0] == 1,
    "vertex-major, block per vertex": lambda r: r[0] == 3,
    "tail": lambda r: r[0] == 2,
}


def densest_superstep(eng, sources):
    """The batch's carry at the superstep with the most (tree, vertex)
    pairs in the frontier, and the routed L1 elements of that superstep."""
    rg = eng.relay_graph
    groups = len(sources) // 32
    _, pt = RE.rank_plane_layout(rg.in_classes)
    st = RE.init_elem_state(rg.vr, rg.old2new[sources].reshape(groups, 32), pt, eng.device)
    best = None
    while bool(st.changed) and st.level <= RE.MAX_ELEM_LEVELS:
        bits = (st.frontier[..., None] >> torch.arange(32, device=eng.device)) & 1
        count = int(bits.sum())
        if best is None or count > best[0]:
            best = (count, RE.ElemState(*(t.clone() for t in st[:4]), st.level, None))
        st = eng.superstep_elem(st)
    st0 = best[1]
    return st0, K.elem_route_gather(st0.frontier, eng.route_index()), best[0]


def launch(eng, l1, work, table, blocks: int) -> None:
    """One ``elem_rowmin_update`` launch over ``table``, as the wrapper
    launches it."""
    rg = eng.relay_graph
    _, pt = RE.rank_plane_layout(rg.in_classes)
    changed = torch.empty(1, dtype=torch.int32, device=l1.device)
    frontier = torch.empty_like(work.visited)
    rc = K.elem_kernels().elem_rowmin_update(
        K._ptr(l1), K._ptr(eng.valid_words), K._ptr(work.visited), K._ptr(frontier),
        K._ptr(work.dist_planes), K._ptr(work.rank_planes), K._ptr(changed),
        K._VP(table.data_ptr()), table.shape[0], blocks, l1.shape[0], l1.shape[1],
        rg.vr, pt,
        work.level + 1, K._ctl(None), K._stream(),
    )
    if rc:
        raise RuntimeError(f"elem_rowmin_update: CUDA error {rc} at launch")


def batch_inputs(scale: int, seed: int):
    """The engine on ``chip_smoke.py``'s graph, and its 64-source batch at
    the densest superstep: ``(eng, carry, l1, pairs in the frontier)``."""
    g = generators.rmat_graph_native(scale, 6, seed=1)
    eng = RelayEngine(build_relay_graph(g), device="cuda")
    root0 = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    comp = np.flatnonzero(canonical_bfs(g, root0)[0] != INF_DIST)
    rng = np.random.default_rng(seed)
    rng.choice(comp, 3, replace=False)  # chip_smoke.py's roots come first
    sources = np.asarray(rng.choice(comp, 64, replace=False), dtype=np.int32)
    return (eng, *densest_superstep(eng, sources))


def breakdown(eng, st0, l1) -> dict:
    """{kind: {ms, blocks, items}}: the whole table, then each kind alone."""
    rg = eng.relay_graph
    work = RE.ElemState(*(t.clone() for t in st0[:4]), st0.level, None)

    def restore():
        for dst, orig in zip(work[:4], st0[:4]):
            dst.copy_(orig)

    table, total = K.elem_rowmin_items(tuple(rg.in_classes), rg.vr)
    rows = table.tolist()
    nblocks = [(rows[i + 1][10] if i + 1 < len(rows) else total) - r[10] for i, r in enumerate(rows)]
    full = cold_ms(lambda: launch(eng, l1, work, table, total), 20, warm=1, prep=restore)
    out = {"full": dict(ms=full, blocks=total, items=len(rows))}
    for name, keep in KINDS.items():
        sub, block = [], 0
        for r, n in zip(rows, nblocks):
            if keep(r):
                sub.append(r[:10] + [block])
                block += n
        if sub:
            t = torch.tensor(sub, dtype=torch.int64)
            ms = cold_ms(lambda: launch(eng, l1, work, t, block), 20, warm=1, prep=restore)
            out[name] = dict(ms=ms, blocks=block, items=len(sub))
    return out


def sweep_builds() -> dict:
    """name -> loaded library: the committed build and a copy of the elem
    source for each (kRowBatch, kElemBlocksPerSm) in SWEEP other than the
    committed one."""
    src = K.SOURCES["relay_elem_kernels"]
    committed = (cuda_build.constant(src, "kRowBatch"),
                 cuda_build.constant(src, "kElemBlocksPerSm"))
    libs = cuda_build.build_variants(
        "relay_elem_kernels", src,
        {f"rb{rb}_lb{lb}": {"kRowBatch": rb, "kElemBlocksPerSm": lb}
         for rb, lb in SWEEP if (rb, lb) != committed},
        K._register_elem)
    out = {f"kRowBatch={committed[0]}, kElemBlocksPerSm={committed[1]} (committed)":
           K.elem_kernels()}
    for name, lib in libs.items():
        rb, lb = name.split("_")
        out[f"kRowBatch={rb[2:]}, kElemBlocksPerSm={lb[2:]}"] = lib
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("elem_rowmin_breakdown: no CUDA device")
    card = card_line()
    libs = sweep_builds() if args.sweep else {"committed": K.elem_kernels()}
    eng, st0, l1, pairs = batch_inputs(args.scale, args.seed)
    print(f"densest superstep {st0.level + 1}: {pairs} (tree, vertex) pairs in the frontier, "
          f"G={l1.shape[0]}")
    rows0, passes0 = K.ROWMIN_CHUNK_ROWS, K.ELEM_NARROW_PASSES
    runs = [(name, lib, rows0, passes0) for name, lib in libs.items()]
    if args.sweep:
        first = next(iter(libs.values()))
        runs += [(f"committed build, ROWMIN_CHUNK_ROWS={rows}", first, rows, passes0)
                 for rows in CHUNK_ROWS if rows != rows0]
        runs += [(f"committed build, ELEM_NARROW_PASSES={p}", first, rows0, p)
                 for p in NARROW_PASSES if p != passes0]
    load, results = K.elem_kernels, {}
    try:
        for name, lib, rows, passes in runs:
            K.elem_kernels = lambda lib=lib: lib
            K.ROWMIN_CHUNK_ROWS, K.ELEM_NARROW_PASSES = rows, passes
            K.elem_rowmin_items.cache_clear()
            results[name] = out = breakdown(eng, st0, l1)
            for kind, r in out.items():
                print(f"elem_rowmin_update [{name}], {kind}: {r['ms']:.4f} ms, {r['items']} "
                      f"items, {r['blocks']} blocks per group (cold L2)", flush=True)
    finally:
        K.elem_kernels, K.ROWMIN_CHUNK_ROWS, K.ELEM_NARROW_PASSES = load, rows0, passes0
        K.elem_rowmin_items.cache_clear()
    print(card)
    print(json.dumps({"scale": args.scale, "card": card, "builds": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
