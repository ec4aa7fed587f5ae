"""Where ``class_rowmin``'s time goes on the lock-step batch, by kind of
work item and number of trees, and how its builds compare.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.rowmin_sweep [--scale 22] [--seed 0] [--only split]

Builds the graph and the sources that ``chip_smoke.py`` builds (R-MAT,
edge factor 6, graph seed 1; the max-out-degree vertex, 3 roots drawn with
``--seed`` from its component and 12 more drawn with ``--seed + 1``: the
16-tree lock-step batch; and the 64 sources of its multi-source batch,
drawn with ``--seed`` after the roots).  Each batch is walked on the card
to its superstep with the most frontier vertices in all, and its frontier
is routed to the L1 slot words as the superstep routes it.  Trees: 1 (the
single search's densest superstep, as ``chip_smoke.py``'s kernel phase
takes it), 4 and 16 (the first trees of the 16-tree batch) and 64 (the
64-source batch).

``split``: one ``class_rowmin`` launch (``utils.timing.cold_ms``: after an
L2 flush and a device sleep; mean of ``--reps``) over the whole work table
and over each kind of its rows alone — rank-major classes walked by one
chunk, rank-major classes split into chunks, vertex-major classes with a
warp per vertex or a block per vertex, the tail — at each tree count,
beside each part's bound (its slot words of every tree and the valid words
once, read, and its outputs written, at 3.35 TB/s), and the bound of an
early exit at first hits (``ops.relay.early_exit_bytes``, from the plain
ranks).  A partial table leaves the other vertices' outputs unwritten;
only its time is read.

``builds`` (the default): the split through the committed build and
copies of ``csrc/relay_kernels.cu`` built into the git-ignored build
directory with other caps on the trees a block takes (``kRowminGroup``;
1 is a block per tree), other register caps (``kRowminBlocks``) and other
rows in flight (``kRowBatch``), then through the committed build on work
tables with other ``CLASS_CHUNK_ROWS`` and ``CLASS_WIDE_BITS`` (constants
of ``ops/relay_cuda.py`` that the table reads when it is built); each
whole-table launch held against the plain version first.

Prints one line per (part, trees, build), the card's name and power limit,
and one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import RelayEngine, build_relay_graph, canonical_bfs, INF_DIST
from ..graph import generators
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..utils import cuda_build
from ..utils.timing import card_line, cold_ms

HBM_BYTES_PER_S = 3.35e12
TREES = (1, 4, 16, 64)
#: name -> the constants of relay_kernels.cu it changes.
VARIANTS = {
    **{f"group{g}": {"kRowminGroup": g} for g in (1, 2, 8)},
    "rowbatch16": {"kRowBatch": 16},
    "blocks3": {"kRowminBlocks": 3},
}
#: The committed build on work tables with other constants of
#: ops/relay_cuda.py.
TABLES = {"CLASS_CHUNK_ROWS": (8, 32), "CLASS_MAX_CHUNKS": (8, 16),
          "CLASS_WIDE_BITS": (4096,)}

KINDS = {
    "rank-major, one chunk": lambda r: r[0] == 0 and r[5] == 1,
    "rank-major, chunked": lambda r: r[0] == 0 and r[5] > 1,
    "vertex-major, warp per vertex": lambda r: r[0] == 1,
    "vertex-major, block per vertex": lambda r: r[0] == 3,
    "tail": lambda r: r[0] == 2,
}


def routed_l1(eng, fwords: torch.Tensor) -> torch.Tensor:
    """The L1 slot words of frontier words ``[S, vr/32]`` (or ``[vr/32]``),
    routed as the superstep routes them."""
    rg = eng.relay_graph
    fw = torch.zeros((*fwords.shape[:-1], rg.vperm_size // 32), dtype=torch.int32,
                     device=fwords.device)
    fw[..., : rg.vr // 32] = fwords
    y = K.apply_benes(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
    return K.apply_benes(l2, eng.net_masks, rg.net_table, rg.net_size)


def densest_batch(eng, sources) -> tuple[torch.Tensor, int, int]:
    """The lock-step batch of ``sources`` at its superstep with the most
    frontier vertices: ``(l1 [S, nw], superstep, frontier vertices)``."""
    rg = eng.relay_graph
    st = R.init_relay_batch(rg.vr, rg.old2new[np.asarray(sources)], eng.device, True)
    best = None
    while bool(st.changed):
        count = sum(int(R.unpack_std(f, rg.vr).sum()) for f in st.fwords)
        if best is None or count > best[0]:
            best = (count, st.fwords.clone(), st.level)
        st = eng.superstep_packed(st)
    count, fwords, level = best
    return routed_l1(eng, fwords), level + 1, count


def inputs(scale: int, seed: int):
    """The engine on ``chip_smoke.py``'s graph and ``{trees: (l1, label)}``."""
    from .superstep_phases import largest_superstep

    g = generators.rmat_graph_native(scale, 6, seed=1)
    eng = RelayEngine(build_relay_graph(g), device="cuda")
    root0 = int(np.argmax(np.bincount(g.src, minlength=g.num_vertices)))
    comp = np.flatnonzero(canonical_bfs(g, root0)[0] != INF_DIST)
    rng = np.random.default_rng(seed)
    roots = [root0] + [int(r) for r in rng.choice(comp, 3, replace=False)]
    lock = np.asarray([*roots, *np.random.default_rng(seed + 1).choice(
        np.setdiff1d(comp, roots), 12, replace=False)], dtype=np.int32)
    batch = np.asarray(rng.choice(comp, 64, replace=False), dtype=np.int32)
    one = largest_superstep(eng)
    l16, step16, n16 = densest_batch(eng, lock)
    l64, step64, n64 = densest_batch(eng, batch)
    return eng, {
        1: (one.l1, f"the single search's superstep {one.level + 1}, {one.count} frontier "
                    "vertices"),
        4: (l16[:4].contiguous(), f"the 16-tree batch's first 4 at its superstep {step16}"),
        16: (l16, f"the 16-tree batch at superstep {step16}, {n16} frontier vertices in all"),
        64: (l64, f"the 64-source batch at superstep {step64}, {n64} frontier vertices in all"),
    }


def work_table(eng) -> K.RowminTable:
    """The work table of ``eng``'s classes on its device."""
    rg = eng.relay_graph
    return K.rowmin_items(tuple(rg.in_classes), rg.vr, str(eng.device))


def launch(lib, eng, l1, table, blocks: int, planes: int, out) -> None:
    """One ``class_rowmin`` launch of ``lib`` over ``table`` (int64 rows
    on the card) staging ``planes`` rank planes, as the wrapper launches
    it."""
    rg = eng.relay_graph
    trees = l1.shape[0] if l1.dim() == 2 else 1
    nw = eng.valid_words.numel()
    rc = lib.class_rowmin(K._ptr(l1), K._ptr(eng.valid_words), K._ptr(out),
                          K._VP(table.data_ptr()), table.shape[0], blocks, planes, trees, nw,
                          rg.vr, K._ctl(None), K._stream())
    if rc:
        raise RuntimeError(f"class_rowmin: CUDA error {rc} at launch")


def bound_ms(eng, rows: list, trees: int) -> float:
    """Every tree's slot words of ``rows`` and the valid words once read,
    their outputs written, at 3.35 TB/s."""
    words = sum(r[4] * r[2] // 32 for r in rows if r[0] != 2)
    outs = sum(r[2] for r in rows)
    return (4 * words * (1 + trees) + 4 * outs * trees) / HBM_BYTES_PER_S * 1e3


def table_parts(eng) -> dict:
    """name -> (rows, table on the card, table blocks): the whole work
    table and each kind's rows alone."""
    table, total, _, _ = work_table(eng)
    rows = table.tolist()
    nblocks = [(rows[i + 1][7] if i + 1 < len(rows) else total) - r[7]
               for i, r in enumerate(rows)]
    parts = {"full": (rows, table, total)}
    for name, keep in KINDS.items():
        sub, block = [], 0
        for r, n in zip(rows, nblocks):
            if keep(r):
                sub.append(r[:7] + [block])
                block += n
        if sub:
            parts[name] = (sub, torch.tensor(sub, dtype=torch.int64, device=eng.device), block)
    return parts


def early_bounds(eng, cases: dict) -> dict:
    """{trees: {part: ms}}: the early exit's bound on each case's plain
    ranks, for the whole table and each kind's classes."""
    rg = eng.relay_graph
    rows = work_table(eng).table.tolist()
    out = {}
    for trees, (l1, _) in cases.items():
        ranks = R.rowmin_ranks(l1, eng.valid_words, rg.in_classes, rg.vr)
        res = out[trees] = {"full": R.early_exit_bytes(ranks, rg.in_classes) / HBM_BYTES_PER_S
                            * 1e3}
        for name, keep in KINDS.items():
            vas = [r[1] for r in rows if keep(r) and r[0] != 2]
            if vas:
                res[name] = R.early_exit_bytes(ranks, rg.in_classes, vas) / HBM_BYTES_PER_S * 1e3
        print(f"class_rowmin, {trees} trees: the early exit's bound (the words up to each "
              "tree's first hits, the valid words up to the furthest tree's, the outputs), ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in res.items()), flush=True)
    return out


def split(lib, name: str, eng, cases: dict, parts: dict, reps: int) -> dict:
    """{trees: {part: {ms, bound_ms, items, blocks}}} of ``lib``."""
    rg = eng.relay_graph
    planes = work_table(eng).planes
    out = {}
    for trees, (l1, _) in cases.items():
        res = out[trees] = {}
        o = torch.empty((*l1.shape[:-1], rg.vr), dtype=torch.int32, device=eng.device)
        for part, (sub, t, blocks) in parts.items():
            ms = cold_ms(lambda: launch(lib, eng, l1, t, blocks, planes, o), reps)
            res[part] = dict(ms=ms, bound_ms=bound_ms(eng, sub, trees), items=len(sub),
                             blocks=blocks)
            print(f"class_rowmin [{name}], {trees} trees, {part}: {ms:.4f} ms (bound "
                  f"{res[part]['bound_ms']:.4f} ms), {len(sub)} items, {blocks} table blocks "
                  "(cold L2)", flush=True)
    return out


def checked_split(lib, name: str, eng, cases: dict, want: dict, reps: int) -> dict:
    """``split`` of ``lib`` on the current work table, after holding its
    whole-table launch against the plain version at every tree count."""
    table, total, _, planes = work_table(eng)
    for trees, (l1, _) in cases.items():
        o = torch.full_like(want[trees], 7)
        launch(lib, eng, l1, table, total, planes, o)
        torch.cuda.synchronize()
        if not torch.equal(o, want[trees]):
            raise AssertionError(f"class_rowmin [{name}], {trees} trees: differs from the "
                                 "plain version")
    return split(lib, name, eng, cases, table_parts(eng), reps)


def builds(eng, cases: dict, reps: int) -> dict:
    """{build: {"group": {trees: trees a block}, "split": split()}}: the
    committed build and each variant, then the committed build on the work
    tables of ``TABLES``."""
    rg = eng.relay_graph
    libs = {"committed": K.kernels(), **cuda_build.build_variants(
        "relay_kernels", K.SOURCES["relay_kernels"], VARIANTS, K._register)}
    want = {trees: R.rowmin_ranks(l1, eng.valid_words, rg.in_classes, rg.vr)
            for trees, (l1, _) in cases.items()}
    out = {}
    for name, lib in libs.items():
        planes = work_table(eng).planes
        group = {trees: lib.rowmin_group(trees, planes) for trees in cases}
        print(f"class_rowmin [{name}]: trees a block {group}", flush=True)
        out[name] = {"group": group, "split": checked_split(lib, name, eng, cases, want, reps)}
    saved = {c: getattr(K, c) for c in TABLES}
    try:
        for const, values in TABLES.items():
            for value in values:
                if value == saved[const]:
                    continue
                setattr(K, const, value)
                K.rowmin_items.cache_clear()
                name = f"committed, {const}={value}"
                out[name] = {"split": checked_split(K.kernels(), name, eng, cases, want, reps)}
                setattr(K, const, saved[const])
    finally:
        for const, value in saved.items():
            setattr(K, const, value)
        K.rowmin_items.cache_clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("split",))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rowmin_sweep: no CUDA device")
    card = card_line()
    K.build_all()
    eng, cases = inputs(args.scale, args.seed)
    for trees, (l1, label) in cases.items():
        print(f"{trees} trees: {label}", flush=True)
    result = {"scale": args.scale, "card": card, "early_bound_ms": early_bounds(eng, cases)}
    if args.only == "split":
        result["split"] = split(K.kernels(), "committed", eng, cases, table_parts(eng),
                                args.reps)
    else:
        result["builds"] = builds(eng, cases, args.reps)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
