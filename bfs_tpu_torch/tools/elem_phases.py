"""The element-major kernels of one multi-source superstep on the card, on
``chip_smoke.py``'s scale-22 inputs, timed phase by phase.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.elem_phases [--scale 22] [--reps 20] [--variants]

Builds ``chip_smoke.py``'s graph (R-MAT, edge factor 6, graph seed 1), its
engine and its batch of 64 sources (``--seed`` 0, drawn as
``chip_smoke.py`` draws them), walks the batch to the superstep with the
most (tree, vertex) pairs in the frontier (G = 2 groups of 32 trees), and
times there, each held against its plain version first:

  local_pass     ``benes_elem_local_pass`` on the net's local run (G = 2,
                 the input the outer prefix gives it), and ``index_select``
                 over the same stages' permutation;
  local_pass_g1  the same on group 0 alone (the route index build's shape);
  gather         ``elem_route_gather`` (all the launches of its wrapper);
  gather_g1      the same on group 0 alone;
  rowmin         ``elem_rowmin_update`` (inputs restored before each call);
  superstep      ``RelayEngine.superstep_elem``, the whole superstep.

Each is timed with ``utils.timing.cold_ms`` (mean of ``--reps`` calls, each
after an L2 flush), with the device sleep (``cold``: device time) and
without it (``unpadded``).  ``--variants`` (trees from this one on) also times the gather built with
8 and 16 slots a thread (``kGatherQuads`` 2 and 4; the committed build
takes 4) and its two launches apart.

The script uses only entry points older than this file
(``benes_elem_local_pass``, ``elem_route_gather``, ``elem_rowmin_update``,
``RelayEngine.superstep_elem``), so two trees can be compared on one card:
unpack the other tree into a git-ignored directory, copy this file and
``utils/timing.py`` into it, and run the script from each root in turn (A,
B, B, A).  Prints one line per phase, the card's name and power limit, and
one JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from .. import INF_DIST, RelayEngine, build_relay_graph
from ..graph import generators
from ..ops import relay_cuda as K
from ..ops import relay_elem as RE
from ..utils import cuda_build
from ..utils.timing import card_line, cold_ms, host_us

EDGE_FACTOR = 6
GRAPH_SEED = 1
ROOTS = 4
BATCH = 64


def batch_sources(g, eng, seed: int) -> np.ndarray:
    """``chip_smoke.py``'s 64 sources: after its 3 extra roots, drawn by
    the same generator from the max-degree vertex's component."""
    deg = np.bincount(g.src, minlength=g.num_vertices)
    comp = np.flatnonzero(eng.run(int(np.argmax(deg))).dist != INF_DIST)
    rng = np.random.default_rng(seed)
    rng.choice(comp, ROOTS - 1, replace=False)
    return np.asarray(rng.choice(comp, BATCH, replace=False), dtype=np.int32)


def densest_state(eng, sources) -> RE.ElemState:
    """The carry before the superstep with the most (tree, vertex) pairs in
    the frontier."""
    rg = eng.relay_graph
    groups = len(sources) // 32
    _, pt = RE.rank_plane_layout(rg.in_classes)
    st = RE.init_elem_state(rg.vr, rg.old2new[sources].reshape(groups, 32), pt, eng.device)
    best = None
    while bool(st.changed) and st.level <= RE.MAX_ELEM_LEVELS:
        count = sum(int(((st.frontier >> t) & 1).sum()) for t in range(32))
        if best is None or count > best[0]:
            best = (count, RE.ElemState(*(t.clone() for t in st[:4]), st.level, None))
        st = eng.superstep_elem(st)
    return best[1]


def phase_fns(eng, st0: RE.ElemState) -> dict:
    """name -> (call, its plain version or None, prep or None)."""
    rg = eng.relay_graph
    dev = eng.device
    n, table, masks = rg.net_size, rg.net_table, eng.net_masks
    groups = st0.frontier.shape[0]
    fw = torch.zeros((groups, rg.vperm_size), dtype=torch.int32, device=dev)
    fw[:, : rg.vr] = st0.frontier
    y = K.apply_benes_elem(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    x = RE.broadcast_l2_elem(y, rg.out_classes, n)
    pre, local, _, tile = K.split_elem_passes(table, n)
    for i in pre:
        x = K.benes_elem_outer_stage(x, masks, table[i], n)
    stages = tuple(table[i] for i in local)
    out = torch.empty_like(x)
    x1 = x[:1].contiguous()
    out1 = torch.empty_like(x1)
    iota = torch.arange(n, dtype=torch.int32, device=dev)[None]
    idx = RE.apply_benes_elem(iota, masks, stages, n)[0].long()
    sel = torch.empty_like(x)
    src = eng.route_index()
    f = st0.frontier
    gbuf = torch.empty((groups, n), dtype=torch.int32, device=dev)
    f1 = f[:1].contiguous()
    gbuf1 = torch.empty((1, n), dtype=torch.int32, device=dev)
    l1 = K.elem_route_gather(f, src)
    work = RE.ElemState(*(t.clone() for t in st0[:4]), st0.level, None)

    def restore():
        for dst, orig in zip(work[:4], st0[:4]):
            dst.copy_(orig)

    vr, ic, valid = rg.vr, rg.in_classes, eng.valid_words
    return {
        "local_pass": (lambda: K.benes_elem_local_pass(x, masks, stages, n, tile, out=out),
                       lambda: RE.apply_benes_elem(x, masks, stages, n), None),
        "index_select": (lambda: torch.index_select(x, 1, idx, out=sel),
                         lambda: RE.apply_benes_elem(x, masks, stages, n), None),
        "local_pass_g1": (lambda: K.benes_elem_local_pass(x1, masks, stages, n, tile, out=out1),
                          lambda: RE.apply_benes_elem(x1, masks, stages, n), None),
        "gather": (lambda: K.elem_route_gather(f, src, out=gbuf),
                   lambda: RE.route_gather(f, src), None),
        "gather_g1": (lambda: K.elem_route_gather(f1, src, out=gbuf1),
                      lambda: RE.route_gather(f1, src), None),
        "rowmin": (lambda: K.elem_rowmin_update(l1, valid, work, ic, vr).frontier,
                   None, restore),
        "superstep": (lambda: eng.superstep_elem(work).frontier, None, restore),
    }


#: Builds of ``relay_elem_kernels.cu`` with other slot runs a gather
#: thread takes (``kGatherQuads``; the committed build has 1).
GATHER_VARIANTS = {"quads2": {"kGatherQuads": 2}, "quads4": {"kGatherQuads": 4}}


def variants(eng, st0) -> dict:
    """At this superstep: the gather through each variant build, and its
    two launches apart (``interleave``, ``gather_only``), each held against
    its plain version first."""
    libs = cuda_build.build_variants("relay_elem_kernels", K.SOURCES["relay_elem_kernels"],
                                     GATHER_VARIANTS, K._register_elem)
    src, f = eng.route_index(), st0.frontier
    want = RE.route_gather(f, src)
    out = torch.empty_like(want)
    ft = RE.interleave_frontier(f)
    ft_out = torch.empty_like(ft)
    cases = {f"gather_{name}": (functools.partial(K.launch_route_gather, lib, f, src, out), want)
             for name, lib in libs.items()}
    cases.update(
        interleave=(lambda: K.elem_frontier_interleave(f, out=ft_out), ft),
        gather_only=(lambda: K.elem_route_gather(f, src, out=out, frontier_t=ft), want),
    )
    times = {}
    for name, (fn, plain) in cases.items():
        if not torch.equal(fn(), plain):
            raise AssertionError(f"{name} differs from its plain version")
        times[name] = dict(cold=cold_ms(fn, 20), unpadded=cold_ms(fn, 20, sleep=False))
        print(f"{name}: cold {times[name]['cold']:.4f} ms, unpadded "
              f"{times[name]['unpadded']:.4f} ms", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time the gather's variants and launches apart")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("elem_phases: no CUDA device")
    card = card_line()
    K.build_all()
    g = generators.rmat_graph_native(args.scale, EDGE_FACTOR, seed=GRAPH_SEED)
    eng = RelayEngine(build_relay_graph(g), device="cuda")
    sources = batch_sources(g, eng, args.seed)
    st0 = densest_state(eng, sources)
    fns = phase_fns(eng, st0)
    print(f"superstep {st0.level + 1}: G={st0.frontier.shape[0]}, "
          f"net n={eng.relay_graph.net_size}", flush=True)
    for name, (fn, plain, prep) in fns.items():
        if plain is not None and not torch.equal(fn(), plain()):
            raise AssertionError(f"{name} differs from its plain version")
    if prep := fns["superstep"][2]:
        prep()
    torch.cuda.synchronize()
    K.reset_launches()
    fns["superstep"][0]()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"one superstep: launches {launches}", flush=True)
    phases = {}
    for name, (fn, _, prep) in fns.items():
        p = phases[name] = dict(cold=cold_ms(fn, args.reps, prep=prep),
                                unpadded=cold_ms(fn, args.reps, prep=prep, sleep=False),
                                host_us=host_us(fn, 20))
        print(f"{name}: cold {p['cold']:.4f} ms, unpadded {p['unpadded']:.4f} ms, host "
              f"{p['host_us']:.1f} us per call", flush=True)
    if args.variants:
        phases.update(variants(eng, st0))
    print(card)
    print(json.dumps({"scale": args.scale, "card": card, "level": st0.level,
                      "launches": launches, "phases": phases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
