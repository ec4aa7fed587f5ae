"""One single-source gather superstep on the card, phase by phase, timed
with and without the device sleep.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.superstep_phases [--scale 22] [--reps 20]

Builds ``chip_smoke.py``'s graph (R-MAT, edge factor 6, graph seed 1) and
its engine, walks the main path from the max-out-degree vertex to the
superstep with the largest frontier (the inputs ``chip_smoke.py``'s kernel
phase uses), counts the kernel launches of one superstep there, and times
each phase — both Beneš networks, the broadcast between them, the row-min,
the update and the whole superstep — in two ways (``utils.timing.cold_ms``,
mean of ``--reps`` calls each after an L2 flush): ``cold``, with a device
sleep before the first event, so the events span device time only, and
``unpadded``, without it, so a span may hold the host's time to launch
the phase's kernels.  Also the host microseconds per call.

The script uses only entry points that the port had before the fused
Beneš passes (``apply_benes``, ``broadcast_l2``, ``rowmin_ranks``,
``apply_relay_candidates_packed``, ``superstep_packed``), so two trees
can be compared on one card: unpack the other tree into a git-ignored
directory, copy this file and ``utils/timing.py`` into it, and run the
script from each root in turn (A, B, B, A).  Prints one line per phase,
the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np
import torch

from .. import RelayEngine, build_relay_graph
from ..graph import generators
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..utils.timing import card_line, cold_ms, host_us

EDGE_FACTOR = 6
GRAPH_SEED = 1


def largest_superstep(eng) -> SimpleNamespace:
    """The main path from the max-out-degree vertex, walked on the card
    through the kernels, at its superstep with the largest frontier: the
    carry (``count`` frontier vertices, ``packed``, ``fwords``, ``level``)
    and that superstep's operands as the kernel route computes them — the
    frontier in the vperm's words (``fw``), routed (``y``), broadcast to
    the net (``l2``), routed (``l1``), the row-min's candidates
    (``cand``)."""
    rg = eng.relay_graph
    dev = eng.device
    outdeg = np.diff(rg.adj_indptr[: rg.vr + 1])
    st = R.init_packed_relay_state(rg.vr, int(np.argmax(outdeg)), dev)
    best = None
    while bool(st.changed):
        count = int(R.unpack_std(st.fwords, rg.vr).sum())
        if best is None or count > best[0]:
            best = (count, st.packed.clone(), st.fwords.clone(), st.level)
        st = eng.superstep_packed(st)
    count, packed, fwords, level = best
    fw = torch.zeros(rg.vperm_size // 32, dtype=torch.int32, device=dev)
    fw[: rg.vr // 32] = fwords
    y = K.apply_benes(fw, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    l2 = R.broadcast_l2(y, rg.out_classes, rg.net_size, rg.out_space)
    l1 = K.apply_benes(l2, eng.net_masks, rg.net_table, rg.net_size)
    cand = K.rowmin_ranks(l1, eng.valid_words, rg.in_classes, rg.vr)
    return SimpleNamespace(count=count, packed=packed, fwords=fwords, level=level,
                           fw=fw, y=y, l2=l2, l1=l1, cand=cand)


def phase_fns(eng, s: SimpleNamespace) -> dict:
    """name -> call: each phase of the superstep at ``s`` (kernel route),
    and the whole superstep.  The update writes a scratch copy of the
    carry."""
    rg = eng.relay_graph
    scratch = R.PackedRelayState(s.packed.clone(), s.fwords, s.level, None)
    fout = torch.empty_like(s.fwords)
    return {
        "vperm_benes": lambda: K.apply_benes(s.fw, eng.vperm_masks, rg.vperm_table,
                                             rg.vperm_size),
        "broadcast_l2": lambda: R.broadcast_l2(s.y, rg.out_classes, rg.net_size,
                                               rg.out_space),
        "net_benes": lambda: K.apply_benes(s.l2, eng.net_masks, rg.net_table, rg.net_size),
        "class_rowmin": lambda: K.rowmin_ranks(s.l1, eng.valid_words, rg.in_classes, rg.vr),
        "packed_update": lambda: K.apply_relay_candidates_packed(scratch, s.cand,
                                                                 fwords_out=fout),
        "superstep": lambda: eng.superstep_packed(scratch._replace(fwords=s.fwords)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("superstep_phases: no CUDA device")
    card = card_line()
    K.build_all()
    g = generators.rmat_graph_native(args.scale, EDGE_FACTOR, seed=GRAPH_SEED)
    eng = RelayEngine(build_relay_graph(g), device="cuda")
    s = largest_superstep(eng)
    fns = phase_fns(eng, s)
    fns["superstep"]()
    torch.cuda.synchronize()
    K.reset_launches()
    fns["superstep"]()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"superstep {s.level + 1}: frontier {s.count} vertices; "
          f"{sum(launches.values())} launches {launches}", flush=True)
    phases = {}
    for name, fn in fns.items():
        p = phases[name] = dict(cold=cold_ms(fn, args.reps),
                                unpadded=cold_ms(fn, args.reps, sleep=False),
                                host_us=host_us(fn, 50))
        print(f"{name}: cold {p['cold']:.4f} ms, unpadded {p['unpadded']:.4f} ms, host "
              f"{p['host_us']:.1f} us per call", flush=True)
    print(card)
    print(json.dumps({"scale": args.scale, "card": card, "frontier": s.count,
                      "level": s.level, "launches": launches, "phases": phases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
