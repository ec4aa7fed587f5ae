"""Times of the single-source Beneš passes on one card, by design choice
and by way of timing.

Run from the root of a checkout on a machine with a card::

    python3 -m bfs_tpu_torch.tools.benes_pass_sweep [--net 26 --vperm 23]

``--net`` and ``--vperm`` are the log2 sizes of the two networks (R-MAT
scale 22 gives 2^26 and 2^23).  The script builds copies of
``csrc/relay_kernels.cu`` into the git-ignored build directory — the local
pass's ring of mask slabs cut to ``kMaxRing`` = 1, 2 and 4 slots (the
committed build has 8, of which the net's 64 KB tile fits 2), its in-word
sweep cut to one stage (``kMaxSweep`` = 1: a barrier per stage), and the
outer pass's units of 1,024 words for 128 threads and 4,096 words for 256
and 512 threads (``kOuterWords``, ``kOuterThreads``), and both passes on
one tree through the batch's kernels (``kBatchTrees`` = 1; the committed
build launches the single search's kernels below 2 trees) — and times
``benes_local_pass`` on both networks and ``benes_outer_pass`` on each
network's prefix with every build that changes it, on random masks (every
stored word may be nonzero, so no tile skips a stage), each output held
against the plain version:

  cold      ``utils.timing.cold_ms``, as ``chip_smoke.py`` times kernels:
            one launch after a 256 MB write that evicts the L2 and a few ms
            of device sleep, CUDA events around the wrapper call (the
            host's time to launch the kernel passes during the sleep);
  unpadded  the same without the sleep: where the L2 write ends before
            the host has launched the kernel, the span holds the difference.

The element-major local pass (``benes_elem_local_pass``, K5) follows on
the net's shape at ``--groups`` groups (the local run of 29 stages on
tiles of 2^15 elements at 2^26): copies of ``csrc/relay_elem_kernels.cu``
with 64 elements a thread (``kElemRegBits`` = 6, 512 threads) and a ring
of 8 mask slots (``kElemSlots``; the committed build has 32 elements a
thread, 1,024 threads and 16 slots), each held against the
plain version, beside ``index_select`` over the same stages' permutation,
and the committed build on the same launch with no stages (the tile's
copy) and with every stage's masks outside the tile (the copy and the
re-layouts).

The lock-step batch's passes follow (``--only batch``) at ``--trees`` trees
(4 and 16: serve's relay-4 tick and the 16-tree batch): ``benes_local_pass``
on both networks at the batch tiles ``BATCH_TILES`` (each cut to the single
search's tile) and ``benes_outer_pass`` on each tile's prefix, through the
committed build and the copies of ``BATCH_VARIANTS`` (other caps on the
trees a block takes; a build whose launcher picks a group already timed
is skipped), each held against the plain version; beside them the S single launches of
the single search's passes; and where the local pass's time goes at the
batch's tile (the same launch with no stages, the sweep alone, the ring
alone).  ``--only network`` times only ``apply_benes`` on ``[S, n/32]`` words, the
call the batch's superstep makes, with entry points older than the batch
kernels, so that a checkout of an earlier tree (with this file copied in)
is timed like with like.  ``--only single``, ``--only elem`` run one part.

Also the host microseconds per wrapper call.  One line per (build,
kernel), the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from ..graph import benes
from ..graph.relay import COMPACT_MIN_D, StageSpec
from ..ops import relay as R
from ..ops import relay_cuda as K
from ..ops import relay_elem as RE
from ..utils import cuda_build
from ..utils.timing import card_line, cold_ms, host_us

HBM_BYTES_PER_S = 3.35e12
#: name -> (the kernel it changes, its constants).
VARIANTS = {
    "ring1": ("benes_local_pass", {"kMaxRing": 1}),
    "ring2": ("benes_local_pass", {"kMaxRing": 2}),
    "ring4": ("benes_local_pass", {"kMaxRing": 4}),
    "sweep1": ("benes_local_pass", {"kMaxSweep": 1}),
    "units1024x128": ("benes_outer_pass", {"kOuterWords": 1024, "kOuterThreads": 128}),
    "units4096x256": ("benes_outer_pass", {"kOuterWords": 4096, "kOuterThreads": 256}),
    "units4096x512": ("benes_outer_pass", {"kOuterWords": 4096, "kOuterThreads": 512}),
    "batch_kernels": (None, {"kBatchTrees": 1}),
}


#: The batch's sweep: tiles (words), and builds (name -> the kernel it
#: changes, its constants): the most trees a block takes (kLocalGroup,
#: kOuterGroup; the committed build has 16 and 8), the outer pass with
#: another register cap (kOuterGroupBlocks).
BATCH_TILES = (1 << 13, 1 << 14)
BATCH_VARIANTS = {
    **{f"local_group{g}": ("benes_local_pass", {"kLocalGroup": g}) for g in (1, 2, 4, 8)},
    **{f"outer_group{g}": ("benes_outer_pass", {"kOuterGroup": g}) for g in (1, 2, 4, 16)},
    "outer_blocks2": ("benes_outer_pass", {"kOuterGroupBlocks": 2}),
    "outer_blocks8": ("benes_outer_pass", {"kOuterGroupBlocks": 8}),
}

#: name -> the constants of relay_elem_kernels.cu it changes.
ELEM_VARIANTS = {
    "regs64": {"kElemRegBits": 6},
    "slots8": {"kElemSlots": 8},
}


def builds() -> dict:
    """name -> (loaded library, the kernel it changes or None for both, its
    ``kOuterWords``): the committed build and the variants."""
    libs = cuda_build.build_variants(
        "relay_kernels", K.SOURCES["relay_kernels"],
        {name: consts for name, (_, consts) in VARIANTS.items()}, K._register)
    out = {"committed": (K.kernels(), None, K.OUTER_MAX_WORDS)}
    for name, (kernel, consts) in VARIANTS.items():
        out[name] = (libs[name], kernel, consts.get("kOuterWords", K.OUTER_MAX_WORDS))
    return out


def elem_builds() -> dict:
    """name -> (loaded library, kElemRegBits, kElemSlots): the committed
    build of ``relay_elem_kernels.cu`` and its variants."""
    libs = cuda_build.build_variants(
        "relay_elem_kernels", K.SOURCES["relay_elem_kernels"], ELEM_VARIANTS, K._register_elem)
    out = {"committed": (K.elem_kernels(), K.ELEM_REG_BITS, K.ELEM_SLOTS)}
    for name, consts in ELEM_VARIANTS.items():
        out[name] = (libs[name], consts.get("kElemRegBits", K.ELEM_REG_BITS),
                     consts.get("kElemSlots", K.ELEM_SLOTS))
    return out


def elem_sweep(log_n: int, groups: int, gen: torch.Generator) -> list[dict]:
    """``benes_elem_local_pass`` on the local run of a random size-2^log_n
    network at ``groups`` groups, per build, and ``index_select`` over the
    same permutation."""
    libs = elem_builds()
    for build, info in cuda_build.BUILD_INFO.items():
        if build.startswith("relay_elem_kernels"):
            for line in info["ptxas"].splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"ptxas [{build}]: {line.strip()}")
    table, masks, n = network(log_n, gen)
    _, local, _, tile = K.split_elem_passes(table, n)
    stages = tuple(table[i] for i in local)
    x = torch.randint(-(2**31), 2**31, (groups, n), dtype=torch.int32, device="cuda",
                      generator=gen)
    out = torch.empty_like(x)
    want = RE.apply_benes_elem(x, masks, stages, n)
    idx = RE.apply_benes_elem(torch.arange(n, dtype=torch.int32, device="cuda")[None], masks,
                              stages, n)[0].long()
    nbytes = 2 * 4 * groups * n + 4 * sum(st.nwords for st in stages)
    shape = f"{len(stages)} stages, G={groups}, tile {tile} elements, {n // tile * groups} blocks"
    cases = {name: functools.partial(K.launch_elem_local_pass, lib, x, masks, stages, n, tile,
                                     out, reg_bits, slots)
             for name, (lib, reg_bits, slots) in libs.items()}
    cases["index_select"] = lambda: torch.index_select(x, 1, idx, out=out)
    # Where the committed build's time goes: the same launch with no stages
    # (the tile read and written), and with every stage's nonzero range
    # emptied (also the re-layouts between windows; no mask read, no swap).
    lib, reg_bits, slots = libs["committed"]
    dead = tuple(st._replace(lo=0, hi=0) for st in stages)
    diag = {
        "copy only": (functools.partial(K.launch_elem_local_pass, lib, x, masks, (), n, tile,
                                        out, reg_bits, slots), x),
        "re-layouts only": (functools.partial(K.launch_elem_local_pass, lib, x, masks, dead, n,
                                              tile, out, reg_bits, slots), x),
    }
    rows = []
    for name, (fn, same) in diag.items():
        if not torch.equal(fn(), same):
            raise AssertionError(f"elem local pass ({name}) changed its input")
        ms = cold_ms(fn, 20)
        rows.append(dict(network="net", n=n, kernel="benes_elem_local_pass", build=name,
                         shape=shape, cold=ms))
        print(f"elem n=2^{log_n} benes_elem_local_pass [committed, {name}]: cold {ms:.4f} ms",
              flush=True)
    for name, fn in cases.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"elem local pass ({name}) differs from plain")
        ms = {mode: cold_ms(fn, 20, sleep=mode == "cold") for mode in ("cold", "unpadded")}
        row = dict(network="net", n=n, kernel="benes_elem_local_pass", build=name, shape=shape,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, host_us=host_us(fn), **ms)
        rows.append(row)
        print(f"elem n=2^{log_n} benes_elem_local_pass [{name}] ({shape}): cold "
              f"{ms['cold']:.4f} ms, unpadded {ms['unpadded']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms; host {row['host_us']:.1f} us per call; bit-exact",
              flush=True)
    return rows


def network(log_n: int, gen: torch.Generator):
    """A stage table of a size-2^log_n network in the stored layout, with
    random masks on the card: ``(table, masks, n)``.  A stage inside a word
    (d < 32) sets only the bits of each pair's lower element, as the
    router's masks do."""
    n = 1 << log_n
    table, off = [], 0
    for s in range(benes.num_stages(n)):
        d = benes.stage_distance(n, s)
        compact = d >= COMPACT_MIN_D
        nw = n // 64 if compact else n // 32
        table.append(StageSpec(d=d, offset=off, nwords=nw, compact=compact, lo=0, hi=nw))
        off += nw
    masks = torch.randint(-(2**31), 2**31, (off,), dtype=torch.int32, device="cuda",
                          generator=gen)
    for st in table:
        if st.d < 32:
            lower = sum(1 << p for p in range(32) if not p & st.d)
            masks[st.offset : st.offset + st.nwords] &= lower - (1 << 32 if lower >> 31 else 0)
    return tuple(table), masks, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", type=int, default=26)
    ap.add_argument("--vperm", type=int, default=23)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--trees", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--only", choices=("all", "single", "elem", "batch", "network"),
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("benes_pass_sweep: no CUDA device")
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if args.only in ("all", "single"):
        rows += single_sweep(args, gen)
    if args.only in ("all", "elem"):
        rows += elem_sweep(args.net, args.groups, gen)
    if args.only in ("all", "batch", "network"):
        rows += batch_sweep(args, gen, args.only == "network")
    print(card)
    print(json.dumps({"card": card, "sweep": rows}))
    return 0


def single_sweep(args, gen: torch.Generator) -> list[dict]:
    """``benes_local_pass`` and ``benes_outer_pass`` on both networks, per
    build."""
    libs = builds()
    for line in cuda_build.BUILD_INFO["relay_kernels"]["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    rows = []
    for name, log_n in (("vperm", args.vperm), ("net", args.net)):
        table, masks, n = network(log_n, gen)
        pre, local, _, tile = K.split_passes(table, n)
        nw = n // 32
        x = torch.randint(-(2**31), 2**31, (nw,), dtype=torch.int32, device="cuda",
                          generator=gen)
        out = torch.empty_like(x)
        lstages = tuple(table[i] for i in local)
        ostages = tuple(table[i] for i in pre)
        cases = {
            "benes_local_pass": (
                lambda lib, words: K.launch_local_pass(lib, x, masks, lstages, n, tile, out),
                R.apply_benes_std(x, masks, lstages, n),
                2 * 4 * nw + 4 * sum(st.nwords for st in lstages),
                lambda words: f"{len(lstages)} stages, tile {tile} words, {nw // tile} blocks"),
            "benes_outer_pass": (
                lambda lib, words: K.launch_outer_pass(lib, x, masks, ostages, n, out, words),
                R.apply_benes_std(x, masks, ostages, n),
                2 * 4 * nw + 4 * sum(st.nwords for st in ostages),
                lambda words: "prefix, {1} stages, {3} units of {2} x 2^{1} words".format(
                    *K.outer_geometry(tuple(st.d for st in ostages), n, words))),
        }
        for lib_name, (lib, only, words) in libs.items():
            for kernel, (launch, want, nbytes, shape) in cases.items():
                if only not in (None, kernel):
                    continue
                fn = functools.partial(launch, lib, words)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{name} {kernel} ({lib_name}) differs from plain")
                ms = {mode: cold_ms(fn, 20, sleep=mode == "cold")
                      for mode in ("cold", "unpadded")}
                row = dict(network=name, n=n, kernel=kernel, build=lib_name,
                           shape=shape(words), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           host_us=host_us(fn), **ms)
                rows.append(row)
                print(f"{name} n=2^{log_n} {kernel} [{lib_name}] ({row['shape']}): cold "
                      f"{ms['cold']:.4f} ms, unpadded {ms['unpadded']:.4f} ms; bound "
                      f"{row['bound_ms']:.4f} ms; host "
                      f"{row['host_us']:.1f} us per call; bit-exact", flush=True)
        del masks, x, out
        torch.cuda.empty_cache()
    return rows


def _timed(rows: list, fn, want, label: str, **row) -> None:
    """One row: ``fn()`` held against ``want`` bit for bit, then timed cold."""
    if not torch.equal(fn(), want):
        raise AssertionError(f"{label} differs from plain")
    row["cold"] = cold_ms(fn, 10)
    rows.append(row)
    bound = f"; bound {row['bound_ms']:.4f} ms" if "bound_ms" in row else ""
    print(f"{label}: cold {row['cold']:.4f} ms{bound}; bit-exact", flush=True)


def batch_sweep(args, gen: torch.Generator, network_only: bool) -> list[dict]:
    """The lock-step batch's Beneš passes at each of ``args.trees`` trees, on
    random masks: by tile and trees a block (or, ``network_only``, the whole
    network through ``apply_benes``)."""
    rows = []
    if not network_only:
        built = cuda_build.build_variants(
            "relay_kernels", K.SOURCES["relay_kernels"],
            {name: consts for name, (_, consts) in BATCH_VARIANTS.items()}, K._register)
        libs = {"committed": (K.kernels(), None),
                **{name: (built[name], kernel) for name, (kernel, _) in BATCH_VARIANTS.items()}}
        for line in cuda_build.BUILD_INFO["relay_kernels"]["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas: {line.strip()}")
    for S in args.trees:
        for name, log_n in (("vperm", args.vperm), ("net", args.net)):
            table, masks, n = network(log_n, gen)
            nw = n // 32
            x = torch.randint(-(2**31), 2**31, (S, nw), dtype=torch.int32, device="cuda",
                              generator=gen)
            out = torch.empty_like(x)
            head = f"S={S} {name} n=2^{log_n}"
            _timed(rows, lambda: K.apply_benes(x, masks, table, n, out=out),
                   R.apply_benes_std(x, masks, table, n), f"{head} apply_benes",
                   trees=S, network=name, kernel="apply_benes")
            if network_only:
                continue
            single = K.tile_words_for(n)
            for tile in sorted({min(t, single) for t in BATCH_TILES}):
                pre, local, _, _ = K.split_passes(table, n, tile)
                lstages = tuple(table[i] for i in local)
                want = R.apply_benes_std(x, masks, lstages, n)
                nbytes = 4 * sum(st.nwords for st in lstages) + S * 2 * 4 * nw
                timed = set()  # trees a block, of the group builds timed
                for build, (lib, only) in libs.items():
                    if only not in (None, "benes_local_pass"):
                        continue
                    g = K.batch_groups(S, tile, lib)[0]
                    if g in timed:
                        continue
                    timed.add(g)
                    _timed(rows, functools.partial(K.launch_local_pass, lib, x, masks,
                                                   lstages, n, tile, out), want,
                           f"{head} benes_local_pass [{build}] tile {tile} group {g}",
                           trees=S, network=name, kernel="benes_local_pass", build=build,
                           tile=tile, group=g, stages=len(lstages),
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                if tile == K.batch_tile_words(n):
                    # Where the committed group's time goes: the same launch
                    # with no stages (the tiles copied in and out), with the
                    # ring stages dead (the sweep alone) and with the sweep's
                    # stages dead (the ring alone); a dead stage changes
                    # nothing, so each is held against the plain version of
                    # the live stages.
                    for diag, live in (("tiles only", lambda st: False),
                                       ("sweep only", lambda st: st.d < 32),
                                       ("ring only", lambda st: st.d >= 32)):
                        part = tuple(st if live(st) else st._replace(lo=0, hi=0)
                                     for st in lstages)
                        _timed(rows, functools.partial(K.launch_local_pass,
                                                       libs["committed"][0], x, masks, part, n,
                                                       tile, out),
                               R.apply_benes_std(x, masks, tuple(filter(live, lstages)), n),
                               f"{head} benes_local_pass tile {tile} [{diag}]", trees=S,
                               network=name, kernel="benes_local_pass", tile=tile,
                               group=K.batch_groups(S, tile)[0], diag=diag)
                if not pre:
                    continue
                run = K.outer_plan(table, pre, n)[0]
                ostages = tuple(table[i] for i in run.stages)
                want = R.apply_benes_std(x, masks, ostages, n)
                nbytes = 4 * sum(st.nwords for st in ostages) + S * 2 * 4 * nw
                timed = set()
                for build, (lib, only) in libs.items():
                    if only not in (None, "benes_outer_pass"):
                        continue
                    group = K.batch_groups(S, tile, lib)[1]
                    if build.startswith("outer_group") and group in timed:
                        continue
                    timed.add(group)
                    _timed(rows, functools.partial(K.launch_outer_pass, lib, x, masks, ostages,
                                                   n, out), want,
                           f"{head} benes_outer_pass [{build}] prefix (tile {tile}, "
                           f"{run.k} stages, {run.units} units of {run.row_words} x "
                           f"2^{run.k} words) group {group}", trees=S, network=name,
                           kernel="benes_outer_pass", build=build, tile=tile, group=group,
                           stages=run.k, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            # The old way: S launches of the single search's passes.
            pre, local, _, _ = K.split_passes(table, n)
            for kernel, stages, launch in (
                ("benes_local_pass", tuple(table[i] for i in local),
                 lambda st, i: K.benes_local_pass(x[i], masks, st, n, single, out=out[i])),
                ("benes_outer_pass", tuple(table[i] for i in
                                           K.outer_plan(table, pre, n)[0].stages) if pre else (),
                 lambda st, i: K.benes_outer_pass(x[i], masks, st, n, out=out[i])),
            ):
                if not stages:
                    continue
                _timed(rows, lambda: [launch(stages, i) for i in range(S)] and out,
                       R.apply_benes_std(x, masks, stages, n),
                       f"{head} {kernel} at the single tile {single}, {S} single launches",
                       trees=S, network=name, kernel=kernel, tile=single, group="singles")
            del masks, x, out
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
