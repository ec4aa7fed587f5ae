"""The superstep phase ledger and the expansion probe: the port of
``bfs_tpu.profiling``.

:func:`superstep_phase_ledger` splits one dense relay superstep into its
phases and times each alone on the engine's own device operands, so the
residual between the phases and the whole superstep is measured:

    vperm         frontier words through the small Beneš network (K1, K2)
    broadcast     vperm output words -> L2 slot words (``broadcast_l2``)
    net_apply     L2 -> L1 through the big Beneš network (K1, K2: the
                  mask stream)
    rowmin        the masked per-class row-min (K3, ``class_rowmin``)
    state_update  the candidates merged into the carry (K4,
                  ``packed_update``), with the bytes of both carry layouts
    expansion     the gather and MXU dense supersteps (K6, ``mxu_expand``)
                  on a pinned dense frontier, when the engine holds tiles

and the whole dense superstep, plain and with the level-curve telemetry,
for the cross-check (``sum_of_phases`` against ``full_superstep``).

:func:`probe_phase_kernels` is what ``RelayEngine``'s ``auto`` arm measures
at engine init (memoized beside the layout bundles,
:func:`bfs_tpu_torch.cache.layout.probe_verdict_key`): the gather and MXU
dense supersteps on a pinned, fully dense frontier (the regime the dense
body runs in; an evolving frontier would empty after a superstep and time
``class_rowmin``'s early exit and ``mxu_expand``'s sparse path instead),
the faster one selected; and K3 and K4 beside their plain versions, for the
record: on a card the port always runs the kernel (no ported kernel gives
way to a stock op), on the CPU the plain version (the kernels run only on a
card, the reference's interpret-mode basis).

Timing is the reference's: ``loops`` and ``2 * loops`` iterations of a
step after a warm-up of both counts, the minimum of ``repeats`` (at least
2) runs of each, and ``(t(2K) - t(K)) / K``, so launch and sync overhead
cancels.  On a card each step is captured once into a CUDA graph (after
one eager call that fills its caches) and the K and 2K replays are timed
with CUDA events; the plain arms run eagerly between the events.  On the
CPU the host clock times eager calls.  Every gated kernel gets a LIVE
control block (K1-K4 and K6 return at entry on a dead superstep): the
probe and the ledger time real work.  Each run starts from the same state
(the reference's loops start from their arguments): an untimed ``prep``
restores what a step updates in place.

Analytic bytes are the least memory traffic of each phase (operands read
once, outputs written once), the reference's for the same layout.

``python -m bfs_tpu_torch.profiling [--scale 12] [--edge-factor 8]
[--device cpu|cuda]`` prints the ledger of a small R-MAT as JSON (on the
card unless ``--device cpu``).
"""

from __future__ import annotations

import time

import torch

from .ops import control as C
from .ops import relay as R
from .ops import relay_cuda as K
from .ops.packed import INT32_MAX
from .utils.timing import device_name

__all__ = [
    "superstep_phase_ledger",
    "state_update_bytes",
    "probe_phase_kernels",
]


def state_update_bytes(vr: int, packed: bool) -> dict:
    """Analytic per-superstep bytes of the state-update phase: the
    dist/parent carry is 8 bytes a vertex packed (one uint32 read, one
    written) against 16 unpacked (two int32 each way); the candidate read
    and the frontier-word write are the same in both layouts."""
    word = 4 * vr if packed else 8 * vr
    return {
        "dist_parent_read": word,
        "dist_parent_written": word,
        "candidate_read": 4 * vr,
        "frontier_words_written": vr // 8,
        "total": 2 * word + 4 * vr + vr // 8,
    }


class _Timer:
    """Seconds per call of a step by the K / 2K difference (the module's
    docstring).  ``bodies`` keeps, per timed step, the kernel launches of
    one call (captured) and the calls made, so the launches a probe made
    are accounted for: ``launches[k] = per_step[k] * steps``."""

    def __init__(self, device: torch.device, loops: int, repeats: int):
        self.card = device.type == "cuda"
        self.loops = int(loops)
        self.repeats = max(int(repeats), 2)
        self.bodies: dict[str, dict] = {}

    def __call__(self, name: str, step, prep=None, capture: bool = True) -> float:
        from .models import loop as L

        graph, per_step, steps = None, {}, 0
        run = step
        if self.card and capture:
            if prep:
                prep()
            step()  # fills the step's caches (tables, kernel libraries) before the capture
            steps = 1
            graph, per_step = L.capture(step)
            run = graph.replay

        def timed(k: int) -> float:
            nonlocal steps
            if prep:
                prep()
            steps += k
            if self.card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(k):
                    run()
                t1.record()
                t1.synchronize()
                return t0.elapsed_time(t1) / 1e3
            t0 = time.perf_counter()
            for _ in range(k):
                run()
            return time.perf_counter() - t0

        k = self.loops
        timed(k)
        timed(2 * k)  # warm both counts
        t1 = min(timed(k) for _ in range(self.repeats))
        t2 = min(timed(2 * k) for _ in range(self.repeats))
        if graph is not None:
            K.add_launches({n: c * (steps - 1) for n, c in per_step.items()})  # the replays
        self.bodies[name] = {"per_step": dict(per_step), "steps": steps}
        return max(t2 - t1, 1e-9) / k

    def launches(self) -> dict[str, int]:
        """Kernel launches of every step timed so far, by kernel."""
        out: dict[str, int] = {}
        for body in self.bodies.values():
            for n, c in body["per_step"].items():
                out[n] = out.get(n, 0) + c * body["steps"]
        return out


def _live_ctl(device: torch.device) -> torch.Tensor:
    """A control block that stays LIVE (no control step runs): every gated
    kernel does its work, at level 0."""
    ctl = C.new_ctl(device)
    C.init_ctl(ctl, 1)
    return ctl


def _check_live(ctl: torch.Tensor) -> None:
    if int(ctl[C.LIVE]) != 1:
        raise AssertionError("the probe's control block went dead: it timed empty launches")


def _i32(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=device)


def _first_ranks(vr: int, device) -> torch.Tensor:
    """The state-update's candidates: the sentinel but for the first 64
    vertices, ranks 0..63 (the reference's)."""
    cand = _i32(vr, -1, device)
    n = min(64, vr)
    cand[:n] = torch.arange(n, dtype=torch.int32, device=device)
    return cand


def _kernel_arms(eng, timer: _Timer, ctl: torch.Tensor) -> dict:
    """K3 and K4 (packed carry) on the engine's shapes, beside their plain
    versions on the same device: ``{"rowmin": {...}, "state_update":
    {...}}``, each with ``kernel_seconds`` (a card only), ``plain_seconds``,
    ``selected`` and ``selection_basis``."""
    rg, dev = eng.relay_graph, eng.device
    vr = rg.vr
    x_net = torch.zeros(rg.net_size // 32, dtype=torch.int32, device=dev)
    cand = _first_ranks(vr, dev)
    fw0 = torch.zeros(vr // 32, dtype=torch.int32, device=dev)
    fout = torch.empty_like(fw0)
    pk = _i32(vr, -1, dev)

    def prep():
        pk.fill_(-1)

    def plain_update():
        new = R.apply_relay_candidates_packed(R.PackedRelayState(pk, fw0, None, None), cand, ctl)
        pk.copy_(new.packed)

    arms = {
        "rowmin": (
            lambda: K.rowmin_ranks(x_net, eng.valid_words, rg.in_classes, vr, ctl=ctl),
            lambda: R.rowmin_ranks(x_net, eng.valid_words, rg.in_classes, vr),
            None,
        ),
        "state_update": (
            lambda: K.apply_relay_candidates_packed(R.PackedRelayState(pk, fw0, None, None), cand,
                                                    fwords_out=fout, ctl=ctl),
            plain_update,
            prep,
        ),
    }
    out = {}
    for phase, (kernel, plain, reset) in arms.items():
        rec = {"plain_seconds": timer(f"{phase}.plain", plain, reset, capture=False)}
        if timer.card:
            rec["kernel_seconds"] = timer(f"{phase}.kernel", kernel, reset)
            rec["selected"] = "kernel"
            rec["selection_basis"] = "kernel: the port runs no stock arm on a card"
        else:
            rec["selected"] = "plain"
            rec["selection_basis"] = (
                "plain: the kernels run only on a card (the reference's interpret-mode basis)")
        out[phase] = rec
    return out


def _dense_arm(eng, arm: str, timer: _Timer, ctl: torch.Tensor) -> float:
    """Seconds per dense superstep of one expansion arm on the engine's
    carry, from a pinned frontier with every bit set: the candidates (K1,
    broadcast, K1, K3 on the gather arm; K6 on the MXU arm) and the merge
    (K4 on the packed carry, the plain merge on the unpacked one), the next
    frontier into a scratch array."""
    rg, dev = eng.relay_graph, eng.device
    vr = rg.vr
    fw = _i32(vr // 32, -1, dev)
    fout = torch.empty_like(fw)
    words = [_i32(vr, -1 if eng.packed else INT32_MAX, dev)]
    if not eng.packed:
        words.append(_i32(vr, -1, dev))

    def cand() -> torch.Tensor:
        if arm == "mxu":
            rows, cols, rtp, vtp, _ = eng.mxu_geometry
            c = K.expand_frontier_mxu(fw, eng.mxu_operands, rows=rows, cols=cols, rtp=rtp,
                                      vtp=vtp, ctl=ctl)
            return c if eng.packed else torch.where(c == -1, INT32_MAX, c)
        ranks = eng._ranks(fw, ctl)
        return ranks if eng.packed else R.rank_to_slot(ranks, rg.in_classes, vr)

    def step():
        if eng.packed:
            K.apply_relay_candidates_packed(R.PackedRelayState(words[0], fw, None, None), cand(),
                                            fwords_out=fout, ctl=ctl)
            return
        new = R.apply_relay_candidates(R.RelayState(*words, fw, None, None), cand(), ctl)
        for dst, src in zip(words, new[:2]):
            dst.copy_(src)
        fout.copy_(new.fwords)

    def prep():
        words[0].fill_(-1 if eng.packed else INT32_MAX)
        if not eng.packed:
            words[1].fill_(-1)

    return timer(f"expansion.{arm}", step, prep)


def _expansion_arms(eng, timer: _Timer, ctl: torch.Tensor) -> dict:
    """Both expansion arms' dense supersteps on the engine's operands (its
    resident tiles), on a pinned dense frontier; the faster is
    ``selected``, ``selection_basis`` always a measurement.  Off a card a
    failing MXU arm is on record and selects gather; on a card it raises,
    since a kernel there either launches or fails the caller."""
    arms = {"gather": _dense_arm(eng, "gather", timer, ctl)}
    try:
        arms["mxu"] = _dense_arm(eng, "mxu", timer, ctl)
    except Exception as exc:
        if timer.card:
            raise
        arms["mxu_error"] = repr(exc)
    rec = {
        "arms": arms,
        "gather_seconds": arms["gather"],
        "tiles": int(eng.adj_tiles.nt),
        "mxu_kernel": "mxu_expand" if timer.card else "plain",
        "frontier": "pinned dense (all bits set)",
    }
    if "mxu" in arms:
        rec["mxu_seconds"] = arms["mxu"]
        rec["selected"] = "mxu" if arms["mxu"] <= arms["gather"] else "gather"
        rec["selection_basis"] = "measured"
    else:
        rec["selected"] = "gather"
        rec["selection_basis"] = "measured (mxu arm failed)"
    return rec


def probe_phase_kernels(eng, *, loops: int = 4, repeats: int = 2) -> dict:
    """The measured half of ``RelayEngine``'s arm selection on the
    engine's own operands: ``rowmin`` and ``state_update`` (kernel against
    plain, the port's fixed rule recorded as the basis), and, when the
    engine holds resident tiles, ``expansion`` (:func:`_expansion_arms`;
    off a card an arm that raises is on record: ``probe_error``, no
    ``selected``; on a card it raises).
    Also the device, the K of the timing, the kernel ``launches`` the probe
    made and the ``bodies`` they came from (launches of one call, calls)."""
    timer = _Timer(eng.device, loops, repeats)
    ctl = _live_ctl(eng.device)
    out = {
        "device": device_name(eng.device),
        "applier": "kernel" if timer.card else "plain",
        "loops": int(loops),
        "repeats": int(repeats),
        **_kernel_arms(eng, timer, ctl),
    }
    if getattr(eng, "mxu_operands", None) is not None:
        try:
            out["expansion"] = _expansion_arms(eng, timer, ctl)
        except Exception as exc:
            if timer.card:
                raise
            out["expansion"] = {"probe_error": repr(exc)}
    _check_live(ctl)
    out["control_block"] = "live"
    out["launches"] = timer.launches()
    out["bodies"] = timer.bodies
    return out


def superstep_phase_ledger(eng, *, loops: int = 4, repeats: int = 2) -> dict:
    """The per-phase ledger of one dense superstep on a resident
    ``RelayEngine``'s own device operands (the module's docstring): the
    reference's top-level keys and phase names, the port's values.
    ``rowmin`` and ``state_update`` report the arm the engine runs (the
    kernel on a card, the plain version on the CPU) with both arms'
    seconds where both run; ``expansion`` (an engine
    holding tiles) the arm the engine runs, with both arms'."""
    rg, dev = eng.relay_graph, eng.device
    vr, packed = rg.vr, bool(eng.packed)
    timer = _Timer(dev, loops, repeats)
    ctl = _live_ctl(dev)
    phases: dict = {}

    # ---- the two networks and the broadcast between them ------------------
    x_vp = torch.zeros(rg.vperm_size // 32, dtype=torch.int32, device=dev)
    x_vp[0] = 1
    y = K.apply_benes(x_vp, eng.vperm_masks, rg.vperm_table, rg.vperm_size)
    x_net = torch.zeros(rg.net_size // 32, dtype=torch.int32, device=dev)
    vperm_mask_bytes = int(rg.vperm_masks.nbytes)
    net_mask_bytes = int(rg.net_masks.nbytes)
    phases["vperm"] = {
        "seconds": timer("vperm", lambda: K.apply_benes(
            x_vp, eng.vperm_masks, rg.vperm_table, rg.vperm_size, ctl=ctl)),
        "mask_bytes": vperm_mask_bytes,
        "word_bytes_rw": rg.vperm_size // 8,
    }
    phases["broadcast"] = {
        "seconds": timer("broadcast", lambda: R.broadcast_l2(
            y, rg.out_classes, rg.net_size, rg.out_space)),
        "word_bytes_rw": (rg.vperm_size + rg.net_size) // 8,
    }
    phases["net_apply"] = {
        "seconds": timer("net_apply", lambda: K.apply_benes(
            x_net, eng.net_masks, rg.net_table, rg.net_size, ctl=ctl)),
        "mask_bytes": net_mask_bytes,
        "word_bytes_rw": rg.net_size // 8,
    }

    # ---- K3 and K4: the arm the engine runs, both arms where both run -------
    kernel_arms = _kernel_arms(eng, timer, ctl)

    def arm_record(phase: str) -> dict:
        rec = kernel_arms[phase]
        arms = {a: rec[f"{a}_seconds"] for a in ("kernel", "plain") if f"{a}_seconds" in rec}
        return {"seconds": arms[rec["selected"]], "selected": rec["selected"],
                "selection_basis": rec["selection_basis"], "arms": arms}

    phases["rowmin"] = {
        **arm_record("rowmin"),
        "flavor": "ranks (packed)" if packed else "slots (unpacked)",
        "word_bytes_read": 2 * (rg.net_size // 8),
        "candidate_bytes_written": 4 * vr,
    }
    d0, p0 = _i32(vr, INT32_MAX, dev), _i32(vr, -1, dev)
    fw0 = torch.zeros(vr // 32, dtype=torch.int32, device=dev)
    ranks = _first_ranks(vr, dev)
    slots = torch.where(ranks == -1, INT32_MAX, ranks)

    def unpacked_update():
        new = R.apply_relay_candidates(R.RelayState(d0, p0, fw0, None, None), slots, ctl)
        d0.copy_(new.dist)
        p0.copy_(new.parent)

    def unpacked_prep():
        d0.fill_(INT32_MAX)
        p0.fill_(-1)

    t_unpacked = timer("state_update.unpacked", unpacked_update, unpacked_prep, capture=False)
    update = arm_record("state_update")
    phases["state_update"] = {
        **update,
        "seconds": update["seconds"] if packed else t_unpacked,
        "packed": {"seconds": update["seconds"], "bytes": state_update_bytes(vr, True)},
        "unpacked": {"seconds": t_unpacked, "bytes": state_update_bytes(vr, False)},
        "dist_parent_bytes_ratio": (
            state_update_bytes(vr, False)["dist_parent_written"]
            / state_update_bytes(vr, True)["dist_parent_written"]
        ),
    }

    # ---- the expansion arms, when the engine holds tiles ------------------
    if getattr(eng, "mxu_operands", None) is not None:
        try:
            exp = _expansion_arms(eng, timer, ctl)
        except Exception as exc:
            if timer.card:
                raise
            exp = {"probe_error": repr(exc), "arms": {}}
        if eng.expansion in exp.get("arms", {}):
            exp["seconds"] = exp["arms"][eng.expansion]
        exp["selected"] = eng.expansion
        exp["selection_basis"] = getattr(eng, "expansion_basis", None)
        phases["expansion"] = exp

    # ---- the whole dense superstep, and with the level-curve telemetry -----
    fields = [_i32(vr, -1, dev)] if packed else [_i32(vr, INT32_MAX, dev), _i32(vr, -1, dev)]
    fw = torch.zeros(vr // 32, dtype=torch.int32, device=dev)
    state = (R.PackedRelayState if packed else R.RelayState)(*fields, fw, None, None)
    _tel, record = eng._telemetry(fw, True)

    def full_prep():
        fields[0].fill_(-1 if packed else INT32_MAX)
        if not packed:
            fields[1].fill_(-1)
        fw.zero_()
        fw[0] = 1  # relabeled vertex 0's frontier, evolving over the K steps

    def full_tel():
        eng._gated_dense(state, ctl)
        record(ctl)

    phases["full_superstep"] = {
        "seconds": timer("full_superstep", lambda: eng._gated_dense(state, ctl), full_prep)}
    phases["full_superstep_telemetry"] = {
        "seconds": timer("full_superstep_telemetry", full_tel, full_prep)}
    _check_live(ctl)

    accounted = sum(
        phases[p]["seconds"] for p in ("vperm", "broadcast", "net_apply", "rowmin", "state_update"))
    return {
        "packed_state": packed,
        "applier": "kernel" if timer.card else "plain",
        "loops": int(loops),
        "repeats": int(repeats),
        "device": device_name(dev),
        "phases": phases,
        "sum_of_phases_seconds": accounted,
        "full_superstep_seconds": phases["full_superstep"]["seconds"],
        "telemetry_overhead_ratio": (
            phases["full_superstep_telemetry"]["seconds"]
            / max(phases["full_superstep"]["seconds"], 1e-12)
        ),
        "mask_bytes_total": vperm_mask_bytes + net_mask_bytes,
        "note": (
            "each phase alone on the engine's own operands under a live control block; "
            "K/2K timing difference cancels launch and sync overhead (CUDA graph replays "
            "between CUDA events on a card, the host clock on the CPU); state_update "
            "reports both layouts: dist/parent bytes halved packed"
        ),
    }


def main(argv=None) -> int:
    """Build a small R-MAT, run the ledger on its default relay engine and
    print it as JSON."""
    import argparse
    import json

    from . import rmat_graph
    from .models.bfs import RelayEngine

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=12)
    parser.add_argument("--edge-factor", type=int, default=8)
    parser.add_argument("--loops", type=int, default=4)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="default: the card (raises without one)")
    args = parser.parse_args(argv)
    g = rmat_graph(args.scale, args.edge_factor, seed=7)
    eng = RelayEngine(g, device=args.device, sparse_hybrid=False)
    print(json.dumps(superstep_phase_ledger(eng, loops=args.loops, repeats=args.repeats),
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
