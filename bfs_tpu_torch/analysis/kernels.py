"""The kernel registry: every hand-written CUDA kernel of the port with its
wrapper, its plain PyTorch version and a lint-scale input builder.  The
counterpart of the reference's ``KERNEL_SPECS``
(``bfs_tpu/analysis/pallas.py``), which pins its ``pl.pallas_call`` sites.

``python -m bfs_tpu_torch.analysis --kernels`` proves on any machine
(:func:`registry_findings`, KRN000):

* the specs are set-equal to the ``__global__`` kernels defined in
  ``bfs_tpu_torch/csrc/*.cu`` (a kernel without a spec is an unpoliced
  kernel, a spec without a kernel a stale one);
* their launch keys are exactly the keys of
  ``ops/relay_cuda.py::LAUNCHES`` (a batch kernel counts under the key of
  its single-search sibling: ``benes_local_group`` under
  ``benes_local_pass``, ``benes_outer_group`` under ``benes_outer_pass``);
* every wrapper and plain version imports;
* every entry of the reference's ``KERNEL_SPECS`` is countered by a spec.

On a card (:func:`run_on_card`, KRN001) each kernel runs at lint scale
(an R-MAT scale-10 relay layout, random words) against its plain version
on the same inputs, bit for bit, and must launch.  Without a card the
wrappers run their plain versions, so the check proves only the builders.
"""

from __future__ import annotations

import importlib
import os
import re
from dataclasses import dataclass
from typing import Callable

from .core import Finding

CSRC = "bfs_tpu_torch/csrc"
RELAY_CU = f"{CSRC}/relay_kernels.cu"
ELEM_CU = f"{CSRC}/relay_elem_kernels.cu"
MXU_CU = f"{CSRC}/relay_mxu_kernels.cu"

#: The reference's ``KERNEL_SPECS`` names (``bfs_tpu/analysis/pallas.py``),
#: copied: the port imports nothing of the reference, and a test holds this
#: copy against the original.
REFERENCE_KERNEL_SPECS = (
    "benes.word_tile_major",
    "benes.word_lane_compact",
    "benes.elem_passes",
    "rowmin.tournament",
    "update.packed_words",
    "expand.frontier_mxu",
)

_RC = "bfs_tpu_torch.ops.relay_cuda"
_R = "bfs_tpu_torch.ops.relay"
_RE = "bfs_tpu_torch.ops.relay_elem"


@dataclass(frozen=True)
class KernelSpec:
    """One ``__global__`` kernel: ``k`` the reference kernel it counters
    (K1-K6 of ``PERF.md``; None for a step that is XLA in the reference),
    ``counters`` the reference ``KERNEL_SPECS`` entries, ``replaces`` the
    reference site (file:line), ``wrapper`` and ``plain`` as
    ``module:function``, ``build(ctx)`` -> ``(kernel(), plain())``, each a
    callable returning a tuple of tensors to compare."""

    name: str
    source: str
    launch_key: str
    k: str | None
    counters: tuple
    replaces: str
    wrapper: str
    plain: tuple
    build: Callable


# --------------------------------------------------------------------------
# Lint-scale inputs.
# --------------------------------------------------------------------------

#: The layout of the lint-scale inputs: R-MAT scale 10, edge factor 8.
LINT_SCALE = 10
#: Tiles small enough to give the networks outer stages at this size.
LINT_TILE_WORDS = 64
LINT_ELEM_TILE = 1024
LINT_TREES = 4


class LintContext:
    """The lint-scale operands of every builder on ``device``: a host-built
    relay layout, its masks and valid words on the device, a gather engine
    (its route index), random words from one seed."""

    def __init__(self, device="cuda", seed: int = 7):
        import numpy as np
        import torch

        from ..graph.generators import rmat_graph
        from ..graph.relay import build_relay_graph, valid_slot_words

        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.rg = build_relay_graph(rmat_graph(LINT_SCALE, 8, seed=3))
        self.net_masks = self.tensor(self.rg.net_masks)
        self.valid = self.tensor(valid_slot_words(self.rg.src_l1, self.rg.net_size))
        self._engine = None

    def tensor(self, words):
        import numpy as np
        import torch

        return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(
            self.device)

    def words(self, n: int, *shape: int):
        """``n`` random words (a tenth all ones, a fifth zero) as int32."""
        import numpy as np

        w = self.rng.integers(0, 2**32, n, dtype=np.uint32)
        w[self.rng.random(n) < 0.1] = 0xFFFFFFFF
        w[self.rng.random(n) < 0.2] = 0
        t = self.tensor(w)
        return t.reshape(*shape) if shape else t

    def engine(self):
        if self._engine is None:
            from ..models.bfs import RelayEngine

            self._engine = RelayEngine(self.rg, device=self.device, expansion="gather")
        return self._engine


def _local(ctx, trees: int | None):
    from ..ops import relay as R
    from ..ops import relay_cuda as K

    rg = ctx.rg
    n, table = rg.net_size, rg.net_table
    pre, local, _, _ = K.split_passes(table, n, LINT_TILE_WORDS)
    lstages = tuple(table[i] for i in local)
    x = ctx.words(n // 32 * (trees or 1), *((trees, n // 32) if trees else ()))
    x = R.apply_benes_std(x, ctx.net_masks, tuple(table[i] for i in pre), n)
    return (lambda: (K.benes_local_pass(x, ctx.net_masks, lstages, n, LINT_TILE_WORDS),),
            lambda: (R.apply_benes_std(x, ctx.net_masks, lstages, n),))


def _outer(ctx, trees: int | None):
    from ..ops import relay as R
    from ..ops import relay_cuda as K

    rg = ctx.rg
    n, table = rg.net_size, rg.net_table
    pre, _, _, _ = K.split_passes(table, n, LINT_TILE_WORDS)
    run = K.outer_plan(table, pre, n)[0]
    ost = tuple(table[i] for i in run.stages)
    x = ctx.words(n // 32 * (trees or 1), *((trees, n // 32) if trees else ()))
    return (lambda: (K.benes_outer_pass(x, ctx.net_masks, ost, n),),
            lambda: (R.apply_benes_std(x, ctx.net_masks, ost, n),))


def _rowmin(ctx):
    from ..ops import relay as R
    from ..ops import relay_cuda as K

    rg = ctx.rg
    l1 = ctx.words(rg.net_size // 32)
    return (lambda: (K.rowmin_ranks(l1, ctx.valid, rg.in_classes, rg.vr),),
            lambda: (R.rowmin_ranks(l1, ctx.valid, rg.in_classes, rg.vr),))


def _flag(changed, like):
    """A superstep's changed flag (a tensor or a bool) as int32[1] on
    ``like``'s device."""
    import torch

    return torch.as_tensor(changed, device=like.device).reshape(-1).to(torch.int32)


def _packed_update(ctx):
    import numpy as np

    from ..ops import relay as R
    from ..ops import relay_cuda as K

    rg = ctx.rg
    ranks = R.rowmin_ranks(ctx.words(rg.net_size // 32), ctx.valid, rg.in_classes, rg.vr)
    lv = ctx.rng.integers(0, 6, rg.vr).astype(np.uint32)
    packed = (lv << np.uint32(26)) | ctx.rng.integers(0, 1 << 10, rg.vr).astype(np.uint32)
    packed[ctx.rng.random(rg.vr) < 0.5] = 0xFFFFFFFF
    packed = ctx.tensor(packed)

    def run(fn):
        new = fn(R.PackedRelayState(packed.clone(), None, 5, None), ranks)
        return new.packed, new.fwords, _flag(new.changed, packed)

    return (lambda: run(K.apply_relay_candidates_packed),
            lambda: run(R.apply_relay_candidates_packed))


def _loop_control(ctx):
    from ..ops import control as C
    from ..ops import relay_cuda as K

    ctl = C.new_ctl(ctx.device)
    C.init_ctl(ctl, 9)
    return (lambda: (K.loop_control(ctl.clone()),), lambda: (C.loop_control(ctl.clone()),))


def _elem_split(ctx):
    from ..ops import relay_cuda as K

    rg = ctx.rg
    return K.split_elem_passes(rg.net_table, rg.net_size, LINT_ELEM_TILE)


def _elem_local(ctx):
    from ..ops import relay_cuda as K
    from ..ops import relay_elem as RE

    rg = ctx.rg
    n, table = rg.net_size, rg.net_table
    pre, local, _, _ = _elem_split(ctx)
    lstages = tuple(table[i] for i in local)
    x = RE.apply_benes_elem(ctx.words(2 * n, 2, n), ctx.net_masks,
                            tuple(table[i] for i in pre), n)
    return (lambda: (K.benes_elem_local_pass(x, ctx.net_masks, lstages, n, LINT_ELEM_TILE),),
            lambda: (RE.apply_benes_elem(x, ctx.net_masks, lstages, n),))


def _elem_outer(ctx):
    from ..ops import relay_cuda as K
    from ..ops import relay_elem as RE

    rg = ctx.rg
    n, table = rg.net_size, rg.net_table
    pre, _, _, _ = _elem_split(ctx)
    stage = table[pre[0]]
    x = ctx.words(2 * n, 2, n)
    return (lambda: (K.benes_elem_outer_stage(x, ctx.net_masks, stage, n),),
            lambda: (RE.apply_benes_elem(x, ctx.net_masks, (stage,), n),))


def _route_gather(ctx):
    from ..ops import relay_cuda as K
    from ..ops import relay_elem as RE

    src = ctx.engine().route_index()
    f = ctx.words(ctx.rg.vr, 1, ctx.rg.vr)  # one group: no interleave launch
    return lambda: (K.elem_route_gather(f, src),), lambda: (RE.route_gather(f, src),)


def _interleave(ctx):
    from ..ops import relay_cuda as K
    from ..ops import relay_elem as RE

    f = ctx.words(2 * ctx.rg.vr, 2, ctx.rg.vr)
    return lambda: (K.elem_frontier_interleave(f),), lambda: (RE.interleave_frontier(f),)


def _elem_rowmin_update(ctx):
    from ..ops import relay_cuda as K
    from ..ops import relay_elem as RE

    rg = ctx.rg
    level = 3
    l1 = ctx.words(2 * rg.net_size, 2, rg.net_size)
    offsets, pt = RE.rank_plane_layout(rg.in_classes)
    visited = ctx.words(2 * rg.vr, 2, rg.vr)
    carry = (visited, visited & ctx.words(2 * rg.vr, 2, rg.vr),
             ctx.words(RE.DIST_PLANES * 2 * rg.vr, RE.DIST_PLANES, 2, rg.vr),
             ctx.words(2 * pt, 2, pt))

    def fresh():
        return RE.ElemState(*(t.clone() for t in carry), level, None)

    def plain():
        found, rp = RE.rowmin_elem(l1, ctx.valid, rg.in_classes, rg.vr, offsets, pt)
        st = RE.apply_elem_found(fresh(), found, rp, rg.in_classes, offsets)
        return (*st[:4], _flag(st.changed, l1))

    def kernel():
        st = K.elem_rowmin_update(l1, ctx.valid, fresh(), rg.in_classes, rg.vr)
        return (*st[:4], _flag(st.changed, l1))

    return kernel, plain


def _mxu_expand(ctx):
    import numpy as np
    import torch

    from ..graph import adj_tiles as AT
    from ..ops import relay as R
    from ..ops import relay_cuda as K
    from ..ops import relay_mxu as RM

    rows = cols = 2000
    src = ctx.rng.integers(0, rows, 20000)
    dst = ctx.rng.integers(0, cols, 20000)
    at = AT.build_adj_tiles_device(
        torch.from_numpy(src.astype(np.int64)), torch.from_numpy(dst.astype(np.int64)),
        rows=rows, cols=cols, keys2d=AT.keys_from_new2old(ctx.rng.permutation(rows), rows),
        device=ctx.device)
    ops = RM.mxu_device_operands(at, ctx.device)
    kw = dict(rows=rows, cols=cols, rtp=at.rtp, vtp=at.vtp)
    fw = R.pack_std(torch.from_numpy(ctx.rng.random(-(-rows // 32) * 32) < 0.3)).to(ctx.device)
    return (lambda: (K.expand_frontier_mxu(fw, ops, **kw),),
            lambda: (RM.expand_frontier_mxu_plain(fw, ops, **kw),))


_PALLAS = "bfs_tpu/ops/relay_pallas.py"

KERNEL_SPECS: dict[str, KernelSpec] = {s.name: s for s in (
    KernelSpec("benes_local_pass_kernel", RELAY_CU, "benes_local_pass", "K1",
               ("benes.word_tile_major",), f"{_PALLAS}:455", f"{_RC}:benes_local_pass",
               (f"{_R}:apply_benes_std",), lambda ctx: _local(ctx, None)),
    KernelSpec("benes_local_group_kernel", RELAY_CU, "benes_local_pass", "K1",
               ("benes.word_tile_major",), f"{_PALLAS}:455", f"{_RC}:benes_local_pass",
               (f"{_R}:apply_benes_std",), lambda ctx: _local(ctx, LINT_TREES)),
    KernelSpec("benes_outer_pass_kernel", RELAY_CU, "benes_outer_pass", "K2",
               ("benes.word_tile_major", "benes.word_lane_compact"), f"{_PALLAS}:618",
               f"{_RC}:benes_outer_pass", (f"{_R}:apply_benes_std",),
               lambda ctx: _outer(ctx, None)),
    KernelSpec("benes_outer_group_kernel", RELAY_CU, "benes_outer_pass", "K2",
               ("benes.word_tile_major", "benes.word_lane_compact"), f"{_PALLAS}:618",
               f"{_RC}:benes_outer_pass", (f"{_R}:apply_benes_std",),
               lambda ctx: _outer(ctx, LINT_TREES)),
    KernelSpec("class_rowmin_kernel", RELAY_CU, "class_rowmin", "K3", ("rowmin.tournament",),
               f"{_PALLAS}:1059", f"{_RC}:rowmin_ranks", (f"{_R}:rowmin_ranks",), _rowmin),
    # K4's paths: RelayEngine's packed loops (both arms, the lock-step batch),
    # the mesh's ShardedRelayEngine.run and run_segmented once per shard per
    # superstep (rank candidates on gather, original ids on the MXU arm).
    KernelSpec("packed_update_kernel", RELAY_CU, "packed_update", "K4", ("update.packed_words",),
               f"{_PALLAS}:1188", f"{_RC}:apply_relay_candidates_packed",
               (f"{_R}:apply_relay_candidates_packed",), _packed_update),
    # XLA in the reference: the fused loop's condition changed & (level < cap).
    KernelSpec("loop_control_kernel", RELAY_CU, "loop_control", None, (),
               "bfs_tpu/models/bfs.py:637", f"{_RC}:loop_control",
               ("bfs_tpu_torch.ops.control:loop_control",), _loop_control),
    KernelSpec("benes_elem_local_pass_kernel", ELEM_CU, "benes_elem_local_pass", "K5",
               ("benes.elem_passes",), f"{_PALLAS}:860", f"{_RC}:benes_elem_local_pass",
               (f"{_RE}:apply_benes_elem",), _elem_local),
    KernelSpec("benes_elem_outer_stage_kernel", ELEM_CU, "benes_elem_outer_stage", "K5",
               ("benes.elem_passes",), f"{_PALLAS}:860", f"{_RC}:benes_elem_outer_stage",
               (f"{_RE}:apply_benes_elem",), _elem_outer),
    KernelSpec("elem_route_gather_kernel", ELEM_CU, "elem_route_gather", "K5",
               ("benes.elem_passes",), f"{_PALLAS}:860", f"{_RC}:elem_route_gather",
               (f"{_RE}:route_gather",), _route_gather),
    KernelSpec("elem_frontier_interleave_kernel", ELEM_CU, "elem_frontier_interleave", "K5",
               ("benes.elem_passes",), f"{_PALLAS}:860", f"{_RC}:elem_frontier_interleave",
               (f"{_RE}:interleave_frontier",), _interleave),
    # XLA in the reference: rowmin_elem (:186) and the update (:258).
    KernelSpec("elem_rowmin_update_kernel", ELEM_CU, "elem_rowmin_update", None, (),
               "bfs_tpu/ops/relay_elem.py:186", f"{_RC}:elem_rowmin_update",
               (f"{_RE}:rowmin_elem", f"{_RE}:apply_elem_found"), _elem_rowmin_update),
    # K6's paths: RelayEngine's MXU arm (run, run_segmented, the lock-step
    # batch, the streamed arm per superblock) and the mesh's
    # ShardedRelayEngine.run and run_segmented with expansion="mxu", once per
    # shard per dense superstep on the global frontier words.
    KernelSpec("mxu_expand_kernel", MXU_CU, "mxu_expand", "K6", ("expand.frontier_mxu",),
               "bfs_tpu/ops/relay_mxu.py:373", f"{_RC}:expand_frontier_mxu",
               ("bfs_tpu_torch.ops.relay_mxu:expand_frontier_mxu_plain",), _mxu_expand),
)}


# --------------------------------------------------------------------------
# The pin.
# --------------------------------------------------------------------------

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def scan_globals(root: str) -> dict[str, str]:
    """``{kernel name: source}`` of every ``__global__`` definition in the
    ``.cu`` files under ``bfs_tpu_torch/csrc``."""
    found: dict[str, str] = {}
    csrc = os.path.join(root, CSRC)
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn), encoding="utf-8") as f:
                text = f.read()
            for m in _GLOBAL.finditer(text):
                found[m.group(1)] = f"{CSRC}/{fn}"
    return found


def _resolve(ref: str):
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


def _pin(rule: str, message: str, snippet: str, path: str = CSRC) -> Finding:
    return Finding(rule=rule, path=path, line=0, col=0, message=message, snippet=snippet)


def registry_findings(root: str, specs: dict | None = None, launches: dict | None = None,
                      globals_found: dict | None = None) -> list[Finding]:
    """KRN000 on the CPU: the specs against the kernel sources, the launch
    counters, the imports and the reference's kernels.  The optional
    arguments replace the live sources (test fixtures)."""
    specs = KERNEL_SPECS if specs is None else specs
    found = scan_globals(root) if globals_found is None else globals_found
    if launches is None:
        from ..ops.relay_cuda import LAUNCHES as launches
    out: list[Finding] = []
    for name in sorted(set(found) - set(specs)):
        out.append(_pin("KRN000", f"__global__ {name} ({found[name]}) has no KernelSpec: an "
                                  "unregistered kernel is an unpoliced one", f"krn:{name}:unregistered",
                        found[name]))
    for name in sorted(set(specs) - set(found)):
        out.append(_pin("KRN000", f"KernelSpec {name} names no __global__ kernel in {CSRC}",
                        f"krn:{name}:stale"))
    for name in sorted(set(specs) & set(found)):
        if specs[name].source != found[name]:
            out.append(_pin("KRN000", f"KernelSpec {name} says {specs[name].source}, the kernel "
                                      f"is defined in {found[name]}", f"krn:{name}:source"))
    keys = {s.launch_key for s in specs.values()}
    for key in sorted(keys - set(launches)):
        out.append(_pin("KRN000", f"launch key {key} is not a key of relay_cuda.LAUNCHES",
                        f"krn:{key}:launch-key"))
    for key in sorted(set(launches) - keys):
        out.append(_pin("KRN000", f"relay_cuda.LAUNCHES counts {key}, which no KernelSpec names",
                        f"krn:{key}:uncounted"))
    for name in sorted(specs):
        for ref in (specs[name].wrapper, *specs[name].plain):
            try:
                _resolve(ref)
            except Exception as exc:
                out.append(_pin("KRN000", f"KernelSpec {name}: {ref} does not import "
                                          f"({type(exc).__name__}: {exc})", f"krn:{name}:{ref}"))
    covered = {c for s in specs.values() for c in s.counters}
    for ref in REFERENCE_KERNEL_SPECS:
        if ref not in covered:
            out.append(_pin("KRN000", f"the reference's kernel {ref} is countered by no "
                                      "KernelSpec", f"krn:{ref}:uncovered"))
    return out


def run_on_card(device="cuda", specs: dict | None = None, ctx: LintContext | None = None):
    """Each kernel at lint scale against its plain version, bit for bit:
    ``(findings, rows)``, a row per kernel with ``max_abs_err`` and the
    launches its call made.  On a CPU device the wrappers run the plain
    versions (the builders are all that is proven)."""
    import torch

    from ..ops import relay_cuda as K

    specs = KERNEL_SPECS if specs is None else specs
    ctx = LintContext(device) if ctx is None else ctx
    findings, rows = [], {}
    for name in sorted(specs):
        spec = specs[name]
        kernel, plain = spec.build(ctx)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        before = K.LAUNCHES[spec.launch_key]
        got = kernel()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        launched = K.LAUNCHES[spec.launch_key] - before
        want = plain()
        err = 0
        for a, b in zip(got, want):
            if a.shape != b.shape:
                err = -1
                break
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = max(err, int(diff.max()) if diff.numel() else 0)
        rows[name] = {"max_abs_err": err, "launches": launched, "outputs": len(got)}
        if err or len(got) != len(want) or (ctx.device.type == "cuda" and launched < 1):
            findings.append(_pin("KRN001", f"{name}: kernel against {', '.join(spec.plain)} at "
                                           f"lint scale: max abs err {err}, {launched} launches",
                                 f"krn:{name}:parity", spec.source))
    return findings, rows
