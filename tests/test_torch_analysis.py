"""The port's lint (``bfs_tpu_torch.analysis``): each AST rule on fixture
snippets; the default run clean against the committed baseline with no
stale entry; the knob rung (KNB001-KNB005) on the tree and with a planted
fault each; the kernel registry's pin (set-equality with the ``__global__``
kernels, the launch keys, the reference's ``KERNEL_SPECS``) and its
lint-scale builders; and the CLI's exit codes on a copy of the package
with a planted fault."""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from bfs_tpu_torch import knobs
from bfs_tpu_torch.analysis import Baseline, analyze_file
from bfs_tpu_torch.analysis import kernels as KR
from bfs_tpu_torch.analysis import knob_rules as KR_rules
from bfs_tpu_torch.analysis.__main__ import main as lint_main
from bfs_tpu_torch.analysis.core import SourceFile
from bfs_tpu_torch.analysis.knobs import analyze_knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(text: str, path: str = "bfs_tpu_torch/fixture.py") -> list[tuple[str, int]]:
    found = analyze_file(os.path.join(REPO, path), REPO, text=textwrap.dedent(text))
    return [(f.rule, f.line) for f in found]


# ---------------------------------------------------------------- AST rules --

HOT = """\
import numpy as np
import torch
from bfs_tpu_torch.analysis.runtime import explicit_transfer


# bfs_tpu_torch: hot
def tick(x, ctl):
    a = x.sum().item()
    b = int(x[0])
    c = int(1e9) + float(3)
    d = x.cpu()
    e = np.asarray(x)
    f = torch.nonzero(x)
    g = x.masked_select(x > 0)
    print(x)
    h = x.tolist()  # bfs_tpu_torch: ok TRC003 a host list by design
    with explicit_transfer():
        i = x.cpu()
    return a, b, c, d, e, f, g, h, i


def cold(x):
    return x.item(), x.cpu(), print(x)
"""


def test_host_sync_rules_in_a_hot_region():
    assert _rules(HOT) == [("TRC001", 8), ("TRC002", 9), ("TRC003", 11), ("TRC003", 12),
                           ("TRC004", 13), ("TRC004", 14), ("TRC005", 15)]


def test_hot_spans_and_overlap():
    text = """\
    def f(x):
        x.item()
        # bfs_tpu_torch: hot-start
        x.item()
        # bfs_tpu_torch: hot-start
        bool(x)
        # bfs_tpu_torch: hot-end
        x.item()
    """
    assert _rules(text) == [("TRC001", 4), ("PRG001", 5), ("TRC002", 6)]


def test_hot_region_decorator_and_captured_pragma():
    text = """\
    from bfs_tpu_torch.analysis.runtime import hot_region

    @hot_region(name="t")
    def f(x):
        return x.item()

    # bfs_tpu_torch: hot captured
    def step(x):
        return float(x)
    """
    assert _rules(text) == [("TRC001", 5), ("TRC002", 9)]


def test_telemetry_read_in_a_hot_region():
    text = """\
    from bfs_tpu_torch.obs.registry import get_registry

    # bfs_tpu_torch: hot
    def tick():
        get_registry().snapshot()
        span_report()

    def report():
        return get_registry().snapshot()
    """
    assert _rules(text) == [("OBS001", 5), ("OBS001", 6)]


LOCKS = """\
import threading

DEVICE_LOCK = threading.RLock()


class Server:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = []  # guarded-by: _lock
        self.count = 0  # guarded-by: DEVICE_LOCK
        self._cache = {}

    def ok(self):
        with self._lock:
            self._pending.append(1)
        with self._cond:
            self._pending.pop()
        with DEVICE_LOCK:
            self.count += 1

    def bad(self):
        self._pending.append(2)
        return self.count

    # bfs_tpu_torch: holds _lock
    def helper(self):
        return len(self._pending)

    def waived(self):
        return self.count  # bfs_tpu_torch: ok LCK001 a report's racy read
"""


def test_lock_rules():
    assert _rules(LOCKS) == [("LCK002", 12), ("LCK001", 23), ("LCK001", 24)]


CACHES = """\
def serve(self, exe_cache, batch, padded):
    first = batch[0]
    bucket = padded * 2
    key = (first.graph, bucket)
    exe_cache.get(key, lambda: build(first.graph, bucket, self.registry))
    width = bucket + 1
    exe_cache.get(key, lambda: build(width, padded))


def loops(self, trees, telemetry):
    lead = (trees,)
    vr = self.relay_graph.vr

    def make():
        return self._empty(*lead, vr), telemetry

    kind = ("multi", trees)
    return L.cached(self._loops, kind, make)
"""


def test_under_keyed_caches():
    """A per-call local the build closure reads and the key does not carry
    is a finding (reported at its read); a bare parameter is context, as
    in the reference."""
    assert _rules(CACHES) == [("RCD005", 7), ("RCD005", 15), ("RCD005", 15)]


def test_suppressions_and_the_baseline():
    text = "# bfs_tpu_torch: hot\ndef f(x):\n    return x.item()\n"
    found = analyze_file(os.path.join(REPO, "bfs_tpu_torch/fixture.py"), REPO, text=text)
    assert [f.rule for f in found] == ["TRC001"]
    bl = Baseline()
    bl.entries[found[0].fingerprint()] = ("TRC001", "why")
    assert bl.accepts(found[0]) and bl.stale() == []
    moved = analyze_file(os.path.join(REPO, "bfs_tpu_torch/fixture.py"), REPO,
                         text="\n\n" + text)
    assert moved[0].fingerprint() == found[0].fingerprint()  # line drift keeps the entry
    rendered = Baseline.render(found + moved, "why")
    assert rendered.count("TRC001") == 1


# ------------------------------------------------------------ the whole tree --

def test_default_run_is_clean_against_the_baseline(capsys):
    assert lint_main([]) == 0
    err = capsys.readouterr().err
    assert " 0 new " in err and " 0 stale " in err


def test_all_passes_clean_and_every_baseline_entry_has_a_reason():
    assert lint_main(["--all"]) == 0
    bl = Baseline.load(os.path.join(REPO, "bfs_tpu_torch", "analysis", "baseline.txt"))
    assert bl.entries
    for rule, why in bl.entries.values():
        reason = why.split("] ", 1)[-1]
        assert reason and "TODO" not in reason, (rule, why)


def test_cli_misuse_exits_2():
    assert lint_main(["--changed", "bfs_tpu_torch"]) == 2
    assert lint_main(["no/such/path.py"]) == 2
    assert lint_main(["--no-such-flag"]) == 2


def test_lint_imports_no_torch():
    code = ("import sys; from bfs_tpu_torch.analysis.__main__ import main; rc = main([]); "
            "print('torch' in sys.modules); sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "False", proc.stdout + proc.stderr


# --------------------------------------------------------------------- knobs --

def test_knob_rung_is_clean_on_the_tree():
    findings, meta = analyze_knobs()
    assert findings == []
    assert meta["knobs"] == sorted(knobs.KNOBS)


def _table(**changes):
    table = dict(knobs.KNOBS)
    for name, fields in changes.items():
        table[name] = dataclasses.replace(table[name], **fields) if name in table else fields
    return table


def _snippets(findings):
    return sorted(f.snippet for f in findings)


def test_knb001_provenance_both_ways():
    ghost = dataclasses.replace(knobs.KNOBS["BFS_TPU_TORCH_SPANS"], name="BFS_TPU_TORCH_GHOST")
    src = SourceFile(os.path.join(REPO, "bfs_tpu_torch/fixture.py"), REPO, text=textwrap.dedent("""\
        import os
        from bfs_tpu_torch import knobs
        a = os.environ.get("BFS_TPU_TORCH_SPANS")
        b = os.environ["BFS_TPU_TORCH_NOPE"]
        c = knobs.get("BFS_TPU_TORCH_TYPO")
        d = os.environ.get("BFS_TPU_TORCH_SPANS")  # bfs_tpu_torch: ok KNB001 restored below
        os.environ["BFS_TPU_TORCH_SPANS"] = "1"
        """))
    found = KR_rules.check_provenance([src], {**knobs.KNOBS, "BFS_TPU_TORCH_GHOST": ghost})
    assert [(f.rule, f.line) for f in found if f.line] == [("KNB001", 3), ("KNB001", 4),
                                                           ("KNB001", 5)]
    dead = {f.snippet for f in found if not f.line}
    assert "knb:BFS_TPU_TORCH_GHOST:unread" in dead
    findings, _ = analyze_knobs({**knobs.KNOBS, "BFS_TPU_TORCH_GHOST": ghost})
    assert _snippets(findings) == ["knb:BFS_TPU_TORCH_GHOST:undocumented",
                                   "knb:BFS_TPU_TORCH_GHOST:unread"]


def test_knb002_keys_against_the_live_builders():
    from bfs_tpu_torch.cache import layout as CL
    from bfs_tpu_torch.resilience import journal
    from bfs_tpu_torch.serve import registry

    assert set(registry.ENGINE_FLAVOR_ENV) == set(knobs.flavor_env("serve"))
    assert tuple(journal.ENV_CONFIG_KEYS) == knobs.flavor_env("journal")
    assert CL._PROBE_ENV == knobs.flavor_env("probe")
    assert CL._LAYOUT_ENV == CL._TILES_ENV == CL._LABELS_ENV == ()
    # A knob that says it keys the serve engine but is not in its key; one
    # the journal hashes without saying so; a journal key off its domain.
    table = _table(BFS_TPU_TORCH_TILES={"affects": frozenset({"journal", "serve"})},
                   BFS_TPU_TORCH_LABELS={"affects": frozenset()},
                   BFS_TPU_TORCH_SPANS={"journal_key": "spans"})
    findings = KR_rules.check_key_completeness(table)
    assert _snippets(findings) == ["knb:BFS_TPU_TORCH_LABELS:journal-key",
                                   "knb:BFS_TPU_TORCH_LABELS:journal:undeclared",
                                   "knb:BFS_TPU_TORCH_SPANS:journal-key",
                                   "knb:BFS_TPU_TORCH_TILES:serve:unkeyed"]
    fixture = {"serve": ("BFS_TPU_TORCH_DIRECTION",), "broken": ("no.such.module", "X")}
    findings = KR_rules.check_key_completeness(providers=fixture)
    assert {f.rule for f in findings} == {"KNB000", "KNB002"}
    assert "knb:BFS_TPU_TORCH_EXPANSION:serve:unkeyed" in _snippets(findings)


def test_knb003_scope():
    src = SourceFile(os.path.join(REPO, "bfs_tpu_torch/fixture.py"), REPO, text=textwrap.dedent("""\
        from bfs_tpu_torch import knobs
        BAKED = knobs.get("BFS_TPU_TORCH_DIRECTION")

        def resolve():
            return knobs.get("BFS_TPU_TORCH_DIRECTION")

        # bfs_tpu_torch: hot captured
        def step():
            return knobs.get("BFS_TPU_TORCH_EXPANSION")
        """))
    assert [(f.rule, f.line) for f in KR_rules.check_scope([src])] == [("KNB003", 2),
                                                                        ("KNB003", 9)]
    table = _table(BFS_TPU_TORCH_DIRECTION={"scope": "import"})
    assert [f.line for f in KR_rules.check_scope([src], table)] == [9]


def test_knb004_the_registry_table():
    doc = knobs.__doc__
    assert KR_rules.check_docs(doc) == []
    rows = KR_rules.doc_table_rows(doc)
    assert set(rows) == set(knobs.KNOBS) and rows["BFS_TPU_TORCH_PHASE_PROBE"][2] == ""
    drifted = doc.replace("BFS_TPU_TORCH_SPANS            flag    1",
                          "BFS_TPU_TORCH_SPANS            flag    0")
    dropped = "\n".join(x for x in doc.splitlines() if "BFS_TPU_TORCH_LOCK_ORDER " not in x)
    stale = doc + "\n  BFS_TPU_TORCH_OLD              flag    0       gone\n"
    assert _snippets(KR_rules.check_docs(drifted)) == ["knb:BFS_TPU_TORCH_SPANS:doc-drift"]
    assert _snippets(KR_rules.check_docs(dropped)) == ["knb:BFS_TPU_TORCH_LOCK_ORDER:undocumented"]
    assert _snippets(KR_rules.check_docs(stale)) == ["knb:BFS_TPU_TORCH_OLD:stale-row"]


def test_knb005_parsers():
    assert KR_rules.check_parsers() == []
    table = _table(BFS_TPU_TORCH_SPANS={"canary": "1"}, BFS_TPU_TORCH_TILES={"default": "hbm"},
                   BFS_TPU_TORCH_LABELS_GB={"canary": None})
    assert _snippets(KR_rules.check_parsers(table)) == [
        "knb:BFS_TPU_TORCH_LABELS_GB:no-canary", "knb:BFS_TPU_TORCH_SPANS:canary-accepted",
        "knb:BFS_TPU_TORCH_TILES:default-rejected"]


# ------------------------------------------------------------------- kernels --

def test_kernel_registry_pins_the_sources():
    from bfs_tpu_torch.ops.relay_cuda import LAUNCHES

    assert KR.registry_findings(REPO) == []
    found = KR.scan_globals(REPO)
    assert len(found) == len(KR.KERNEL_SPECS) == 13
    assert set(found) == set(KR.KERNEL_SPECS)
    by_source = {}
    for name, src in found.items():
        by_source[src] = by_source.get(src, 0) + 1
    assert by_source == {KR.RELAY_CU: 7, KR.ELEM_CU: 5, KR.MXU_CU: 1}
    assert {s.launch_key for s in KR.KERNEL_SPECS.values()} == set(LAUNCHES) and len(LAUNCHES) == 11
    assert {s.k for s in KR.KERNEL_SPECS.values()} == {"K1", "K2", "K3", "K4", "K5", "K6", None}


def test_kernel_registry_covers_the_reference():
    from bfs_tpu.analysis.pallas import KERNEL_SPECS

    assert KR.REFERENCE_KERNEL_SPECS == tuple(KERNEL_SPECS)
    assert {c for s in KR.KERNEL_SPECS.values() for c in s.counters} == set(KERNEL_SPECS)
    for spec in KR.KERNEL_SPECS.values():
        path, line = spec.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        want = "pl.pallas_call(" if spec.counters else ""
        assert want in text, (spec.name, spec.replaces, text)


def test_kernel_registry_planted_faults():
    specs = dict(KR.KERNEL_SPECS)
    orphan = dict(KR.scan_globals(REPO), extra_kernel=KR.RELAY_CU)
    del specs["mxu_expand_kernel"]
    launches = {k: 0 for k in {s.launch_key for s in specs.values()}} | {"ghost": 0}
    broken = dataclasses.replace(specs["loop_control_kernel"], plain=("no.such:module",))
    specs["loop_control_kernel"] = broken
    found = _snippets(KR.registry_findings(REPO, specs, launches, orphan))
    assert found == ["krn:expand.frontier_mxu:uncovered", "krn:extra_kernel:unregistered",
                     "krn:ghost:uncounted", "krn:loop_control_kernel:no.such:module",
                     "krn:mxu_expand_kernel:unregistered"]


def test_kernel_builders_run_at_lint_scale_on_the_cpu():
    """Without a card every wrapper runs its plain version: the builders
    and both call paths are proven, not the kernels."""
    findings, rows = KR.run_on_card("cpu")
    assert findings == [] and set(rows) == set(KR.KERNEL_SPECS)
    assert all(r["max_abs_err"] == 0 and r["launches"] == 0 for r in rows.values())


# ------------------------------------------------------------ CLI on a copy --

@pytest.fixture(scope="module")
def package_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("lintcopy")
    shutil.copytree(os.path.join(REPO, "bfs_tpu_torch"), root / "bfs_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root / "chip_smoke.py")
    return root


def _plant(root, rel: str, old: str, new: str) -> str:
    path = root / rel
    text = path.read_text()
    assert old in text, (rel, old)
    path.write_text(text.replace(old, new, 1))
    return text


@pytest.mark.parametrize("fault", ["clean", "trc", "stale", "knb001", "knb002", "krn000"])
def test_cli_exit_codes_on_planted_faults(package_copy, fault):
    root = package_copy
    plants = {
        "trc": ("bfs_tpu_torch/models/loop.py", "        stats = LoopStats()\n",
                "        stats = LoopStats()\n        self.ctl.sum().item()\n"),
        "stale": ("bfs_tpu_torch/models/loop.py", "            live = bool(ctl[C.LIVE])\n",
                  "            live = ctl[C.LIVE] != 0\n"),
        "knb001": ("bfs_tpu_torch/config.py", "def cache_root() -> str:\n",
                   "def cache_root() -> str:\n    os.environ.get(\"BFS_TPU_TORCH_SPANS\")\n"),
        "knb002": ("bfs_tpu_torch/serve/registry.py", '    "BFS_TPU_TORCH_EXPANSION",\n', ""),
        "krn000": ("bfs_tpu_torch/csrc/relay_mxu_kernels.cu", "__global__ void",
                   "__global__ void planted_kernel(int* x) {}\n__global__ void"),
    }
    saved = None
    if fault != "clean":
        rel, old, new = plants[fault]
        saved = (rel, _plant(root, rel, old, new))
    try:
        flag = {"knb001": "--knobs", "knb002": "--knobs", "krn000": "--kernels"}.get(fault)
        argv = [sys.executable, "-m", "bfs_tpu_torch.analysis", *([flag] if flag else [])]
        proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=str(root)))
    finally:
        if saved is not None:
            (root / saved[0]).write_text(saved[1])
    want = 0 if fault == "clean" else 1
    assert proc.returncode == want, proc.stdout[-3000:] + proc.stderr[-3000:]
    if fault == "stale":
        assert "stale baseline entry" in proc.stdout
