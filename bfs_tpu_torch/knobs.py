"""The port's environment knobs: a typed registry.

Each knob has a type, a default and a validator; :func:`get` reads the
environment, takes the default when the variable is unset or empty, and
raises ``ValueError`` on a value its validator refuses (a typo'd knob that
were silently clamped would quietly change what a run measured).  They
mirror knobs of the reference's registry of the same names without
``TORCH_``:

  ============================== ======= ======= ==========================
  name                           type    default meaning
  ============================== ======= ======= ==========================
  BFS_TPU_TORCH_DIRECTION        enum    auto    push | pull | auto
  BFS_TPU_TORCH_DIRECTION_ALPHA  float   14.0    go pull when m_f * alpha
                                                 > m_u (> 0)
  BFS_TPU_TORCH_DIRECTION_BETA   float   24.0    stay pull while n_f * beta
                                                 > n (> 0)
  BFS_TPU_TORCH_LAYOUT_BUILD     enum    device  device | host relay builder
  BFS_TPU_TORCH_CACHE_DIR        path    ""      artifact cache root
                                                 ("" = <repo>/.bench_cache)
  BFS_TPU_TORCH_FAULT            spec    ""      fault injection:
                                                 kill|raise|phase:<phase>
                                                 [:nth] | delay:<phase>
                                                 [:seconds]
  BFS_TPU_TORCH_CKPT             spec    off     superstep checkpoints:
                                                 off | every:<k> | auto
  BFS_TPU_TORCH_CKPT_MTBF_S      float   600.0   failure-rate prior of the
                                                 auto interval (> 0)
  BFS_TPU_TORCH_SSSP_DELTA       spec    64      delta-stepping bucket width:
                                                 an int, or inf | infinite |
                                                 single (one bucket); <= 0
                                                 is one bucket
  BFS_TPU_TORCH_TILES            enum    resident where the MXU arm's tiles
                                                 live: resident | stream |
                                                 auto
  BFS_TPU_TORCH_TILES_BUILD      enum    device  device | host tile builder
  BFS_TPU_TORCH_STREAM_CACHE_GB  float   1       the streamed arm's device
                                                 superblock cache (GiB, > 0)
  BFS_TPU_TORCH_STREAM_VERIFY    flag    0       fingerprint every cache hit
  BFS_TPU_TORCH_TILES_CACHE      flag    0       keep built tiles bundles in
                                                 the layout store
  BFS_TPU_TORCH_LABELS           spec    off     landmark label tier: off |
                                                 <K> roots swept at register
  BFS_TPU_TORCH_LABELS_GB        float   2       device budget of the label
                                                 rows (GiB, > 0)
  BFS_TPU_TORCH_LABELS_VERIFY    int     0       check every Nth tight label
                                                 answer exactly (0 = off)
  BFS_TPU_TORCH_ROUTER_FAILURES  int     2       fleet router: failures that
                                                 open a replica's breaker
  BFS_TPU_TORCH_ROUTER_COOLDOWN_S float  2.0     fleet router breaker
                                                 cooldown (s, > 0)
  BFS_TPU_TORCH_JOURNAL          flag    1       run journal of the tools
                                                 (resume a killed run)
  BFS_TPU_TORCH_JOURNAL_DIR      path    ""      run-journal directory
                                                 ("" = <cache root>/journal)
  BFS_TPU_TORCH_SPANS            flag    1       phase spans; 0 disables
  BFS_TPU_TORCH_EXPANSION        enum    auto    the relay engine's dense
                                                 arm: auto | gather | mxu
  BFS_TPU_TORCH_PHASE_PROBE      enum    ""      force: run the expansion
                                                 probe on the CPU too
  BFS_TPU_TORCH_TRANSFER_GUARD   spec    ""      sync guard over the hot
                                                 regions: 0/off | 1/disallow
                                                 (error) | log (warn)
  BFS_TPU_TORCH_LOCK_ORDER       spec    ""      lock-order recorder on the
                                                 serve locks: 0/off |
                                                 1/record | raise
  BFS_TPU_TORCH_EXCHANGE         enum    auto    the mesh engine's frontier
                                                 exchange: auto | bitmap |
                                                 delta | flat
  BFS_TPU_TORCH_EXCHANGE_DIV     int     8       word-list budget divisor:
                                                 B = ceil(kw / div) (>= 1)
  BFS_TPU_TORCH_MESH             spec    ""      2-D grid mesh 'rxc' (bare c
                                                 = 1xc); "" = 1 x devices
  ============================== ======= ======= ==========================

Each knob also declares ``affects``: the content keys its value must be
part of, one domain per key builder (:func:`flavor_env` derives each
domain's tuple; ``python -m bfs_tpu_torch.analysis --knobs`` proves every
builder hashes exactly its domain's knobs):

* ``layout`` / ``tiles`` / ``labels`` -- the relay and pull, tiles and
  label bundle keys (``cache/layout.py`` ``_LAYOUT_ENV``, ``_TILES_ENV``,
  ``_LABELS_ENV``; no knob: every builder arm writes the same bytes);
* ``probe`` -- the probe verdict's key (``cache/layout.py``
  ``_PROBE_ENV``);
* ``journal`` -- a run journal's config (``resilience/journal.py``
  ``ENV_CONFIG_KEYS``, under each knob's ``journal_key``);
* ``serve`` -- the serve registry's resident-engine key
  (``serve/registry.py`` ``ENGINE_FLAVOR_ENV``).

``scope`` is ``call`` (read when a run resolves it) or ``import`` (baked
into a module constant); ``canary`` is a value the parser must refuse
(None only for the free-form ``path`` knobs).

A knob in the ``journal`` domain carries a ``journal_key``:
its field in a :class:`~bfs_tpu_torch.resilience.journal.RunJournal`
config, under the reference's field name, so one configuration keys one
journal in either package.  :func:`journal_map` derives the fields from
the registry.  The reference's other journal knobs (``BFS_TPU_PACKED``,
``_ROWMIN``, ``_STATE_UPDATE``, ``_MXU_KERNEL``) have no knob here: the
port chooses those by argument or has no such arm (no ported kernel gives
way to a stock op on a card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Knob:
    name: str
    type: str
    default: str
    parse: Callable[[str], object]
    help: str
    journal_key: str | None = None
    affects: frozenset = frozenset()
    scope: str = "call"
    canary: str | None = None


def _enum(*choices: str):
    def parse(raw: str) -> str:
        if raw not in choices:
            raise ValueError(f"use one of {' | '.join(choices)}")
        return raw
    return parse


def _path(raw: str) -> str:
    return raw


def _fault(raw: str) -> str:
    """The fault spec's action and phase are checked here; nth and seconds
    are told apart by :func:`bfs_tpu_torch.resilience.faults.fault_spec`."""
    raw = raw.strip()
    action, _, rest = raw.partition(":")
    if raw and (action not in ("kill", "raise", "phase", "delay") or not rest):
        raise ValueError("use kill|raise|phase:<phase>[:nth] | delay:<phase>[:seconds]")
    return raw


def _ckpt(raw: str) -> str:
    """The grammar of :func:`bfs_tpu_torch.resilience.superstep_ckpt.resolve_ckpt`."""
    raw = raw.strip()
    mode, _, arg = raw.partition(":")
    if mode not in ("off", "every", "auto"):
        raise ValueError("use off | every:<k> | auto")
    if mode == "every":
        if arg and int(arg) < 1:
            raise ValueError("every:<k> needs k >= 1")
    elif arg:
        raise ValueError("only 'every' takes an argument")
    return raw


_INT32_MAX = (1 << 31) - 1


def _delta(raw: str) -> int:
    """The grammar of :func:`bfs_tpu_torch.algo.substrate.resolve_delta`:
    an int (non-positive means one bucket) or inf | infinite | single, as
    the int32 threshold increment."""
    if raw.lower() in ("inf", "infinite", "single"):
        return _INT32_MAX
    value = int(raw)
    if value <= 0:
        return _INT32_MAX
    return min(value, _INT32_MAX)


def _flag(raw: str) -> bool:
    if raw not in ("0", "1"):
        raise ValueError("use one of 0 | 1")
    return raw == "1"


def _labels(raw: str) -> int:
    """off | <K>: the landmark count, 0 for off."""
    raw = raw.strip().lower()
    if raw in ("off", "0"):
        return 0
    value = int(raw)
    if value < 1:
        raise ValueError("use off | <K> with K >= 1")
    return value


def _int_at_least(minimum: int):
    def parse(raw: str) -> int:
        value = int(raw)
        if value < minimum:
            raise ValueError(f"must be >= {minimum} (got {value})")
        return value
    return parse


def _positive_float(raw: str) -> float:
    value = float(raw)
    if not value > 0:
        raise ValueError(f"must be > 0 (got {value})")
    return value


def _transfer_guard(raw: str) -> str | None:
    """The sync-debug mode of a guarded region: None (off), ``"error"``
    (the reference's ``disallow``) or ``"warn"`` (its ``log``)."""
    s = raw.strip().lower()
    if s in ("", "0", "off", "false", "allow"):
        return None
    if s in ("1", "on", "true", "disallow", "error"):
        return "error"
    if s in ("log", "warn"):
        return "warn"
    raise ValueError("use 0/off | 1/disallow | log")


def _mesh(raw: str) -> str:
    """'rxc' (or a bare c, meaning 1xc), both axes >= 1, kept raw; "" is
    the 1-D degenerate ``1 x devices``
    (:func:`bfs_tpu_torch.graph.grid_layout.parse_mesh_spec` parses it)."""
    s = raw.strip().lower()
    if not s:
        return ""
    rs, x, cs = s.partition("x")
    r, c = (int(rs), int(cs)) if x else (1, int(rs))
    if r < 1 or c < 1:
        raise ValueError("both mesh axes must be >= 1")
    return raw


def _lock_order(raw: str) -> str | None:
    """None (off), ``"record"`` or ``"raise"``."""
    s = raw.strip().lower()
    if s in ("", "0", "off", "false"):
        return None
    if s == "raise":
        return "raise"
    if s in ("1", "on", "true", "record"):
        return "record"
    raise ValueError("use 0/off | 1/record | raise")


_JS = ("journal", "serve")

KNOBS: dict[str, Knob] = {k.name: k for k in (
    Knob("BFS_TPU_TORCH_DIRECTION", "enum", "auto", _enum("push", "pull", "auto"),
         "traversal body: force push or pull, or switch per superstep on the "
         "alpha/beta thresholds", journal_key="direction", affects=frozenset(_JS),
         canary="sideways"),
    Knob("BFS_TPU_TORCH_DIRECTION_ALPHA", "float", "14.0", _positive_float,
         "direction switch: enter pull when frontier out-edge mass * alpha "
         "exceeds the unexplored mass", journal_key="direction_alpha",
         affects=frozenset(_JS), canary="fast"),
    Knob("BFS_TPU_TORCH_DIRECTION_BETA", "float", "24.0", _positive_float,
         "direction switch: stay in pull while frontier occupancy * beta "
         "exceeds n", journal_key="direction_beta", affects=frozenset(_JS), canary="-1"),
    Knob("BFS_TPU_TORCH_LAYOUT_BUILD", "enum", "device", _enum("device", "host"),
         "relay layout builder of load_or_build_relay; host is the oracle, "
         "byte-identical", canary="tpu"),
    Knob("BFS_TPU_TORCH_CACHE_DIR", "path", "", _path,
         "root of the persistent artifact caches (default <repo>/.bench_cache)"),
    Knob("BFS_TPU_TORCH_FAULT", "spec", "", _fault,
         "fault injection at a named phase boundary (resilience/faults.py): "
         "kill|raise|phase:<phase>[:nth] | delay:<phase>[:seconds]", canary="explode"),
    Knob("BFS_TPU_TORCH_CKPT", "spec", "off", _ckpt,
         "superstep checkpointing: off | every:<k> | auto (Young/Daly interval); "
         "selects the fused or the segmented runs", canary="sometimes"),
    Knob("BFS_TPU_TORCH_CKPT_MTBF_S", "float", "600.0", _positive_float,
         "mean-time-between-failures prior of the auto checkpoint interval", canary="-3"),
    Knob("BFS_TPU_TORCH_SSSP_DELTA", "spec", "64", _delta,
         "delta-stepping bucket width of sssp (int, or inf/single for plain "
         "frontier Bellman-Ford); non-positive = one bucket", journal_key="sssp_delta",
         affects=frozenset({"journal"}), canary="wide"),
    Knob("BFS_TPU_TORCH_TILES", "enum", "resident", _enum("resident", "stream", "auto"),
         "where the MXU arm's adjacency tiles live: on the card, streamed per "
         "superblock from pinned host memory, or streamed when over the cache budget",
         journal_key="tiles", affects=frozenset({"journal"}), canary="hbm"),
    Knob("BFS_TPU_TORCH_TILES_BUILD", "enum", "device", _enum("device", "host"),
         "adjacency-tile builder; host is the numpy oracle, byte-identical", canary="gpu"),
    Knob("BFS_TPU_TORCH_STREAM_CACHE_GB", "float", "1", _positive_float,
         "the streamed arm's device superblock cache budget (LRU, a single "
         "oversized superblock allowed)", journal_key="stream_cache_gb",
         affects=frozenset({"journal"}), canary="big"),
    Knob("BFS_TPU_TORCH_STREAM_VERIFY", "flag", "0", _flag,
         "fingerprint a streamed superblock again on every cache hit; a corrupt "
         "entry is dropped and fetched again", canary="yes"),
    Knob("BFS_TPU_TORCH_TILES_CACHE", "flag", "0", _flag,
         "keep built adjacency-tile bundles in the layout store", canary="yes"),
    Knob("BFS_TPU_TORCH_LABELS", "spec", "off", _labels,
         "landmark distance-label tier: off | <K> landmark roots swept at the "
         "server's register(); point queries answer from labels where the "
         "tightness certificate holds", journal_key="labels",
         affects=frozenset({"journal"}), canary="many"),
    Knob("BFS_TPU_TORCH_LABELS_GB", "float", "2", _positive_float,
         "device budget of the resident label rows (uint16[K, V]); an index "
         "over it serves exact-only", canary="big"),
    Knob("BFS_TPU_TORCH_LABELS_VERIFY", "int", "0", _int_at_least(0),
         "check every Nth tight label answer against the exact traversal; a "
         "mismatch quarantines the index (0 = off)", canary="-1"),
    Knob("BFS_TPU_TORCH_ROUTER_FAILURES", "int", "2", _int_at_least(1),
         "fleet router per-replica breaker: consecutive failures before the "
         "replica is routed around", canary="0"),
    Knob("BFS_TPU_TORCH_ROUTER_COOLDOWN_S", "float", "2.0", _positive_float,
         "fleet router breaker cooldown before an opened replica is tried again",
         canary="slow"),
    Knob("BFS_TPU_TORCH_JOURNAL", "flag", "1", _flag,
         "run journal of the tools (graph500_run): completed phases are kept "
         "and skipped when the run is made again; 0 disables", canary="off"),
    Knob("BFS_TPU_TORCH_JOURNAL_DIR", "path", "", _path,
         "run-journal directory (default <cache root>/journal)"),
    Knob("BFS_TPU_TORCH_SPANS", "flag", "1", _flag,
         "phase spans (obs/spans.py); 0 disables", canary="yes"),
    Knob("BFS_TPU_TORCH_EXPANSION", "enum", "auto", _enum("auto", "gather", "mxu"),
         "the relay engine's dense-frontier expansion arm: the Benes relay gather, "
         "the tiled masked product (mxu_expand), or auto: measured at engine "
         "init on a card where the tiles fit their budget", journal_key="expansion",
         affects=frozenset(_JS), canary="dense"),
    Knob("BFS_TPU_TORCH_PHASE_PROBE", "enum", "", _enum("", "force"),
         "force the expansion probe on the CPU too (the plain arms); '' probes "
         "on a card only", affects=frozenset({"probe"}), canary="maybe"),
    Knob("BFS_TPU_TORCH_TRANSFER_GUARD", "spec", "", _transfer_guard,
         "torch.cuda sync-debug mode over the hot regions "
         "(analysis/runtime.py guarded_region): 0/off | 1/disallow (error) | log (warn)",
         canary="never ever"),
    Knob("BFS_TPU_TORCH_LOCK_ORDER", "spec", "", _lock_order,
         "lock-order recorder on the named serve locks (analysis/runtime.py "
         "make_lock): 0/off | 1/record | raise", canary="maybe"),
    Knob("BFS_TPU_TORCH_EXCHANGE", "enum", "auto", _enum("auto", "bitmap", "delta", "flat"),
         "the mesh engine's frontier exchange arm (parallel/exchange.py): sieved "
         "bitmaps, word-list deltas on sparse levels, or the flat oracle",
         journal_key="exchange", affects=frozenset({"journal"}), canary="zip"),
    Knob("BFS_TPU_TORCH_EXCHANGE_DIV", "int", "8", _int_at_least(1),
         "exchange word-list budget divisor B = ceil(kw/div); larger cuts deeper "
         "but engages on sparser levels only", journal_key="exchange_div",
         affects=frozenset({"journal"}), canary="0"),
    Knob("BFS_TPU_TORCH_MESH", "spec", "", _mesh,
         "the 2-D grid's mesh shape 'rxc' (parallel/grid.py; a bare c is 1xc); unset "
         "is the 1-D degenerate 1 x the visible cards.  It keys no content: a grid "
         "engine keeps its loops by its mesh's shape", canary="3by2"),
)}


def parse_value(name: str, raw: str):
    """``raw`` parsed as knob ``name``; a value its parser refuses raises
    ``ValueError`` naming the knob, an unregistered name ``KeyError``."""
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered knob (bfs_tpu_torch/knobs.py)")
    try:
        return knob.parse(raw)
    except ValueError as err:
        raise ValueError(f"{name}={raw!r}: {err}") from None


def get(name: str):
    """The typed read of a registered knob: the parsed environment value,
    or the default when unset or empty; a bad value raises ``ValueError``
    naming the knob."""
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered knob (bfs_tpu_torch/knobs.py)")
    return parse_value(name, os.environ.get(name) or knob.default)


def raw(name: str) -> str:
    """The unparsed environment value of a registered knob ("" when unset):
    what a key builder hashes."""
    if name not in KNOBS:
        raise KeyError(f"{name} is not a registered knob (bfs_tpu_torch/knobs.py)")
    return os.environ.get(name) or ""


def flavor_env(domain: str) -> tuple:
    """The sorted names of the knobs that declare ``domain`` in ``affects``."""
    return tuple(sorted(k.name for k in KNOBS.values() if domain in k.affects))


def journal_map() -> dict[str, str]:
    """``{journal config key: knob name}`` of the knobs in the ``journal``
    domain, sorted by key: the fields every run journal's config holds
    (:func:`bfs_tpu_torch.resilience.journal.env_config`)."""
    return dict(sorted((k.journal_key, k.name) for k in KNOBS.values()
                       if "journal" in k.affects))
