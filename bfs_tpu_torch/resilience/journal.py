"""RunJournal: an append-only, crash-safe JSONL journal of phase results,
and the content keys of run configurations.  The port of
``bfs_tpu.resilience.journal``, byte for byte on disk: the same records,
crc and file name for the same config, so a journal written by either
package resumes in the other.

One journal file per run configuration: the file name is a blake2b over
the canonical config JSON (:func:`config_key`, which the superstep
checkpointer also names its epochs by).

Disk format, one JSON object per line::

    {"i": 3, "phase": "scale:16", "t": 1722.4, "crc": "deadbeef",
     "payload": {...}, "arrays": "<stem>_reference.npz"}

* ``i``: a strictly increasing record index; a gap invalidates the tail.
* ``crc``: crc32 over the canonical JSON of ``(i, phase, payload)``; a
  torn or bit-flipped record invalidates the tail from that record on
  (an append-only log is damaged only at its end by a crash).
* ``arrays``: an optional sidecar ``.npz`` (written atomically by
  :func:`bfs_tpu_torch.utils.checkpoint.save_npz_atomic`) for payloads
  that are arrays; a missing sidecar invalidates its record alone, a
  damaged one the whole journal.

Writes are append, flush and fsync, so a SIGKILL loses at most the record
being written, which the next open trims.  A config mismatch or a foreign
file at the journal's path rotates the file aside to ``*.stale.<n>``; a
journal is never edited in place.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Any

from .. import knobs

JOURNAL_VERSION = 1

_HEADER_PHASE = "_header"


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _crc(i: int, phase: str, payload: Any) -> str:
    return f"{zlib.crc32(_canon([i, phase, payload]).encode()):08x}"


def config_key(config: dict) -> str:
    """blake2b-64 over the canonical config JSON: the stem of the files a
    run configuration owns."""
    return hashlib.blake2b(_canon(config).encode(), digest_size=8).hexdigest()


#: The knobs every journal config holds, derived from the registry (the
#: ``journal`` domain of ``affects``); the knob rung (KNB002) proves it.
ENV_CONFIG_KEYS = knobs.flavor_env("journal")


def env_config() -> dict:
    """``{journal config key: effective raw value}`` for every knob of the
    ``journal`` domain (:func:`bfs_tpu_torch.knobs.journal_map`): the
    environment's value when set and non-empty, else the registered
    default, so a default run and an explicit-default run resume each
    other and any change of a knob keys another journal."""
    return {jk: knobs.raw(name) or knobs.KNOBS[name].default
            for jk, name in knobs.journal_map().items()}


def _valid(raw: bytes, expect_i: int):
    """The record of one journal line when it is whole, parses, carries
    index ``expect_i`` and its crc; else None.  Any malformed shape (a
    line that is not an object, a flipped byte in a key, wrong types)
    reads as a torn tail."""
    if not raw.endswith(b"\n"):
        return None
    try:
        rec = json.loads(raw)
        ok = (
            isinstance(rec, dict)
            and rec.get("i") == expect_i
            and isinstance(rec.get("phase"), str)
            and _crc(rec["i"], rec["phase"], rec["payload"]) == rec.get("crc")
        )
    except (ValueError, KeyError, TypeError):
        return None
    return rec if ok else None


def read_records(path: str) -> list:
    """Every crc-valid record of a journal FILE in index order, stopping at
    the first torn or invalid line; needs no config, and locks and
    truncates nothing (``python -m bfs_tpu_torch.obs`` reads finished
    journals through it)."""
    records = []
    if not os.path.exists(path):
        return records
    with open(path, "rb") as f:
        for raw in f:
            rec = _valid(raw, len(records))
            if rec is None:
                break
            records.append(rec)
    return records


class RunJournal:
    """Append-only phase journal for one run configuration.

    ``get(phase)`` returns the payload of a completed phase (or None);
    ``put(phase, payload, arrays=...)`` appends one durable record.
    Phases are free-form strings; per-item phases use ``"name:<i>"``.
    """

    #: Seconds to wait for a draining predecessor's file lock before
    #: failing; tests shrink it.
    LOCK_TIMEOUT_S = 10.0

    def __init__(self, path: str, config: dict):
        self.path = path
        self.config = dict(config)
        self._records: dict[str, dict] = {}
        self._arrays_cache: dict[str, dict | None] = {}
        self._fh = None
        self.resumed_phases: list[str] = []
        self.invalidated: str | None = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._open()

    @classmethod
    def open_for(cls, root: str, config: dict) -> "RunJournal":
        """The journal of ``config`` under ``root``:
        ``<root>/<config_key>.jsonl``."""
        return cls(os.path.join(root, f"{config_key(config)}.jsonl"), config)

    # ----------------------------------------------------------- lifecycle --
    def _flock(self, fh, timeout_s: float | None = None) -> None:
        """An exclusive lock on the journal file: two live processes of one
        config must never interleave appends (an interleaved ``i`` sequence
        would make the next replay trim fsynced records).  Waits briefly for
        a draining predecessor, then raises."""
        try:
            import fcntl
        except ImportError:  # not POSIX: one process at a time
            return
        if timeout_s is None:
            timeout_s = self.LOCK_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"journal {self.path} is locked by another live "
                        "process; two runs of the same config cannot share "
                        "a journal"
                    )
                time.sleep(0.1)

    def _open(self) -> None:
        # Lock before replaying, so no other process appends in between.
        self._fh = open(self.path, "ab")
        self._flock(self._fh)
        good_bytes, records = self._replay()
        if records is None:  # header mismatch or a foreign file
            self._fh.close()  # releases the lock with the old inode
            self._rotate()
            self._fh = open(self.path, "ab")
            self._flock(self._fh)
            good_bytes, records = 0, {}
        self._records = records
        if good_bytes < self._fh.tell():
            # A torn tail: trim to the last good record and append on.
            self._fh.truncate(good_bytes)
            self._fh.seek(good_bytes)
        if not self._records:
            self._append(_HEADER_PHASE, {
                "journal_version": JOURNAL_VERSION,
                "config": self.config,
            })
        self.resumed_phases = self.phases()

    def _replay(self):
        """``(good_byte_count, {phase: record})`` of the existing file;
        ``records is None`` means the whole file is untrustworthy (a missing
        or mismatched header, a foreign file) and is rotated aside."""
        if not os.path.exists(self.path):
            return 0, {}
        records: dict[str, dict] = {}
        good = 0
        expect_i = 0
        try:
            with open(self.path, "rb") as f:
                for raw in f:
                    rec = _valid(raw, expect_i)
                    if rec is None:
                        break
                    if rec["phase"] == _HEADER_PHASE:
                        hdr = rec["payload"]
                        if (
                            not isinstance(hdr, dict)
                            or hdr.get("journal_version") != JOURNAL_VERSION
                            or hdr.get("config") != self.config
                        ):
                            self.invalidated = "config mismatch"
                            return 0, None
                    records[rec["phase"]] = rec
                    good += len(raw)
                    expect_i += 1
        except OSError:
            return 0, None
        if _HEADER_PHASE not in records and good:
            return 0, None
        if not records and os.path.getsize(self.path) > 0:
            # No valid record in a non-empty file: not a torn tail but a
            # foreign file at the journal's path.  Truncating it would
            # destroy evidence; rotate it aside instead.
            self.invalidated = "foreign/pre-journal file"
            return 0, None
        return good, records

    def _rotate(self) -> None:
        """Move a stale or foreign journal aside (never delete it)."""
        if not os.path.exists(self.path):
            return
        n = 0
        while os.path.exists(f"{self.path}.stale.{n}"):
            n += 1
        os.replace(self.path, f"{self.path}.stale.{n}")

    def restart(self, reason: str) -> None:
        """Invalidate everything (e.g. a graph that is not the journaled
        one): rotate the file aside and begin a fresh journal for the same
        config."""
        if self._fh is not None:
            self._fh.close()
        self._rotate()
        self._records = {}
        self._arrays_cache = {}
        self.invalidated = reason
        self._fh = open(self.path, "ab")
        self._flock(self._fh)
        self._append(_HEADER_PHASE, {
            "journal_version": JOURNAL_VERSION,
            "config": self.config,
        })
        self.resumed_phases = []

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # --------------------------------------------------------------- writes --
    def _append(self, phase: str, payload: Any, arrays_name: str | None = None):
        i = max((r["i"] for r in self._records.values()), default=-1) + 1
        rec = {
            "i": i,
            "phase": phase,
            "t": time.time(),
            "crc": _crc(i, phase, payload),
            "payload": payload,
        }
        if arrays_name is not None:
            rec["arrays"] = arrays_name
        self._fh.write((_canon(rec) + "\n").encode())
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._records[phase] = rec

    def put(self, phase: str, payload: Any, *, arrays: dict | None = None) -> None:
        """Record a phase's completion durably (``payload`` JSON-safe;
        ``arrays`` go to an atomic sidecar ``.npz``)."""
        arrays_name = None
        self._arrays_cache.pop(phase, None)
        if arrays:
            from ..utils.checkpoint import save_npz_atomic

            stem = os.path.basename(self.path).rsplit(".", 1)[0]
            safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in phase)
            arrays_name = f"{stem}_{safe}.npz"
            save_npz_atomic(os.path.join(os.path.dirname(self.path), arrays_name), **arrays)
        self._append(phase, payload, arrays_name)

    # ---------------------------------------------------------------- reads --
    def get(self, phase: str) -> Any | None:
        """The payload of a completed phase, or None.

        A record whose sidecar is damaged (present but unreadable) rotates
        the whole journal aside and starts afresh: later phases that used
        those arrays can no longer be shown consistent.  A missing sidecar
        makes its phase alone read as not completed (an incomplete write,
        not corruption).  Either way corruption costs time, never
        correctness."""
        rec = self._records.get(phase)
        if rec is None:
            return None
        if rec.get("arrays") and self.load_arrays(phase) is None:
            if os.path.exists(os.path.join(os.path.dirname(self.path), rec["arrays"])):
                self.restart(f"corrupt sidecar for phase {phase!r}")
            return None
        return rec["payload"]

    def load_arrays(self, phase: str) -> dict | None:
        """The sidecar arrays of a completed phase (None if absent or
        unreadable), cached: ``get`` validates a sidecar by loading it."""
        if phase in self._arrays_cache:
            return self._arrays_cache[phase]
        rec = self._records.get(phase)
        if rec is None or not rec.get("arrays"):
            return None
        from ..utils.checkpoint import CheckpointError, load_npz_strict

        try:
            out = load_npz_strict(os.path.join(os.path.dirname(self.path), rec["arrays"]))
        except (CheckpointError, OSError):
            out = None
        self._arrays_cache[phase] = out
        return out

    def phases(self) -> list[str]:
        return [p for p in self._records if p != _HEADER_PHASE]

    def __contains__(self, phase: str) -> bool:
        return self.get(phase) is not None
