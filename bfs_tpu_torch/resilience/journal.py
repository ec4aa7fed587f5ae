"""Content keys of run configurations: the part of
``bfs_tpu.resilience.journal`` that the superstep checkpointer names its
files by.

A configuration (a dict of JSON values) maps to one key, a blake2b-64 over
its canonical JSON, so the same configuration gives the same key in this
package and in the reference, and an epoch written by either is found by
the other.  The reference's ``RunJournal`` (the bench's phase journal) is
not ported here: its one caller is the bench.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def config_key(config: dict) -> str:
    """blake2b-64 over the canonical config JSON: the stem of the files a
    run configuration owns."""
    return hashlib.blake2b(_canon(config).encode(), digest_size=8).hexdigest()
