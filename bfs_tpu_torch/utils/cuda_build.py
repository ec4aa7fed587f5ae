"""nvcc -> shared library -> ctypes, for the port's hand-written kernels.

Each ``csrc/*.cu`` source (which may include the shared ``csrc/*.cuh``
headers) exports a plain C interface (pointers, ints and
the CUDA stream as ``void*``; every function returns ``cudaGetLastError()``)
and is compiled for Hopper (``sm_90a``) at first use into the port's build
directory.  Nothing here runs at import time: the CPU test platform has no
nvcc, and only a call that launches a kernel builds one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from .native_loader import BUILD_DIR, PKG_ROOT

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when reused), "ptxas": log}
BUILD_INFO: dict[str, dict] = {}


def csrc(name: str) -> str:
    return os.path.join(PKG_ROOT, "csrc", name)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _headers() -> list[str]:
    """The shared headers (``csrc/*.cuh``) every source may include."""
    d = os.path.join(PKG_ROOT, "csrc")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".cuh"))


def _so_path(name: str, source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source, *_headers()):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(sources: dict[str, str]) -> None:
    """Build every ``name -> source`` whose library is missing (or whose
    source changed): one nvcc per source, all started together.  Raises if
    any of them fails."""
    from .metrics import bump_artifact

    started = {}
    for name, source in sources.items():
        so = _so_path(name, source)
        if os.path.exists(so):
            if name not in BUILD_INFO:  # counted once a process
                bump_artifact("kernel_library_hits")
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": ""})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", os.path.join(PKG_ROOT, "csrc"), "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (source, so, tmp, proc, time.perf_counter())
    failed = []
    for name, (source, so, tmp, proc, t0) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        bump_artifact("kernel_library_builds")
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, source: str, register) -> ctypes.CDLL:
    """Build ``source`` (if its content changed) into ``lib<name>.so``, load
    it and call ``register`` once on it to set argtypes/restype.  Raises on
    any build or load failure: there is no fallback."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build({name: source})
        lib = ctypes.CDLL(_so_path(name, source))
        register(lib)
        _libs[name] = lib
        return lib


def constant(source: str, const: str) -> int:
    """The value of ``constexpr int <const>`` in ``source``."""
    found = re.search(rf"constexpr int {const} = (\d+);", open(source).read())
    if not found:
        raise RuntimeError(f"{const} not found in {source}")
    return int(found.group(1))


def build_variants(name: str, source: str, variants: dict[str, dict[str, int]],
                   register) -> dict[str, ctypes.CDLL]:
    """Copies of ``source`` with some of its ``constexpr int`` constants
    changed, for tuning: ``variants`` maps a variant's name to its
    ``{constant: value}``.  Each copy is written into the build directory
    and built beside ``source`` itself (one nvcc each, all started
    together); returns variant name -> loaded library (``lib<name>_<variant>``)."""
    text = open(source).read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {}
    for var, consts in variants.items():
        copy = text
        for const, value in consts.items():
            pat = re.compile(rf"constexpr int {const} = \d+;")
            if not pat.search(copy):
                raise RuntimeError(f"{const} not found in {source}")
            copy = pat.sub(f"constexpr int {const} = {value};", copy)
        path = os.path.join(BUILD_DIR, f"{name}_{var}.cu")
        with open(path, "w") as f:
            f.write(copy)
        paths[f"{name}_{var}"] = path
    build({**paths, name: source})
    return {var: load(f"{name}_{var}", paths[f"{name}_{var}"], register) for var in variants}
