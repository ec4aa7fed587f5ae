"""Build-on-demand ctypes loader for the repo's native C++ libraries.

The port compiles the shared ``native/*.cpp`` sources with g++ into its
own build directory (``bfs_tpu_torch/_build/``, listed in ``.gitignore``)
and loads them through ctypes.  Loading never raises: a compile or load
failure latches the library as unavailable and callers take their NumPy
paths (the Beneš router has none, so the layout build raises instead).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from collections.abc import Callable

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)
BUILD_DIR = os.path.join(PKG_ROOT, "_build")


def native_source(name: str) -> str:
    """Path of a shared native source, ``native/<name>`` at the repo root."""
    return os.path.join(REPO_ROOT, "native", name)


class NativeLib:
    """Lazily built, lazily loaded shared library.

    ``register`` is called once with the loaded CDLL to set
    restype/argtypes; if it raises, the library is latched unavailable.
    """

    def __init__(self, src: str, so: str, register: Callable[[ctypes.CDLL], None]):
        self._src = src
        self._so = so
        self._register = register
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False

    def _needs_build(self) -> bool:
        if not os.path.exists(self._so):
            return True
        try:
            return os.path.getmtime(self._so) < os.path.getmtime(self._src)
        except OSError:
            return False

    def _build(self) -> bool:
        if not os.path.exists(self._src):
            return False
        os.makedirs(os.path.dirname(self._so), exist_ok=True)
        # Compile to a per-process temp path and publish atomically, so a
        # concurrent process never loads a half-written library.
        tmp = f"{self._so}.tmp.{os.getpid()}"
        cmd = [
            os.environ.get("CXX", "g++"),
            "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
            "-pthread", "-o", tmp, self._src,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, self._so)
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def load(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            if self._needs_build() and not self._build():
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(self._so)
                self._register(lib)
            except Exception:
                self._failed = True
                return None
            self._lib = lib
            return self._lib

    def available(self) -> bool:
        return self.load() is not None
