"""Build and load the port's CUDA kernels: one helper for every ``csrc/*.cu``.

Each kernel package describes its source once as a :class:`CudaLibrary`.
The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at the first launch of one of its kernels, and loaded
with ``ctypes``.  The library lands in ``src/repro_torch/build/`` under a
name keyed by a hash of the source, every header it includes from this
package (``#include "..."``, followed through the headers they include in
turn) and the flags (``lib<name>_<hash>.so``), so an edit to any of them
rebuilds.  :func:`build_all` starts one ``nvcc`` per source at once and waits
for all of them.  ptxas warns of register spills and local memory, and what
nvcc prints on a build that succeeds is kept as :attr:`CudaLibrary.build_log`.
Nothing happens at import time: the CPU tests import every kernel module on
machines that have no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "build_all", "local_headers"]

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-warn-spills,-warn-lmem-usage",
)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list[Path]:
    """The headers ``source`` includes with quotes, and those they include in
    turn, in the order first met; a quoted name that is not a file beside
    its includer (a toolkit header) is left out."""
    found: list[Path] = []
    todo = [source]
    while todo:
        path = todo.pop(0)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / name.decode()).resolve()
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class CudaLibrary:
    """One CUDA source, its shared library and its ctypes binding.

    ``bind`` declares ``argtypes``/``restype`` of every entry point on the
    freshly loaded library; ``extra_flags`` follow :data:`NVCC_FLAGS` on its
    nvcc line.  The source must export
    ``const char* <error_fn>(int)``, which names a CUDA error code.
    :attr:`build_log` holds what nvcc printed when this process built the
    library (ptxas's warnings among it), and stays empty when it was built
    before.
    """

    def __init__(self, name: str, source: Path, bind: Callable[[ctypes.CDLL], None],
                 *, error_fn: str, extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = source
        self.flags = (*NVCC_FLAGS, *extra_flags)
        self.build_dir = BUILD_DIR
        self._bind = bind
        self._error_fn = error_fn
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._mu = threading.Lock()

    def path(self) -> Path:
        """Where the library built from the current source, headers and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in local_headers(self.source):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return self.build_dir / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def _start(self) -> tuple[Path, Path, subprocess.Popen] | None:
        """Start nvcc unless the library exists; (out, tmp, process) or None."""
        out = self.path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"cannot build the {self.name} CUDA kernels: {cmd[0]} not found "
                "(set CUDA_HOME to the CUDA toolkit)"
            ) from None
        return out, tmp, proc

    def _finish(self, started: tuple[Path, Path, subprocess.Popen]) -> Path:
        out, tmp, proc = started
        printed, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} (exit {proc.returncode}):\n{err}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        self.build_log = (printed + err).strip()
        return out

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists; return its path."""
        started = self._start()
        return self.path() if started is None else self._finish(started)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built and bound at the first call."""
        with self._mu:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                getattr(lib, self._error_fn).argtypes = [ctypes.c_int]
                getattr(lib, self._error_fn).restype = ctypes.c_char_p
                self._bind(lib)
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code other than 0."""
        if err != 0:
            msg = getattr(self.load(), self._error_fn)(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def build_all(libraries: Sequence[CudaLibrary]) -> list[Path]:
    """Build every library, one nvcc per source, all started together."""
    started = []
    try:
        for lib in libraries:
            started.append((lib, lib._start()))
    except BaseException:
        for _, s in started:
            if s is not None:
                s[2].kill()
                s[2].wait()
        raise
    errors, paths = [], []
    for lib, s in started:
        try:
            paths.append(lib.path() if s is None else lib._finish(s))
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths
