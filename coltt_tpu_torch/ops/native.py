"""Build and load the hand-written CUDA kernels in ``coltt_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded with
``ctypes``. The build runs at first use, from the sources in the checkout,
into ``coltt_tpu_torch/build/``; the library's file name carries a hash of
every source and header in ``csrc/`` and of the flags, so an edited source
or header is rebuilt and an unchanged tree is loaded as it is.
:func:`load_all` runs one ``nvcc`` per source, all at once. Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register / spill report, kept in the build log
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "coltt_tpu_torch/csrc at first use"
    )


class KernelLibrary:
    """One ``csrc/<name>.cu`` built into a shared library on first
    :meth:`load`. ``build_seconds`` and ``build_log`` describe the build
    (0.0 and the cached log when the library was already on disk)."""

    def __init__(self, name: str):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib = None
        self._mu = threading.Lock()

    def _target(self) -> str:
        """The library's path: its name carries a hash of the flags and of
        every ``*.cu``, ``*.cuh`` and ``*.h`` under the source's directory,
        since the source may include any of them."""
        src_dir = os.path.dirname(self.source)
        h = hashlib.sha256()
        for root, dirs, files in os.walk(src_dir):
            dirs.sort()
            for fname in sorted(files):
                if fname.endswith((".cu", ".cuh", ".h")):
                    path = os.path.join(root, fname)
                    h.update(os.path.relpath(path, src_dir).encode() + b"\0")
                    with open(path, "rb") as f:
                        h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def load(self) -> ctypes.CDLL:
        with self._mu:
            if self._lib is not None:
                return self._lib
            target = self._target()
            log_path = target[:-3] + ".log"
            if not os.path.exists(target):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{target}.{os.getpid()}.tmp"
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.build_seconds = time.perf_counter() - t0
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on {self.source}:\n"
                        f"{self.build_log}"
                    )
                with open(log_path, "w") as f:
                    f.write(self.build_log)
                os.replace(tmp, target)  # atomic against concurrent builds
            elif os.path.exists(log_path):
                with open(log_path) as f:
                    self.build_log = f.read()
            self._lib = ctypes.CDLL(target)
            return self._lib


def load_all(libraries) -> None:
    """Load every :class:`KernelLibrary` of ``libraries``, building the
    missing ones with one ``nvcc`` each, all started together. Raises the
    first build error after every build has ended."""
    libraries = [lib for lib in libraries if not lib.loaded]
    if not libraries:
        return  # the launch path: nothing to build, no thread to start
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libraries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
