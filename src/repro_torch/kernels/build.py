"""Build and bind the hand-written CUDA kernels.

A kernel source (``csrc/*.cu``, plain C entry points) is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v

into ``build/kernels/<name>-<hash>.so`` at the repository root, at first
use.  The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  The library is loaded with
``ctypes``; every C entry returns ``cudaGetLastError()`` after its launch,
and ``CudaKernel.launch`` raises when that is not 0.  Nothing here runs
at import time: this module imports on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return nvcc


def build(name: str, source: Path) -> Path:
    """Compile ``source`` into a shared library unless an up-to-date one
    exists; returns its path.  Writes go through a temporary file and an
    atomic rename, so concurrent builders never load a half-written
    library.  The compiler's resource report (``-Xptxas -v``) is kept
    beside the library as ``<name>-<hash>.log``."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


class CudaKernel:
    """One kernel library: built and loaded at first use, its C entries
    bound with ``ctypes``.  ``launches`` counts launches that the runtime
    accepted — the count a run reads to show it went through the
    kernel."""

    def __init__(self, name: str, source: Path,
                 entries: Dict[str, Sequence]):
        self.name = name
        self.source = source
        self.entries = dict(entries)
        self.launches = 0
        self.library_path: Path | None = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = build(self.name, self.source)
                lib = ctypes.CDLL(str(path))
                for entry, argtypes in self.entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                self.library_path = path
                self._lib = lib
        return self._lib

    def launch(self, entry: str, *args) -> None:
        lib = self.load()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: {entry} failed to launch: "
                               f"CUDA error {rc} ({msg})")
        self.launches += 1


def load_all(kernels: Iterable[CudaKernel]) -> List[Path]:
    """Build every kernel at once, one ``nvcc`` per source in parallel."""
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as ex:
        list(ex.map(lambda k: k.load(), kernels))
    return [k.library_path for k in kernels]
