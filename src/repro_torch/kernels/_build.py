"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is a plain-C-interface CUDA file compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``<repo>/build/kernels/``
(listed in ``.gitignore``) at first use, and loaded with ``ctypes``. The
library name carries a hash of the source, so an edited kernel is never
served from a stale build. :func:`build_all` compiles every source in
parallel (one ``nvcc`` each) — what a fresh machine pays once.

Every C entry point takes raw pointers and the CUDA stream as ``void*``,
ints as ``int``, launches on that stream without synchronising, and
returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises on a
non-zero code and counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class Kernel:
    """One ``csrc/<source>`` library: built on first use, launch-counted."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.source.stem

    def lib_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists."""
        out = self.lib_path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc._out, proc._tmp = out, tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(proc._tmp, proc._out)  # type: ignore[attr-defined]

    def _load(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.lib_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry on PyTorch's current stream (appended as the
        last argument); raise if the launch was refused."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> None:
    """Compile every registered kernel, all ``nvcc`` processes at once."""
    procs = [(k, k.start_build()) for k in KERNELS.values()]
    errors: List[str] = []
    for k, proc in procs:
        try:
            k.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k._load()


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
