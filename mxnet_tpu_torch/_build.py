"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/lib<name>-<hash>.so``, a shared library with a plain C
interface that ``ops/cuda_kernels.py`` loads with ``ctypes``.  The hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited kernel or header rebuilds and an unchanged one loads at
once.  Nothing here runs at import: the first
call that launches a kernel builds it, or ``build()`` builds every
kernel at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from .base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "build", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_mha_packed", "flash_mha_packed_bwd", "flash_mha",
           "flash_mha_bwd", "paged_attention_decode",
           "paged_attention_decode_quant", "paged_attention_verify",
           "lstm_scan", "nms")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the "
        "port's CUDA kernels are built from csrc/ at first use")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every kernel of ``names`` not built yet, all ``nvcc``
    processes at once.  Returns ``{name: seconds}`` (0.0 for a library
    already built).  A failed build raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, float] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        if name not in SOURCES:
            raise MXNetError(f"unknown kernel source {name!r}")
        target = _target(name)
        if target.exists():
            out[name] = 0.0
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        # compiler output goes to a file: a pipe nobody drains while the
        # others compile could fill and stall nvcc
        log = tmp.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(_CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, target, log)
    try:
        while running:
            for name, (proc, tmp, target, log) in list(running.items()):
                if proc.poll() is None:
                    continue
                del running[name]
                text = log.read_text(errors="replace")
                log.unlink()
                if proc.returncode != 0:
                    raise MXNetError(f"nvcc failed on csrc/{name}.cu "
                                     f"(exit {proc.returncode}):\n{text}")
                os.replace(tmp, target)  # atomic: a concurrent loader
                # never sees a half-written library
                out[name] = time.perf_counter() - t0
            if running:
                time.sleep(0.05)
    finally:
        for proc, tmp, _, log in running.values():  # only after a failure
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
