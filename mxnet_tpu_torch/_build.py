"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/lib<name>-<hash>.so``, a shared library with a plain C
interface that ``ops/cuda_kernels.py`` loads with ``ctypes``.  The hash
covers the source, the headers of ``csrc/`` it includes (``#include
"x.cuh"``, and theirs in turn) and the flags, so an edited kernel or
header rebuilds the kernels that include it, and an unchanged one loads
at once.  Nothing here runs at import: the first
call that launches a kernel builds it, or ``build()`` builds every
kernel at once, one ``nvcc`` process per source, all started together.

A user's CUDA source (``rtc.cuda_kernel``) builds the same way from
text: ``build_sources`` compiles each ``(key, text, flags)`` into
``build/libuser_<key>-<hash>.so``, the hash over the text and the
flags, and ``library_for_source`` loads one once per process;
``build(sources=...)`` compiles user sources beside the kernels of
``csrc/``.
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
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

from .base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "build_sources",
           "build_source", "library_for_source"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_mha_packed", "flash_mha_packed_bwd", "flash_mha",
           "flash_mha_bwd", "paged_attention_decode",
           "paged_attention_decode_quant", "paged_attention_verify",
           "lstm_scan", "nms", "flash_attention_partial",
           "flash_attention_partial_bwd")
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _included(text: bytes, seen: Dict[str, bytes]) -> None:
    """Add each ``csrc/`` header that ``text`` includes, and those it
    includes, to ``seen`` (name → contents)."""
    for m in _INCLUDE.finditer(text):
        name = m.group(1).decode()
        path = _CSRC / name
        if name not in seen and path.is_file():
            seen[name] = path.read_bytes()
            _included(seen[name], seen)


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers: Dict[str, bytes] = {}
    _included(src, headers)
    digest = hashlib.sha256(src + b"".join(
        headers[h] for h in sorted(headers)) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(jobs: Dict[str, Tuple[Path, Path, Sequence[str]]]
             ) -> Dict[str, float]:
    """Run one ``nvcc`` per ``name: (source, target, extra flags)`` whose
    target is not built yet, all at once; each library lands under its
    target name by an atomic rename.  Returns ``{name: seconds}`` (0.0
    for a library already built).  A failed build raises with the
    compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, float] = {}
    running = {}
    t0 = time.perf_counter()
    for name, (src, target, flags) in jobs.items():
        if target.exists():
            out[name] = 0.0
            continue
        # a name per process and thread: two threads building the same
        # target never write one file
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        # compiler output goes to a file: a pipe nobody drains while the
        # others compile could fill and stall nvcc
        log = tmp.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)],
                stdout=fh, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, target, log, src)
    try:
        while running:
            for name, (proc, tmp, target, log, src) in list(
                    running.items()):
                if proc.poll() is None:
                    continue
                del running[name]
                text = log.read_text(errors="replace")
                log.unlink()
                if proc.returncode != 0:
                    raise MXNetError(f"nvcc failed on {name} ({src.name}, "
                                     f"exit {proc.returncode}):\n{text}")
                os.replace(tmp, target)  # atomic: a concurrent loader
                # never sees a half-written library
                out[name] = time.perf_counter() - t0
            if running:
                time.sleep(0.05)
    finally:
        for proc, tmp, _, log, _ in running.values():  # after a failure
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
    return out


def build(names: Iterable[str] = SOURCES,
          sources: Iterable[Tuple[str, str, Sequence[str]]] = ()
          ) -> Dict[str, float]:
    """Compile every kernel of ``names`` not built yet, and every user
    source ``(key, text, flags)`` of ``sources`` (as ``build_sources``),
    all ``nvcc`` processes at once.  Returns ``{name: seconds}``, a user
    source under ``user_<key>`` (0.0 for a library already built).  A
    failed build raises with the compiler's output."""
    jobs = {}
    for name in names:
        if name not in SOURCES:
            raise MXNetError(f"unknown kernel source {name!r}")
        jobs[name] = (_CSRC / f"{name}.cu", _target(name), ())
    jobs.update({f"user_{k}": job for k, job in _source_jobs(sources).items()})
    return _compile(jobs)


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


# ---------------------------------------------------------------------------
# user sources (rtc.cuda_kernel): CUDA C++ text from Python
# ---------------------------------------------------------------------------

_user_libs: Dict[Path, ctypes.CDLL] = {}


def _source_target(key: str, text: str, flags: Sequence[str]) -> Path:
    if not key.replace("_", "").isalnum():
        raise MXNetError(f"source key {key!r}: letters, digits and _ only")
    digest = hashlib.sha256("\0".join(
        (text, " ".join(NVCC_FLAGS), " ".join(flags))).encode())
    return BUILD_DIR / f"libuser_{key}-{digest.hexdigest()[:16]}.so"


def _source_jobs(sources: Iterable[Tuple[str, str, Sequence[str]]]
                 ) -> Dict[str, Tuple[Path, Path, Sequence[str]]]:
    """``_compile``'s jobs for user sources: each text written once to
    ``build/libuser_<key>-<hash>.cu`` beside its target."""
    jobs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for key, text, flags in sources:
        target = _source_target(key, text, flags)
        src = target.with_suffix(".cu")
        if not target.exists() and not src.exists():
            tmp = src.with_name(
                f"{src.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        jobs[key] = (src, target, tuple(flags))
    return jobs


def build_sources(sources: Iterable[Tuple[str, str, Sequence[str]]]
                  ) -> Dict[str, float]:
    """Compile each ``(key, text, flags)`` not built yet into
    ``build/libuser_<key>-<hash>.so``, all ``nvcc`` processes at once,
    with ``NVCC_FLAGS`` and then ``flags``.  Returns ``{key: seconds}``
    (0.0 for a library already built).  A failed build raises
    ``MXNetError`` with the compiler's output."""
    return _compile(_source_jobs(sources))


def build_source(key: str, text: str, flags: Sequence[str] = ()) -> float:
    """``build_sources`` of one source → seconds (0.0 when built)."""
    return build_sources([(key, text, flags)])[key]


def library_for_source(key: str, text: str,
                       flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library built from ``text``, built first if needed;
    loaded once per process."""
    target = _source_target(key, text, flags)
    lib = _user_libs.get(target)
    if lib is not None:
        return lib
    with _lock:
        lib = _user_libs.get(target)
        if lib is None:
            build_source(key, text, flags)
            lib = ctypes.CDLL(str(target))
            _user_libs[target] = lib
    return lib
