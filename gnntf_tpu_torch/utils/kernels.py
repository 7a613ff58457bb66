"""Build and load the port's hand-written CUDA kernels.

Each ``gnntf_tpu_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``gnntf_tpu_torch/build/lib<name>.so``, a shared library
with a plain C interface that the kernel's wrapper loads with ``ctypes``.  A
library is rebuilt when it is missing or older than its source or a header
of ``csrc/`` that the source includes (``#include "..."``, followed
through headers).  A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise FileNotFoundError("nvcc not found (needed to build the CUDA "
                                "kernels of gnntf_tpu_torch)")
    return path


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def inputs(name: str) -> list:
    """``<name>.cu`` and every header of ``csrc/`` it includes, directly or
    through another header."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(CSRC / h for h in _INCLUDE.findall(path.read_text()))
    return seen


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists() or lib.stat().st_mtime
            < max(p.stat().st_mtime for p in inputs(name)))


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> Dict[str, dict]:
    """Compile the named sources (default: all), one ``nvcc`` process each,
    all started together.  Returns ``{name: {"seconds", "ptxas"}}`` for the
    libraries built; raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    started = {}
    for name in todo:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    results, failures = {}, []
    for name, (proc, tmp, t0) in started.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, library_path(name))
        results[name] = {"seconds": seconds, "ptxas": output}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``lib<name>.so``, built first if needed."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.gnntf_cuda_error_string.restype = ctypes.c_char_p
    lib.gnntf_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.gnntf_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
