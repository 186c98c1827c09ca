"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` holds one kernel family behind a plain C interface
(no PyTorch headers, so a build takes seconds).  It compiles for Hopper
(``sm_90a``) into ``build/paddle_tpu_torch/<name>-<hash>.so`` under the
checkout, at first use; the hash covers the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
built when a module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per kernel source (ptxas register / shared memory report)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cuh", ".h")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = f"{out}.tmp{os.getpid()}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together."""
    with _lock:
        jobs = []
        for name in names:
            out = _target(name)
            if not os.path.exists(out):
                jobs.append((name, out, _start(name, out)))
        errors = []
        for name, out, proc in jobs:
            try:
                _finish(name, out, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_target(name))
    return lib


def all_kernels():
    return sorted(fn[:-3] for fn in os.listdir(CSRC) if fn.endswith(".cu"))
