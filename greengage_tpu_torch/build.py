"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel family behind a plain C interface.
It is compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``greengage_tpu_torch/_build/`` and loaded with
ctypes. The library's file name carries a digest of its source, so an
edited kernel is rebuilt and a stale one is never loaded. Nothing is built
when the package is imported: the CPU tests import every module on hosts
without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
KERNELS = ("fused_dense_agg",)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _command(name: str, out: str) -> list[str]:
    return [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", out,
            os.path.join(CSRC, name + ".cu")]


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. -> {name: compiler output}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (tmp, out, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
