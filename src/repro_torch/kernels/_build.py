"""Build the hand-written CUDA kernels at first use.

nvcc compiles each `csrc/<name>.cu` into a shared library with a plain C
interface, loaded with ctypes.  The library lands in `kernels/build/`
under a name that carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
here runs at import time: the package imports on machines without nvcc or
a card, and only a launch on a CUDA tensor asks for the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if path is None and os.path.exists(home):
        path = home
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """Where the build of `csrc/<name>.cu` lives for the current source."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless the current build exists; returns
    the library path.  The compiler's report (registers, spills) is kept
    beside it as `<library>.log`."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                           os.path.join(CSRC_DIR, name + ".cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    return ctypes.CDLL(build(name))
