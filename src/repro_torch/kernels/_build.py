"""Build the hand-written CUDA kernels at first use.

nvcc compiles each `csrc/<name>.cu`, with the headers it includes from
`csrc/`, into a shared library with a plain C interface, loaded with
ctypes.  The library lands in `kernels/build/` under a name that carries
a hash of the sources and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing
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
from typing import List

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
    """Where the build of `csrc/<name>.cu` lives for the current source
    and the shared headers (`csrc/*.cuh`) it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(*names: str) -> List[str]:
    """Compile each `csrc/<name>.cu` whose current build is missing, one
    nvcc process per source, all started together; returns the library
    paths in the order given.  The compiler's report (registers, spills)
    is kept beside each library as `<library>.log`."""
    outs = [library_path(n) for n in names]
    todo = [(n, out) for n, out in zip(names, outs)
            if not os.path.exists(out)]
    if not todo:
        return outs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                                 os.path.join(CSRC_DIR, name + ".cu")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{err}")
            continue
        with open(out + ".log", "w") as f:
            f.write(err)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    return ctypes.CDLL(build(name)[0])
