"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/mpi4jax_tpu_torch/<name>-<hash>.so`` under the checkout,
where the hash covers the source, the ``csrc/*.cuh`` headers it includes
(directly or through another header) and the flags.  A library is built at
its first use and reused while those are unchanged.  A missing ``nvcc`` or
a failed build raises, with nvcc's messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mpi4jax_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}  # name -> loaded library
LOGS: dict = {}  # name -> nvcc's messages (ptxas register/smem lines)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH: the CUDA kernels cannot be built")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+\.cuh)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header, each once, in the order first included."""
    paths = [CSRC / f"{name}.cu"]
    for path in paths:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep not in paths:
                paths.append(dep)
    return paths


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            LOGS[name] = proc.stdout
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def build_all(names) -> dict:
    """Build (or load) several libraries at once, one ``nvcc`` each, all
    started together; returns each one's seconds until it was loaded."""

    def one(name):
        t0 = time.perf_counter()
        library(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def error_string(lib: ctypes.CDLL, err: int) -> str:
    """The CUDA error text of a code a kernel's C function returned."""
    return f"{lib.kernel_error_string(err).decode()} (cudaError {err})"
