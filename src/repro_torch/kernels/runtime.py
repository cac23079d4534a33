"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.
:func:`load_library` compiles it with ``nvcc`` for ``sm_90a`` into a
shared library under ``kernels/build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, and loads it with ``ctypes``.  A rebuilt source gets a new
name, so a stale library is never loaded.  Nothing builds at import
time: the first launch builds, and ``chip_smoke.py`` calls :func:`build`
up front to time it.

A missing ``nvcc`` or a failed compile raises; there is no fallback.

The wrappers share :func:`ptr`, :func:`stream_of` and :func:`check`:
every pointer and the stream cross into C as ``c_void_p``, the stream is
read at launch time (autograd runs a backward on its own thread), and
each C entry point returns its launch's ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

import torch

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD = pathlib.Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel source, in the order chip_smoke.py builds and reports them
KERNELS = ("moba_decode", "centroids", "flash_topk", "moba_fwd", "moba_bwd",
           "swa")
# the ``dtype`` code of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the ``payload`` code of a paged pool (the decode kernel): unquantized
# pools share q's code; int8 and fp8 (e4m3 "fn") pools carry scales
PAYLOAD_CODES = {**DTYPE_CODES, torch.int8: 2, torch.float8_e4m3fn: 3}

_LOADED: Dict[str, ctypes.CDLL] = {}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s card, read at launch time (the
    raw handle: no ``torch.cuda.Stream`` object is built)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """Library ``name`` with ``argtypes`` and an int return set on its
    entry point ``fn``."""
    lib = load_library(name)
    entry = getattr(lib, fn)
    if entry.argtypes is None:
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    return lib


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels build from source at first use")


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns each compile's ptxas
    report (empty for a library that was already built)."""
    names = list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {n: "" for n in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)        # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if
    needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
