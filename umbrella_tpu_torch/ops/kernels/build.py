"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own into
`build/<name>-<hash>.so` at the repository root (the hash is of the source and
of the shared headers `csrc/*.cuh`, so an edited kernel is rebuilt and a stale
library is never loaded). All sources
are compiled together, one nvcc process each, the first time any kernel is
needed; nothing is built when a module is imported.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a nonzero code. A wrapper launches
inside `on_device(tensor)`, which makes the tensor's card current and gives
that card's current stream: the runtime launches on the current device, so an
operand on `cuda:1` must not meet a launch on `cuda:0`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-I", CSRC_DIR]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _headers() -> list:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def _lib_path(name: str) -> str:
    """build/<name>-<hash>.so, the hash of the source and every shared header."""
    digest = hashlib.sha1()
    for f in [name + ".cu", *_headers()]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that has no up-to-date library, all nvcc
    processes at once; load them all. Returns {name: ctypes.CDLL}."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in sources():
            out = _lib_path(name)
            if name in _libs or os.path.exists(out):
                continue
            tmp = out + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in sources():
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_lib_path(name))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {code}")


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# an H100 SXM's SMs. A constant, not read from the card, so a row's summation
# order -- and with it every result -- is the same on any card for the same
# matrix shape.
SMS = 132


def split_k(n_col_tiles: int, n_chunks: int, min_chunks: int, blocks: int) -> int:
    """How many blocks share one output tile's K range of `n_chunks` chunks,
    each split taking at least `min_chunks` chunks: the most that keep the grid
    within `blocks` blocks (a kernel of one block a SM: `blocks` is one wave).
    A function of the matrix shape only -- never of the row count -- so a
    row's summation order is the same in every batch."""
    return max(1, min(n_chunks // min_chunks, blocks // n_col_tiles))


@contextlib.contextmanager
def on_device(t):
    """Make tensor `t`'s card the current device for the block and give its
    current stream (a ctypes pointer) to launch on."""
    import torch

    with torch.cuda.device(t.device):
        yield ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
