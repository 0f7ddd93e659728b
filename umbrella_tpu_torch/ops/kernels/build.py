"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own into
`build/<name>-<hash>.so` at the repository root (the hash is of the source, so
an edited kernel is rebuilt and a stale library is never loaded). All sources
are compiled together, one nvcc process each, the first time any kernel is
needed; nothing is built when a module is imported.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a nonzero code.
"""
from __future__ import annotations

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
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

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


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


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


# blocks to aim for when K is split: about four per SM of an H100 SXM (132 SMs).
# A constant, not read from the card, so a row's summation order -- and with
# it every result -- is the same on any card for the same matrix shape.
SPLIT_K_TARGET_BLOCKS = 4 * 132


def split_k(n_col_tiles: int, n_chunks: int) -> int:
    """How many blocks share one output tile's K range: enough to reach
    SPLIT_K_TARGET_BLOCKS, with at least four K chunks per block. A function of
    the matrix shape only -- never of the row count -- so a row's summation
    order is the same in every batch."""
    return max(1, min(n_chunks // 4, -(-SPLIT_K_TARGET_BLOCKS // n_col_tiles)))


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
