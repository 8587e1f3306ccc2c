"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``),
named by a hash of the sources so an edit rebuilds and an unchanged tree
reuses the build. ``build()`` starts one nvcc per missing library, all at
once, and waits for them. Libraries go under ``build/kernels/`` at the repo
root (listed in ``.gitignore``). Nothing here runs at import (the CPU
tests import every module); a build happens where a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("msfp_quant", "w4_matmul", "conv", "kv4")
# K2/K3's tiles (csrc/w4_gemm.cuh): cfg -> (act rows, packed byte columns
# (each two output columns), k step, threads), 0 = Large, 1 = Small,
# 2 = Medium. nvcc gets them as -DW4_TILE<cfg>_ROWS=... (one macro a value:
# nvcc splits a -D value at commas); kernels/w4_matmul.py plans launches
# with the same table.
GEMM_TILES = {0: (128, 64, 32, 256), 1: (8, 32, 32, 128), 2: (64, 32, 32, 256)}
# kv4_attend (csrc/kv4.cu): cache slots a cp.async ring stage (one a
# thread of its 128) and the most query heads a kv-head. nvcc gets them as
# -DKV4_ATTEND_CHUNK / -DKV4_ATTEND_MAX_G; kernels/kv4.py sizes the
# kernel's shared memory from the same values.
ATTEND_CHUNK = 128
ATTEND_MAX_G = 8
BLOCK_SMEM_LIMIT = 232_448  # shared memory one block may hold on sm_90
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              *(f"-DW4_TILE{c}_{name}={v}" for c, t in GEMM_TILES.items()
                for name, v in zip(("ROWS", "BJ", "BK", "NT"), t)),
              f"-DKV4_ATTEND_CHUNK={ATTEND_CHUNK}",
              f"-DKV4_ATTEND_MAX_G={ATTEND_MAX_G}")

P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_float)
# C entry points: name -> (library, argtypes); every one returns the
# cudaError_t of its launch as an int.
SIGNATURES = {
    "msfp_qdq_launch": ("msfp_quant", [P, P, LL, P, P, I, I, I, I, I, P]),
    "qdq_conv2d_launch": ("msfp_quant",
                          [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I,
                           I, I, P, P, I, I, I, I, I, P]),
    "w4_matmul_launch": ("w4_matmul",
                         [P, P, P, P, I, I, I, I, I, I, I, P, P, I, I, I, I,
                          I, I, I, P, P, P]),
    "w4_conv2d_launch": ("conv",
                         [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I,
                          I, I, I, I, P, P, I, I, I, I, I, I, I, P, P, P]),
    "kv4_encode_launch": ("kv4", [P, P, P, I, I, I, P]),
    "kv4_decode_launch": ("kv4", [P, P, P, LL, I, I, P]),
    "kv4_store_launch": ("kv4", [P, P, P, P, P, P, I, I, LL, I, I, I, P]),
    "kv4_attend_launch": ("kv4", [P, P, P, P, P, P, I, I, I, I, LL, I, F, F,
                                  I, I, I, I, P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns the names it compiled."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def function(fn_name: str):
    """The bound C entry point ``fn_name`` (building its library first)."""
    lib_name, argtypes = SIGNATURES[fn_name]
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            build([lib_name])
            lib = ctypes.CDLL(str(lib_path(lib_name)))
            for name, (owner, types) in SIGNATURES.items():
                if owner == lib_name:
                    fn = getattr(lib, name)
                    fn.argtypes = types
                    fn.restype = ctypes.c_int
            _libs[lib_name] = lib
    return getattr(lib, fn_name)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
