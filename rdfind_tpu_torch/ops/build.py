"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes.  Libraries go to ``build/`` at the
root of the checkout, named by a hash of their source and flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing here runs at import
time: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C signatures of each library's launchers: {symbol: argtypes}.
SIGNATURES = {
    "fused_cind": {"fused_cind_launch":
                   [_P, _LL, _P, _LL, _LL] + [_P] * 11 + [_I] * 5 + [_P]
                   + [_I] * 4 + [_P] * 4,
                   "fused_cind_smem_bytes": []},
    "contains": {"contains_launch": [_P] * 4 + [_I] * 3 + [_P],
                 "repeat_probe_launch": [_P, _P, _I, _I, _P],
                 "pipeline_probe_launch": [_P, _P, _I, _P]},
    "membership": {"membership_rows_launch": [_P, _LL] + [_I] * 4 + [_P] * 3,
                   "membership_lines_launch": [_P, _LL, _I, _I] + [_P] * 3},
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or in /usr/local/cuda/bin): "
                           "the CUDA kernels are built with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile every named kernel that is not built yet, all nvcc processes at
    once.  Returns {name: {"seconds": s, "log": nvcc output}} for what was
    compiled; raises with nvcc's output when one fails.  The log is kept beside
    the library (``build_log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def build_log(name: str) -> str:
    """nvcc's output (ptxas' registers, shared memory and spills) from the
    build of kernel `name`'s library."""
    return library_path(name).with_suffix(".log").read_text()


_LIBS: dict = {}


def load(name: str):
    """The loaded library of kernel `name`, built first when needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
