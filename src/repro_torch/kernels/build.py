"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), in
``kernels/build/`` next to this file, a directory git ignores. A library's
file name carries a hash of its sources and flags, so an edited source never
loads a stale build. :func:`build_all` starts one ``nvcc`` per missing
library, all at once, and returns their ``-Xptxas -v`` reports.

Nothing here runs at import time: the CPU tests import every module of the
port on machines that have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# library -> (source, {C function: argtypes}); every function returns the
# cudaError_t of its launch as an int.
LIBRARIES = {
    "ns_matmul": (
        "ns_matmul.cu",
        {"ns_gemm_batched": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                             _I, _I, _I, _I, _I, _F, _F, _P]},
    ),
    "ns_fused": (
        "ns_fused.cu",
        {"ns_fused_chain": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P]},
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    source, _ = LIBRARIES[name]
    h = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(part.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns ``{name: nvcc log}``.

    Libraries already built from the same sources are not rebuilt (their log
    reads "cached"). Raises ``RuntimeError`` with the compiler output when a
    build fails.
    """
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: dict[str, str] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            logs[name] = "cached"
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
