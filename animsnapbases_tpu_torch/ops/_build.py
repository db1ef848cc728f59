"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under ``build/kernels/`` at
the repository root, at first use, and loaded with ``ctypes``.  Every
pointer and the stream pass as ``c_void_p``.  Every C entry point returns
the ``cudaGetLastError()`` of its launches, and :func:`check` raises on a
non-zero code.  Nothing here runs when the module is imported: the CPU
tests import every module, and the CPU has no ``nvcc``.

A library's file name carries a hash of its sources, so an edited
kernel is rebuilt and a stale one is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_reduced", "resident", "affine", "affine_chunked",
           "affine_chunked_free", "affine_chunked_opts")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source build record: seconds, ptxas report, library path
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Raises with the compiler's
    output when one fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return build_info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        build_info[n] = {"seconds": time.perf_counter() - t0,
                         "log": log, "path": str(out)}
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed once."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(name: str, code: int, what: str) -> None:
    """Raise when a C entry point of ``csrc/<name>.cu`` returned a CUDA
    error code."""
    if code != 0:
        describe = load(name).cuda_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {code} ({describe(code).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
