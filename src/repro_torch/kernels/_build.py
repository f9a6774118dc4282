"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, one ``nvcc`` per source, all started together, into
``build/repro_torch/<hash>/`` at the root of the checkout; the hash covers
the sources and the flags, so an edit rebuilds and an unchanged tree
reuses the libraries. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only on a machine with the CUDA toolkit")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Raises with nvcc's output when a source fails to build."""
    if _libs:
        return _libs
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        so = out / f"lib{src.stem}.so"
        if so.exists():
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    logs = []
    failed = []
    for stem, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        logs.append(f"== {stem}.cu ==\n{log}")
        if proc.returncode != 0:
            failed.append(stem)
        else:
            os.replace(tmp, so)         # atomic: concurrent builds agree
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    for so in sorted(out.glob("lib*.so")):
        _libs[so.stem[3:]] = ctypes.CDLL(str(so))
    return _libs


def bind(lib: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of one kernel library, with its argument types
    declared (pointers and the stream as ``c_void_p``, so none is cut to
    32 bits) and an ``int`` result: the ``cudaGetLastError()`` code."""
    fn = getattr(build_all()[lib], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def stream_ptr(device: Optional[object] = None) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
