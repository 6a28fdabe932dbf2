"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds happen at first use,
never at import, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``); the library name carries a hash of its sources and
flags, so an edited kernel is rebuilt and an unchanged one reused. All
sources build in parallel, one ``nvcc`` process each.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception, because a refused launch never runs and a later
``synchronize`` does not report it.

``launch_counts`` holds one plain integer per kernel: a wrapper adds one
exactly where it launches its kernel, so a run can show which kernels
its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mpmrf_decode", "mpmrf_prefill")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: Dict[str, int] = {
    "mpmrf_paged_filter_scores": 0,
    "paged_decode_gather_attention": 0,
    "mpmrf_paged_prefill_filter_scores": 0,
    "paged_prefill_gather_attention": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build and nvcc's resource report per source
build_info: Dict[str, object] = {"seconds": 0.0, "ptxas": {}}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds spent (0 when everything was built)."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failures: List[str] = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        build_info["ptxas"][name] = stderr
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    build_info["seconds"] = seconds
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C function to its ``argtypes``; every one
    returns an ``int`` CUDA error code."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
