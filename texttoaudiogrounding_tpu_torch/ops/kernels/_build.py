"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles, with ``nvcc`` for ``sm_90a``, into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``.  The first call builds all
sources at once, one ``nvcc`` process each, started together.  A library
is named by a hash of its source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.

The build directory is ``texttoaudiogrounding_tpu_torch/build/`` (listed
in ``.gitignore``); ``TTG_TORCH_BUILD_DIR`` overrides it.
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

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple, object] = {}
build_seconds: float | None = None


def build_dir() -> Path:
    return Path(os.environ.get("TTG_TORCH_BUILD_DIR", _PKG / "build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns seconds."""
    global build_seconds
    with _lock:
        if build_seconds is not None:
            return build_seconds
        start = time.perf_counter()
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sources():
            target = _lib_path(src)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            log = target.with_suffix(".log")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh,
                                        stderr=subprocess.STDOUT)
            jobs.append((src, proc, tmp, target, log))
        failed = []
        for src, proc, tmp, target, log in jobs:
            if proc.wait() != 0:
                failed.append(f"{src.name}:\n{log.read_text()}")
                continue
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - start
        return build_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
    return _libs[name]


def function(lib: str, name: str, argtypes: list):
    """A C entry point returning ``cudaError_t`` as an int."""
    key = (lib, name)
    if key not in _funcs:
        fn = getattr(library(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return _funcs[key]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
