"""Build the port's CUDA kernels at first use: nvcc -> .so -> ctypes.

Each ``mini_tpu_torch/csrc/<name>.cu`` has a plain C interface (no PyTorch
headers), so one nvcc call takes seconds.  The library goes into
``mini_tpu_torch/build/`` under a name that carries the hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  With no nvcc there is no kernel: :func:`load` raises
``RuntimeError`` and nothing falls back to a plain version.

The launch path.  A wrapper binds each C entry once, at its first launch
(:func:`bind`: the library built and loaded, ``argtypes`` and ``restype``
set), and keeps the bound function in a module-level name; every later
launch is one call of it.  ``stream`` gives the current stream of a
device as a raw handle, without building a ``torch.cuda.Stream`` object
per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LIBS: dict = {}  # name -> loaded ctypes.CDLL
last_build_seconds: dict = {}  # name -> seconds nvcc took (0.0 if cached)


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then the default CUDA install."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")
    return cand if os.path.isfile(cand) else None


def _lib_path(name: str, src: bytes) -> str:
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{h}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; return the library path.  Raises RuntimeError without nvcc or
    when nvcc fails."""
    import time

    src_path = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src_path, "rb") as f:
        src = f.read()
    out = _lib_path(name, src)
    if os.path.isfile(out):
        last_build_seconds[name] = 0.0
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc was not found "
            f"($CUDA_HOME/bin, $PATH, {DEFAULT_CUDA_HOME}/bin); the CUDA "
            "toolkit is required to run the port on a GPU"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src_path],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src_path} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    last_build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib


def bind(name: str, fn: str, argtypes: list, restype=ctypes.c_int):
    """The C entry ``fn`` of library ``name`` with its argument and result
    types set: bound once, then called per launch."""
    entry = getattr(load(name), fn)
    entry.argtypes = argtypes
    entry.restype = restype
    return entry


# stream(device_index) -> int: the raw handle of that device's current CUDA
# stream, what ``torch.cuda.current_stream(d).cuda_stream`` gives without
# the Stream object that call builds per call (``chip_smoke.py`` times
# both); None in a build of torch without CUDA, where no launch happens.
stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
