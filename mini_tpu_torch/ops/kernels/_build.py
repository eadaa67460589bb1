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

:func:`compile_library` (hash-named library, private name, rename) also
builds the native graph loader with g++ (``mini_tpu_torch/native``).
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


def compile_library(src_path: str, stem: str, compiler: str,
                    flags: tuple, build_dir: str) -> tuple[str, float]:
    """Compile ``src_path`` with ``compiler flags`` into
    ``build_dir/lib<stem>_<hash>.so`` unless that library exists; the hash
    covers the source and the flags.  Returns the path and the seconds the
    compiler took (0.0 if the library was there).  Raises RuntimeError
    when the compiler fails, with its output.

    The library is written under a private name and renamed into place,
    so processes that build at once never load a half-written file."""
    import time

    with open(src_path, "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(build_dir, f"lib{stem}_{h}.so")
    if os.path.isfile(out):
        return out, 0.0
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", tmp, src_path],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed to build {src_path} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; return the library path.  Raises RuntimeError without nvcc or
    when nvcc fails."""
    src_path = os.path.join(CSRC_DIR, f"{name}.cu")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc was not found "
            f"($CUDA_HOME/bin, $PATH, {DEFAULT_CUDA_HOME}/bin); the CUDA "
            "toolkit is required to run the port on a GPU"
        )
    out, seconds = compile_library(src_path, name, nvcc, NVCC_FLAGS,
                                   BUILD_DIR)
    last_build_seconds[name] = seconds
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
