"""Build-at-first-use for the port's CUDA kernels.

Each kernel source under `ops/csrc/` is compiled by nvcc for sm_90a into a
shared library with a plain C interface, which the kernel's wrapper loads
with ctypes. Libraries go to `build/kernels/` at the repository root, named
by a hash of the source and the compiler and link flags, so an edit rebuilds
and an unchanged source is loaded as it is. A source that calls a library
of the CUDA toolkit names it in `LINK_FLAGS`: `jpeg_decode.cu` links
nvJPEG.

There is no fallback: without nvcc, or when nvcc fails, `load_library`
raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = {"jpeg_decode.cu": ("-lnvjpeg",)}

_lock = threading.Lock()


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then /usr/local/cuda, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    return shutil.which("nvcc")


def _flags(source: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *LINK_FLAGS.get(source, ()))


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str, verbose: bool = False) -> Path:
    """Compile `csrc/<source>` unless the hashed library already exists;
    returns the library path. Raises RuntimeError without nvcc or on a
    compiler error."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {source}: nvcc not found (set CUDA_HOME or put "
            "nvcc on PATH)"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / source), *LINK_FLAGS.get(source, ())]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source} (rc={proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for `csrc/<source>`. The lock
    keeps two threads of one process from writing the same build file."""
    with _lock:
        return ctypes.CDLL(str(build(source)))
