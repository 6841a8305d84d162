"""Builds the package's CUDA sources (``csrc/*.cu``) with one ``nvcc`` call into
a shared library with a plain C interface, and loads it with ``ctypes``.

The library goes to ``build/`` at the repository root, named by a hash of the
sources and the flags, so a second run loads it without rebuilding. Nothing
here runs on import: the first kernel launch (or :func:`build_library`)
builds. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # nvcc wall time; 0 when the cached library was reused
    built: bool
    log: str  # nvcc's output (ptxas register and spill report)


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(SOURCES_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libodeuq_kernels_{digest.hexdigest()[:16]}.so"


def build_library() -> BuildResult:
    """Compiles every ``csrc/*.cu`` into one shared library unless the hashed
    library already exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in _sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, True, proc.stdout + proc.stderr)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library with its C entry points typed; built on first use
    and loaded once per process."""
    lib = ctypes.CDLL(str(build_library().path))
    lib.odeuq_nll_fwd.argtypes = [
        ctypes.c_int,  # dtype
        ctypes.c_int,  # n
        ctypes.c_int,  # obs_dim
        ctypes.c_int,  # model
        ctypes.c_int,  # tableau
        ctypes.c_void_p,  # phys
        ctypes.c_int,  # k_params
        ctypes.c_int,  # batch
        ctypes.c_void_p,  # ys
        ctypes.POINTER(ctypes.c_double),  # rig constants (host)
        ctypes.c_double,  # gamma_sqrt
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    lib.odeuq_nll_fwd.restype = ctypes.c_int
    lib.odeuq_error_string.argtypes = [ctypes.c_int]
    lib.odeuq_error_string.restype = ctypes.c_char_p
    return lib
