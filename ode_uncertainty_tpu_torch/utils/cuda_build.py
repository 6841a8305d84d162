"""Builds the package's CUDA sources (``csrc/*.cu``, which include
``csrc/*.cuh``) into one shared library with a plain C interface, and loads
it with ``ctypes``.

Each source is compiled to an object by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects. The library goes to
``build/`` at the repository root, named by a hash of the sources, the
headers and the flags, so a second run loads it without rebuilding. Nothing
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
import threading
import time
from pathlib import Path

SOURCES_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # nvcc wall time (compiles and link); 0 when the cached library was reused
    built: bool
    log: str  # nvcc's output (ptxas register and spill report)
    # source name -> seconds from the build's start to the end of its nvcc (all start together)
    unit_seconds: dict = dataclasses.field(default_factory=dict)


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
    for src in sorted(SOURCES_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libodeuq_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds) -> tuple:
    """Runs the commands side by side; returns their output and the seconds
    from the start to each one's end, or raises with the output of the first
    that failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs, seconds = [None] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        seconds[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    return "".join(outs), seconds


def build_library() -> BuildResult:
    """Compiles every ``csrc/*.cu`` (one nvcc each, in parallel) and links
    them into one shared library, unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    log, unit_seconds = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(_sources(), objs)])
    tmp = out.with_name(f"{stem}.tmp.so")
    log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])[0]
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    return BuildResult(out, seconds, True, log, {src.name: t for src, t in zip(_sources(), unit_seconds)})


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
    lib.odeuq_nll_bwd.argtypes = [
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
        ctypes.c_void_p,  # g
        ctypes.POINTER(ctypes.c_int),  # parameter rows to differentiate (host)
        ctypes.c_int,  # number of rows
        ctypes.c_void_p,  # dphys
        ctypes.c_void_p,  # dgamma per lane, or NULL
        ctypes.c_void_p,  # stream
    ]
    lib.odeuq_nll_bwd.restype = ctypes.c_int
    lib.odeuq_error_string.argtypes = [ctypes.c_int]
    lib.odeuq_error_string.restype = ctypes.c_char_p
    return lib
