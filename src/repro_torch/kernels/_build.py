"""Build and bind the CUDA kernels: nvcc into a shared library with a plain
C interface, loaded with ctypes.

The library is built on first use from the sources in ``csrc/`` and
nothing else, into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources and flags: editing a source
rebuilds, an unchanged tree reuses the library already built. Building
needs ``nvcc`` (on ``PATH``, or under ``$CUDA_HOME/bin``, or
``/usr/local/cuda/bin``) and a Hopper card to run on (``sm_90a``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("fullw2v.cu",)
HEADERS = ("seq.cuh", "tiled.cuh", "window.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""
    lib: ctypes.CDLL
    path: str
    built: bool            # compiled by this process (False: reused)
    seconds: float         # compile time (0 when reused)
    log: str               # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels of repro_torch build on first use and need the CUDA "
        "toolkit")


def source_hash() -> str:
    """Hash of the kernel sources and build flags (names the library)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fullw2v_seq_launch.argtypes = [p, p, p, p, p, f, i, i, i, i, i, i, p]
    lib.fullw2v_seq_launch.restype = i
    lib.fullw2v_seq_variant.argtypes = [p, p, i, i, i, i]
    lib.fullw2v_seq_variant.restype = i
    lib.fullw2v_seq_smem_bytes.argtypes = [i, i, i, i, i]
    lib.fullw2v_seq_smem_bytes.restype = ctypes.c_longlong
    lib.fullw2v_tiled_launch.argtypes = [p, p, p, p, p, p, p, p, p, f,
                                         i, i, i, i, i, i, i, i, p, p]
    lib.fullw2v_tiled_launch.restype = i
    lib.fullw2v_tiled_fused_launch.argtypes = [p, p, p, p, i, p, p, p, p, p,
                                               p, p, f, i, i, i, i, i, i, i,
                                               i, p, p]
    lib.fullw2v_tiled_fused_launch.restype = i
    lib.fullw2v_tiled_choice.argtypes = [p, p, p, p, i, i, i, i, i, i, i]
    lib.fullw2v_tiled_choice.restype = i
    lib.fullw2v_tiled_smem_bytes.argtypes = [i, i, i, i, i, i, i, i]
    lib.fullw2v_tiled_smem_bytes.restype = ctypes.c_longlong
    lib.fullw2v_error_string.argtypes = [i]
    lib.fullw2v_error_string.restype = ctypes.c_char_p


@contextlib.contextmanager
def _build_lock():
    """One nvcc build at a time across processes (the ranks of a mesh load
    the library together): an advisory lock on a file in the build
    directory, which the kernel drops when its holder exits."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Build (when the sources changed) and load the kernel library."""
    out = BUILD_DIR / f"libfullw2v_{source_hash()}.so"
    with _build_lock():
        built, seconds, log = _build(out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    return Library(lib=lib, path=str(out), built=built, seconds=seconds,
                   log=log)


def _build(out: pathlib.Path):
    """Compile the library into ``out`` unless it exists; returns
    ``(built, seconds, log)``."""
    built, seconds, log = False, 0.0, ""
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)       # atomic: concurrent builders never see
        built = True               # a half-written library
        (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return built, seconds, log
