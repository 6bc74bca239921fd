"""Build and load the CUDA C++ kernels of calib/csrc/.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, on the machine with the card, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), and runs again
whenever a source is newer than the library.  Each source compiles in its
own ``nvcc`` process, all started together, then one link.  A failed build
raises ``KernelBuildError``; nothing falls back."""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "octav.cu", CSRC / "histogram.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libdipoorlet_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    pass


class OctavEntry(ctypes.Structure):
    """One tensor of an OCTAV launch (``Entry`` in csrc/octav.cu)."""
    _fields_ = [("x", ctypes.c_void_p), ("n", ctypes.c_int), ("chunk", ctypes.c_int),
                ("index", ctypes.c_int)]


class BinCountEntry(ctypes.Structure):
    """One tensor of a histogram launch (``Entry`` in csrc/histogram.cu)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("first", ctypes.c_int64), ("t", ctypes.c_int)]


def find_nvcc() -> str:
    """nvcc on PATH, then in $CUDA_HOME/bin, then in /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                           "/usr/local/cuda/bin: the CUDA toolkit is needed to build "
                           "the dipoorlet_torch kernels")


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES)


def build() -> float:
    """Compile the kernels if the library is missing or stale; returns the
    seconds the build took (0.0 when the library was current)."""
    if not _stale():
        return 0.0
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objects)]
    failures = []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))
    tmp_lib = BUILD_DIR / f"{LIBRARY.name}.{tag}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objects), "-o", str(tmp_lib)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
    os.replace(tmp_lib, LIBRARY)  # atomic: concurrent builders never see half a file
    return time.perf_counter() - t0


_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.octav_launch.argtypes = [ctypes.POINTER(OctavEntry), i32, i32, i32, i32, i32, i32,
                                     i32, p, p, i32]
        lib.octav_launch.restype = i32
        lib.bin_count_launch.argtypes = [ctypes.POINTER(BinCountEntry), i32, i32, i32, i64, i64,
                                         i64, i32, i32, p, p, p, i32]
        lib.bin_count_launch.restype = i32
        _lib = lib
    return _lib
