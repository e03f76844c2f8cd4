"""Build and bind the port's CUDA kernels.

``seg_search.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (pointers as
``c_void_p``, the stream from ``torch.cuda.current_stream()``). The
build happens at first use, into ``comdb2_tpu_torch/_build/``, keyed by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.

Nothing here runs at import: the CPU tests import every module, and
the host they run on has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "seg_search.cu"
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: compiler output of the last build in this process (``-Xptxas -v``
#: reports registers, shared memory and spills per kernel)
BUILD_LOG = ""

_LIB: Optional[ctypes.CDLL] = None


class SegLayout(ctypes.Structure):
    """Mirror of ``struct SegLayout`` in ``seg_search.cu``."""
    _fields_ = [("P", ctypes.c_int), ("K", ctypes.c_int),
                ("W", ctypes.c_int), ("slot_bits", ctypes.c_int),
                ("state_bits", ctypes.c_int),
                ("state_word", ctypes.c_int),
                ("state_shift", ctypes.c_int),
                ("n_keys", ctypes.c_int),
                ("slot_word", ctypes.c_int * 16),
                ("slot_shift", ctypes.c_int * 16)]


def layout(spec) -> SegLayout:
    """The kernel's layout struct for a :class:`SegKernelSpec`."""
    lay = SegLayout(P=spec.P, K=spec.K, W=spec.n_words,
                    slot_bits=spec.slot_bits,
                    state_bits=spec.state_bits,
                    state_word=spec.state_pos[0],
                    state_shift=spec.state_pos[1], n_keys=spec.n_keys)
    for q, (w, sh) in enumerate(spec.slot_pos):
        lay.slot_word[q] = w
        lay.slot_shift[q] = sh
    return lay


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"seg_search_{h}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its
    path. Raises on a failed compile, with the compiler's output."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (at first use) and load the library, with every
    function's argument and result types declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.seg_search_launch.argtypes = [p, i, i, i, p, p, p, i, p, p, i,
                                      ctypes.POINTER(SegLayout), p]
    lib.seg_search_launch.restype = i
    lib.seg_search_error_string.argtypes = [i]
    lib.seg_search_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def error_string(err: int) -> str:
    return load().seg_search_error_string(err).decode()
