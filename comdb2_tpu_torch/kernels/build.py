"""Build and bind the port's CUDA kernels.

Each source (``seg_search.cu``, ``pair_sort.cu``) is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, loaded with ``ctypes`` (pointers as ``c_void_p``, the stream
from ``torch.cuda.current_stream()``). The build happens at first use,
into ``comdb2_tpu_torch/_build/``, keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library already built. :func:`build_all` starts one ``nvcc`` per source
at once. ``defines`` builds a variant with extra ``-D`` macros beside
the plain one (``seg_search.cu``'s ``SEG_PROFILE`` phase counters, read
by ``scripts/torch_seg_profile.py``; ``pair_sort.cu``'s ``PS_PROFILE``
phase stamps, read by ``scripts/torch_pair_sort_profile.py``).

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
from typing import Dict

_HERE = Path(__file__).resolve().parent
SOURCES = {"seg_search": _HERE / "seg_search.cu",
           "pair_sort": _HERE / "pair_sort.cu"}
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: compiler output of each build in this process, by source name
#: (``-Xptxas -v`` reports registers, shared memory and spills per
#: kernel)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[tuple, ctypes.CDLL] = {}


class SegLayout(ctypes.Structure):
    """Mirror of ``struct SegLayout`` in ``seg_search.cu``."""
    _fields_ = [("P", ctypes.c_int), ("K", ctypes.c_int),
                ("W", ctypes.c_int), ("slot_bits", ctypes.c_int),
                ("state_bits", ctypes.c_int),
                ("state_word", ctypes.c_int),
                ("state_shift", ctypes.c_int),
                ("n_keys", ctypes.c_int),
                ("slot_word", ctypes.c_int * 16),
                ("slot_shift", ctypes.c_int * 16),
                ("root", ctypes.c_int * 4)]


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
        lay.root[w] |= 1 << sh            # the empty config: slots IDLE
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


def _flags(defines=()) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str = "seg_search", defines=()) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCES[name].read_bytes()
                       + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{h}.so"


def _start(name: str, defines=()):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(out, tmp, process)`` or None."""
    out = library_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(SOURCES[name])]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(name: str, started) -> None:
    out, tmp, proc = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, out)


def build(name: str = "seg_search", defines=()) -> Path:
    """Compile one library unless it is already built; returns its
    path. Raises on a failed compile, with the compiler's output."""
    started = _start(name, defines)
    if started is not None:
        _finish(name, started)
    return library_path(name, defines)


def build_all() -> None:
    """Compile every library not yet built, one ``nvcc`` per source,
    all running at once. Raises on the first failed compile."""
    started = {n: _start(n) for n in SOURCES}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)


def load(name: str = "seg_search", defines=()) -> ctypes.CDLL:
    """Build (at first use) and load one library, with every function's
    argument and result types declared."""
    key = (name, tuple(defines))
    if key in _LIBS:
        return _LIBS[key]
    lib = ctypes.CDLL(str(build(name, defines)))
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "seg_search":
        lib.seg_search_launch.argtypes = [
            p, i, i, i, p, p, p, i, p, p, i, i, ctypes.POINTER(SegLayout),
            p, i, p, p, p]
        lib.seg_search_launch.restype = i
        lib.seg_search_occupancy.argtypes = [ctypes.POINTER(SegLayout), i]
        lib.seg_search_occupancy.restype = i
    else:
        lib.pair_sort_launch.argtypes = [p, p, p, p, p, i, i, p]
        lib.pair_sort_launch.restype = i
        lib.pair_sort_phase.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.pair_sort_phase.restype = i
        for fn in ("pair_sort_tile", "pair_sort_smem_bytes"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.pair_sort_attrs.argtypes = [i, ctypes.POINTER(i)]
        lib.pair_sort_attrs.restype = i
        lib.pair_sort_scratch_words.argtypes = [i, i]
        lib.pair_sort_scratch_words.restype = ctypes.c_longlong
        lib.pair_sort_stamps.argtypes = [p]
        lib.pair_sort_stamps.restype = i
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [i]
    err_fn.restype = ctypes.c_char_p
    _LIBS[key] = lib
    return lib


def error_string(err: int, name: str = "seg_search") -> str:
    return getattr(load(name), f"{name}_error_string")(err).decode()
