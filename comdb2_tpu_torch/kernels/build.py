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

The host source (``HOST_SOURCE``: ``remap_slots.cpp``, the slot
renaming of ``checker.linear_torch.remap_slots``) is plain C++ for the
CPU, built the same way by the host's C++ compiler (``c++`` or ``g++``
from ``PATH``) and loaded by :func:`load_host`; its hash also takes the
compiler's path and ``--version`` and the machine, so a library built on
another host is not loaded. ``SOURCES`` lists only the ``nvcc``
sources, and only their builds count in ``compile_guard``.

Nothing here runs at import: the CPU tests import every module, and
the host they run on has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ..utils import compile_guard

_HERE = Path(__file__).resolve().parent
SOURCES = {"seg_search": _HERE / "seg_search.cu",
           "pair_sort": _HERE / "pair_sort.cu"}
HOST_SOURCE = _HERE / "remap_slots.cpp"
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: compiler output of each build in this process, by source name
#: (``-Xptxas -v`` reports registers, shared memory and spills per
#: kernel)
BUILD_LOG: Dict[str, str] = {}

HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

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


def _path(src: Path, key: str) -> Path:
    """Where the library built from ``src`` under ``key`` (the flags,
    and for the host library the compiler's identity) lives."""
    h = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{h}.so"


def library_path(name: str = "seg_search", defines=()) -> Path:
    """Where the library for the current source and flags lives."""
    return _path(SOURCES[name], " ".join(_flags(defines)))


def _start(out: Path, cmd, src: Path):
    """Start the compiler ``cmd`` (with its flags) on ``src`` into a
    temporary file beside ``out``; returns ``(out, tmp, process)``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    return out, tmp, subprocess.Popen([*cmd, "-o", str(tmp), str(src)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _start_nvcc(name: str, defines=()):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    what :func:`_start` does, or None."""
    out = library_path(name, defines)
    if out.exists():
        return None
    return _start(out, [_nvcc(), *_flags(defines)], SOURCES[name])


def _finish(name: str, started) -> None:
    out, tmp, proc = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(proc.args[0]).name} failed on {name} "
                           f"({proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(name: str = "seg_search", defines=()) -> Path:
    """Compile one library unless it is already built; returns its
    path. Raises on a failed compile, with the compiler's output."""
    started = _start_nvcc(name, defines)
    if started is not None:
        _finish(name, started)
        compile_guard.note_build()
    return library_path(name, defines)


def build_all() -> None:
    """Compile every library not yet built, one ``nvcc`` per source,
    all running at once. Raises on the first failed compile."""
    started = {n: _start_nvcc(n) for n in SOURCES}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
            compile_guard.note_build()


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
        lib.seg_search_smem_bytes.argtypes = [ctypes.POINTER(SegLayout),
                                              i, i]
        lib.seg_search_smem_bytes.restype = ctypes.c_longlong
        lib.seg_search_attrs.argtypes = [i, ctypes.POINTER(i)]
        lib.seg_search_attrs.restype = i
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


# --- host libraries ---------------------------------------------------------

def _host_cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("c++ compiler not found: the host library builds "
                       "with c++ or g++ from PATH")


def _host_cmd() -> list:
    return [_host_cxx(), *HOST_FLAGS]


def host_library_path() -> Path:
    """Where the host library for the current source, compiler, flags
    and machine lives: a library built by another compiler or for
    another machine is never loaded."""
    cmd = _host_cmd()
    ident = subprocess.run([cmd[0], "--version"], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True).stdout
    return _path(HOST_SOURCE,
                 " ".join([*cmd, platform.machine()]) + "\n" + ident)


def load_host() -> ctypes.CDLL:
    """Build (at first use) and load the host library, with its
    function's argument and result types declared."""
    key = ("host",)
    if key in _LIBS:
        return _LIBS[key]
    out = host_library_path()
    if not out.exists():
        _finish(HOST_SOURCE.stem, _start(out, _host_cmd(), HOST_SOURCE))
    lib = ctypes.CDLL(str(out))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.remap_slots.argtypes = [p, p, ll, ll, p, p, p, ll, p]
    lib.remap_slots.restype = ll
    _LIBS[key] = lib
    return lib
