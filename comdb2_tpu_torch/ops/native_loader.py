"""ctypes bindings for the native EDN history loader.

The counterpart of the JAX package's ``ops/native_loader.py``.
:func:`parse_history_fast` parses the op-map EDN that ``ct_register
-j`` writes through the C++ loader in ``native/build/libct_sut.so``
(built with ``cmake -S native -B native/build && cmake --build
native/build``) and falls back to the port's :func:`.history.parse_history` for
anything outside the fast subset, or when the library is not built.
This is host parsing, not the device path: the fallback gives the same
ops, and ``info`` says which reader produced them. Values reconstruct
exactly as the Python reader builds them: ``nil → None``, ints,
``[a b] → (a, b)``, ``[k [a b]] → (k, (a, b))``; a ``nil`` inside a
vector round-trips as ``None``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from .op import Op, TYPE_NAMES

_V_NIL, _V_INT, _V_VEC, _V_VECVEC = 0, 1, 2, 3
_NIL_SENTINEL = -(1 << 63)

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _find_lib() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(root, "native", "build", "libct_sut.so")
    return cand if os.path.exists(cand) else None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.edn_load.restype = ctypes.c_void_p
        lib.edn_load.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.edn_load_free.argtypes = [ctypes.c_void_p]
        lib.edn_n_ops.restype = ctypes.c_longlong
        lib.edn_n_ops.argtypes = [ctypes.c_void_p]
        lib.edn_pool_len.restype = ctypes.c_longlong
        lib.edn_pool_len.argtypes = [ctypes.c_void_p]
        lib.edn_f_names.restype = ctypes.c_char_p
        lib.edn_f_names.argtypes = [ctypes.c_void_p]
        lib.edn_copy.argtypes = [ctypes.c_void_p] + \
            [np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
             for dt in (np.int32, np.int8, np.int32, np.int64,
                        np.int8, np.int32, np.int32, np.int32,
                        np.int64)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def _decode_value(kind, off, ln, split, pool):
    if kind == _V_NIL:
        return None
    if kind == _V_INT:
        v = pool[off]
        return None if v == _NIL_SENTINEL else int(v)
    def elem(x):
        return None if x == _NIL_SENTINEL else int(x)
    if kind == _V_VEC:
        return tuple(elem(pool[off + i]) for i in range(ln))
    # V_VECVEC: outer ints with one inner vector at `split`
    inner_len = ln - split
    outer = [elem(pool[off + i]) for i in range(split)]
    inner = tuple(elem(pool[off + split + i]) for i in range(inner_len))
    return tuple(outer) + (inner,)


def parse_history_fast(text: str, info: Optional[dict] = None) -> List[Op]:
    """Parse an EDN history, preferring the native loader. ``info``,
    when given, receives ``{"parser": "native" | "python"}``: the
    reader that produced the ops."""
    lib = _load_lib()
    handle = None
    if lib is not None:
        raw = text.encode()
        rc = ctypes.c_int(0)
        handle = lib.edn_load(raw, len(raw), ctypes.byref(rc))
    if info is not None:
        info["parser"] = "native" if handle else "python"
    if not handle:
        # no library, or outside the fast subset / malformed
        from .history import parse_history

        return parse_history(text)
    try:
        n = lib.edn_n_ops(handle)
        pool_n = lib.edn_pool_len(handle)
        process = np.empty(n, np.int32)
        type_ = np.empty(n, np.int8)
        f = np.empty(n, np.int32)
        time_us = np.empty(n, np.int64)
        val_kind = np.empty(n, np.int8)
        val_off = np.empty(n, np.int32)
        val_len = np.empty(n, np.int32)
        val_split = np.empty(n, np.int32)
        pool = np.empty(max(pool_n, 1), np.int64)
        lib.edn_copy(handle, process, type_, f, time_us, val_kind,
                     val_off, val_len, val_split, pool)
        f_names = lib.edn_f_names(handle).decode().split("\n")[:-1]
    finally:
        lib.edn_load_free(handle)

    out: List[Op] = []
    for i in range(n):
        out.append(Op(
            process=int(process[i]),
            type=TYPE_NAMES[type_[i]],
            f=f_names[f[i]],
            value=_decode_value(int(val_kind[i]), int(val_off[i]),
                                int(val_len[i]), int(val_split[i]),
                                pool),
            time=int(time_us[i]) if time_us[i] >= 0 else None,
        ))
    return out
