"""Native (C++) TALCO-XDrop host kernel binding.

Same call surface as talco_np.align_freq; the shared library
(native/talco.cpp) reproduces the oracle's float32 semantics exactly and is
~10-50x faster, making it the preferred host path (narrow levels, fallback
ladder) while wide levels run on the GPU kernel. Falls back to None when no
toolchain is available; callers then use the NumPy oracle.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..native import load

_lib = None
_checked = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    lib = load("talco")
    if lib is None:
        return None
    fn = lib.talco_align_freq
    fn.restype = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    fn.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, f32p, f32p,
        f32p, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i8p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def align_freq(param, freq_ref: np.ndarray, freq_qry: np.ndarray,
               gap_op: Tuple[np.ndarray, np.ndarray],
               gap_ex: Tuple[np.ndarray, np.ndarray],
               num: Tuple[float, float]) -> Tuple[np.ndarray, int]:
    """Drop-in for talco_np.align_freq (param: talco_np.TalcoRunParams)."""
    lib = get_lib()
    fr = np.ascontiguousarray(freq_ref, dtype=np.float32)
    fq = np.ascontiguousarray(freq_qry, dtype=np.float32)
    gor = np.ascontiguousarray(gap_op[0], dtype=np.float32)
    goq = np.ascontiguousarray(gap_op[1], dtype=np.float32)
    ger = np.ascontiguousarray(gap_ex[0], dtype=np.float32)
    geq = np.ascontiguousarray(gap_ex[1], dtype=np.float32)
    mat = np.ascontiguousarray(param.matrix, dtype=np.float32)
    out = np.empty(fr.shape[0] + fq.shape[0] + 8, dtype=np.int8)
    n = lib.talco_align_freq(
        fr, fr.shape[0], fq, fq.shape[0], np.int32(fr.shape[1]),
        gor, goq, ger, geq, mat, np.int32(param.matrix_size),
        np.float32(param.gap_open), np.float32(param.gap_extend),
        np.float32(param.gap_char_score),
        np.float32(num[0]), np.float32(num[1]),
        np.int32(param.xdrop), np.int32(param.flen), np.int32(param.marker),
        out)
    if n < 0:
        return np.zeros(0, dtype=np.int8), int(-n)
    return out[:n].copy(), 0
