"""ctypes bindings for the native C++ reference implementations.

The port's own copy of ``gqmap_tpu/native.py``: the C++ ports (``native/``)
of the reference's four opaque ``.mexw64`` binaries (SURVEY.md section 2.4),
a bit-level cross-check for the port's ops on the CPU. Built on demand with
``make -C native`` (g++); every function raises :class:`NativeUnavailable`
where the library cannot be built, so callers and tests can skip. Arrays go
in and come out as numpy.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "NativeUnavailable",
    "available",
    "get_vv",
    "sample_bicubic",
    "mixture_map",
    "flow_to_color",
    "read_flo",
    "write_flo",
]

_ROOT = Path(__file__).resolve().parents[1] / "native"
_LIB = _ROOT / "libgqmap_native.so"
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists():
        try:
            subprocess.run(
                ["make", "-C", os.fspath(_ROOT)], check=True,
                capture_output=True, text=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(f"cannot build native library: {e}") from e
    lib = ct.CDLL(os.fspath(_LIB))
    d = ct.POINTER(ct.c_double)
    u8 = ct.POINTER(ct.c_uint8)
    f4 = ct.POINTER(ct.c_float)
    lib.gq_get_vv.argtypes = [d, ct.c_int, ct.c_int, d]
    lib.gq_sample_bicubic.argtypes = [d, ct.c_int, ct.c_int, d, d, ct.c_int64, d]
    lib.gq_mixture_map.argtypes = [d, d, d, d, d, ct.c_int, ct.c_int, ct.c_int, d]
    lib.gq_flow_to_color.argtypes = [d, ct.c_int, ct.c_int, u8, d, d, u8]
    lib.gq_read_flo_header.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int), ct.POINTER(ct.c_int)]
    lib.gq_read_flo_header.restype = ct.c_int
    lib.gq_read_flo.argtypes = [ct.c_char_p, f4, ct.c_int64]
    lib.gq_read_flo.restype = ct.c_int
    lib.gq_write_flo.argtypes = [ct.c_char_p, f4, ct.c_int, ct.c_int]
    lib.gq_write_flo.restype = ct.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _dp(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


def get_vv(V: np.ndarray) -> np.ndarray:
    lib = _load()
    V = np.ascontiguousarray(V, np.float64)
    M, N = V.shape
    out = np.empty((M + 2, N + 2), np.float64)
    lib.gq_get_vv(_dp(V), M, N, _dp(out))
    return out


def sample_bicubic(VV: np.ndarray, Xq, Yq) -> np.ndarray:
    lib = _load()
    VV = np.ascontiguousarray(VV, np.float64)
    M, N = VV.shape[0] - 2, VV.shape[1] - 2
    Xq = np.ascontiguousarray(Xq, np.float64)
    Yq = np.ascontiguousarray(np.broadcast_to(Yq, Xq.shape), np.float64)
    out = np.empty(Xq.shape, np.float64)
    lib.gq_sample_bicubic(_dp(VV), M, N, _dp(Xq), _dp(Yq), Xq.size, _dp(out))
    return out


def mixture_map(alpha, muu, sigmau, muv, sigmav) -> np.ndarray:
    """``get_map_mex(alf, mu_u, sig_u, mu_v, sig_v)`` equivalent."""
    lib = _load()
    muu = np.ascontiguousarray(muu, np.float64)
    M, N, L = muu.shape
    args = [np.ascontiguousarray(a, np.float64) for a in (alpha, muu, sigmau, muv, sigmav)]
    out = np.empty((M, N, 2), np.float64)
    lib.gq_mixture_map(*[_dp(a) for a in args], M, N, L, _dp(out))
    return out


def flow_to_color(flow: np.ndarray):
    """``flowToColor_mex(flow)`` equivalent: (img, flo, minu, maxu, minv,
    maxv, unknown)."""
    lib = _load()
    flow = np.ascontiguousarray(flow, np.float64)
    M, N, _ = flow.shape
    img = np.empty((M, N, 3), np.uint8)
    flo = np.empty((M, N, 2), np.float64)
    ranges = np.empty(4, np.float64)
    unk = np.empty((M, N), np.uint8)
    lib.gq_flow_to_color(
        _dp(flow), M, N,
        img.ctypes.data_as(ct.POINTER(ct.c_uint8)), _dp(flo), _dp(ranges),
        unk.ctypes.data_as(ct.POINTER(ct.c_uint8)),
    )
    return img, flo, ranges[0], ranges[1], ranges[2], ranges[3], unk.astype(bool)


def read_flo(path) -> np.ndarray:
    lib = _load()
    w, h = ct.c_int(), ct.c_int()
    rc = lib.gq_read_flo_header(os.fspath(path).encode(), ct.byref(w), ct.byref(h))
    if rc:
        raise ValueError(f"read_flo({path}): error {rc}")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.gq_read_flo(
        os.fspath(path).encode(), out.ctypes.data_as(ct.POINTER(ct.c_float)), out.size
    )
    if rc:
        raise ValueError(f"read_flo({path}): error {rc}")
    return out


def write_flo(path, flow) -> None:
    lib = _load()
    flow = np.ascontiguousarray(flow, np.float32)
    h, w, _ = flow.shape
    rc = lib.gq_write_flo(
        os.fspath(path).encode(), flow.ctypes.data_as(ct.POINTER(ct.c_float)), w, h
    )
    if rc:
        raise ValueError(f"write_flo({path}): error {rc}")
