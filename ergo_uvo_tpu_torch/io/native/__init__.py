"""ctypes bindings for the native ingestion runtime (``decode.cpp``).

A copy of ``ergo_uvo_tpu/io/native/__init__.py`` for the port.  The shared
library is built with g++ against libjpeg at first use, never on import,
into ``build/ergo_uvo_tpu_torch/libergo_native_<hash>.so`` under the
checkout's root (the directory the CUDA kernels are built into), where
``<hash>`` covers the source and the flags.  Where the toolchain or libjpeg is
missing, :func:`available` is False and callers decode with PIL instead.

Unlike the original, the build leaves out ``-march=native``: the library is
cached by content in the checkout, which may be used on another host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ergo_uvo_tpu_torch.cuda_build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decode.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    return str(BUILD_DIR / f"libergo_native_{digest}.so")


def _build(so: str) -> str | None:
    """Compile decode.cpp into ``so`` if it is not there; returns an error string or None."""
    if os.path.exists(so):
        return None
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS]
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # toolchain missing
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        so = _so_path()
        _build_error = _build(so)
        if _build_error is not None:
            return
        lib = ctypes.CDLL(so)
        lib.eun_decode_jpeg.restype = ctypes.c_int
        lib.eun_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.eun_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.eun_demosaic_bggr.restype = ctypes.c_int
        lib.eun_demosaic_bggr.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p
        ]
        lib.eun_loader_create.restype = ctypes.c_void_p
        lib.eun_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.eun_loader_next.restype = ctypes.c_long
        lib.eun_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.eun_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib


def available() -> bool:
    _load()
    return _lib is not None


def build_error() -> str | None:
    _load()
    return _build_error


def decode_jpeg(data: bytes, gray: bool = True) -> np.ndarray:
    """Decode JPEG bytes to (H, W) gray or (H, W, 3) RGB uint8."""
    _load()
    if _lib is None:
        raise RuntimeError(f"the native decoder is not available: {_build_error}")
    ch = 1 if gray else 3
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = _lib.eun_decode_jpeg(data, len(data), ch, ctypes.byref(out),
                              ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    n = w.value * h.value * ch
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    _lib.eun_free(out)
    shape = (h.value, w.value) if gray else (h.value, w.value, 3)
    return arr.reshape(shape)


def demosaic_bggr(bayer: np.ndarray) -> np.ndarray:
    """(H, W) uint8 BGGR mosaic -> (H, W, 3) RGB uint8 (bilinear).

    The reference's bayer branch (math_utility.cpp:166-170, BayerBG).
    """
    _load()
    if _lib is None:
        raise RuntimeError(f"the native decoder is not available: {_build_error}")
    bayer = np.ascontiguousarray(bayer, np.uint8)
    h, w = bayer.shape
    out = np.empty((h, w, 3), np.uint8)
    rc = _lib.eun_demosaic_bggr(
        bayer.ctypes.data_as(ctypes.c_char_p), w, h,
        out.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        raise ValueError("demosaic failed")
    return out


class JpegLoader:
    """Prefetching multi-threaded JPEG file loader (bounded ring buffer)."""

    def __init__(self, paths, threads: int = 4, capacity: int = 16,
                 gray: bool = True):
        _load()
        if _lib is None:
            raise RuntimeError(f"the native decoder is not available: {_build_error}")
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(self._paths)
        self._gray = gray
        self._handle = _lib.eun_loader_create(
            arr, self._n, threads, capacity, 1 if gray else 3
        )

    def __iter__(self):
        ch = 1 if self._gray else 3
        buf = np.empty(64 * 1024 * 1024, np.uint8)  # 64 MB frame cap
        idx = ctypes.c_int()
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            n = _lib.eun_loader_next(
                self._handle, buf.ctypes.data_as(ctypes.c_char_p), buf.size,
                ctypes.byref(idx), ctypes.byref(w), ctypes.byref(h),
            )
            if n <= 0:
                break
            shape = (h.value, w.value) if ch == 1 else (h.value, w.value, 3)
            yield idx.value, buf[:n].reshape(shape).copy()

    def close(self):
        if self._handle:
            _lib.eun_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
