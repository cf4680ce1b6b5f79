"""ctypes loader for the port's host entropy library.

The counterpart of ``lilliput_tpu/binding.py``. It does not run the JAX
package's ``make`` (which compiles every native shim and links libjpeg,
libwebp and ffmpeg): the slice needs only the Huffman decoder
(``lilliput_tpu/native/src/jpeg_huff.cpp``, shared source) and the port's
baseline Huffman encoder (``csrc/host/jpeg_enc.cpp``). Neither needs libjpeg,
so the library builds on machines without it. It is built with g++ at first
use into ``lilliput_tpu_torch/_build/`` (see ``ops/_build.py``); a failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

from .ops import _build

HOST_SOURCES = (
    os.path.join(_build.REPO_DIR, "lilliput_tpu", "native", "src",
                 "jpeg_huff.cpp"),
    os.path.join(_build.CSRC_DIR, "host", "jpeg_enc.cpp"),
)

_lock = threading.Lock()
_lib = None


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p, i16p, u16p, i32p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int16),
                             c.POINTER(c.c_uint16), c.POINTER(c.c_int32))
    lib.lp_jpeg_decode_coefs_fast.argtypes = [
        u8p, c.c_size_t, c.POINTER(i16p), u16p, c.c_int32]
    lib.lp_jpeg_decode_coefs_fast.restype = c.c_int
    lib.lp_jpeg_decode_coefs_win.argtypes = [
        u8p, c.c_size_t, c.POINTER(i16p), u16p, c.c_int32, i32p]
    lib.lp_jpeg_decode_coefs_win.restype = c.c_int
    lib.lpt_jpeg_encode_baseline.argtypes = [
        c.c_int32, c.c_int32, c.c_int32, i32p, i32p, c.POINTER(i16p),
        u16p, u16p, u8p, c.c_int32, u8p, c.c_size_t]
    lib.lpt_jpeg_encode_baseline.restype = c.c_long


def build() -> str:
    """Build (or find) the host library; returns its path."""
    return _build.build_shared("liblilliput_torch_host", HOST_SOURCES,
                               lambda out: [
                                   "g++", "-O3", "-fPIC", "-std=c++20",
                                   "-march=native", "-shared", "-pthread",
                                   "-Wl,--no-undefined", "-o", out,
                                   *HOST_SOURCES])


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _configure(lib)
            _lib = lib
    return _lib
