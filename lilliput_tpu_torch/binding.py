"""ctypes loader for the port's host library.

The counterpart of ``lilliput_tpu/binding.py``. It does not run the JAX
package's ``make`` (which compiles every native shim and links libjpeg,
libwebp and ffmpeg): the port needs the Huffman decoder
(``csrc/host/jpeg_huff.cpp``), the PNG row filters with their deflate
helpers (``csrc/host/png_filter.cpp``) and the GIF container and LZW
codec (``csrc/host/gif_codec.cpp``) and the JPEG 2000 Tier-1 coder
(``csrc/host/jp2_t1.cpp``), byte-for-byte copies of the JAX package's
``native/src`` files held equal by tests, and the port's
baseline Huffman encoder (``csrc/host/jpeg_enc.cpp``). None needs libjpeg,
so the library builds on machines without it. ``png_filter.cpp`` uses
libdeflate where ``libdeflate.h`` exists; the build then links
``-ldeflate``, the decision of ``lilliput_tpu/native/Makefile``, and
elsewhere ``lp_zlib_fast_available()`` is 0 and the PNG encoder deflates
with Python's zlib. It is built with g++ at first use into
``lilliput_tpu_torch/_build/`` (see ``ops/_build.py``); a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

from .ops import _build

HOST_SOURCES = (
    os.path.join(_build.CSRC_DIR, "host", "jpeg_huff.cpp"),
    os.path.join(_build.CSRC_DIR, "host", "jpeg_enc.cpp"),
    os.path.join(_build.CSRC_DIR, "host", "png_filter.cpp"),
    os.path.join(_build.CSRC_DIR, "host", "gif_codec.cpp"),
    os.path.join(_build.CSRC_DIR, "host", "jp2_t1.cpp"),
)
#: the header whose presence compiles png_filter.cpp's libdeflate route
LIBDEFLATE_HEADER = "/usr/include/libdeflate.h"

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
    lib.lp_png_filter.argtypes = [u8p, u8p, c.c_int64, c.c_int64, c.c_int32]
    lib.lp_png_filter.restype = None
    lib.lp_png_unfilter.argtypes = [u8p, u8p, c.c_int64, c.c_int64,
                                    c.c_int32]
    lib.lp_png_unfilter.restype = c.c_int
    lib.lp_zlib_fast_available.argtypes = []
    lib.lp_zlib_fast_available.restype = c.c_int
    lib.lp_zlib_compress.argtypes = [u8p, c.c_int64, u8p, c.c_int64,
                                     c.c_int32]
    lib.lp_zlib_compress.restype = c.c_int64
    lib.lp_zlib_compress_bound.argtypes = [c.c_int64]
    lib.lp_zlib_compress_bound.restype = c.c_int64
    lib.lp_zlib_decompress.argtypes = [u8p, c.c_int64, u8p, c.c_int64]
    lib.lp_zlib_decompress.restype = c.c_int64
    _configure_gif(lib, u8p, i32p)
    _configure_jp2(lib, u8p, i32p)


def _configure_gif(lib: ctypes.CDLL, u8p, i32p) -> None:
    """The lp_gif_* entry points of gif_codec.cpp (its C ABI), as the JAX
    package's codecs/gif.py registers them."""
    c = ctypes
    sigs = {
        "lp_gif_open": ([u8p, c.c_size_t, i32p], c.c_void_p),
        "lp_gif_free": ([c.c_void_p], None),
        "lp_gif_global_palette": ([c.c_void_p, u8p], c.c_int),
        "lp_gif_next_frame": ([c.c_void_p, i32p], c.c_int),
        "lp_gif_frame_palette": ([c.c_void_p, u8p], c.c_int),
        "lp_gif_frame_ext": ([c.c_void_p, u8p, c.c_int32], c.c_int),
        "lp_gif_frame_indices": ([c.c_void_p, u8p], c.c_int),
        "lp_gif_skip_frame": ([c.c_void_p], c.c_int),
        "lp_gif_scan": ([c.c_void_p], c.c_int),
        "lp_gif_scanned_meta": ([c.c_void_p, c.c_int32, i32p], c.c_int),
        "lp_gif_scanned_palette": ([c.c_void_p, c.c_int32, u8p], c.c_int),
        "lp_gif_scanned_ext": ([c.c_void_p, c.c_int32, u8p, c.c_int32],
                               c.c_int),
        "lp_gif_decode_scanned": ([c.c_void_p, c.c_int32, u8p], c.c_int),
        "lp_gif_anim_info": ([u8p, c.c_size_t, i32p], c.c_int),
        "lp_gif_enc_new": ([c.c_int32] * 5 + [u8p, c.c_int32], c.c_void_p),
        "lp_gif_enc_frame": ([c.c_void_p, u8p, c.c_int32, i32p, u8p,
                              c.c_int32, u8p], c.c_int),
        "lp_gif_enc_size": ([c.c_void_p], c.c_long),
        "lp_gif_enc_finish": ([c.c_void_p, u8p, c.c_size_t], c.c_long),
        "lp_gif_enc_free": ([c.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _configure_jp2(lib: ctypes.CDLL, u8p, i32p) -> None:
    """The lp_jp2_t1_* entry points of jp2_t1.cpp, with the signatures the
    JAX package's codecs/jp2_t1.py registers."""
    c = ctypes
    i32 = c.c_int32
    sigs = {
        "lp_jp2_t1_decode": ([u8p] + [i32] * 7 + [i32p], c.c_int),
        "lp_jp2_t1_decode2": ([u8p, i32, i32p, i32p] + [i32] * 8 + [i32p],
                              c.c_int),
        "lp_jp2_t1_encode": ([i32p] + [i32] * 5 + [u8p, i32] + [i32p] * 6
                             + [i32], c.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def build() -> str:
    """Build (or find) the host library; returns its path."""
    return _build.build_shared("liblilliput_torch_host", HOST_SOURCES,
                               lambda out: [
                                   "g++", "-O3", "-fPIC", "-std=c++20",
                                   "-march=native", "-shared", "-pthread",
                                   "-Wl,--no-undefined", "-o", out,
                                   *HOST_SOURCES, *_libs()])


def _libs() -> list:
    """Link flags: -ldeflate where png_filter.cpp compiles libdeflate in
    (its ``__has_include`` sees the header), as the JAX package's Makefile
    decides."""
    return ["-ldeflate"] if os.path.exists(LIBDEFLATE_HEADER) else []


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
