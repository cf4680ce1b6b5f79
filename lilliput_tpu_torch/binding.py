"""ctypes loader for the port's host library.

The counterpart of ``lilliput_tpu/binding.py``. It does not run the JAX
package's ``make`` (which compiles every native shim and links libjpeg,
libwebp and ffmpeg): the port needs the Huffman decoder
(``csrc/host/jpeg_huff.cpp``), the PNG row filters with their deflate
helpers (``csrc/host/png_filter.cpp``) and the GIF container and LZW
codec (``csrc/host/gif_codec.cpp``) and the JPEG 2000 Tier-1 coder
(``csrc/host/jp2_t1.cpp``), byte-for-byte copies of the JAX package's
``native/src`` files held equal by tests, and the port's own JPEG
entropy encoder (``csrc/host/jpeg_enc.cpp``: libjpeg's bytes for every
option of ``lp_jpeg_encode_coefs``, baseline, optimized, progressive and
restart markers). None needs libjpeg, so the library builds on machines
without it.

Two shims include a library's headers unconditionally, so each is a
library of its own, built only where its header exists, as
``lilliput_tpu/native/Makefile`` gates them: libjpeg's
(``csrc/host/jpeg_shim.cpp``, ``load_jpeg``, linked with ``-ljpeg``: the
decode of the streams jpeg_huff.cpp declines, and the restart-marker
slicer) where ``JPEG_HEADER`` exists, and WebP's
(``csrc/host/webp_shim.cpp``, ``load_webp``, ``-lwebp -lwebpmux
-lwebpdemux``) where ``WEBP_HEADER`` exists. Both are byte-for-byte
copies of the JAX package's. Elsewhere ``load_jpeg`` and ``load_webp``
raise ``errors.HostLibraryMissingError`` and nothing takes another
route. ``png_filter.cpp`` uses
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
JPEG_SOURCES = (os.path.join(_build.CSRC_DIR, "host", "jpeg_shim.cpp"),)
#: the header whose presence builds the libjpeg library (the JAX package's
#: Makefile needs it for jpeg_shim.cpp)
JPEG_HEADER = "/usr/include/jpeglib.h"
WEBP_SOURCES = (os.path.join(_build.CSRC_DIR, "host", "webp_shim.cpp"),)
#: the header whose presence builds the WebP library (the JAX package's
#: Makefile gate)
WEBP_HEADER = "/usr/include/webp/encode.h"

_i32p = ctypes.POINTER(ctypes.c_int32)
#: lp_jpeg_encode_coefs's signature, which lpt_jpeg_encode_coefs shares
_ENCODE_ARGS = [
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32p, _i32p,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
    ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]

_lock = threading.Lock()
_lib = None
_webp_lib = None
_jpeg_lib = None


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
    lib.lpt_jpeg_encode_coefs.argtypes = _ENCODE_ARGS
    lib.lpt_jpeg_encode_coefs.restype = c.c_long
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


def _configure_jpeg(lib: ctypes.CDLL) -> None:
    """The libjpeg entry points of jpeg_shim.cpp the port calls, with the
    signatures of the JAX package's binding.py."""
    c = ctypes
    u8p, i16p, u16p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int16),
                       c.POINTER(c.c_uint16))
    lib.lp_jpeg_decode_coefs.argtypes = [u8p, c.c_size_t, c.POINTER(i16p),
                                         u16p, u8p, c.c_int32]
    lib.lp_jpeg_decode_coefs.restype = c.c_int
    lib.lp_jpeg_decode_coefs_parallel.argtypes = [
        u8p, c.c_size_t, c.POINTER(i16p), u16p, c.c_int32]
    lib.lp_jpeg_decode_coefs_parallel.restype = c.c_int
    lib.lp_jpeg_encode_coefs.argtypes = _ENCODE_ARGS
    lib.lp_jpeg_encode_coefs.restype = c.c_long


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


def _configure_webp(lib: ctypes.CDLL) -> None:
    """The 12 lp_webp_* entry points of webp_shim.cpp, with the signatures
    the JAX package's codecs/webp.py registers."""
    c = ctypes
    u8p, i32p = c.POINTER(c.c_uint8), c.POINTER(c.c_int32)
    i32, vp = c.c_int32, c.c_void_p
    sigs = {
        "lp_webp_open": ([u8p, c.c_size_t, i32p], vp),
        "lp_webp_icc": ([vp, u8p, i32], c.c_int),
        "lp_webp_next_frame": ([vp, i32p], c.c_int),
        "lp_webp_total_duration": ([vp], c.c_int),
        "lp_webp_frame_pixels": ([vp, u8p, i32, i32, i32], c.c_int),
        "lp_webp_free": ([vp], None),
        "lp_webp_enc_new": ([u8p, i32, c.c_uint32, i32], vp),
        "lp_webp_enc_add": ([vp, u8p, i32, i32, i32, i32, i32p, i32],
                            c.c_int),
        "lp_webp_enc_flush": ([vp, i32p, i32, u8p, c.c_size_t], c.c_long),
        "lp_webp_enc_free": ([vp], None),
        "lp_webp_bgra_to_yuv": ([u8p, i32, i32, i32, u8p, u8p, u8p, u8p],
                                c.c_int),
        "lp_webp_encode_yuv": ([u8p, u8p, u8p, u8p, i32, i32, i32p, i32,
                                u8p, i32, u8p, c.c_size_t], c.c_long),
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


def _require_webp_header() -> None:
    from .errors import HostLibraryMissingError
    if not os.path.exists(WEBP_HEADER):
        raise HostLibraryMissingError(
            f"libwebp is not installed on this machine ({WEBP_HEADER} is "
            "missing), so the WebP host codec (csrc/host/webp_shim.cpp) "
            "cannot be built: WebP decode and encode need libwebp, "
            "libwebpmux and libwebpdemux")


def _require_jpeg_header() -> None:
    from .errors import HostLibraryMissingError
    if not os.path.exists(JPEG_HEADER):
        raise HostLibraryMissingError(
            f"libjpeg is not installed on this machine ({JPEG_HEADER} is "
            "missing), so the libjpeg host route (csrc/host/jpeg_shim.cpp) "
            "cannot be built: decoding a JPEG stream that jpeg_huff.cpp "
            "declines needs libjpeg")


def build_jpeg() -> str:
    """Build (or find) the libjpeg library; returns its path. Raises
    HostLibraryMissingError where libjpeg's headers are absent."""
    _require_jpeg_header()
    return _build.build_shared("liblilliput_torch_jpeg", JPEG_SOURCES,
                               lambda out: [
                                   "g++", "-O3", "-fPIC", "-std=c++20",
                                   "-march=native", "-shared", "-pthread",
                                   "-Wl,--no-undefined", "-o", out,
                                   *JPEG_SOURCES, "-ljpeg"])


def load_jpeg() -> ctypes.CDLL:
    """The libjpeg library (lp_jpeg_decode_coefs, its restart-parallel
    form, and lp_jpeg_encode_coefs for the tests), built at first use.
    Raises HostLibraryMissingError where JPEG_HEADER is absent, checked on
    every call, so no libjpeg call runs on a machine without its headers."""
    global _jpeg_lib
    _require_jpeg_header()
    if _jpeg_lib is not None:
        return _jpeg_lib
    with _lock:
        if _jpeg_lib is None:
            lib = ctypes.CDLL(build_jpeg())
            _configure_jpeg(lib)
            _jpeg_lib = lib
    return _jpeg_lib


def build_webp() -> str:
    """Build (or find) the WebP library; returns its path. Raises
    HostLibraryMissingError where libwebp's headers are absent."""
    _require_webp_header()
    return _build.build_shared("liblilliput_torch_webp", WEBP_SOURCES,
                               lambda out: [
                                   "g++", "-O3", "-fPIC", "-std=c++20",
                                   "-march=native", "-shared", "-pthread",
                                   "-Wl,--no-undefined", "-o", out,
                                   *WEBP_SOURCES, "-lwebp", "-lwebpmux",
                                   "-lwebpdemux"])


def load_webp() -> ctypes.CDLL:
    """The WebP library (lp_webp_*), built at first use. Raises
    HostLibraryMissingError where WEBP_HEADER is absent, checked on every
    call, so no WebP call runs on a machine without libwebp's headers."""
    global _webp_lib
    _require_webp_header()
    if _webp_lib is not None:
        return _webp_lib
    with _lock:
        if _webp_lib is None:
            lib = ctypes.CDLL(build_webp())
            _configure_webp(lib)
            _webp_lib = lib
    return _webp_lib


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
