"""The benchmark's own host encoders, built with g++ at first use.

``jpeg_enc.cpp`` and ``gif_enc.cpp`` are frozen copies of the program's
entropy encoders. The inputs of every cell are written through them, so
the yardstick does not move when the program's encoders change. Each
library is built once into ``portbench/_build/`` (a fixed directory inside
the checkout, git-ignored), named by a hash of the compiler's version, the
command and the source, so a later run finds it built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")

_lock = threading.Lock()
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u16p = ctypes.POINTER(ctypes.c_uint16)


def build(name: str) -> str:
    """Path of the shared library of native/<name>.cpp, built with g++ into
    BUILD_DIR unless a build of the same compiler, command and source is
    there."""
    src = os.path.join(HERE, name + ".cpp")
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src]
    h = hashlib.sha256((version + " ".join(cmd[:-1])).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        subprocess.run(cmd + ["-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(name))
    if name == "jpeg_enc":
        f = lib.lpt_jpeg_encode_coefs
        f.restype = ctypes.c_long
        f.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32p,
                      _i32p, ctypes.POINTER(_i16p), _u16p, _u16p,
                      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
                      ctypes.c_int32, _u8p, ctypes.c_size_t]
    else:
        lib.lp_gif_enc_new.restype = ctypes.c_void_p
        lib.lp_gif_enc_new.argtypes = [ctypes.c_int32] * 5 + [
            _u8p, ctypes.c_int32]
        lib.lp_gif_enc_frame.restype = ctypes.c_int
        lib.lp_gif_enc_frame.argtypes = [ctypes.c_void_p, _u8p,
                                         ctypes.c_int32, _i32p, _u8p,
                                         ctypes.c_int32, _u8p]
        lib.lp_gif_enc_size.restype = ctypes.c_long
        lib.lp_gif_enc_size.argtypes = [ctypes.c_void_p]
        lib.lp_gif_enc_finish.restype = ctypes.c_long
        lib.lp_gif_enc_finish.argtypes = [ctypes.c_void_p, _u8p,
                                          ctypes.c_size_t]
        lib.lp_gif_enc_free.restype = None
        lib.lp_gif_enc_free.argtypes = [ctypes.c_void_p]
    return lib


def jpeg_encode(width: int, height: int, comps, h_samp, v_samp,
                qt_luma: np.ndarray, qt_chroma: np.ndarray) -> bytes:
    """A baseline JPEG (JFIF, standard Huffman tables) of quantized
    coefficients: comps are contiguous int16 (blocks_h, blocks_w, 64)
    arrays in natural order at libjpeg's block geometry, qt_* u16 (64,)
    tables in natural order."""
    lib = _lib("jpeg_enc")
    nc = len(comps)
    comps = [np.ascontiguousarray(c, np.int16) for c in comps]
    ql = np.ascontiguousarray(qt_luma, np.uint16)
    qc = np.ascontiguousarray(qt_chroma, np.uint16)
    out = np.empty(width * height * 4 + (1 << 20), np.uint8)
    n = lib.lpt_jpeg_encode_coefs(
        width, height, nc, (ctypes.c_int32 * nc)(*h_samp),
        (ctypes.c_int32 * nc)(*v_samp),
        (_i16p * nc)(*[c.ctypes.data_as(_i16p) for c in comps]),
        ql.ctypes.data_as(_u16p), qc.ctypes.data_as(_u16p), 0, 0, 0, None,
        0, out.ctypes.data_as(_u8p), out.size)
    if n < 0:
        raise ValueError(f"JPEG encode failed ({n})")
    return out[:n].tobytes()


def gif_encode(width: int, height: int, global_palette: np.ndarray,
               bg_index: int, frames) -> bytes:
    """A GIF89a with dictionary LZW. frames: dicts with indices ((h, w)
    u8), left, top, interlace, trans (-1: none), delay_cs, disposal,
    palette (None: the global one) and ext (extensions written before the
    frame's GCE, each as [function][sub-blocks], without the 0x21)."""
    lib = _lib("gif_enc")
    gpal = np.ascontiguousarray(global_palette, np.uint8).reshape(-1, 3)
    h = lib.lp_gif_enc_new(width, height, 8, 0, bg_index,
                           gpal.ctypes.data_as(_u8p), len(gpal))
    if not h:
        raise MemoryError("GIF encoder")
    try:
        gbits = 0
        while (2 << gbits) < len(gpal):
            gbits += 1
        for f in frames:
            idx = np.ascontiguousarray(f["indices"], np.uint8)
            fh, fw = idx.shape
            desc = np.array([f["left"], f["top"], fw, fh,
                             int(f["interlace"]), f["trans"], f["delay_cs"],
                             f["disposal"], max(2, gbits + 1)], np.int32)
            ext = np.frombuffer(f.get("ext", b""), np.uint8)
            local = f.get("palette")
            local = (None if local is None else
                     np.ascontiguousarray(local, np.uint8).reshape(-1, 3))
            rc = lib.lp_gif_enc_frame(
                h, ext.ctypes.data_as(_u8p) if ext.size else None, ext.size,
                desc.ctypes.data_as(_i32p),
                None if local is None else local.ctypes.data_as(_u8p),
                0 if local is None else len(local), idx.ctypes.data_as(_u8p))
            if rc != 0:
                raise ValueError("GIF frame encode failed")
        out = np.empty(lib.lp_gif_enc_size(h), np.uint8)
        n = lib.lp_gif_enc_finish(h, out.ctypes.data_as(_u8p), out.size)
        if n < 0:
            raise ValueError("GIF encode failed")
        return out[:n].tobytes()
    finally:
        lib.lp_gif_enc_free(h)
