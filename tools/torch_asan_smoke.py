#!/usr/bin/env python3
"""Memory-safety smoke of the port's host library under AddressSanitizer:
the counterpart of tools/asan_smoke.py for lilliput_tpu_torch.

    python tools/torch_asan_smoke.py [--small]

Builds binding.HOST_SOURCES (jpeg_huff.cpp, jpeg_enc.cpp, png_filter.cpp,
gif_codec.cpp, jp2_t1.cpp, yuv_bgr.cpp, jpeg_scan.cpp) with g++ -fsanitize=address
-fno-omit-frame-pointer into lilliput_tpu_torch/_build/asan/ (git-ignored),
then runs the round trips below in a child process under LD_PRELOAD of the
compiler's libasan.so, with the port's binding pointed at that library:

  jpeg_huff   decode of the committed 1080p fixtures (4:2:0, 4:2:2, gray;
              --small: of the built streams only), of the streams built
              here, and of truncations and bit flips of them, into arrays
              sized from the port's header parse of the same buffer;
              jpeg_scan.cpp's preparation of each for the device entropy
              route, into arrays of exactly its capacity;
  jpeg_enc    lpt_jpeg_encode_coefs of random coefficients at odd
              geometries (4:2:0, 4:2:2, 4:4:4, gray), baseline,
              optimize_coding, progressive and restart markers, 8 threads
              at once; baseline and restart streams decode back to the
              same coefficients;
  png         lp_png_filter then lp_png_unfilter at 1-4 channels and 1 and
              2 bytes per sample, the rows back equal; hostile filter bytes;
  gif         a 3-frame GIF (local palette, transparency, interlace)
              through lp_gif_enc_* and back through lp_gif_open /
              next_frame / frame_indices and lp_gif_scan /
              decode_scanned on 4 threads, indices equal; truncations of
              it; min-code-size 9-11 streams with root codes past 255;
  jp2_t1      lp_jp2_t1_encode then lp_jp2_t1_decode2 of random codeblocks
              in every coding style, equal; hostile MQ bytes and segment
              tables;
  yuv_bgr     lp_yuv_to_bgr at 4:2:0, 4:2:2, 4:4:4 and gray, odd sizes,
              with and without alpha, and geometries it must decline.

Every input is built in the script (the JPEG fixtures are the repo's).
LeakSanitizer is off: the child is a Python interpreter, whose own
allocations outlive it. Any AddressSanitizer report, or a failed round
trip, exits non-zero. Needs g++ and its libasan.so (g++
-print-file-name=libasan.so); without them it exits 2 and says so.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = ("bench_1080p.jpg", "bench_1080p_422.jpg", "bench_1080p_gray.jpg")
ASAN_OPTIONS = ("detect_leaks=0:halt_on_error=1:exitcode=23:"
                "abort_on_error=0:allocator_may_return_null=1")

u8p = ctypes.POINTER(ctypes.c_uint8)
i16p = ctypes.POINTER(ctypes.c_int16)
u16p = ctypes.POINTER(ctypes.c_uint16)
i32p = ctypes.POINTER(ctypes.c_int32)


def libasan() -> str:
    """The compiler's libasan.so, or '' where g++ has none."""
    try:
        path = subprocess.run(["g++", "-print-file-name=libasan.so"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return ""
    return path if os.path.isabs(path) and os.path.exists(path) else ""


def build_asan() -> str:
    """binding.HOST_SOURCES built with AddressSanitizer into
    lilliput_tpu_torch/_build/asan/; returns the library's path."""
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.ops import _build
    os.makedirs(os.path.join(_build.BUILD_DIR, "asan"), exist_ok=True)
    return _build.build_shared(
        os.path.join("asan", "liblilliput_torch_host_asan"),
        binding.HOST_SOURCES, lambda out: [
            "g++", "-O1", "-g", "-fsanitize=address",
            "-fno-omit-frame-pointer", "-fPIC", "-std=c++20", "-shared",
            "-pthread", "-o", out, *binding.HOST_SOURCES,
            *binding._libs()])


# -- the round trips (run in the child, under libasan) ------------------------

def _p(a, t=u8p):
    return a.ctypes.data_as(t)


def _random_comps(rng, w, h, h_samp, v_samp):
    max_h, max_v = max(h_samp), max(v_samp)
    comps = []
    for hs, vs in zip(h_samp, v_samp):
        bh = (h * vs + 8 * max_v - 1) // (8 * max_v)
        bw = (w * hs + 8 * max_h - 1) // (8 * max_h)
        c = rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16)
        c[..., 20:] *= rng.random((bh, bw, 44)) < 0.1     # sparse high AC
        c[..., 0] = rng.integers(-500, 501, (bh, bw))
        comps.append(np.ascontiguousarray(c))
    return comps


def _decode_huff(lib, buf: bytes):
    """lp_jpeg_decode_coefs_fast into arrays sized by the port's header
    parse of the same buffer: (rc, comps) or None where the header does
    not parse."""
    from lilliput_tpu_torch.codecs import jpeg as J
    from lilliput_tpu_torch.errors import LilliputError
    try:
        info = J.read_info(buf)
    except (LilliputError, ValueError, IndexError):
        return None
    nc = int(info.num_components)
    comps = [np.zeros((info.comp_blocks_h[c], info.comp_blocks_w[c], 64),
                      np.int16) for c in range(nc)]
    q = np.zeros((4, 64), np.uint16)
    arr = np.frombuffer(buf, np.uint8)
    rc = lib.lp_jpeg_decode_coefs_fast(
        _p(arr), arr.size, (i16p * nc)(*[_p(c, i16p) for c in comps]),
        _p(q, u16p), 2)
    _prepare_scan(lib, arr, info)
    return rc, comps


def _prepare_scan(lib, arr: np.ndarray, info) -> bool:
    """lpt_jpeg_scan_prepare (jpeg_scan.cpp) of the same buffer into
    arrays of exactly the size the device entropy route gives it: whether
    it took the stream."""
    from lilliput_tpu_torch.ops import entropy_kernels as E
    nc = int(info.num_components)
    samp = [(int(info.comp_h_samp[c]), int(info.comp_v_samp[c]))
            for c in range(nc)]
    if min(min(s) for s in samp) < 1:
        return False
    geom = E.scan_geometry(int(info.width), int(info.height), samp,
                           [(0, 0, 1, 1)] * nc)
    return E.prepare_stream(
        lib, arr, np.empty(E.scan_capacity(arr.size, geom.nmcu), np.uint8),
        np.empty((geom.nmcu, 2), np.int32),
        np.empty((2 * nc, E.TABLE_BYTES), np.uint8),
        np.empty((4, 64), np.uint16), None) is not None


def _mutations(rng, buf: bytes, n: int):
    out = [buf[:len(buf) // 4], buf[:len(buf) // 2], buf[:-2], buf[:40]]
    for _ in range(n):
        m = bytearray(buf)
        for _ in range(3):
            m[int(rng.integers(2, len(m)))] = int(rng.integers(0, 256))
        out.append(bytes(m))
    return out


def jpeg_roundtrips(lib, small: bool) -> str:
    from lilliput_tpu_torch.codecs import jpeg as J
    rng = np.random.default_rng(0)
    samp = {"420": ([2, 1, 1], [2, 1, 1]), "422": ([2, 1, 1], [1, 1, 1]),
            "444": ([1, 1, 1], [1, 1, 1]), "gray": ([1], [1])}
    jobs = []
    for (w, h) in ((133, 91), (37, 29), (16, 8), (1, 1)):
        for sub, (hs, vs) in samp.items():
            comps = _random_comps(rng, w, h, hs, vs)
            for opt in ("baseline", "optimize", "progressive", "restart"):
                jobs.append((w, h, sub, hs, vs, comps, opt))
    qt_l, qt_c = J.scaled_qtables(85)

    def encode(job):
        w, h, sub, hs, vs, comps, opt = job
        return J.encode_coefs(
            w, h, comps, hs, vs, qt_l, qt_c,
            progressive=int(opt == "progressive"),
            optimize=int(opt == "optimize"),
            restart_rows=1 if opt == "restart" else 0)
    with ThreadPoolExecutor(8) as ex:
        streams = list(ex.map(encode, jobs))
    same = prepared = 0
    for job, buf in zip(jobs, streams):
        assert buf[:2] == b"\xff\xd8" and buf[-2:] == b"\xff\xd9", job[:3]
        got = _decode_huff(lib, buf)
        assert got is not None, job[:3]
        rc, dec = got
        if job[6] in ("baseline", "restart"):
            assert rc == 0, (job[:3], job[6], rc)
            prepared += _prepare_scan(lib, np.frombuffer(buf, np.uint8),
                                      J.read_info(buf))
        if rc == 0:
            for c, d in zip(job[5], dec):
                assert np.array_equal(c, d[:c.shape[0], :c.shape[1]]), \
                    (job[:3], job[6])
            same += 1
    hostile = 0
    for buf in streams[::7]:
        for m in _mutations(rng, buf, 4 if small else 12):
            _decode_huff(lib, m)
            hostile += 1
    fixtures = 0
    if not small:
        for name in FIXTURES:
            with open(os.path.join(ROOT, "tests", "assets", name), "rb") as f:
                buf = f.read()
            rc, _ = _decode_huff(lib, buf)
            assert rc == 0, (name, rc)
            fixtures += 1
            for m in _mutations(rng, buf, 6):
                _decode_huff(lib, m)
                hostile += 1
    return (f"{len(streams)} streams encoded on 8 threads, {same} decoded "
            f"back equal, {prepared} baseline scans prepared for the card, "
            f"{fixtures} fixtures, {hostile} hostile decodes")


def png_roundtrips(lib) -> str:
    rng = np.random.default_rng(1)
    n = 0
    for ch in (1, 2, 3, 4):
        for bps in (1, 2):
            for (h, w) in ((1, 1), (17, 13), (64, 65)):
                bpp = ch * bps
                stride = w * bpp
                img = rng.integers(0, 256, (h, stride), np.uint8)
                filtered = np.empty(h * (stride + 1), np.uint8)
                lib.lp_png_filter(_p(img), _p(filtered), h, stride, bpp)
                back = np.empty(h * stride, np.uint8)
                assert lib.lp_png_unfilter(_p(filtered), _p(back), h,
                                           stride, bpp) == 0
                assert np.array_equal(back.reshape(h, stride), img)
                bad = filtered.copy()
                bad[::stride + 1] = rng.integers(5, 256, h)  # filter > 4
                lib.lp_png_unfilter(_p(bad), _p(back), h, stride, bpp)
                n += 1
    return f"{n} filter/unfilter round trips, hostile filter bytes"


def _gif_encode(lib, w, h, frames, gpal) -> bytes:
    enc = lib.lp_gif_enc_new(w, h, 8, 0, 0, _p(gpal), len(gpal))
    assert enc
    try:
        for left, top, idx, local, trans, interlace in frames:
            fh, fw = idx.shape
            desc = np.array([left, top, fw, fh, interlace,
                             -1 if trans is None else trans, 4, 1, 8],
                            np.int32)
            assert lib.lp_gif_enc_frame(
                enc, None, 0, _p(desc, i32p),
                None if local is None else _p(local),
                0 if local is None else len(local),
                _p(np.ascontiguousarray(idx))) == 0
        out = np.empty(lib.lp_gif_enc_size(enc), np.uint8)
        n = lib.lp_gif_enc_finish(enc, _p(out), out.size)
        assert n > 0
        return out[:n].tobytes()
    finally:
        lib.lp_gif_enc_free(enc)


def _gif_decode(lib, buf: bytes):
    """Every frame's indices by lp_gif_next_frame/frame_indices (None where
    the file does not open)."""
    arr = np.frombuffer(buf, np.uint8)
    info = np.zeros(6, np.int32)
    h = lib.lp_gif_open(_p(arr), arr.size, _p(info, i32p))
    if not h:
        return None
    out = []
    try:
        meta = np.zeros(10, np.int32)
        while lib.lp_gif_next_frame(h, _p(meta, i32p)) == 1:
            idx = np.empty(max(int(meta[2]) * int(meta[3]), 1), np.uint8)
            if lib.lp_gif_frame_indices(h, _p(idx)) != 0:
                break
            out.append(idx[:int(meta[2]) * int(meta[3])].reshape(
                int(meta[3]), int(meta[2])))
    finally:
        lib.lp_gif_free(h)
    return out


def _gif_scanned(lib, buf: bytes):
    """lp_gif_scan, then every frame by lp_gif_decode_scanned on 4
    threads."""
    arr = np.frombuffer(buf, np.uint8)
    info = np.zeros(6, np.int32)
    h = lib.lp_gif_open(_p(arr), arr.size, _p(info, i32p))
    if not h:
        return None
    try:
        nf = lib.lp_gif_scan(h)

        def one(i):
            meta = np.zeros(10, np.int32)
            if lib.lp_gif_scanned_meta(h, i, _p(meta, i32p)) != 0:
                return None
            raw = np.empty(max(int(meta[2]) * int(meta[3]), 1), np.uint8)
            if lib.lp_gif_decode_scanned(h, i, _p(raw)) != 0:
                return None
            return raw[:int(meta[2]) * int(meta[3])].reshape(
                int(meta[3]), int(meta[2]))
        with ThreadPoolExecutor(4) as ex:
            return list(ex.map(one, range(max(nf, 0))))
    finally:
        lib.lp_gif_free(h)


def _root_code_gif(mcs: int) -> bytes:
    """A 4x4 GIF whose LZW stream (min code size mcs) emits root codes past
    255 (tools/asan_smoke.py's hostile case)."""
    import struct
    clear = 1 << mcs
    acc = nb = 0
    data = bytearray()
    for c in [clear] + [300] * 16 + [clear + 1]:
        acc |= c << nb
        nb += mcs + 1
        while nb >= 8:
            data.append(acc & 0xFF)
            acc >>= 8
            nb -= 8
    if nb:
        data.append(acc & 0xFF)
    g = bytearray(b"GIF89a" + struct.pack("<HH", 4, 4) + bytes([0xF0, 0, 0]))
    g += bytes(6) + b"," + struct.pack("<HHHH", 0, 0, 4, 4) + bytes([0])
    g += bytes([mcs, len(data)]) + bytes(data) + b"\x00;"
    return bytes(g)


def gif_roundtrips(lib) -> str:
    rng = np.random.default_rng(2)
    w, h = 61, 47
    gpal = rng.integers(0, 256, (256, 3), np.uint8)
    local = rng.integers(0, 256, (16, 3), np.uint8)
    frames = [(0, 0, rng.integers(0, 256, (h, w), np.uint8), None, None, 0),
              (5, 3, rng.integers(0, 16, (29, 33), np.uint8), local, 7, 0),
              (0, 10, (np.arange(37 * w).reshape(37, w) % 251)
               .astype(np.uint8), None, 2, 1)]
    buf = _gif_encode(lib, w, h, frames, gpal)
    want = [f[2] for f in frames]
    got = _gif_decode(lib, buf)
    assert got is not None and len(got) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    scanned = _gif_scanned(lib, buf)
    assert all(np.array_equal(a, b) for a, b in zip(scanned, want))
    n = 0
    for cut in range(13, len(buf), max(1, len(buf) // 23)):
        _gif_decode(lib, buf[:cut])
        _gif_scanned(lib, buf[:cut])
        n += 1
    for mcs in (9, 10, 11):
        _gif_decode(lib, _root_code_gif(mcs))
    return (f"3 frames encoded and decoded equal (serial and 4 threads), "
            f"{n} truncations, 3 root-code streams")


def jp2_roundtrips(lib) -> str:
    from lilliput_tpu_torch.codecs import jp2_t1 as T1
    from lilliput_tpu_torch.errors import LilliputError
    rng = np.random.default_rng(3)
    n = 0
    for style in (0x00, 0x01, 0x04, 0x08, 0x05, 0x2F):
        for (h, w, amp) in ((64, 64, 30000), (1, 1, 1), (3, 64, 255),
                            (17, 5, 7)):
            coefs = rng.integers(-amp, amp + 1, (h, w)).astype(np.int32)
            mb = max(int(np.abs(coefs).max()).bit_length(), 1) + 2
            segs, np_, zp = T1.encode_codeblock(coefs, 2, mb, style)
            data = b"".join(s for s, _ in segs)
            out = T1.decode_codeblock(data, w, h, 2, zp, np_, mb, style,
                                      [(len(s), p) for s, p in segs])
            assert np.array_equal(np.sign(out) * (np.abs(out) >> 1), coefs)
            n += 1
    blob = rng.bytes(256)
    for data, passes in ((rng.bytes(200), 60), (b"\xff" * 64, 30),
                         (b"", 10), (rng.bytes(3), 100)):
        try:
            T1.decode_codeblock(data, 64, 64, 2, 0, passes, 30)
        except LilliputError:
            pass
    for meta in ([(300, 5)], [(10, 0), (10, 200)], [(0, 1)] * 64,
                 [(256, 1), (1, 1)]):
        try:
            T1.decode_codeblock(blob, 32, 32, 1, 0, sum(p for _, p in meta),
                                20, 0x05, meta)
        except LilliputError:
            pass
    return f"{n} codeblocks encoded and decoded equal, 8 hostile decodes"


def yuv_roundtrips(lib) -> str:
    from lilliput_tpu_torch.codecs.yuv_rgb import _yuv_to_bgr_native
    rng = np.random.default_rng(4)
    n = 0
    for (h, w) in ((16, 16), (17, 19), (1, 1), (7, 1)):
        ch, cw = (h + 1) // 2, (w + 1) // 2
        y = rng.integers(0, 256, (h, w), np.uint8)
        a = rng.integers(0, 256, (h, w), np.uint8)
        for u_shape in ((ch, cw), (h, cw), (h, w), None):
            u = None if u_shape is None else rng.integers(0, 256, u_shape,
                                                          np.uint8)
            v = None if u_shape is None else rng.integers(0, 256, u_shape,
                                                          np.uint8)
            for alpha in (None, a):
                for matrix in (1, 6, 9):
                    out = _yuv_to_bgr_native(y, u, v, matrix, True, h, w,
                                             alpha)
                    assert out is not None and out.shape[:2] == (h, w)
                    n += 1
    # geometries the row kernel must decline, not read past
    yy = rng.integers(0, 256, (7, 1), np.uint8)
    uu = rng.integers(0, 256, (4, 1), np.uint8)
    out = np.empty((7, 1, 3), np.uint8)
    for sub in (0, 1):
        assert lib.lp_yuv_to_bgr(_p(yy), 1, _p(uu), _p(uu), 1, 1, 4, sub, 1,
                                 7, 128, 25, 52, 102, 18997, -1160, None, 0,
                                 _p(out), 3) == -3
    assert lib.lp_yuv_to_bgr(None, 0, None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, None, 0, None, 3) == -1
    return f"{n} conversions, 3 declined geometries"


def child(lib_path: str, small: bool) -> int:
    from lilliput_tpu_torch import binding
    lib = ctypes.CDLL(lib_path)
    binding._configure(lib)
    binding._lib = lib      # every codec of the port calls this library
    for name, fn in (("jpeg", lambda: jpeg_roundtrips(lib, small)),
                     ("png", lambda: png_roundtrips(lib)),
                     ("gif", lambda: gif_roundtrips(lib)),
                     ("jp2_t1", lambda: jp2_roundtrips(lib)),
                     ("yuv_bgr", lambda: yuv_roundtrips(lib))):
        print(f"{name}: {fn()}", flush=True)
    print("asan smoke OK", flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return child(argv[1], "--small" in argv)
    small = "--small" in argv
    asan = libasan()
    if not asan:
        print("no libasan.so for g++: cannot run the ASan smoke",
              file=sys.stderr)
        return 2
    lib_path = build_asan()
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS=ASAN_OPTIONS,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", lib_path]
        + (["--small"] if small else []), env=env, capture_output=True,
        text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if "AddressSanitizer" in proc.stderr or proc.returncode != 0:
        print(f"ASan smoke failed (exit {proc.returncode})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
