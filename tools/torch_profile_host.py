#!/usr/bin/env python3
"""Host-side splits of the port's serving paths: the counterpart of
tools/profile_host.py for lilliput_tpu_torch, plus the host splits no
other script gives.

    python tools/torch_profile_host.py [--device cuda|cpu] [--small]
                                       [--out FILE]

Prints one JSON object per split (and writes them all to FILE where
given), each with the host's core count (os.cpu_count()):

  jpeg_decode  the single-thread host split of the JPEG entropy decode of
               tests/assets/bench_1080p.jpg as JpegTranscodePipeline
               (256x256 Fit) runs it, per image: header (codecs.jpeg.
               read_info), validate (_validate_header: the parse and the
               geometry gates), alloc (the window's arrays, pinned on a
               card, amortized over N), prep (np.frombuffer, the qtables,
               the pointer array), decode_c (lp_jpeg_decode_coefs_win of
               jpeg_huff.cpp into the window, one thread), tables (the
               per-image f32 qtable rows); compose and compose_pool:
               decode_entropy(workers=1) over N images, fresh and pooled
               arrays; the stage sum over compose_pool;
  jp2_decode   JPEG 2000 Tier-2 (Python) against Tier-1 (C++, the
               codeblock pool over the host's cores) in Jp2Image.decode of
               the lossless 1080p stream chip_smoke.jp2_inputs writes
               (the port's encoder on --device): parse (Jp2Image()),
               tier1 (_tier1), tier2 (_host_stages less _tier1), device
               (the wavelet and colour tail, synchronized);
  png_decode   PNG inflate against unfilter in PngDecoder on the 1080p
               RGB8 PNG of chip_smoke.png_inputs (filter type 0) and on
               the port's own encode of the same pixels (encode_png_pixels:
               adaptive filters): parse, inflate (lp_zlib_decompress where
               libdeflate is built in, else Python zlib), unfilter
               (lp_png_unfilter), to_pixels (the rest of decode_to on the
               CPU);
  jpeg_encode  a batch of 128 256x256 4:2:0 outputs of the fixture (the
               4:2:0 device step's coefficients) through encode_entropy at
               1-8 threads, baseline and optimize_coding, ms per batch; and
               one image's single-thread stages: prep (the contiguous
               component copies), alloc (the output buffer), encode_c
               (lpt_jpeg_encode_coefs and the bytes copy).

Each time is the minimum over ITERS runs (host clock; contention only
adds time). --small cuts the sources to 320x180 and the batches to 8 for
a CPU check; --device cpu runs the device stages on the CPU. Imports
only the port (and chip_smoke's input builders).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 5


def _best(fn, iters: int = ITERS, inner: int = 1) -> float:
    """Minimum over iters of the mean ms of `inner` calls of fn()."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        best = min(best, (time.perf_counter() - t0) / inner)
    return 1e3 * best


def _round(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def _fixture(small: bool) -> bytes:
    with open(os.path.join(ROOT, "tests", "assets", "bench_1080p.jpg"),
              "rb") as f:
        buf = f.read()
    if not small:
        return buf
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    fb = Framebuffer()
    new_decoder(buf, device="cpu").decode_to(fb)
    px = np.ascontiguousarray(fb.to_numpy()[:180, :320])
    return new_encoder(".jpeg").encode(
        Framebuffer.from_array(px, device="cpu"), {})


def jpeg_decode_split(device: str, small: bool) -> dict:
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    from lilliput_tpu_torch.codecs import jpeg as J
    buf = _fixture(small)
    n = 8 if small else 32
    pipe = JpegTranscodePipeline(buf, 256, 256, quality=85, device=device)
    lib = pipe._lib
    _, _, _, _, yr, ycs, crr, ccs = pipe._window
    out = {"split": "jpeg_decode", "bytes": len(buf), "n": n,
           "geometry": f"{pipe.geom.width}x{pipe.geom.height}"}
    out["header_ms"] = _best(lambda: J.read_info(buf), inner=n)
    out["validate_ms"] = _best(lambda: pipe._validate_header(buf), inner=n)
    shape_y = (n, yr.stop - yr.start, ycs.stop - ycs.start, 64)
    shape_c = (n, crr.stop - crr.start, ccs.stop - ccs.start, 64)

    def alloc():
        return (pipe._alloc(shape_y), pipe._alloc(shape_c),
                pipe._alloc(shape_c))
    out["alloc_ms"] = _best(alloc) / n
    arrs = alloc()
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    win = np.array([[yr.start, ycs.start, yr.stop - yr.start,
                     ycs.stop - ycs.start]]
                   + [[crr.start, ccs.start, crr.stop - crr.start,
                       ccs.stop - ccs.start]] * 2 + [[0, 0, 0, 0]],
                   np.int32)
    win_p = win.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def prep(i=0):
        a = np.frombuffer(buf, np.uint8)
        q = np.zeros((4, 64), np.uint16)
        ptrs = (i16p * 3)(*[x[i].ctypes.data_as(i16p) for x in arrs])
        return a, q, ptrs
    out["prep_ms"] = _best(prep, inner=n)
    a, q, ptrs = prep()

    def dec():
        rc = lib.lp_jpeg_decode_coefs_win(a.ctypes.data_as(u8p), a.size,
                                          ptrs, q.ctypes.data_as(u16p), 1,
                                          win_p)
        assert rc == 0, rc
    out["decode_c_ms"] = _best(dec, inner=max(4, n // 4))
    info = J.read_info(buf)
    qty = pipe._alloc((n, 64), dtype=torch.float32)
    qtc = pipe._alloc((n, 64), dtype=torch.float32)

    def tables(i=0):
        qty[i] = q[info.comp_quant_tbl[0]]
        qtc[i] = q[info.comp_quant_tbl[1]]
    out["tables_ms"] = _best(tables, inner=n)
    bufs = [buf] * n
    pipe.decode_entropy(bufs, workers=1)
    out["compose_ms"] = _best(lambda: pipe.decode_entropy(bufs, workers=1),
                              iters=3) / n
    for _ in range(2):
        pipe.decode_entropy(bufs, workers=1, pool=True)
    out["compose_pool_ms"] = _best(
        lambda: pipe.decode_entropy(bufs, workers=1, pool=True), iters=3) / n
    ssum = sum(out[k] for k in ("validate_ms", "alloc_ms", "prep_ms",
                                "decode_c_ms", "tables_ms"))
    out["stage_sum_ms"] = ssum
    out["sum_over_compose_pool"] = ssum / out["compose_pool_ms"]
    out["images_per_s_one_thread"] = 1e3 / out["compose_pool_ms"]
    return out


def _jp2_lossless(device: str, small: bool) -> bytes:
    import torch
    from chip_smoke import fixture_pixels
    from lilliput_tpu_torch.codecs.jp2_enc import encode_jp2
    bgr = fixture_pixels("bench_1080p.jpg")
    if small:
        bgr = bgr[:180, :320]
    rgb = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1])).to(device)
    return encode_jp2(rgb)


def jp2_decode_split(device: str, small: bool) -> dict:
    import torch
    from lilliput_tpu_torch.codecs import jp2 as JP2
    buf = _jp2_lossless(device, small)
    out = {"split": "jp2_decode", "stream": "lossless 5/3 RGB",
           "bytes": len(buf)}
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))
    times = {"parse": [], "host": [], "tier1": [], "device": []}
    for _ in range(3):
        t0 = time.perf_counter()
        img = JP2.Jp2Image(buf, device=device)
        t1 = time.perf_counter()
        tier1 = img._tier1
        spent = []

        def timed_tier1(*a, _tier1=tier1, _spent=spent):
            s = time.perf_counter()
            _tier1(*a)
            _spent.append(time.perf_counter() - s)
        img._tier1 = timed_tier1
        staged = img._host_stages()
        t2 = time.perf_counter()
        planes = img._device_stages(*staged)
        sync()
        t3 = time.perf_counter()
        assert planes[0].shape[-2:] == ((180, 320) if small
                                        else (1080, 1920))
        times["parse"].append(t1 - t0)
        times["host"].append(t2 - t1)
        times["tier1"].append(sum(spent))
        times["device"].append(t3 - t2)
    best = min(range(3), key=lambda k: times["host"][k])
    out["parse_ms"] = 1e3 * min(times["parse"])
    out["tier1_ms"] = 1e3 * times["tier1"][best]
    out["tier2_ms"] = 1e3 * (times["host"][best] - times["tier1"][best])
    out["host_ms"] = 1e3 * times["host"][best]
    out["device_ms"] = 1e3 * min(times["device"])
    out["tier1_share_of_host"] = out["tier1_ms"] / out["host_ms"]
    return out


def png_decode_split(small: bool) -> list:
    from chip_smoke import fixture_pixels, png_inputs
    from lilliput_tpu_torch import Framebuffer
    from lilliput_tpu_torch.codecs import png as P
    bgr = fixture_pixels("bench_1080p.jpg")
    gray = fixture_pixels("bench_1080p_gray.jpg")
    if small:
        bgr, gray = bgr[:180, :320], gray[:180, :320]
    sources = {"png_rgb8 (filter 0)": png_inputs(bgr, gray)["png_rgb8"],
               "png_rgb8 (port encoder)": P.encode_png_pixels(
                   np.ascontiguousarray(bgr))}
    rows = []
    for name, buf in sources.items():
        dec = P.PngDecoder(buf, device="cpu")
        info = dec._info
        out = {"split": "png_decode", "source": name, "bytes": len(buf),
               "fast_inflate": bool(P._fast_zlib(dec._lib))}
        out["parse_ms"] = _best(lambda: P._parse(buf))
        out["inflate_ms"] = _best(dec._inflate)
        data = dec._inflate()
        stride = info.width * 3
        out["unfilter_ms"] = _best(lambda: P._unfilter(
            dec._lib, data[:info.height * (stride + 1)], info.height,
            stride, 3))

        def whole():
            fb = Framebuffer()
            P.PngDecoder(buf, device="cpu").decode_to(fb)
        out["decode_to_ms"] = _best(whole, iters=3)
        out["to_pixels_ms"] = out["decode_to_ms"] - (
            out["parse_ms"] + out["inflate_ms"] + out["unfilter_ms"])
        rows.append(out)
    return rows


def jpeg_encode_split(device: str, small: bool) -> dict:
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    from lilliput_tpu_torch.codecs import jpeg as J
    buf = _fixture(small)
    b = 8 if small else 128
    out = {"split": "jpeg_encode", "batch": b, "output": "256x256 4:2:0"}
    for opt in (False, True):
        pipe = JpegTranscodePipeline(buf, 256, 256, quality=85,
                                     optimize_coding=opt, device=device)
        coefs = [o.cpu().numpy() for o in
                 pipe.device_step(*pipe.decode_entropy([buf] * b))]
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        tag = "optimize" if opt else "baseline"
        for k in range(1, 9):
            out[f"{tag}_threads{k}_ms"] = _best(
                lambda: pipe.encode_entropy(*coefs, workers=k), iters=3)
        out[f"{tag}_bytes"] = sum(map(len, pipe.encode_entropy(*coefs)))
        yb, cbb = (32, 32), (16, 16)

        def prep():
            return [np.ascontiguousarray(coefs[0][0][:yb[0], :yb[1]])] + [
                np.ascontiguousarray(a[0][:cbb[0], :cbb[1]])
                for a in coefs[1:]]
        cap = 256 * 256 * 4 + (1 << 20)
        comps = prep()
        obuf = np.empty(cap, np.uint8)
        out[f"{tag}_prep_ms"] = _best(prep, inner=16)
        out[f"{tag}_alloc_ms"] = _best(lambda: np.empty(cap, np.uint8),
                                       inner=16)
        out[f"{tag}_encode_c_ms"] = _best(lambda: J.encode_coefs(
            256, 256, comps, [2, 1, 1], [2, 1, 1], pipe.enc_qt_y_np,
            pipe.enc_qt_c_np, optimize=int(opt), out=obuf), inner=16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from lilliput_tpu_torch.utils import resolve_device
    device = str(resolve_device(args.device))
    host = {"cores": os.cpu_count()}
    rows = [jpeg_decode_split(device, args.small),
            jp2_decode_split(device, args.small),
            *png_decode_split(args.small),
            jpeg_encode_split(device, args.small)]
    rows = [_round({**r, **host}) for r in rows]
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
