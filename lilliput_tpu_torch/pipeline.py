"""Batched JPEG Fit transcode — the port's serving path.

The slice of ``lilliput_tpu/pipeline.py`` that runs the main path: a batch
of same-geometry 4:2:0 JPEGs, upright, to Fit-cropped JPEGs at the
destination size, AREA resize, chroma_mode="rgb". Five stages:

1. host Huffman decode into the MCU window around the Fit crop
   (``decode_entropy``, jpeg_huff.cpp);
2. the 4:2:0 decode kernel (``ops/decode_kernels.decode420``, CUDA) to three
   raster u8 planes;
3. INTER_AREA resize with the crop folded into banded matrices
   (``ops/resize.resize_area_plane_embedded``);
4. BGR->YCbCr, 2x2 chroma downsample, fDCT and quantization
   (``ops/jpeg_kernels.encode_from_bgr_planes``);
5. host Huffman encode (``encode_entropy``, csrc/host/jpeg_enc.cpp).

Stages 2-4 run on the pipeline's torch device; the host threads run the
serial entropy stages and overlap with device work through CUDA's
asynchronous launches (``transcode_pipelined``). Everything outside the
slice raises NotImplementedError naming its ROADMAP queue 1 item; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import binding
from .codecs import jpeg as J
from .errors import DecodingFailedError
from .ops import jpeg_kernels as K
from .ops import resize as R

_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)


@dataclasses.dataclass(frozen=True)
class JpegGeometry:
    """Static shape key: one pipeline per geometry."""
    width: int
    height: int
    h2: bool          # chroma h subsampled
    v2: bool
    blocks: tuple     # ((bh, bw) per component)


def geometry_of(info) -> JpegGeometry:
    if info.num_components == 1:
        return JpegGeometry(
            width=info.width, height=info.height, h2=False, v2=False,
            blocks=((int(info.comp_blocks_h[0]),
                     int(info.comp_blocks_w[0])),))
    hy, vy = info.comp_h_samp[0], info.comp_v_samp[0]
    hc, vc = info.comp_h_samp[1], info.comp_v_samp[1]
    return JpegGeometry(
        width=info.width, height=info.height,
        h2=(hy // hc == 2), v2=(vy // vc == 2),
        blocks=tuple((int(info.comp_blocks_h[c]), int(info.comp_blocks_w[c]))
                     for c in range(3)))


def fit_rect(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Center-crop rect for Fit (opencv.go:316-353 math)."""
    aspect_in = src_w / src_h
    aspect_out = dst_w / dst_h
    if aspect_in > aspect_out:
        w = int(aspect_out * src_h + 0.5)
        h = src_h
    else:
        h = int(src_w / aspect_out + 0.5)
        w = src_w
    w, h = max(w, 1), max(h, 1)
    left = max(int((src_w - w) * 0.5), 0)
    top = max(int((src_h - h) * 0.5), 0)
    return left, top, w, h


def mcu_decode_window(src_w: int, src_h: int, dst_w: int, dst_h: int,
                      h2: bool, v2: bool, blocks, luma_rows: int):
    """MCU-aligned coefficient window covering the Fit crop plus one MCU
    margin (the chroma triangle filter's neighbor taps). Returns
    (x0, y0, rw, rh, luma_rowslice, luma_colslice, chroma_rowslice,
    chroma_colslice) in BLOCK units; decode_entropy slices on the HOST, so
    the H2D transfer and the device step carry only the window."""
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    fx = 2 if h2 else 1
    fy = 2 if v2 else 1
    mx, my = 8 * fx, 8 * fy
    ybh, ybw = blocks[0]
    cbh, cbw = blocks[1]
    plane_w = min(ybw * 8, cbw * 8 * fx)
    plane_h = min(ybh * 8, cbh * 8 * fy)
    x0 = max((left // mx) * mx - mx, 0)
    y0 = max((top // my) * my - my, 0)
    x1 = min(((left + w + mx - 1) // mx + 1) * mx, plane_w)
    y1 = min(((top + h + my - 1) // my + 1) * my, plane_h)
    ybx0, ybx1 = x0 // 8, -(-x1 // 8)
    yby0, yby1 = y0 // 8, -(-y1 // 8)
    cbx0, cbx1 = x0 // (8 * fx), -(-x1 // (8 * fx))
    cby0, cby1 = y0 // (8 * fy), -(-y1 // (8 * fy))
    if fy == 2:
        yby1 = min(2 * cby1, luma_rows)
    return (x0, y0, x1 - x0, y1 - y0, slice(yby0, yby1), slice(ybx0, ybx1),
            slice(cby0, cby1), slice(cbx0, cbx1))


def _fused_jpeg_fit_impl(yc, cb, cr, qt_y, qt_c, enc_qt_y, enc_qt_c,
                         src_w: int, src_h: int, dst_w: int, dst_h: int,
                         window, plain: bool = False):
    """(B, bh, bw, 64) window coefficient batches -> quantized encode
    coefficients (yq, cbq, crq): the upright AREA 4:2:0 block-tail branch
    of the JAX function (lilliput_tpu/pipeline.py:247-281).

    The decode kernel writes raster u8 planes; each plane's resize folds
    the Fit crop into its AREA matrices, rounds and clips, and the three
    resized planes re-encode at 4:2:0. plain=True decodes with the plain
    PyTorch version of the kernel (for comparisons on the card)."""
    left, top, w, h = fit_rect(src_w, src_h, dst_w, dst_h)
    x0, y0 = window[0], window[1]
    planes = K.decode_ycc_u8_plane_blocks(yc, cb, cr, qt_y, qt_c, True, True,
                                          plain=plain)
    if planes is None:
        raise DecodingFailedError(
            f"coefficient shapes {tuple(yc.shape)}/{tuple(cb.shape)} are "
            "not 4:2:0")
    out = [torch.clamp(torch.round(R.resize_area_plane_embedded(
        p, left - x0, w, dst_w, top - y0, h, dst_h)), 0, 255)
        for p in planes]
    return K.encode_from_bgr_planes(out[0], out[1], out[2], enc_qt_y,
                                    enc_qt_c, subsample=True)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to lilliput_tpu_torch yet "
        f"(ROADMAP queue 1, {item}); use lilliput_tpu")


class _ServingPipelineBase:
    """Host-encode/orchestration stages of the serving pipelines.

    Subclasses provide `_host_decode` and `device_step` plus the attributes
    the encode stage reads: dst_w/dst_h, ncomp, enc_qt_y_np/enc_qt_c_np,
    _lib."""

    def _host_decode(self, bufs: Sequence[bytes],
                     errors: Optional[Dict[int, Exception]] = None):
        raise NotImplementedError

    def device_step(self, *args, plain: bool = False):
        raise NotImplementedError

    # -- host encode stage ----------------------------------------------------

    def encode_entropy(self, yq: np.ndarray, cbq: Optional[np.ndarray] = None,
                       crq: Optional[np.ndarray] = None,
                       workers: Optional[int] = None,
                       iccs: Optional[Sequence[bytes]] = None) -> List[bytes]:
        """Huffman-encode device-quantized coefficients (host, threaded).

        Color pipelines take (yq, cbq, crq); grayscale just (yq,). The
        encoder releases the GIL (ctypes), so encode scales across host
        cores; each worker owns its output buffer. iccs: per-image ICC
        profiles to embed, so colour profiles survive the transcode."""
        w, h = self.dst_w, self.dst_h
        yb = ((h + 7) // 8, (w + 7) // 8)
        cbb = ((h + 15) // 16, (w + 15) // 16)
        gray = self.ncomp == 1
        b = yq.shape[0]
        outs: List[Optional[bytes]] = [None] * b
        nc = 1 if gray else 3
        hs = (ctypes.c_int32 * nc)(*([1] if gray else [2, 1, 1]))
        vs = (ctypes.c_int32 * nc)(*([1] if gray else [2, 1, 1]))
        cap = w * h * 4 + (1 << 20)
        if iccs is not None:
            cap += max((len(p or b"") for p in iccs), default=0) + (1 << 12)

        def one(i: int, out_buf=None):
            if out_buf is None:
                out_buf = np.empty(cap, np.uint8)
            y = np.ascontiguousarray(yq[i][:yb[0], :yb[1]])
            if gray:
                ptrs = (_i16p * 1)(y.ctypes.data_as(_i16p))
            else:
                cbx = np.ascontiguousarray(cbq[i][:cbb[0], :cbb[1]])
                crx = np.ascontiguousarray(crq[i][:cbb[0], :cbb[1]])
                ptrs = (_i16p * 3)(y.ctypes.data_as(_i16p),
                                   cbx.ctypes.data_as(_i16p),
                                   crx.ctypes.data_as(_i16p))
            icc = (iccs[i] if iccs is not None else b"") or b""
            icc_arr = np.frombuffer(icc, np.uint8) if icc else None
            n = self._lib.lpt_jpeg_encode_baseline(
                w, h, nc, hs, vs, ptrs,
                self.enc_qt_y_np.ctypes.data_as(_u16p),
                self.enc_qt_c_np.ctypes.data_as(_u16p),
                icc_arr.ctypes.data_as(_u8p) if icc_arr is not None else None,
                len(icc), out_buf.ctypes.data_as(_u8p), out_buf.size)
            if n < 0:
                raise DecodingFailedError(f"JPEG entropy encode failed ({n})")
            outs[i] = out_buf[:n].tobytes()

        n_workers = workers if workers is not None else min(8, os.cpu_count() or 1)
        if n_workers <= 1 or b <= 1:
            buf = np.empty(cap, np.uint8)
            for i in range(b):
                one(i, buf)
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(n_workers) as ex:
                list(ex.map(one, range(b)))
        return outs  # type: ignore[return-value]

    # -- end to end -----------------------------------------------------------

    @staticmethod
    def _resolve_errors(out: List[bytes], errors: Dict[int, Exception],
                        return_exceptions: bool) -> List[bytes]:
        """Apply the serving-front failure contract: failed items are
        counted in Metrics, then either attached to their own slots
        (return_exceptions=True) or the first one re-raises after healthy
        items finished — one corrupt buffer never fails its co-batched
        requests' work."""
        if not errors:
            return out
        from .utils import metrics
        metrics.incr("serving.poison_isolated", len(errors))
        if not return_exceptions:
            raise errors[min(errors)]
        for i, e in errors.items():
            out[i] = e  # type: ignore[assignment]
        return out

    @staticmethod
    def _to_host(dev) -> List[np.ndarray]:
        """Device outputs -> host arrays (waits for the device)."""
        return [a.cpu().numpy() for a in dev]

    def transcode(self, bufs: Sequence[bytes],
                  return_exceptions: bool = False) -> List[bytes]:
        """Transcode a batch. Per-item decode failures are ISOLATED: a
        corrupt buffer cannot fail its healthy co-batched requests (its
        lane is zero-filled through the device step and its output
        discarded). With return_exceptions=True the failing items' slots
        hold the exception objects; with the default False the first
        failure re-raises after healthy items finish."""
        from .utils import StageTimer, metrics
        errors: Dict[int, Exception] = {}
        with StageTimer("entropy_decode"):
            args, iccs = self._host_decode(bufs, errors)
        with StageTimer("device"):
            arrs = self._to_host(self.device_step(*args))
        with StageTimer("encode"):
            out = self.encode_entropy(*arrs, iccs=iccs)
        metrics.incr("images_transcoded", len(bufs) - len(errors))
        return self._resolve_errors(out, errors, return_exceptions)

    def transcode_pipelined(self, batches: Sequence[Sequence[bytes]],
                            return_exceptions: bool = False
                            ) -> List[List[bytes]]:
        """Double-buffered: host decode for batch i+1 overlaps device batch
        i (CUDA launches are asynchronous; the D2H copy waits). Failure
        isolation matches transcode(): per-item within each batch."""
        results = []
        pending = None  # (device tensors, ICC profiles, per-item errors)
        for bufs in batches:
            errors: Dict[int, Exception] = {}
            args, iccs = self._host_decode(bufs, errors)
            dev = self.device_step(*args)
            if pending is not None:
                pdev, piccs, perr = pending
                results.append(self._resolve_errors(self.encode_entropy(
                    *self._to_host(pdev), iccs=piccs), perr,
                    return_exceptions))
            pending = (dev, iccs, errors)
        if pending is not None:
            pdev, piccs, perr = pending
            results.append(self._resolve_errors(self.encode_entropy(
                *self._to_host(pdev), iccs=piccs), perr, return_exceptions))
        return results


class JpegTranscodePipeline(_ServingPipelineBase):
    """Batched JPEG Fit transcoder for a fixed 4:2:0 source geometry.

    Usage:
        pipe = JpegTranscodePipeline(sample_jpeg_bytes, 256, 256, quality=85)
        outs = pipe.transcode(list_of_jpeg_bytes)   # same geometry as sample

    device: the torch device of the dense stages, "cuda" by default; the
    CPU runs only when asked for (device="cpu"), with the decode kernel's
    plain version. Source ICC profiles are carried into every output."""

    def __init__(self, sample: bytes, dst_w: int, dst_h: int,
                 quality: int = 85, method: str = R.AREA,
                 optimize_coding: bool = False, chroma_mode: str = "rgb",
                 dct_scale: int = 1, output_format: str = ".jpeg",
                 encode_options: Optional[dict] = None,
                 device="cuda"):
        if chroma_mode not in ("rgb", "direct"):
            raise ValueError("chroma_mode must be 'rgb' or 'direct'")
        if dct_scale not in (1, 2, 4):
            raise ValueError("dct_scale must be 1, 2 or 4")
        fmt = {".jpg": ".jpeg"}.get(output_format, output_format)
        if fmt not in (".jpeg", ".webp", ".png"):
            raise ValueError("output_format must be .jpeg, .webp or .png")
        if chroma_mode == "direct":
            _not_ported("chroma_mode='direct'", "item 4.1")
        if dct_scale != 1:
            _not_ported("dct_scale>1", "item 4.2")
        if method != R.AREA:
            _not_ported(f"method={method!r}", "item 4.6")
        if fmt != ".jpeg":
            _not_ported(f"output_format={fmt!r}", "item 4.7")
        if optimize_coding:
            _not_ported("optimize_coding (optimal Huffman tables)",
                        "item 2, host encode")
        if encode_options:
            _not_ported("encode_options", "item 4.7")
        self.device = torch.device(device)
        self._lib = binding.load()
        self._coef_pool: dict = {}
        self.dst_w, self.dst_h = dst_w, dst_h
        self.method = method
        self.optimize_coding = optimize_coding
        self.output_format = fmt
        self.chroma_mode = chroma_mode
        self.dct_scale = dct_scale
        info = J.read_info(sample)
        if info.num_components == 1:
            _not_ported("grayscale sources", "item 4.4")
        if info.num_components != 3:
            raise DecodingFailedError(
                "pipeline expects color or grayscale JPEGs")
        if not J.supported_subsampling(info):
            raise DecodingFailedError("unsupported chroma subsampling")
        if info.jpeg_color_space != J.JCS_YCBCR:
            raise DecodingFailedError(
                "non-YCbCr 3-component JPEG (JCS_RGB): use the streaming "
                "ImageOps path for this source")
        if info.comp_quant_tbl[2] != info.comp_quant_tbl[1]:
            raise DecodingFailedError(
                "distinct Cb/Cr quant tables: use the streaming "
                "ImageOps path for this source")
        self.ncomp = 3
        self.geom = geometry_of(info)
        g = self.geom
        if not (g.h2 and g.v2):
            _not_ported("4:4:4, 4:2:2 and 4:4:0 sources", "item 4.3")
        self.orientation = int(J.exif_orientation(sample))
        if self.orientation != 1:
            _not_ported("EXIF orientation != 1", "item 4.5")
        # host-side decode window: coefficients outside the MCU-aligned
        # crop window never leave the host
        ybh = g.blocks[0][0]
        self._window = mcu_decode_window(
            g.width, g.height, dst_w, dst_h, g.h2, g.v2, g.blocks,
            ybh + (ybh % 2))
        #: (x0, y0, rw, rh) of the window's plane origin and size
        self.window_static = self._window[:4]
        self.quality = quality
        eql, eqc = J.scaled_qtables(quality)
        self.enc_qt_y_np, self.enc_qt_c_np = eql, eqc
        self.enc_qt_y = torch.from_numpy(eql.astype(np.float32)).to(self.device)
        self.enc_qt_c = torch.from_numpy(eqc.astype(np.float32)).to(self.device)

    # -- host entropy stages --------------------------------------------------

    def _validate_header(self, buf: bytes) -> J._JpegInfo:
        """Header-only parse + geometry/orientation gate. Every buffer is
        validated BEFORE the coefficient decode: the decoder writes by the
        image's own block counts, so an unchecked larger image would
        overrun the batch arrays."""
        info = J.read_info(buf)
        if info.num_components != self.ncomp:
            raise DecodingFailedError(
                f"component-count mismatch: pipeline built for "
                f"{self.ncomp}-component JPEGs, got {info.num_components}")
        if geometry_of(info) != self.geom:
            raise DecodingFailedError(
                f"geometry mismatch: pipeline built for {self.geom}, "
                f"got {geometry_of(info)}")
        if info.comp_quant_tbl[2] != info.comp_quant_tbl[1]:
            raise DecodingFailedError(
                "distinct Cb/Cr quant tables: use the streaming ImageOps "
                "path for this source")
        if info.jpeg_color_space != J.JCS_YCBCR:
            raise DecodingFailedError(
                "non-YCbCr 3-component JPEG (JCS_RGB): use the streaming "
                "ImageOps path for this source")
        if not J.supported_subsampling(info):
            raise DecodingFailedError(
                "unsupported chroma subsampling: use the streaming "
                "ImageOps path for this source")
        o = int(J.exif_orientation(buf))
        if o != self.orientation:
            raise DecodingFailedError(
                f"EXIF orientation mismatch: pipeline expects "
                f"{self.orientation}, got {o}")
        return info

    def _alloc(self, shape) -> np.ndarray:
        """Host batch array; page-locked on CUDA so the H2D copy of a batch
        is asynchronous and overlaps the next batch's host decode."""
        if self.device.type == "cuda":
            return torch.empty(shape, dtype=torch.int16,
                               pin_memory=True).numpy()
        return np.empty(shape, np.int16)

    def _pooled(self, key, alloc):
        """Rotating 2-slot destination-array pool for decode_entropy.

        Steady-state serving reuses the previous-but-one batch's arrays
        (fresh arrays pay first-touch page faults, and pinned ones a
        cudaHostAlloc). Two slots cover transcode_pipelined, whose batch-i
        H2D transfer may still be in flight while batch i+1 decodes; slot
        i is reused only at batch i+2, after iteration i+1 fetched batch
        i's OUTPUTS (which orders after its input transfer). Callers of
        pool=True must serialize decode_entropy calls per pipeline."""
        slots = self._coef_pool.get(key)
        if slots is None:
            if len(self._coef_pool) >= 4:  # ragged tail batches: stay bounded
                self._coef_pool.pop(next(iter(self._coef_pool)))
            self._coef_pool[key] = slots = [[], 0]
        arrs, idx = slots
        if len(arrs) < 2:
            arrs.append(alloc())
            return arrs[-1]
        out = arrs[idx]
        slots[1] = 1 - idx
        return out

    def decode_entropy(self, bufs: Sequence[bytes],
                       workers: Optional[int] = None, pool: bool = False,
                       errors: Optional[Dict[int, Exception]] = None):
        """Huffman-decode a batch into the MCU window around the Fit crop.

        Returns (ys, cbs, crs, qt_y, qt_c) with qt_* of shape (B, 64): each
        image is dequantized with its OWN tables on device. pool=True
        reuses the previous-but-one batch's destination arrays (see
        _pooled); direct callers that hold returned arrays across calls
        must keep pool=False.

        errors: when a dict, per-item failures are ISOLATED: a corrupt
        buffer's exception lands in errors[i] and its lane is zero-filled
        (coefficients AND qtables, so pooled reuse cannot leak a previous
        request's data) instead of failing the whole batch. errors=None
        raises on the first bad buffer.

        The decoder is jpeg_huff.cpp (bit-identical to libjpeg for the
        streams it accepts). The port has no libjpeg to fall back to, so a
        stream it declines (arithmetic coding, non-interleaved baseline
        scans, ...) fails its item."""
        if not J.use_fast_huff():
            _not_ported("the libjpeg Huffman decode route", "item 2")
        b = len(bufs)
        _, _, _, _, yr, ycs, crr, ccs = self._window

        def _alloc_win():
            c = (b, crr.stop - crr.start, ccs.stop - ccs.start, 64)
            return (self._alloc((b, yr.stop - yr.start,
                                 ycs.stop - ycs.start, 64)),
                    self._alloc(c), self._alloc(c))

        ys, cbs, crs = (self._pooled((b, "win"), _alloc_win) if pool
                        else _alloc_win())
        # per-component block windows {y0, x0, h, w} for
        # lp_jpeg_decode_coefs_win, which decodes straight into them
        win_c = np.array(
            [[yr.start, ycs.start, yr.stop - yr.start,
              ycs.stop - ycs.start]] +
            [[crr.start, ccs.start, crr.stop - crr.start,
              ccs.stop - ccs.start]] * 2 + [[0, 0, 0, 0]], np.int32)
        win_p = win_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        qty = np.empty((b, 64), np.uint16)
        qtc = np.empty((b, 64), np.uint16)
        n_workers = workers if workers is not None else min(8, os.cpu_count() or 1)
        # small batches underfill the pool: split each image's scan at its
        # restart markers across the idle threads (byte-identical output)
        intra = max(1, n_workers // max(b, 1)) if b < n_workers else 1

        def one(i: int):
            info = self._validate_header(bufs[i])
            arr = np.frombuffer(bufs[i], np.uint8)
            qtables = np.zeros((4, 64), np.uint16)
            ptrs = (_i16p * 3)(ys[i].ctypes.data_as(_i16p),
                               cbs[i].ctypes.data_as(_i16p),
                               crs[i].ctypes.data_as(_i16p))
            rc = self._lib.lp_jpeg_decode_coefs_win(
                arr.ctypes.data_as(_u8p), arr.size, ptrs,
                qtables.ctypes.data_as(_u16p), intra, win_p)
            if rc != 0:
                raise DecodingFailedError(f"JPEG entropy decode failed ({rc})")
            qty[i] = qtables[info.comp_quant_tbl[0]]
            qtc[i] = qtables[info.comp_quant_tbl[1]]

        if errors is not None:
            decode_one = one

            def one(i: int):
                try:
                    decode_one(i)
                except Exception as e:  # noqa: BLE001 — isolate per item
                    errors[i] = e
                    ys[i] = 0            # benign all-zero lane; also wipes
                    cbs[i] = 0           # pooled previous-batch data
                    crs[i] = 0
                    qty[i] = 0
                    qtc[i] = 0

        if n_workers <= 1 or b <= 1:
            for i in range(b):
                one(i)
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(n_workers) as ex:
                list(ex.map(one, range(b)))
        return ys, cbs, crs, qty, qtc

    # -- device stage ----------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, non_blocking=True)

    def device_step(self, ys, cbs, crs, qty, qtc, plain: bool = False):
        """One batch through the dense stages; returns device tensors
        (yq, cbq, crq) int16, asynchronously on CUDA. Takes
        decode_entropy's output. plain=True runs the plain PyTorch version
        of the decode kernel instead of the kernel."""
        g = self.geom
        return _fused_jpeg_fit_impl(
            self._to_device(ys), self._to_device(cbs), self._to_device(crs),
            self._to_device(qty.astype(np.float32)),
            self._to_device(qtc.astype(np.float32)),
            self.enc_qt_y, self.enc_qt_c,
            src_w=g.width, src_h=g.height, dst_w=self.dst_w,
            dst_h=self.dst_h, window=self.window_static, plain=plain)

    # -- end to end --------------------------------------------------------------

    def _host_decode(self, bufs: Sequence[bytes],
                     errors: Optional[Dict[int, Exception]] = None):
        """Host stage: entropy decode + ICC collection (a cheap APP2
        header walk per source, so colour profiles survive the
        transcode)."""
        coefs = self.decode_entropy(bufs, pool=True, errors=errors)
        iccs = [b"" if errors is not None and i in errors
                else J.read_icc(buf) for i, buf in enumerate(bufs)]
        return coefs, iccs

