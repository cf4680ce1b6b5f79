"""GIF codec: the host container and LZW (``csrc/host/gif_codec.cpp``, a
byte-for-byte copy of the JAX package's) with the frame rendering and
palette quantization as torch ops on the decoder's device.

The counterpart of ``lilliput_tpu/codecs/gif.py``, with its behaviour
(the reference's giflib.cpp / giflib.go):

* decode_to yields the full composited canvas per frame (the decoder
  applies GIF disposal), duration = delay * 10 ms, offsets 0, NO_BLEND
  (giflib.go:180-219);
* the first frame paints the background colour of the first GCB
  (giflib.cpp:590-631);
* partial frames without transparency force a transparent palette slot
  (giflib.cpp:554-560), so the encoder can represent the composite;
* the encoder needs the paired GifDecoder (palette reuse), replays
  non-GCE extensions (NETSCAPE loop count), applies the
  background-transparency removal rule and quantizes with the device
  argmin and the previous-frame transparency optimization.

Frames are (H, W, 4) u8 BGRA tensors on the decoder's device ("cuda"
unless the caller passes device="cpu"). The streaming composite of
decode_to runs in numpy on the host, as in the JAX package (rect fills,
copies and a 256-entry LUT gather), and each frame is handed out as a
fresh tensor; decode_animation composites every frame on the device
(ops/palette.composite_animation).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .. import binding
from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import (BlendMethod, DisposeMethod, Framebuffer,
                           ImageHeader, ImageOrientation)
from ..interfaces import Decoder, Encoder
from ..ops import palette as P
from ..utils import resolve_device

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

# GIF disposal codes (spec): 0 unspecified, 1 none, 2 background, 3 previous
_GIF_DISPOSE_BACKGROUND = 2
_GIF_DISPOSE_PREVIOUS = 3

# decode dimension hardening (giflib.go:39-52, default 10000)
_gif_max_frame_dimension = 10000
_gif_dim_lock = threading.Lock()


def set_gif_max_frame_dimension(dim: int) -> None:
    global _gif_max_frame_dimension
    with _gif_dim_lock:
        _gif_max_frame_dimension = dim


class _FrameMeta:
    __slots__ = ("left", "top", "width", "height", "interlace", "local_count",
                 "trans_idx", "delay_cs", "disposal", "ext", "palette",
                 "pal_count")


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _meta(out: np.ndarray, pal: np.ndarray, pal_count: int,
          ext: bytes) -> _FrameMeta:
    m = _FrameMeta()
    (m.left, m.top, m.width, m.height, m.interlace, m.local_count,
     m.trans_idx, m.delay_cs, m.disposal) = (int(v) for v in out[:9])
    m.palette, m.pal_count, m.ext = pal, pal_count, ext
    return m


def _fb_meta(fb: Framebuffer, m: _FrameMeta) -> None:
    fb.duration = m.delay_cs * 10 / 1000.0
    fb.x_offset = fb.y_offset = 0
    fb.blend = BlendMethod.NO_BLEND
    fb.dispose = (DisposeMethod.DISPOSE_TO_BACKGROUND_COLOR
                  if m.disposal == _GIF_DISPOSE_BACKGROUND
                  else DisposeMethod.NO_DISPOSE)


class GifDecoder(Decoder):
    def __init__(self, buf: bytes, device="cuda"):
        self.device = resolve_device(device)
        self._lib = binding.load()
        self._buf = np.frombuffer(buf, np.uint8)
        info = np.zeros(6, np.int32)
        self._h = self._lib.lp_gif_open(_u8(self._buf), self._buf.size,
                                        info.ctypes.data_as(_i32p))
        if not self._h:
            raise InvalidImageError("not a valid GIF")
        self._w, self._hgt = int(info[0]), int(info[1])
        self._global_count = int(info[2])
        self._bg_index = int(info[3])
        self._color_res = int(info[4])
        self._aspect = int(info[5])
        self._global_pal = np.zeros((256, 3), np.uint8)
        if self._global_count:
            self._lib.lp_gif_global_palette(self._h, _u8(self._global_pal))
        self._anim: Optional[np.ndarray] = None
        # render state (host numpy: the streaming composite)
        self._canvas: Optional[np.ndarray] = None
        self._prev_canvas: Optional[np.ndarray] = None
        self._have_first = False
        self._prev_disposal = 0
        self._prev_rect = (0, 0, 0, 0)
        # current frame meta, consumed by the paired encoder
        self.frame_meta: Optional[_FrameMeta] = None
        self._closed = False

    # -- metadata ------------------------------------------------------------

    def header(self) -> ImageHeader:
        return ImageHeader(width=self._w, height=self._hgt, channels=4,
                           orientation=ImageOrientation.TOP_LEFT,
                           num_frames=self.frame_count(),
                           content_length=len(self._buf))

    def description(self) -> str:
        return "GIF"

    def duration(self) -> float:
        return 0.0  # parity: the reference reports 0 for GIFs

    def _anim_info(self) -> np.ndarray:
        if self._anim is None:
            out = np.zeros(7, np.int32)
            self._lib.lp_gif_anim_info(_u8(self._buf), self._buf.size,
                                       out.ctypes.data_as(_i32p))
            self._anim = out
        return self._anim

    def loop_count(self) -> int:
        return int(self._anim_info()[0])

    def frame_count(self) -> int:
        return int(self._anim_info()[1])

    def total_duration_ms(self) -> int:
        return int(self._anim_info()[2])

    def background_color(self) -> int:
        a = self._anim_info()
        r, g, b, al = int(a[3]), int(a[4]), int(a[5]), int(a[6])
        return (r << 16) | (g << 8) | b | (al << 24)

    def _bg_bgra(self) -> np.ndarray:
        bg = self._anim_info()[3:7]  # r, g, b, a
        return np.array([bg[2], bg[1], bg[0], bg[3]], np.uint8)

    # -- decoding ------------------------------------------------------------

    def _next_frame_meta(self) -> _FrameMeta:
        out = np.zeros(10, np.int32)
        st = self._lib.lp_gif_next_frame(self._h, out.ctypes.data_as(_i32p))
        if st == 0:
            raise EOFError()
        if st < 0:
            raise InvalidImageError("corrupt GIF frame")
        pal = np.zeros((256, 3), np.uint8)
        count = int(self._lib.lp_gif_frame_palette(self._h, _u8(pal)))
        ext = b""
        if out[9] > 0:
            eb = np.zeros(int(out[9]), np.uint8)
            self._lib.lp_gif_frame_ext(self._h, _u8(eb), eb.size)
            ext = eb.tobytes()
        return _meta(out, pal, count, ext)

    def _scanned_meta(self, i: int) -> _FrameMeta:
        """Frame meta of scanned frame i (after lp_gif_scan)."""
        out = np.zeros(10, np.int32)
        if self._lib.lp_gif_scanned_meta(self._h, i,
                                         out.ctypes.data_as(_i32p)) != 0:
            raise InvalidImageError("corrupt GIF frame")
        pal = np.zeros((256, 3), np.uint8)
        count = int(self._lib.lp_gif_scanned_palette(self._h, i, _u8(pal)))
        ext = b""
        if out[9] > 0:
            eb = np.zeros(int(out[9]), np.uint8)
            self._lib.lp_gif_scanned_ext(self._h, i, _u8(eb), eb.size)
            ext = eb.tobytes()
        return _meta(out, pal, count, ext)

    def _decode_raw_raster(self, m: _FrameMeta) -> np.ndarray:
        """Max-dimension guard + the pending frame's raster decode -> (h, w)
        palette indices; one copy shared by the first frame and the frames
        after it."""
        maxd = _gif_max_frame_dimension
        if m.width > maxd or m.height > maxd:
            raise InvalidImageError("gif frame exceeds max dimension")
        raw = np.empty(m.height * m.width, np.uint8)
        if self._lib.lp_gif_frame_indices(self._h, _u8(raw)) != 0:
            raise DecodingFailedError("gif raster decode failed")
        return raw.reshape(m.height, m.width)

    def _scatter(self, m: _FrameMeta, raw: np.ndarray):
        """Canvas-shape scatter of a decoded raster (clipping + BGRA LUT),
        shared by the streaming and batch paths."""
        cw, ch = self._w, self._hgt
        full_idx = np.zeros((ch, cw), np.uint8)
        drawn = np.zeros((ch, cw), bool)
        fl, ft, fw, fh = self._clip_rect(m.left, m.top, m.width, m.height)
        if fw > 0 and fh > 0:
            sx, sy = fl - m.left, ft - m.top
            full_idx[ft:ft + fh, fl:fl + fw] = raw[sy:sy + fh, sx:sx + fw]
            drawn[ft:ft + fh, fl:fl + fw] = True
        lut = np.zeros((256, 4), np.uint8)
        lut[:m.pal_count, 0] = m.palette[:m.pal_count, 2]  # B
        lut[:m.pal_count, 1] = m.palette[:m.pal_count, 1]  # G
        lut[:m.pal_count, 2] = m.palette[:m.pal_count, 0]  # R
        lut[:m.pal_count, 3] = 255
        return full_idx, drawn, lut, (fl, ft, fw, fh)

    def _hand_out(self, fb: Framebuffer, m: _FrameMeta) -> None:
        """The composited canvas as a fresh tensor on the decoder's
        device: a frame handed out never changes, and never shares memory
        with the decoder's next canvas."""
        fb.array = torch.from_numpy(self._canvas).to(self.device, copy=True)
        _fb_meta(fb, m)
        self.frame_meta = m

    def _end_frame(self, m: _FrameMeta, rect) -> None:
        """Partial-frame transparency forcing for the encoder
        (giflib.cpp:548-560) and the disposal state the next frame reads."""
        fl, ft, fw, fh = rect
        partial = (fw < self._w or fh < self._hgt or fl != 0 or ft != 0)
        if partial and m.trans_idx < 0:
            m.trans_idx = m.pal_count - 1
        self._prev_disposal = m.disposal
        self._prev_rect = (m.left, m.top, m.width, m.height)
        self._have_first = True

    def decode_to(self, fb: Framebuffer) -> None:
        m = self._next_frame_meta()
        if m.pal_count <= 0:
            raise DecodingFailedError("gif frame has no color map")
        bg_bgra = self._bg_bgra()
        if not self._have_first:
            self._decode_first_frame(m, bg_bgra)
            self._hand_out(fb, m)
            return

        raw = self._decode_raw_raster(m)
        full_idx, _, lut256, rect = self._scatter(m, raw)
        fl, ft, fw, fh = rect
        # copy-on-write: each frame composes a fresh canvas
        canvas = self._canvas.copy()

        # apply the PREVIOUS frame's disposal (giflib.cpp:400-489)
        pl, pt, pw, ph = self._clip_rect(*self._prev_rect)
        if pw > 0 and ph > 0:
            if self._prev_disposal == _GIF_DISPOSE_BACKGROUND:
                canvas[pt:pt + ph, pl:pl + pw] = bg_bgra
            elif self._prev_disposal == _GIF_DISPOSE_PREVIOUS:
                # giflib's prev_frame_bgra is zero-initialized and only
                # saved from the second frame on (giflib.cpp:491-494)
                canvas[pt:pt + ph, pl:pl + pw] = (
                    0 if self._prev_canvas is None else
                    self._prev_canvas[pt:pt + ph, pl:pl + pw])
        # saved after disposal, before drawing (giflib.cpp:491-494)
        self._prev_canvas = canvas.copy()

        # bounds-check via the LUT's row count (giflib.cpp:530-533)
        lut = lut256[:m.pal_count]
        if fw > 0 and fh > 0:
            sl = np.s_[ft:ft + fh, fl:fl + fw]
            idx_r = full_idx[sl].astype(np.int32)
            valid = idx_r < lut.shape[0]
            if m.trans_idx >= 0:
                valid &= idx_r != m.trans_idx
            color = lut[np.minimum(idx_r, lut.shape[0] - 1)]
            np.copyto(canvas[sl], color, where=valid[..., None])
        self._canvas = canvas
        self._end_frame(m, rect)
        self._hand_out(fb, m)

    def _decode_first_frame(self, m: _FrameMeta, bg_bgra: np.ndarray) -> None:
        """The first frame over the background (giflib.cpp:590-631): the
        background folds into a 256-row packed-u32 LUT, which out-of-palette
        and transparent indices read, so the composite is one table
        gather."""
        raw = self._decode_raw_raster(m)
        cw, ch = self._w, self._hgt
        fl, ft, fw, fh = self._clip_rect(m.left, m.top, m.width, m.height)
        bg32 = np.uint32(int(bg_bgra[0]) | (int(bg_bgra[1]) << 8)
                         | (int(bg_bgra[2]) << 16) | (int(bg_bgra[3]) << 24))
        lut32 = np.full(256, bg32, np.uint32)   # invalid indices show bg
        pc = m.pal_count
        pal = m.palette[:pc].astype(np.uint32)
        lut32[:pc] = (pal[:, 2] | (pal[:, 1] << 8) | (pal[:, 0] << 16)
                      | np.uint32(255 << 24))
        if 0 <= m.trans_idx < 256:
            lut32[m.trans_idx] = bg32           # transparent over bg = bg
        canvas32 = np.full((ch, cw), bg32, np.uint32)
        if fw > 0 and fh > 0:
            sx, sy = fl - m.left, ft - m.top
            canvas32[ft:ft + fh, fl:fl + fw] = \
                lut32[raw[sy:sy + fh, sx:sx + fw]]
        self._canvas = canvas32.view(np.uint8).reshape(ch, cw, 4)
        self._end_frame(m, (fl, ft, fw, fh))

    def _clip_rect(self, left, top, w, h):
        if left < 0:
            w += left
            left = 0
        if top < 0:
            h += top
            top = 0
        w = min(w, self._w - left)
        h = min(h, self._hgt - top)
        return left, top, max(w, 0), max(h, 0)

    def frame_header(self):
        """Metadata of the most recently decoded frame (gifDecoder.FrameHeader,
        giflib.go): the raw GIF rect and disposal code (0 unspecified /
        1 none / 2 background / 3 previous)."""
        return self.frame_meta

    def animation_inputs(self, pad_frames: int = 0,
                         workers: Optional[int] = None):
        """Host-side assembly for the batched composite: every frame's LZW
        decoded and scattered to canvas shape, without the device
        composite. Returns (inputs, metas): inputs is a dict of numpy
        arrays shaped for ops.palette.composite_animation (idxs, drawn,
        luts, counts, trans, pdisp, prects stacked over the padded frame
        axis, plus bg_bgra), the unit the cross-animation batch stacks
        over a leading animation axis. An empty animation returns
        (None, []).

        One serial container scan records every frame; the rasters
        (independent LZW streams) then decode on `workers` host threads
        (default min(4, cores)); byte-identical to the serial walk."""
        cw, ch = self._w, self._hgt
        nf = self._lib.lp_gif_scan(self._h)
        if nf < 0:
            raise InvalidImageError("corrupt GIF frame")
        smetas = [self._scanned_meta(i) for i in range(nf)]
        maxd = _gif_max_frame_dimension
        for m in smetas:
            if m.width > maxd or m.height > maxd:
                raise InvalidImageError("gif frame exceeds max dimension")

        def _dec(i: int) -> np.ndarray:
            m = smetas[i]
            raw = np.empty(m.height * m.width, np.uint8)
            if self._lib.lp_gif_decode_scanned(self._h, i, _u8(raw)) != 0:
                raise DecodingFailedError("gif raster decode failed")
            return raw.reshape(m.height, m.width)

        nw = workers if workers is not None else min(4, os.cpu_count() or 1)
        if nw > 1 and nf > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(nw, nf)) as ex:
                raws = list(ex.map(_dec, range(nf)))
        else:
            raws = [_dec(i) for i in range(nf)]
        if not raws:
            return None, []

        nb = P.frame_bucket(nf) if pad_frames == -1 else max(pad_frames, nf)
        idxs = np.zeros((nb, ch, cw), np.uint8)
        drawn = np.zeros((nb, ch, cw), bool)
        prects = np.zeros((nb, ch, cw), bool)
        luts = np.zeros((nb, 256, 4), np.uint8)
        counts = np.zeros(nb, np.int32)
        trans = np.full(nb, -1, np.int32)
        pdisp = np.zeros(nb, np.int32)
        prev_rect = None
        prev_disposal = 0
        for k, (m, raw) in enumerate(zip(smetas, raws)):
            idxs[k], drawn[k], luts[k], (fl, ft, fw, fh) = \
                self._scatter(m, raw)
            if prev_rect is not None:
                pl, pt, pw, ph = self._clip_rect(*prev_rect)
                if pw > 0 and ph > 0:
                    prects[k, pt:pt + ph, pl:pl + pw] = True
            counts[k] = m.pal_count
            trans[k] = m.trans_idx if m.trans_idx >= 0 else -1
            pdisp[k] = prev_disposal
            # partial-frame transparency forcing for the encoder (parity)
            partial = (fw < cw or fh < ch or fl != 0 or ft != 0)
            if partial and m.trans_idx < 0:
                m.trans_idx = m.pal_count - 1
            prev_rect = (m.left, m.top, m.width, m.height)
            prev_disposal = m.disposal
        inputs = dict(idxs=idxs, drawn=drawn, luts=luts, counts=counts,
                      trans=trans, pdisp=pdisp, prects=prects,
                      bg_bgra=self._bg_bgra())
        return inputs, smetas

    def decode_animation(self, pad_frames: int = 0,
                         workers: Optional[int] = None):
        """Decode ALL frames: host LZW and index scattering, then one
        device composite (ops/palette.composite_animation) on the
        decoder's device. Returns ((N, H, W, 4) u8 frames, [frame metas]).

        pad_frames > n pads the inputs with inert frames (nothing drawn, no
        disposal) up to a frame bucket, as the batch paths do; the padded
        outputs repeat the last real composite and callers slice
        [:len(metas)]. pad_frames=-1 picks ops.palette.frame_bucket(n).
        decode_to remains the frame-at-a-time streaming API."""
        inp, metas = self.animation_inputs(pad_frames, workers=workers)
        if not metas:
            return torch.zeros((0, self._hgt, self._w, 4), dtype=torch.uint8,
                               device=self.device), []
        t = {k: torch.from_numpy(v).to(self.device) for k, v in inp.items()}
        frames = P.composite_animation(
            t["idxs"], t["drawn"], t["luts"], t["counts"], t["trans"],
            t["pdisp"], t["prects"], t["bg_bgra"])
        return frames, metas

    def skip_frame(self) -> None:
        st = self._lib.lp_gif_skip_frame(self._h)
        if st == 0:
            raise EOFError()
        if st < 0:
            raise InvalidImageError("corrupt GIF frame")

    def close(self) -> None:
        if not self._closed and self._h:
            self._lib.lp_gif_free(self._h)
            self._closed = True
            self._h = None


class GifEncoder(Encoder):
    """Multi-frame GIF encoder (palette reuse from the paired decoder).
    Each frame is quantized on its own device, its indices are copied to
    the host, and the LZW runs on the host."""

    def __init__(self, decoded_by: Optional[Decoder],
                 icc_override: Optional[bytes] = None):
        if not isinstance(decoded_by, GifDecoder):
            raise InvalidImageError("GIF encoder requires a GIF decoder source")
        self._lib = binding.load()
        self._dec = decoded_by
        self._h = None
        self._prev_bgra: Optional[torch.Tensor] = None
        self._prev_disposal = 0
        self._have_first = False
        self._finished = False
        # giflib's crushed-RGB lookup cache persists while the palette stays
        # byte-identical (giflib.cpp:974-996): a seen-key table plus the
        # cached palette index per key, on the frames' device
        self._seen_keys: Optional[torch.Tensor] = None
        self._cache_idx: Optional[torch.Tensor] = None
        self._prev_palette_bytes: Optional[bytes] = None

    def _plan_frame(self, m) -> tuple:
        """Host-side quantization plan for one frame: the resolved
        transparent index (background-transparency removal,
        giflib.cpp:891-905), local-palette use, the cache-clear flag (a
        palette byte change, giflib.cpp:974-996) and the previous frame's
        validity for the transparency optimization. Advances the encoder's
        sequential state: call once per frame, in frame order. Returns
        (trans, use_local, clear, use_prev)."""
        d = self._dec
        trans = m.trans_idx
        use_local = m.local_count > 0
        bg_alpha = int(d._anim_info()[6])
        if (trans >= 0 and not use_local and d._global_count > 0
                and trans == d._bg_index and bg_alpha == 255):
            trans = -1
        pal_bytes = m.palette[:m.pal_count].tobytes()
        clear = self._prev_palette_bytes != pal_bytes
        self._prev_palette_bytes = pal_bytes
        prev_valid = self._have_first and self._prev_disposal in (0, 1)
        use_prev = bool(prev_valid and trans >= 0)
        self._prev_disposal = m.disposal
        self._have_first = True
        return trans, use_local, clear, use_prev

    def _emit_frame(self, m, idx_np: np.ndarray, width: int, height: int,
                    trans: int, use_local: bool) -> None:
        """Write one quantized frame (palette indices) through the C++ LZW
        encoder."""
        d = self._dec
        if self._h is None:
            self._h = self._lib.lp_gif_enc_new(
                width, height, d._color_res, d._aspect, d._bg_index,
                _u8(np.ascontiguousarray(
                    d._global_pal[:max(d._global_count, 1)])),
                d._global_count)
            if not self._h:
                raise DecodingFailedError("gif encoder init failed")
        mcs = 2
        while (1 << mcs) < m.pal_count:
            mcs += 1
        desc = np.array([0, 0, width, height, m.interlace, trans,
                         m.delay_cs, m.disposal, mcs], np.int32)
        ext = np.frombuffer(m.ext, np.uint8)
        rc = self._lib.lp_gif_enc_frame(
            self._h, _u8(ext) if ext.size else None, ext.size,
            desc.ctypes.data_as(_i32p),
            (_u8(np.ascontiguousarray(m.palette[:m.pal_count]))
             if use_local else None),
            m.pal_count if use_local else 0,
            _u8(idx_np))
        if rc != 0:
            raise DecodingFailedError("gif frame encode failed")

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if self._finished:
            raise DecodingFailedError("gif encoder already finished")
        if fb is None:
            return self._finish()
        m = self._dec.frame_meta
        if m is None:
            raise DecodingFailedError("gif encoder requires decoder frame state")
        trans, use_local, clear, use_prev = self._plan_frame(m)
        dev = fb.array.device
        if clear or self._seen_keys is None:
            self._seen_keys = torch.zeros(P.CACHE_SIZE, dtype=torch.bool,
                                          device=dev)
            self._cache_idx = torch.zeros(P.CACHE_SIZE, dtype=torch.uint8,
                                          device=dev)
        pal_rgb = torch.from_numpy(
            m.palette[:m.pal_count].astype(np.int32)).to(dev)
        prev = (self._prev_bgra if (use_prev and self._prev_bgra is not None)
                else torch.zeros_like(fb.array))
        idx, self._seen_keys, self._cache_idx = P.quantize_to_palette(
            fb.array, pal_rgb, prev, self._seen_keys, self._cache_idx,
            int(trans), trans >= 0, use_prev)
        idx_np = np.ascontiguousarray(idx.cpu().numpy())
        self._emit_frame(m, idx_np, fb.width, fb.height, trans, use_local)
        self._prev_bgra = fb.array
        return None  # multi-frame: ask for more

    def _finish(self) -> bytes:
        if self._h is None:
            raise DecodingFailedError("gif encoder got no frames")
        size = self._lib.lp_gif_enc_size(self._h)
        out = np.empty(size, np.uint8)
        n = self._lib.lp_gif_enc_finish(self._h, _u8(out), out.size)
        if n < 0:
            raise DecodingFailedError("gif encode finalize failed")
        self._finished = True
        return out[:n].tobytes()

    def close(self) -> None:
        if self._h:
            self._lib.lp_gif_enc_free(self._h)
            self._h = None
