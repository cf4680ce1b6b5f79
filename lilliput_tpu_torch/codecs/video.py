"""Video and audio decoder over ffmpeg, through the port's copy of the JAX
package's shim (``csrc/host/avformat_shim.cpp``, built by
``binding.load_avformat``).

The counterpart of ``lilliput_tpu/codecs/video.py``, with its behaviour
(the reference's avcodec layer, avcodec.go/avcodec.cpp): the container
probe with SAR-corrected dimensions and rotation -> orientation, the HEVC
and AV1 feature gates, the moov-atom streamability scan (a host byte
walk), codec and audio names, ICC by colour primaries, and the keyframe
index with the stateless raw keyframe decode of spritesheet workflows.

``decode_to`` splits at the device boundary. ffmpeg demuxes and decodes
on the host, and the shim exports the frame as planes (planar 8-bit
4:2:0, 4:2:2 and 4:4:4, limited or full range) or, for other pixel
formats, as BGRA through its sws_scale. On the decoder's device
("cuda" unless the caller passes device="cpu") ``frame_to_bgra`` or
``bgra_to_display`` takes those host arrays: one upload, the YUV -> BGR
matrix (``ops/color.yuv420_to_bgr``), alpha, and the LINEAR resize to
the SAR-corrected display size. Both are functions of host arrays, so
they run where ffmpeg is absent; there every demux and decode call
raises ``errors.HostLibraryMissingError``, and nothing takes another
route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import binding
from ..errors import DecodingFailedError, InvalidImageError
from ..framebuffer import (BlendMethod, DisposeMethod, Framebuffer,
                           ImageHeader, ImageOrientation)
from ..interfaces import Decoder
from ..ops import blend as B
from ..ops import color as C
from ..ops import resize as R
from ..utils import StageClock, resolve_device
from .icc import (REC601_NTSC_PROFILE, REC601_PAL_PROFILE, REC2020_PROFILE,
                  SRGB_PROFILE)

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


class _AvInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("orientation", ctypes.c_int32),
        ("video_codec", ctypes.c_int32), ("audio_codec", ctypes.c_int32),
        ("has_video", ctypes.c_int32), ("has_audio", ctypes.c_int32),
        ("has_subtitles", ctypes.c_int32),
        ("duration_us", ctypes.c_int64),
        ("colorspace", ctypes.c_int32), ("color_range", ctypes.c_int32),
        ("pix_fmt", ctypes.c_int32), ("frame_count_estimate", ctypes.c_int32),
        ("color_primaries", ctypes.c_int32),
    ]


_VIDEO_NAMES = {0: "Unknown", 1: "H264", 2: "HEVC", 3: "AV1", 4: "VP8",
                5: "VP9", 6: "MPEG4"}
_AUDIO_NAMES = {0: "Unknown", 1: "AAC", 2: "MP3", 3: "FLAC", 4: "Vorbis",
                5: "Opus"}

# feature gates (parity with the reference's Go linker flags, avcodec.go:14-22)
_hevc_enabled = False
_av1_enabled = False

# AVPixelFormat values converted on the device (planar 8-bit YUV)
_PLANAR_YUV = {0: (2, 2), 4: (2, 1), 5: (1, 1),    # yuv420p, yuv422p, yuv444p
               12: (2, 2), 13: (2, 1), 14: (1, 1)}  # yuvj*
_FULL_RANGE_FMTS = {12, 13, 14}


def set_hevc_enabled(v: bool) -> None:
    global _hevc_enabled
    _hevc_enabled = v


def set_av1_enabled(v: bool) -> None:
    global _av1_enabled
    _av1_enabled = v


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def is_streamable_mp4(buf: bytes) -> bool:
    """Exact mirror of avcodec_decoder_is_streamable
    (avcodec.cpp:209-245): walk top-level atoms whose HEADERS sit in the
    first 32 KB, validating each atom size against the WHOLE buffer
    before looking at its type; 'moov' first -> streamable, 'mdat'
    first -> not, anything invalid/absent -> not. The reference runs
    this scan on EVERY input (no ftyp gate, no 64-bit atom sizes), so
    WebM/MP3/etc. report not-streamable via the no-moov fallthrough."""
    n = len(buf)
    peek = min(n, 32 * 1024)
    pos = 0
    while pos + 8 <= peek:
        size = int.from_bytes(buf[pos:pos + 4], "big")
        if size < 8 or size + pos > n:
            break
        typ = buf[pos + 4:pos + 8]
        if typ == b"moov":
            return True
        if typ == b"mdat":
            return False
        pos += size
    return False


def _to_display(arr: torch.Tensor, display_w: int,
                display_h: int) -> torch.Tensor:
    """Anamorphic content scaled to its SAR-corrected display size with the
    fixed-point LINEAR resize (the reference folds this into its sws_scale
    pass, avcodec.cpp:37-111)."""
    if (arr.shape[1], arr.shape[0]) != (display_w, display_h):
        arr = R.resize(arr, display_w, display_h, R.LINEAR)
    return arr


def frame_to_bgra(y: np.ndarray, u: np.ndarray, v: np.ndarray, *, spc: int,
                  rng: int, fmt: int, display_w: int, display_h: int,
                  device,
                  stage_times: Optional[Dict[str, List[float]]] = None
                  ) -> torch.Tensor:
    """The device half of a planar frame's decode: host u8 planes (Y at
    the coded size, U and V at the chroma size of 4:2:0, 4:2:2 or 4:4:4)
    -> (display_h, display_w, 4) BGRA u8 on `device`. One upload, then
    yuv420_to_bgr with the stream's AVCOL_SPC matrix (bt601 when
    unlisted), full range for AVCOL_RANGE_JPEG (2) and the yuvj formats,
    alpha 255, and the LINEAR resize to the display size where it
    differs. stage_times, when a dict, gets the ms of "h2d" and
    "device_convert" (CUDA events on a card)."""
    dev = resolve_device(device)
    clock = StageClock(stage_times, dev)
    with clock("h2d", device=True):
        yt, ut, vt = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                      for p in (y, u, v))
    with clock("device_convert", device=True):
        fh, fw = y.shape
        bgr = C.yuv420_to_bgr(yt, ut, vt, space=C.AVCOL_SPC.get(spc, "bt601"),
                              full_range=rng == 2 or fmt in _FULL_RANGE_FMTS,
                              out_h=fh, out_w=fw)
        out = _to_display(B.to_bgra(bgr), display_w, display_h)
    return out


def bgra_to_display(px: np.ndarray, *, display_w: int, display_h: int,
                    device,
                    stage_times: Optional[Dict[str, List[float]]] = None
                    ) -> torch.Tensor:
    """The device half of a frame the shim converted to BGRA on the host
    (pixel formats other than planar 8-bit YUV): one upload, then the
    LINEAR resize to the display size where it differs. stage_times as
    in frame_to_bgra."""
    dev = resolve_device(device)
    clock = StageClock(stage_times, dev)
    with clock("h2d", device=True):
        t = torch.from_numpy(np.ascontiguousarray(px)).to(dev)
    with clock("device_convert", device=True):
        out = _to_display(t, display_w, display_h)
    return out


class VideoDecoder(Decoder):
    def __init__(self, buf: bytes, device="cuda"):
        self._h = None
        self._closed = True
        self.device = resolve_device(device)
        self._lib = binding.load_avformat()
        self._raw = buf
        # the shim reads the container through this array: keep it alive
        self._buf = np.frombuffer(buf, np.uint8)
        self._h = self._lib.lp_av_open(_u8(self._buf), self._buf.size,
                                       1 if _hevc_enabled else 0,
                                       1 if _av1_enabled else 0)
        if not self._h:
            raise InvalidImageError("unsupported media container/codec")
        self._info = _AvInfo()
        self._lib.lp_av_get_info(self._h, ctypes.byref(self._info))
        self._closed = False

    # -- metadata --------------------------------------------------------

    def header(self) -> ImageHeader:
        i = self._info
        return ImageHeader(
            width=int(i.width), height=int(i.height), channels=4,
            orientation=ImageOrientation(int(i.orientation)),
            num_frames=1, content_length=len(self._raw))

    def description(self) -> str:
        """Container name (avcodec.cpp:473-499 mapping; MOV with an mp4
        ftyp brand reports MP4, avcodec.go:77-86)."""
        buf = ctypes.create_string_buffer(64)
        self._lib.lp_av_format_name(self._h, buf, 64)
        name = buf.value.decode()
        if name.startswith("mov"):
            return "MP4" if self._raw[4:8] == b"ftyp" else "MOV"
        for key, label in (("matroska", "WEBM"), ("mp3", "MP3"),
                           ("flac", "FLAC"), ("wav", "WAV"), ("aac", "AAC"),
                           ("ogg", "OGG")):
            if key in name:
                return label
        return name.upper() or "Unknown"

    def duration(self) -> float:
        return self._info.duration_us / 1e6

    def video_codec(self) -> str:
        return _VIDEO_NAMES.get(int(self._info.video_codec), "Unknown")

    def audio_codec(self) -> str:
        return _AUDIO_NAMES.get(int(self._info.audio_codec), "Unknown")

    def has_subtitles(self) -> bool:
        return bool(self._info.has_subtitles)

    def is_streamable(self) -> bool:
        # the reference probes EVERY container with the atom scan
        # (avcodec.go:93-95 -> avcodec.cpp:209)
        return is_streamable_mp4(self._raw)

    def icc(self) -> bytes:
        """Embedded profile by color primaries (avcodec.cpp:353-370)."""
        if not self._info.has_video:
            return b""
        pri = int(self._info.color_primaries)
        if pri == 9:    # AVCOL_PRI_BT2020
            return REC2020_PROFILE
        if pri == 5:    # AVCOL_PRI_BT470BG (601 PAL)
            return REC601_PAL_PROFILE
        if pri == 6:    # AVCOL_PRI_SMPTE170M (601 NTSC)
            return REC601_NTSC_PROFILE
        return SRGB_PROFILE

    # -- decoding ---------------------------------------------------------

    def next_frame(self):
        """The next frame on the host: ("planes", (y, u, v), (spc, rng,
        fmt)) for planar 8-bit YUV, else ("bgra", px, None), px the shim's
        (h, w, 4) sws_scale output. Raises EOFError after the last frame."""
        if not self._info.has_video:
            raise DecodingFailedError("no video stream")
        st = self._lib.lp_av_decode_frame(self._h)
        if st == 0:
            raise EOFError()
        if st < 0:
            raise DecodingFailedError(f"video decode failed ({st})")
        finfo = np.zeros(8, np.int32)
        self._lib.lp_av_frame_info(self._h, finfo.ctypes.data_as(_i32p))
        fw, fh, fmt, spc, rng, _planes, cw, ch = (int(v) for v in finfo)
        if fmt in _PLANAR_YUV:
            y = np.empty((fh, fw), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty((ch, cw), np.uint8)
            if (self._lib.lp_av_frame_plane(self._h, 0, _u8(y), fw, fh) != 0
                    or self._lib.lp_av_frame_plane(self._h, 1, _u8(u), cw,
                                                   ch) != 0
                    or self._lib.lp_av_frame_plane(self._h, 2, _u8(v), cw,
                                                   ch) != 0):
                raise DecodingFailedError("frame plane export failed")
            return "planes", (y, u, v), (spc, rng, fmt)
        px = np.empty((fh, fw, 4), np.uint8)
        if self._lib.lp_av_frame_bgra(self._h, _u8(px), fw, fh) != 0:
            raise DecodingFailedError("frame conversion failed")
        return "bgra", px, None

    def decode_to(self, fb: Framebuffer) -> None:
        kind, data, fmt = self.next_frame()
        # the header's size: SAR-corrected
        dw, dh = int(self._info.width), int(self._info.height)
        if kind == "planes":
            spc, rng, pix = fmt
            arr = frame_to_bgra(*data, spc=spc, rng=rng, fmt=pix,
                                display_w=dw, display_h=dh,
                                device=self.device)
        else:
            arr = bgra_to_display(data, display_w=dw, display_h=dh,
                                  device=self.device)
        fb.array = arr
        fb.duration = 0.0
        fb.x_offset = fb.y_offset = 0
        fb.blend = BlendMethod.NO_BLEND
        fb.dispose = DisposeMethod.DISPOSE_TO_BACKGROUND_COLOR

    # -- spritesheet API (avcodec.go:203-302) -------------------------------

    def keyframes(self) -> List[Tuple[int, int, int]]:
        """(pts_us, byte_offset, byte_size) per keyframe."""
        cap = 4096
        out = np.zeros(cap * 3, np.int64)
        n = self._lib.lp_av_keyframes(self._h, out.ctypes.data_as(_i64p), cap)
        if n < 0:
            raise DecodingFailedError("no keyframe index")
        if n > cap:
            # the shim reports the true count; re-call with a buffer that
            # holds the whole index instead of truncating it
            cap = n
            out = np.zeros(cap * 3, np.int64)
            n = self._lib.lp_av_keyframes(self._h, out.ctypes.data_as(_i64p),
                                          cap)
            if n < 0:
                raise DecodingFailedError("no keyframe index")
        n = min(n, cap)
        return [(int(out[i * 3]), int(out[i * 3 + 1]), int(out[i * 3 + 2]))
                for i in range(n)]

    def codec_params(self) -> Tuple[int, bytes]:
        codec_id = ctypes.c_int32(0)
        extradata = np.zeros(10240, np.uint8)
        n = self._lib.lp_av_codec_params(self._h, ctypes.byref(codec_id),
                                         _u8(extradata), extradata.size)
        if n < 0:
            raise DecodingFailedError("extradata too large")
        return int(codec_id.value), extradata[:n].tobytes()

    def close(self) -> None:
        if not self._closed and self._h:
            self._lib.lp_av_free(self._h)
            self._closed = True
            self._h = None

    def __del__(self):
        self.close()


def decode_raw_keyframe(codec_id: int, extradata: bytes, packet: bytes,
                        width: int, height: int,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stateless single-keyframe decode -> (H, W, 4) BGRA on the host,
    into `out` when given (a C-contiguous (height, width, 4) u8 array).
    Thread-safe (a fresh codec context per call, avcodec.cpp:774-873)."""
    lib = binding.load_avformat()
    ed = (np.frombuffer(extradata, np.uint8) if extradata
          else np.zeros(0, np.uint8))
    pk = np.frombuffer(packet, np.uint8)
    if out is None:
        out = np.empty((height, width, 4), np.uint8)
    elif (out.shape != (height, width, 4) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous ({height}, {width}, 4) "
                         f"u8 array, got {out.shape}")
    rc = lib.lp_av_decode_raw_keyframe(
        codec_id, _u8(ed) if ed.size else None, ed.size,
        _u8(pk), pk.size, _u8(out), width, height)
    if rc != 0:
        raise DecodingFailedError(f"raw keyframe decode failed ({rc})")
    return out
