"""AVIF codec: the counterpart of ``lilliput_tpu/codecs/avif.py``.

Decode walks the ISOBMFF boxes in Python (codecs/av1_raw.py), decodes the
AV1 payloads through dav1d (the ffmpeg shim, ``binding.load_avformat``)
and converts them: SDR on the host, bit-identical to PIL/libavif at every
depth (codecs/yuv_rgb.planes_to_bgr_u8), the frame then a tensor on the
decoder's device; HDR sources with tone mapping take the full-precision
device route (``hdr_planes_to_bgr``: one upload of the native-depth
planes, then YUV -> R'G'B', PQ/HLG linearization, primaries to BT.709,
Reinhard and sRGB as torch ops, ops/color.py). Encode is libaom through
the same shim and the port's muxer (codecs/avif_enc.py). Capability
parity with the reference's avif.cpp/avif.go: still and animated (avis)
decode, per-frame durations (stts), loop counts (infinite or unknown ->
0, avif.cpp:401-413), ICC extraction with the Rec709 profile substituted
for tone-mapped HDR output (avif.cpp:415-427), CICP-based HDR detection
(PQ = 16, HLG = 18 in colr/nclx), clean-aperture offsets, and the quality
and speed encode options on the ms timescale.

Where ffmpeg's headers are absent (``binding.AVFORMAT_HEADER``) the AV1
decode and encode raise ``errors.HostLibraryMissingError``; that is not a
decline and nothing takes another route. PIL (imported lazily) serves
what the JAX package gives it: ``LILLIPUT_AVIF=pil``, the corners the
native route declines (limited-range YCgCo, mixed-depth alpha, a stream
dav1d refuses), the header of a file the walk cannot read, and a failed
native encode. Where that route is due and PIL or its AVIF plugin is
absent, it raises HostLibraryMissingError naming PIL. Only host steps sit
inside a ``try``: a failed device step raises, and never yields PIL's
8-bit frame instead.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import (DecodingFailedError, HostLibraryMissingError,
                      InvalidImageError)
from ..framebuffer import (AVIF_QUALITY, AVIF_SPEED, BlendMethod,
                           DisposeMethod, Framebuffer, ImageHeader,
                           ImageOrientation)
from ..interfaces import Decoder, Encoder, check_encode_options
from ..ops import color as COLOR
from ..utils import StageClock, resolve_device
from . import av1_raw as AR
from .icc import REC709_PROFILE

_AVIF_ENCODE_KEYS = frozenset({AVIF_QUALITY, AVIF_SPEED})

CICP_TRANSFER_PQ = 16
CICP_TRANSFER_HLG = 18

# cap on per-frame timing entries expanded from stts (DoS hardening)
_MAX_TIMING_SAMPLES = 1 << 16

# CICP colour primaries -> the tone map's source primaries
_PRIMARIES = {9: "bt2020", 12: "p3", 1: "bt709"}


def _pil_image():
    """PIL's Image module with its AVIF plugin, for the PIL route; raises
    HostLibraryMissingError where either is absent."""
    try:
        from PIL import Image, features
    except ImportError as e:
        raise HostLibraryMissingError(
            "PIL is not installed on this machine: the AVIF route it serves "
            "(LILLIPUT_AVIF=pil, streams the native route declines, a "
            "failed native encode) needs PIL with its AVIF plugin") from e
    if not features.check("avif"):
        raise HostLibraryMissingError(
            "PIL on this machine has no AVIF plugin: the AVIF route it "
            "serves (LILLIPUT_AVIF=pil, streams the native route declines, "
            "a failed native encode) needs it")
    return Image


# ---------------------------------------------------------------------------
# ISOBMFF helpers (host): timing + CICP
# ---------------------------------------------------------------------------

def _find_box(buf: bytes, path: List[bytes], start=0, end=None):
    end = len(buf) if end is None else end
    if not path:
        return start, end
    for typ, s, e in AR._iter_boxes(buf, start, end):
        if typ == path[0]:
            # fullbox children for some containers handled by caller offsets
            r = _find_box(buf, path[1:], s, e)
            if r:
                return r
    return None


def parse_avis_timing(buf: bytes) -> Tuple[List[float], int]:
    """Per-frame durations (seconds) from the pict track's stts; loop count
    (0 = infinite/unknown, parity with avif.cpp:401-413)."""
    moov = _find_box(buf, [b"moov"])
    if not moov:
        return [], 0
    ms, me = moov
    durations: List[float] = []
    for typ, s, e in AR._iter_boxes(buf, ms, me):
        if typ != b"trak":
            continue
        mdia = _find_box(buf, [b"mdia"], s, e)
        if not mdia:
            continue
        timescale = 1000
        mdhd = _find_box(buf, [b"mdhd"], *mdia)
        if mdhd:
            v = buf[mdhd[0]]
            timescale = int.from_bytes(
                buf[mdhd[0] + (20 if v == 1 else 12):
                    mdhd[0] + (24 if v == 1 else 16)], "big") or 1000
        stts = _find_box(buf, [b"minf", b"stbl", b"stts"], *mdia)
        if not stts:
            continue
        s0 = stts[0] + 4  # version/flags
        if s0 + 4 > stts[1]:
            continue
        (count,) = struct.unpack(">I", buf[s0:s0 + 4])
        # entries must live inside the stts box (truncation guard), and the
        # expanded list is capped: sample_count fields are attacker-
        # controlled u32s that would otherwise size a multi-GB Python list
        count = min(count, (stts[1] - s0 - 4) // 8)
        ds: List[float] = []
        for i in range(count):
            if len(ds) >= _MAX_TIMING_SAMPLES:
                break  # cap reached — stop expanding
            off = s0 + 4 + i * 8
            n, delta = struct.unpack(">II", buf[off:off + 8])
            n = min(n, _MAX_TIMING_SAMPLES - len(ds))
            if n > 0:
                # a file-supplied zero sample_count entry extends nothing
                # but must NOT abort the remaining entries
                ds.extend([delta / timescale] * n)
        if len(ds) > len(durations):
            durations = ds
    return durations, 0


def parse_cicp(buf: bytes) -> Optional[Tuple[int, int, int, int]]:
    """(primaries, transfer, matrix, full_range) of the image's colr/nclx.

    Stills: the PRIMARY item's ipma-associated colr property (an alpha
    item's colr or stray mdat bytes can never be picked up). Animated /
    fallback: a search scoped to the moov (sample entry) or meta box —
    never the whole buffer, which includes entropy-coded mdat payload."""
    payload = None
    # animated (avis): the pict track's sample-entry colr governs playback,
    # so a moov-scoped hit wins over any still cover item's property
    moov = _find_box(buf, [b"moov"])
    if moov:
        # scope the search to the COLOR track's stsd sample entry: a raw
        # moov-wide scan can pick up an alpha/aux track's colr first, or
        # coincidental bytes in an unrelated box payload
        for typ, s, e in AR._iter_boxes(buf, *moov):
            if typ != b"trak":
                continue
            mdia = _find_box(buf, [b"mdia"], s, e)
            if not mdia:
                continue
            hdlr = _find_box(buf, [b"hdlr"], *mdia)
            # hdlr payload: version/flags(4) pre_defined(4) handler(4)
            if (not hdlr or hdlr[1] - hdlr[0] < 12
                    or buf[hdlr[0] + 8:hdlr[0] + 12] != b"pict"):
                continue
            # an alpha track references the color track via tref/auxl —
            # skip it; the color track carries no tref
            tref = _find_box(buf, [b"tref"], s, e)
            if tref and b"auxl" in buf[tref[0]:tref[1]]:
                continue
            stsd = _find_box(buf, [b"minf", b"stbl", b"stsd"], *mdia)
            if not stsd:
                continue
            idx = buf.find(b"colrnclx", stsd[0], stsd[1])
            if idx != -1 and idx + 15 <= stsd[1]:
                payload = buf[idx + 4:idx + 15]
                break
        if payload is None:
            # fallback: the original moov-scoped scan (hand-rolled or
            # truncated files whose trak walk fails)
            idx = buf.find(b"colrnclx", moov[0], moov[1])
            if idx != -1 and idx + 15 <= moov[1]:
                payload = buf[idx + 4:idx + 15]
    still_parsed = False
    if payload is None:
        try:
            si = AR.parse_still_items(buf)
            if si is not None:
                still_parsed = True
                payload = si.nclx
        except Exception:
            still_parsed = False
    if payload is None and not still_parsed:
        # substring fallback ONLY when the item walk could not parse the
        # meta box at all — if it parsed and found no primary-item colr,
        # searching ipco raw would misattribute an alpha item's nclx
        box = _find_box(buf, [b"meta"])
        if box:
            idx = buf.find(b"colrnclx", box[0], box[1])
            if idx != -1 and idx + 15 <= box[1]:
                payload = buf[idx + 4:idx + 15]
    if payload is None or len(payload) < 11:
        return None
    p, t, m = struct.unpack(">HHH", payload[4:10])
    fr = (payload[10] >> 7) & 1
    return (p, t, m, fr)


def _cicp_is_hdr(cicp) -> bool:
    return cicp is not None and cicp[1] in (CICP_TRANSFER_PQ,
                                            CICP_TRANSFER_HLG)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _av1c_depth(av1c: bytes) -> int:
    """Coded bit depth from the av1C config record (byte 2:
    seq_tier(1) high_bitdepth(1) twelve_bit(1) ...)."""
    if len(av1c) < 3:
        return 8
    b = av1c[2]
    if not (b & 0x40):
        return 8
    return 12 if (b & 0x20) else 10


def _avif_native_default() -> bool:
    """The own decode route (ISOBMFF walk + dav1d + libyuv-exact
    conversion) is the default; LILLIPUT_AVIF=pil takes PIL/libavif."""
    import os
    return os.environ.get("LILLIPUT_AVIF", "native").lower() != "pil"


def _upload_planes(planes, device) -> List[torch.Tensor]:
    """u8/u16 host planes -> int32 tensors on `device` in one H2D: the
    planes packed into one u16 buffer, moved as int16 (a dtype every
    torch build copies) and widened back to 0..65535 there."""
    flat = np.concatenate([np.ascontiguousarray(p, np.uint16).ravel()
                           for p in planes])
    dev = torch.from_numpy(flat.view(np.int16)).to(device)
    dev = dev.to(torch.int32) & 0xFFFF
    out, pos = [], 0
    for p in planes:
        out.append(dev[pos:pos + p.size].reshape(p.shape))
        pos += p.size
    return out


def _header_or_box(header: int, unspecified, cicp, i: int,
                   default: int) -> int:
    """A colour value of the AV1 sequence header, unless it is one of
    `unspecified` (2 is what libaom writes by default); then the colr
    box's (cicp[i]), else `default`. The JAX package takes any header
    value above 0, so 2 overrides the box there (ROADMAP queue 3 entry
    20)."""
    if header not in unspecified:
        return header
    return cicp[i] if cicp else default


def hdr_planes_to_bgr(rp: AR.RawPlanes, ap: Optional[AR.RawPlanes],
                      h: int, w: int,
                      cicp: Optional[Tuple[int, int, int, int]],
                      device,
                      stage_times: Optional[Dict[str, List[float]]] = None
                      ) -> torch.Tensor:
    """The device half of the HDR decode (the JAX package's
    AvifDecoder._decode_raw_hdr after its host half): native-depth AV1
    planes (and the alpha item's or track's) -> (h, w, 3|4) BGR(A) u8 on
    `device`. One H2D of the planes, then YUV -> normalized R'G'B'
    (ops/color.yuv_to_rgb_norm; CICP identity takes the planes as G, B,
    R), hdr_to_sdr, BGR order, and the alpha plane rescaled to u8. The
    matrix, transfer and primaries come from the sequence header where it
    specifies them, else from the colr box; the range from the header,
    which always codes it.
    stage_times, when a dict, gets the ms of "h2d" and "device_convert"
    (CUDA events on a card)."""
    dev = resolve_device(device)
    clock = StageClock(stage_times, dev)
    planes = [rp.y]
    if rp.u is not None and rp.v is not None:
        planes += [rp.u, rp.v]
    if ap is not None and ap.y is not None:
        planes.append(ap.y)
    with clock("h2d", device=True):
        up = _upload_planes(planes, dev)
    with clock("device_convert", device=True):
        y = up[0]
        if rp.u is not None and rp.v is not None:
            u, v = up[1], up[2]
        else:
            u = v = torch.full(tuple(rp.y.shape), 1 << (rp.depth - 1),
                               dtype=torch.int32, device=dev)
        matrix = _header_or_box(rp.matrix, (2,), cicp, 2, 2)
        if matrix == 0 and rp.u is not None:
            # CICP identity: the planes are G, B, R (AVCOL_SPC maps 0 onto
            # bt709 for video's untagged streams, wrong for AVIF)
            step = float(1 << (rp.depth - 8))
            maxv = float((1 << rp.depth) - 1)
            bias, rng = (0.0, maxv) if rp.full_range else (16.0 * step,
                                                           219.0 * step)

            def norm(p):
                return torch.clamp((p[..., :h, :w].to(torch.float32) - bias)
                                   / rng, 0.0, 1.0)
            rgb = torch.stack([norm(v), norm(y), norm(u)], dim=-1)
        else:
            rgb = COLOR.yuv_to_rgb_norm(
                y, u, v, space=COLOR.AVCOL_SPC.get(matrix, "bt2020"),
                full_range=rp.full_range, depth=rp.depth, out_h=h, out_w=w)
        primaries = _PRIMARIES.get(
            _header_or_box(rp.primaries, (0, 2), cicp, 0, 9), "bt2020")
        trc = _header_or_box(rp.trc, (0, 2), cicp, 1, 16)
        transfer = "pq" if trc == CICP_TRANSFER_PQ else "hlg"
        bgr = COLOR.hdr_to_sdr(rgb, transfer=transfer,
                               primaries=primaries).flip(-1)
        if ap is not None and ap.y is not None:
            maxv = float((1 << ap.depth) - 1)
            a = torch.clamp(torch.round(
                up[-1][..., :h, :w].to(torch.float32)
                * float(np.float32(255.0 / maxv))), 0, 255).to(torch.uint8)
            bgr = torch.cat([bgr, a[..., None]], dim=-1)
    return bgr


class AvifDecoder(Decoder):
    """AVIF decode on the port's own stack by default: the ISOBMFF item
    and track walk (av1_raw.py) -> dav1d through the ffmpeg shim -> the
    libyuv-exact YUV -> BGR conversion (yuv_rgb.py) on the host for SDR,
    or the device tone map (hdr_planes_to_bgr) for HDR. Frames are tensors
    on `device` ("cuda" unless the caller passes device="cpu"). SDR
    converts at every depth and every matrix libavif converts, YCgCo and
    chromaticity-derived NCL included; the corners it declines
    (limited-range YCgCo, ICtCp, mixed-depth alpha) fail in PIL/libavif
    too, so the PIL route keeps the JAX package's results and errors."""

    def __init__(self, buf: bytes, tone_mapping_enabled: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self._raw = buf
        self._tone_map = tone_mapping_enabled
        self._cicp = parse_cicp(buf)
        self._is_hdr = _cicp_is_hdr(self._cicp)
        self._durations, _ = parse_avis_timing(buf)
        self._next = 0
        self._im = None          # PIL handle, made on the PIL route only

        self._loops = AR.parse_loop_count(buf)
        self._clap_off = (0, 0)
        self._still_items = None
        self._tracks = None
        try:
            self._still_items = AR.parse_still_items(buf)
        except Exception:
            self._still_items = None
        try:
            self._tracks = AR.parse_tracks(buf)
        except Exception:
            self._tracks = None
        if self._still_items and self._still_items.clap:
            c = self._still_items.clap
            # int(horizOffN / horizOffD): C truncation (avif.cpp:500-522)
            if c[5] and c[7]:
                self._clap_off = (int(c[4] / c[5]), int(c[6] / c[7]))

        # geometry and frame count from the own walk; PIL only if it failed
        self._native_meta = False
        if self._tracks is not None:
            color, alpha = self._tracks
            self._frames = len(color.samples)
            self._w, self._h = color.width, color.height
            self._has_alpha = alpha is not None
            self._depth = _av1c_depth(color.av1c)
            self._native_meta = self._w > 0 and self._h > 0
        elif self._still_items is not None and self._still_items.ispe:
            self._frames = 1
            self._w, self._h = self._still_items.ispe
            self._has_alpha = self._still_items.alpha_data is not None
            self._depth = _av1c_depth(self._still_items.color_av1c)
            self._native_meta = self._w > 0 and self._h > 0
        if not self._native_meta or not _avif_native_default():
            im = self._pil()     # raises InvalidImageError if unparseable
            self._frames = getattr(im, "n_frames", 1)
            self._w, self._h = im.size
            self._has_alpha = im.mode in ("RGBA", "LA", "PA")
            self._depth = 8

        # full-precision HDR route (device tone map on native-depth planes)
        self._use_raw = False
        if self._tone_map and self._is_hdr:
            self._use_raw = (
                (self._tracks is not None and self._tracks[0].av1c != b"")
                or (self._still_items is not None
                    and bool(self._still_items.color_av1c)))
        # incremental animated stream decoders (made on the first frame)
        self._cdec = self._adec = None
        self._cfifo: list = []
        self._afifo: list = []
        self._fed = 0
        # latched when the native stream can no longer be trusted to be
        # frame-synchronized with self._next (a feed raised mid-loop, or
        # the alpha track ran dry while colour frames remain): every later
        # frame takes the PIL route, whose seek() is absolute
        self._stream_dead = False

    def _pil(self):
        """The lazy PIL handle of the PIL route."""
        if self._im is None:
            image = _pil_image()
            try:
                self._im = image.open(io.BytesIO(self._raw))
                self._im.load()
            except Exception as e:
                raise InvalidImageError(f"not a valid AVIF: {e}") from e
        return self._im

    def header(self) -> ImageHeader:
        orientation = ImageOrientation.TOP_LEFT
        exif = self._still_items.exif if self._still_items else b""
        if exif:
            from .jpeg import _parse_tiff_orientation
            try:
                o = _parse_tiff_orientation(exif)
                if 1 <= o <= 8:
                    orientation = ImageOrientation(o)
            except Exception:
                pass
        elif self._im is not None:
            try:
                o = self._im.getexif().get(0x0112)
                if o and 1 <= int(o) <= 8:
                    orientation = ImageOrientation(int(o))
            except Exception:
                pass
        return ImageHeader(width=self._w, height=self._h,
                           channels=4 if self._has_alpha else 3,
                           orientation=orientation,
                           num_frames=self._frames,
                           content_length=len(self._raw))

    def description(self) -> str:
        return "AVIF"

    def duration(self) -> float:
        return float(sum(self._durations))

    def loop_count(self) -> int:
        return self._loops

    def icc(self) -> bytes:
        # the Rec709 profile for tone-mapped HDR output (avif.cpp:415-427)
        if self._tone_map and self._is_hdr:
            return REC709_PROFILE
        if self._still_items is not None and self._still_items.icc:
            return self._still_items.icc
        if self._tracks is not None and self._tracks[0].icc:
            return self._tracks[0].icc
        if self._native_meta and _avif_native_default():
            return b""
        return self._pil().info.get("icc_profile", b"") or b""

    def _next_planes(self):
        """(colour RawPlanes, alpha RawPlanes or None) of frame self._next,
        on the host. Stills decode their items statelessly; animations
        feed the stateful stream decoders in order (samples are
        inter-coded). A missing ffmpeg raises HostLibraryMissingError."""
        if self._frames > 1 and self._tracks is not None:
            if self._stream_dead:
                return None, None
            color, alpha = self._tracks
            if self._next >= len(color.samples):
                return None, None
            try:
                if self._cdec is None:
                    self._cdec = AR.Av1StreamDecoder(color.av1c)
                    if alpha is not None:
                        self._adec = AR.Av1StreamDecoder(alpha.av1c)
                while not self._cfifo or (self._adec and not self._afifo):
                    if self._fed < len(color.samples):
                        self._cfifo.extend(self._cdec.feed(
                            color.samples[self._fed]))
                        if self._adec is not None:
                            self._afifo.extend(self._adec.feed(
                                alpha.samples[self._fed]
                                if self._fed < len(alpha.samples) else None))
                        self._fed += 1
                    else:
                        self._cfifo.extend(self._cdec.feed(None))
                        if self._adec is not None:
                            self._afifo.extend(self._adec.feed(None))
                        if not self._cfifo:
                            self._stream_dead = True
                            return None, None
                        break
            except HostLibraryMissingError:
                raise
            except Exception:
                # a feed raised after sibling feeds may have extended a
                # FIFO: frame/position sync is unprovable from here on
                self._stream_dead = True
                return None, None
            if self._adec is not None and not self._afifo:
                # the alpha track ran dry while colour frames remain
                self._stream_dead = True
                return None, None
            return (self._cfifo.pop(0),
                    self._afifo.pop(0) if self._afifo else None)
        if self._still_items:
            rp = AR.decode_av1_planes(self._still_items.color_av1c,
                                      self._still_items.color_data)
            ap = None
            if rp is not None and self._still_items.alpha_data is not None:
                ap = AR.decode_av1_planes(
                    self._still_items.alpha_av1c or b"",
                    self._still_items.alpha_data)
            return rp, ap
        return None, None

    def _decode_native_sdr(self) -> Optional[np.ndarray]:
        """The own SDR route on the host: dav1d planes -> libavif-exact
        BGR(A) u8 (yuv_rgb.planes_to_bgr_u8) at every depth; None where it
        declines (a mixed-depth alpha item, an exotic matrix)."""
        from .yuv_rgb import planes_to_bgr_u8
        rp, ap = self._next_planes()
        if rp is None:
            return None
        if ap is not None and ap.y is None:
            return None
        # the colr/nclx box governs (libavif's priority), the sequence
        # header's values are the fallback; primaries drives matrix 12's
        # family mapping and kr/kb derivation
        if self._cicp:
            primaries, _, matrix, full_range = self._cicp
            if primaries <= 0:
                primaries = rp.primaries if rp.primaries > 0 else 2
        else:
            primaries = rp.primaries if rp.primaries > 0 else 2
            matrix, full_range = rp.matrix, rp.full_range
        return planes_to_bgr_u8(
            rp.y, rp.u, rp.v, rp.depth, matrix, full_range,
            self._h, self._w,
            alpha=ap.y if ap is not None else None,
            alpha_depth=ap.depth if ap is not None else None,
            primaries=primaries)

    def _host_step(self, fn):
        """A host step of the native route; None where it declines or
        fails (the PIL route then takes the frame), but a missing ffmpeg
        raises."""
        try:
            return fn()
        except HostLibraryMissingError:
            raise
        except Exception:
            return None

    def decode_to(self, fb: Framebuffer) -> None:
        if self._next >= self._frames:
            raise EOFError()
        px = None
        if _avif_native_default():
            if self._use_raw:
                rp, ap = self._host_step(self._next_planes) or (None, None)
                if rp is not None:
                    px = hdr_planes_to_bgr(rp, ap, self._h, self._w,
                                           self._cicp, self.device)
            elif not (self._tone_map and self._is_hdr):
                host = self._host_step(self._decode_native_sdr)
                if host is not None:
                    px = torch.from_numpy(host).to(self.device)
        if px is None:
            px = self._pil_frame()
        fb.array = px
        if self._next < len(self._durations):
            fb.duration = self._durations[self._next]
        else:
            fb.duration = 0.0
        # clean-aperture offsets (avif.cpp:500-522)
        fb.x_offset, fb.y_offset = self._clap_off
        fb.blend = BlendMethod.NO_BLEND          # avis frames are full canvas
        fb.dispose = DisposeMethod.NO_DISPOSE
        self._next += 1

    def _pil_frame(self) -> torch.Tensor:
        """Frame self._next through PIL/libavif, on the decoder's device;
        an HDR source with tone mapping is tone-mapped from PIL's 8-bit
        coded signal there."""
        im = self._pil()
        im.seek(self._next)
        mode = "RGBA" if im.mode in ("RGBA", "LA", "PA") else "RGB"
        arr = np.asarray(im.convert(mode))
        ch = 4 if mode == "RGBA" else 3
        bgr = np.empty(arr.shape[:-1] + (ch,), np.uint8)
        bgr[..., 0] = arr[..., 2]
        bgr[..., 1] = arr[..., 1]
        bgr[..., 2] = arr[..., 0]
        if ch == 4:
            bgr[..., 3] = arr[..., 3]
        px = torch.from_numpy(bgr).to(self.device)
        if self._tone_map and self._is_hdr:
            primaries = _PRIMARIES.get(self._cicp[0], "bt2020")
            transfer = ("pq" if self._cicp[1] == CICP_TRANSFER_PQ
                        else "hlg")
            rgb = px[..., :3].flip(-1).to(torch.float32) / 255.0
            sdr = COLOR.hdr_to_sdr(rgb, transfer=transfer,
                                   primaries=primaries).flip(-1)
            px = torch.cat([sdr, px[..., 3:4]], dim=-1) if ch == 4 else sdr
        return px

    def skip_frame(self) -> None:
        if self._next >= self._frames:
            raise EOFError()
        # the stream decoders hand out frames in FIFO order, so a skipped
        # frame consumes one native frame exactly when decode_to would,
        # before the first decode too; later frames are inter-coded
        # against it, so its sample still feeds the decoders
        if (self._frames > 1 and self._tracks is not None
                and _avif_native_default()
                and (self._use_raw
                     or not (self._tone_map and self._is_hdr))):
            self._host_step(self._next_planes)
        self._next += 1

    def close(self) -> None:
        for dec in (self._cdec, self._adec):
            if dec is not None:
                try:
                    dec.close()
                except Exception:
                    pass
        self._cdec = self._adec = None
        if self._im is not None:
            try:
                self._im.close()
            except Exception:
                pass


def _set_avis_repetitions(buf: bytes, loops: int) -> bytes:
    """Rewrite mvhd.duration = track_duration_in_movie_ts * (loops + 1)."""
    moov = AR._child(buf, 0, len(buf), b"moov")
    if not moov:
        return buf
    mvhd = AR._child(buf, *moov, b"mvhd")
    if not mvhd:
        return buf
    v = buf[mvhd[0]]
    # movie timescale + current duration
    if v == 1:
        ts_off, dur_off, dur_len = mvhd[0] + 20, mvhd[0] + 24, 8
    else:
        ts_off, dur_off, dur_len = mvhd[0] + 12, mvhd[0] + 16, 4
    mts = int.from_bytes(buf[ts_off:ts_off + 4], "big")
    # track duration in its own timescale
    track_s = None
    for t, s, e in AR._iter_boxes(buf, *moov):
        if t != b"trak":
            continue
        mdia = AR._child(buf, s, e, b"mdia")
        if not mdia:
            continue
        mdhd = AR._child(buf, *mdia, b"mdhd")
        if not mdhd:
            continue
        hv = buf[mdhd[0]]
        if hv == 1:
            tts = int.from_bytes(buf[mdhd[0] + 20:mdhd[0] + 24], "big")
            tdur = int.from_bytes(buf[mdhd[0] + 24:mdhd[0] + 32], "big")
        else:
            tts = int.from_bytes(buf[mdhd[0] + 12:mdhd[0] + 16], "big")
            tdur = int.from_bytes(buf[mdhd[0] + 16:mdhd[0] + 20], "big")
        if tts and tdur:
            track_s = tdur / tts
            break
    if not mts or track_s is None:
        return buf
    new_dur = int(round(track_s * mts * (loops + 1)))
    if new_dur >= 1 << (8 * dur_len):
        return buf
    out = bytearray(buf)
    out[dur_off:dur_off + dur_len] = new_dur.to_bytes(dur_len, "big")
    return bytes(out)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class AvifEncoder(Encoder):
    """Buffers frames and emits a still or animated AVIF at flush (ms
    timescale, the quality and speed options; avif.cpp:614-776). libaom
    through the ffmpeg shim and the port's muxer (avif_enc.py) encode;
    where ffmpeg is absent the flush raises HostLibraryMissingError. PIL
    encodes only when that native encode raises. Unlike the JAX
    package's, construction does not require PIL (ROADMAP queue 3)."""

    def __init__(self, decoded_by: Optional[Decoder] = None,
                 icc_override: Optional[bytes] = None):
        self._icc = icc_override
        self._loops = 0
        if decoded_by is not None:
            if self._icc is None:
                try:
                    self._icc = decoded_by.icc() or None
                except Exception:
                    self._icc = None
            try:
                self._loops = int(decoded_by.loop_count())
            except Exception:
                self._loops = 0
        self._frames: List[np.ndarray] = []
        self._durations: List[int] = []
        self._opts: Dict[int, int] = {}
        self._flushed = False

    def encode(self, fb: Optional[Framebuffer],
               opts: Dict[int, int]) -> Optional[bytes]:
        if self._flushed:
            raise EOFError()
        if fb is not None:
            check_encode_options(opts, _AVIF_ENCODE_KEYS, "avif")
            self._opts = opts or {}
            arr = fb.to_numpy()
            if arr.shape[2] == 4:
                rgb = arr[:, :, [2, 1, 0, 3]]
            elif arr.shape[2] == 1:
                rgb = arr[:, :, 0]  # 2-D: PIL mode "L"
            else:
                rgb = arr[:, :, ::-1]
            self._frames.append(np.ascontiguousarray(rgb))
            self._durations.append(max(int(round(fb.duration * 1000)), 0))
            return None
        if not self._frames:
            raise DecodingFailedError("avif encoder got no frames")
        quality = int(self._opts.get(AVIF_QUALITY, 60))
        speed = int(self._opts.get(AVIF_SPEED, 6))
        from . import avif_enc
        avif_enc.require()
        try:
            durs = self._durations if len(self._frames) > 1 else [0]
            out = avif_enc.encode(
                self._frames, [max(d, 1) for d in durs],
                quality=min(max(quality, 0), 100),
                speed=min(max(speed, 0), 10),
                loop_count=max(self._loops, 0), icc=self._icc)
            self._flushed = True
            return out
        except Exception:
            pass  # the PIL route below, as in the JAX package
        image = _pil_image()
        imgs = [image.fromarray(f) for f in self._frames]
        bio = io.BytesIO()
        kwargs = dict(format="AVIF", quality=min(max(quality, 0), 100),
                      speed=min(max(speed, 0), 10))
        if self._icc:
            kwargs["icc_profile"] = self._icc
        if len(imgs) > 1:
            kwargs.update(save_all=True, append_images=imgs[1:],
                          duration=self._durations or 100)
        imgs[0].save(bio, **kwargs)
        self._flushed = True
        out = bio.getvalue()
        if len(imgs) > 1 and self._loops > 0:
            # a finite source loop count: libavif writes it as
            # mvhd.duration = track_duration * (loops + 1) (avif.cpp:639;
            # 0 stays infinite)
            out = _set_avis_repetitions(out, self._loops)
        return out
