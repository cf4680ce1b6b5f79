"""Public API: format sniffing and decoder/encoder construction.

The counterpart of ``lilliput_tpu/api.py`` (lilliput.go:100-202): magic-byte
dispatch and extension-based encoder selection. The port decodes JPEG,
PNG/APNG, BMP, PNM, PAM, Sun Raster, Radiance HDR and PFM, and encodes
those formats and thumbhash (not APNG). GIF, WebP, AVIF, JPEG 2000 and
video raise NotImplementedError naming their ROADMAP queue 1 item, never
InvalidImageError, so a caller can tell "not ported" from "not an image";
bytes no decoder of the JAX package would recognize raise
InvalidImageError as there.
"""

from __future__ import annotations

from typing import Optional

from .codecs.hdr import is_hdr
from .codecs.pfm import is_pfm
from .codecs.pnm import is_pam, is_pnm
from .codecs.sunras import is_sunras
from .errors import InvalidImageError, not_ported
from .interfaces import Decoder, Encoder

_GIF87 = b"GIF87a"
_GIF89 = b"GIF89a"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_J2K_SOC = b"\xff\x4f\xff\x51"


def is_gif(buf: bytes) -> bool:
    return buf.startswith(_GIF87) or buf.startswith(_GIF89)


def is_webp(buf: bytes) -> bool:
    return len(buf) >= 12 and buf.startswith(b"RIFF") and buf[8:12] == b"WEBP"


def is_avif(buf: bytes) -> bool:
    return len(buf) >= 12 and buf[4:8] == b"ftyp" and buf[8:12] in (b"avif", b"avis")


def is_mp4(buf: bytes) -> bool:
    return len(buf) >= 12 and (buf[4:12] == b"ftypmp42" or buf[4:12] == b"ftypisom")


def is_png(buf: bytes) -> bool:
    return buf.startswith(_PNG_MAGIC)


def is_jpeg(buf: bytes) -> bool:
    return len(buf) >= 3 and buf[0] == 0xFF and buf[1] == 0xD8 and buf[2] == 0xFF


def is_jpeg2000(buf: bytes) -> bool:
    return buf.startswith(_JP2_SIG) or buf.startswith(_J2K_SOC)


def _is_video(buf: bytes) -> bool:
    """Containers the JAX package's ffmpeg probe opens: ISO BMFF (MP4/MOV)
    and Matroska/WebM."""
    return (is_mp4(buf) or (len(buf) >= 8 and buf[4:8] == b"ftyp")
            or buf.startswith(b"\x1a\x45\xdf\xa3"))


#: (sniffer, what, ROADMAP queue 1 item) of each decoder not ported yet,
#: at its place in the JAX package's dispatch order
_NOT_PORTED_FIRST = (
    (is_gif, "the GIF decoder", "item 6.1"),
    (is_webp, "the WebP decoder", "item 6.2"),
    (is_avif, "the AVIF decoder", "item 6.5"),
)
_NOT_PORTED_LAST = (
    (is_jpeg2000, "the JPEG 2000 decoder", "item 6.4"),
    (_is_video, "the video first-frame decoder", "item 6.6"),
)


def _still_decoder(buf: bytes):
    """The decoder class of a still format the port reads, in the JAX
    package's order after GIF/WebP/AVIF (lilliput_tpu/api.py:46-105), or
    None."""
    if is_jpeg(buf):
        from .codecs.jpeg import JpegDecoder
        return JpegDecoder
    if is_png(buf):
        from .codecs.png import PngDecoder
        return PngDecoder
    if buf[:2] == b"BM":
        from .codecs.bmp import BmpDecoder
        return BmpDecoder
    if is_pnm(buf):
        from .codecs.pnm import PnmDecoder
        return PnmDecoder
    if is_pam(buf):
        from .codecs.pnm import PamDecoder
        return PamDecoder
    if is_sunras(buf):
        from .codecs.sunras import SunRasDecoder
        return SunRasDecoder
    if is_hdr(buf):
        from .codecs.hdr import HdrDecoder
        return HdrDecoder
    if is_pfm(buf):
        from .codecs.pfm import PfmDecoder
        return PfmDecoder
    return None


def new_decoder(buf: bytes, tone_mapping_enabled: bool = True,
                device="cuda") -> Decoder:
    """Sniff magic bytes and return the right Decoder (lilliput.go:129-164).
    The decoder's frames are tensors on `device`: "cuda" unless the caller
    asks for the CPU (device="cpu")."""
    del tone_mapping_enabled  # read by the AVIF decoder (item 6.5)
    if len(buf) == 0:
        raise InvalidImageError("empty buffer")
    for sniff, what, item in _NOT_PORTED_FIRST:
        if sniff(buf):
            not_ported(what, item)
    cls = _still_decoder(buf)
    if cls is not None:
        return cls(buf, device=device)
    for sniff, what, item in _NOT_PORTED_LAST:
        if sniff(buf):
            not_ported(what, item)
    raise InvalidImageError("unrecognized image format")


#: output extension -> (what, ROADMAP queue 1 item) of encoders not ported
_ENCODERS_NOT_PORTED = {
    ".gif": ("the GIF encoder", "item 6.1"),
    ".webp": ("the WebP encoder", "item 4.7b"),
    ".avif": ("the AVIF encoder", "item 6.5"),
    ".jp2": ("the JPEG 2000 encoder", "item 6.4"),
    ".j2k": ("the JPEG 2000 encoder", "item 6.4"),
}


def new_encoder(ext: str, decoded_by: Optional[Decoder] = None,
                icc_override: Optional[bytes] = None) -> Encoder:
    """Extension-based encoder dispatch (lilliput.go:180-202)."""
    e = ext.lower()
    if e in _ENCODERS_NOT_PORTED:
        not_ported(*_ENCODERS_NOT_PORTED[e])
    if e in (".mp4", ".webm"):
        raise InvalidImageError("Encoder cannot encode into video types")
    if e == ".thumbhash":
        from .codecs.thumbhash import ThumbhashEncoder
        return ThumbhashEncoder(decoded_by)
    if e in (".jpg", ".jpeg"):
        from .codecs.jpeg import JpegEncoder
        return JpegEncoder(decoded_by, icc_override=icc_override)
    if e == ".png":
        from .codecs.png import PngEncoder
        return PngEncoder(decoded_by, icc_override=icc_override)
    if e == ".bmp":
        from .codecs.bmp import BmpEncoder
        return BmpEncoder(decoded_by, icc_override=icc_override)
    if e in (".pbm", ".pgm", ".ppm", ".pnm"):
        from .codecs.pnm import PnmEncoder
        return PnmEncoder(decoded_by, icc_override=icc_override, subtype=e)
    if e == ".pam":
        from .codecs.pnm import PamEncoder
        return PamEncoder(decoded_by, icc_override=icc_override)
    if e in (".sr", ".ras"):
        from .codecs.sunras import SunRasEncoder
        return SunRasEncoder(decoded_by, icc_override=icc_override)
    if e == ".hdr":
        from .codecs.hdr import HdrEncoder
        return HdrEncoder(decoded_by, icc_override=icc_override)
    if e == ".pfm":
        from .codecs.pfm import PfmEncoder
        return PfmEncoder(decoded_by, icc_override=icc_override)
    raise InvalidImageError(f"unsupported output type {ext!r}")
