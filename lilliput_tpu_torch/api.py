"""Public API: format sniffing and decoder/encoder construction.

The counterpart of ``lilliput_tpu/api.py`` (lilliput.go:100-202): magic-byte
dispatch and extension-based encoder selection. The port decodes GIF,
WebP, JPEG, PNG/APNG, BMP, PNM, PAM, Sun Raster, Radiance HDR, PFM and
JPEG 2000 (JP2 and J2K) and AVIF, and encodes those formats and thumbhash
(not APNG); anything else falls through to the video and audio probe
(``codecs/video.py``: the first frame of MP4/MOV/WebM/Matroska/AVI,
audio-only files with width 0), as in the JAX package. WebP needs
libwebp, and AVIF's AV1 decode and encode and the video probe need
ffmpeg: where their headers are absent, those steps raise
HostLibraryMissingError. Then a buffer sniffed as a video container
(ISO BMFF, Matroska) raises it too, uncaught, so a caller can tell "no
ffmpeg here" from "not an image"; other bytes raise InvalidImageError.
"""

from __future__ import annotations

from typing import Optional

from .codecs.hdr import is_hdr
from .codecs.pfm import is_pfm
from .codecs.pnm import is_pam, is_pnm
from .codecs.sunras import is_sunras
from .errors import HostLibraryMissingError, InvalidImageError
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


def _still_decoder(buf: bytes):
    """The decoder class of a still format the port reads, in the JAX
    package's order after GIF, WebP and AVIF (lilliput_tpu/api.py:46-105), or
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
    if is_jpeg2000(buf):
        from .codecs.jp2 import Jp2Decoder
        return Jp2Decoder
    return None


def new_decoder(buf: bytes, tone_mapping_enabled: bool = True,
                device="cuda") -> Decoder:
    """Sniff magic bytes and return the right Decoder (lilliput.go:129-164).
    The decoder's frames are tensors on `device`: "cuda" unless the caller
    asks for the CPU (device="cpu"). tone_mapping_enabled is the AVIF
    decoder's: HDR sources tone-map to SDR unless it is False."""
    if len(buf) == 0:
        raise InvalidImageError("empty buffer")
    if is_gif(buf):
        from .codecs.gif import GifDecoder
        return GifDecoder(buf, device=device)
    if is_webp(buf):
        from .codecs.webp import WebpDecoder
        return WebpDecoder(buf, device=device)
    if is_avif(buf):
        from .codecs.avif import AvifDecoder
        return AvifDecoder(buf, tone_mapping_enabled, device=device)
    cls = _still_decoder(buf)
    if cls is not None:
        return cls(buf, device=device)
    return _video_decoder(buf, device)


def _video_decoder(buf: bytes, device) -> Decoder:
    """The fallthrough to the video and audio probe (lilliput_tpu/api.py:
    104-109): any failure to open is "unrecognized image format", except
    a missing ffmpeg, which a sniffed video container raises and nothing
    catches; other bytes need no ffmpeg to be refused."""
    import os

    from . import binding
    from .codecs.video import VideoDecoder
    from .utils import resolve_device
    device = resolve_device(device)
    if not (_is_video(buf) or os.path.exists(binding.AVFORMAT_HEADER)):
        raise InvalidImageError("unrecognized image format")
    try:
        return VideoDecoder(buf, device=device)
    except HostLibraryMissingError:
        raise
    except Exception as e:
        raise InvalidImageError("unrecognized image format") from e


def new_encoder(ext: str, decoded_by: Optional[Decoder] = None,
                icc_override: Optional[bytes] = None) -> Encoder:
    """Extension-based encoder dispatch (lilliput.go:180-202)."""
    e = ext.lower()
    if e == ".gif":
        from .codecs.gif import GifEncoder
        return GifEncoder(decoded_by, icc_override=icc_override)
    if e == ".webp":
        from .codecs.webp import WebpEncoder
        return WebpEncoder(decoded_by, icc_override=icc_override)
    if e == ".avif":
        from .codecs.avif import AvifEncoder
        return AvifEncoder(decoded_by, icc_override=icc_override)
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
    if e in (".jp2", ".j2k"):
        from .codecs.jp2 import Jp2Encoder
        return Jp2Encoder(decoded_by, icc_override=icc_override)
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
