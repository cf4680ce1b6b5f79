"""Public API: format sniffing and decoder/encoder construction.

The counterpart of ``lilliput_tpu/api.py`` (lilliput.go:100-202): magic-byte
dispatch and extension-based encoder selection. The port decodes JPEG and
encodes JPEG and PNG so far. Every other format raises NotImplementedError
naming its ROADMAP queue 1 item, never InvalidImageError, so a caller can
tell "not ported" from "not an image"; bytes no decoder of the JAX package
would recognize raise InvalidImageError as there.
"""

from __future__ import annotations

from typing import Optional

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


def _is_pnm(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] in b"123456" and buf[2] in b" \t\r\n#")


def _is_pam(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] == 0x37 and buf[2] in b" \t\r\n#")


def _is_sunras(buf: bytes) -> bool:
    return len(buf) >= 32 and buf[:4] == b"\x59\xa6\x6a\x95"


def _is_hdr(buf: bytes) -> bool:
    return buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")


def _is_pfm(buf: bytes) -> bool:
    return (len(buf) >= 3 and buf[0] == 0x50  # 'P'
            and buf[1] in b"Ff" and buf[2] in b" \t\r\n")


def _is_video(buf: bytes) -> bool:
    """Containers the JAX package's ffmpeg probe opens: ISO BMFF (MP4/MOV)
    and Matroska/WebM."""
    return (is_mp4(buf) or (len(buf) >= 8 and buf[4:8] == b"ftyp")
            or buf.startswith(b"\x1a\x45\xdf\xa3"))


#: (sniffer, what, ROADMAP queue 1 item) of each decoder not ported yet,
#: in the JAX package's dispatch order (JPEG's magic matches none of them)
_NOT_PORTED = (
    (is_gif, "the GIF decoder", "item 6.1"),
    (is_webp, "the WebP decoder", "item 6.2"),
    (is_avif, "the AVIF decoder", "item 6.5"),
    (is_png, "the PNG decoder", "item 6.1"),
    (lambda b: b[:2] == b"BM", "the BMP decoder", "item 6.3"),
    (_is_pnm, "the PNM decoder", "item 6.3"),
    (_is_pam, "the PAM decoder", "item 6.3"),
    (_is_sunras, "the Sun Raster decoder", "item 6.3"),
    (_is_hdr, "the Radiance HDR decoder", "item 6.3"),
    (_is_pfm, "the PFM decoder", "item 6.3"),
    (is_jpeg2000, "the JPEG 2000 decoder", "item 6.4"),
    (_is_video, "the video first-frame decoder", "item 6.6"),
)


def new_decoder(buf: bytes, tone_mapping_enabled: bool = True,
                device="cuda") -> Decoder:
    """Sniff magic bytes and return the right Decoder (lilliput.go:129-164).
    The decoder's frames are tensors on `device`: "cuda" unless the caller
    asks for the CPU (device="cpu")."""
    del tone_mapping_enabled  # read by the AVIF decoder (item 6.5)
    if len(buf) == 0:
        raise InvalidImageError("empty buffer")
    if is_jpeg(buf):
        from .codecs.jpeg import JpegDecoder
        return JpegDecoder(buf, device=device)
    for sniff, what, item in _NOT_PORTED:
        if sniff(buf):
            not_ported(what, item)
    raise InvalidImageError("unrecognized image format")


#: output extension -> (what, ROADMAP queue 1 item) of encoders not ported
_ENCODERS_NOT_PORTED = {
    ".gif": ("the GIF encoder", "item 6.1"),
    ".webp": ("the WebP encoder", "item 4.7b"),
    ".avif": ("the AVIF encoder", "item 6.5"),
    ".thumbhash": ("the thumbhash encoder", "item 5.3"),
    ".bmp": ("the BMP encoder", "item 6.3"),
    ".pbm": ("the PNM encoder", "item 6.3"),
    ".pgm": ("the PNM encoder", "item 6.3"),
    ".ppm": ("the PNM encoder", "item 6.3"),
    ".pnm": ("the PNM encoder", "item 6.3"),
    ".pam": ("the PAM encoder", "item 6.3"),
    ".jp2": ("the JPEG 2000 encoder", "item 6.4"),
    ".j2k": ("the JPEG 2000 encoder", "item 6.4"),
    ".sr": ("the Sun Raster encoder", "item 6.3"),
    ".ras": ("the Sun Raster encoder", "item 6.3"),
    ".hdr": ("the Radiance HDR encoder", "item 6.3"),
    ".pfm": ("the PFM encoder", "item 6.3"),
}


def new_encoder(ext: str, decoded_by: Optional[Decoder] = None,
                icc_override: Optional[bytes] = None) -> Encoder:
    """Extension-based encoder dispatch (lilliput.go:180-202)."""
    e = ext.lower()
    if e in (".mp4", ".webm"):
        raise InvalidImageError("Encoder cannot encode into video types")
    if e in (".jpg", ".jpeg"):
        from .codecs.jpeg import JpegEncoder
        return JpegEncoder(decoded_by, icc_override=icc_override)
    if e == ".png":
        from .codecs.png import PngEncoder
        return PngEncoder(decoded_by, icc_override=icc_override)
    if e in _ENCODERS_NOT_PORTED:
        not_ported(*_ENCODERS_NOT_PORTED[e])
    raise InvalidImageError(f"unsupported output type {ext!r}")
