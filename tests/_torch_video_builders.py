"""Small video and audio inputs made in memory for the port's video tests:
cv2.VideoWriter clips (its FFMPEG backend), a WAV through Python's wave
module, a Matroska file with a rotate tag (tools/make_webm_fixture), and
an MPEG-4 Part 2 clip made anamorphic by patching its VOL header's
aspect_ratio_info. Nothing is downloaded."""

import functools
import io
import os
import re
import sys
import tempfile
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_VP8 = os.path.join(ROOT, "tests", "assets", "tiny_vp8.webm")

#: name -> (fourcc, container): MPEG-4 Part 2 (yuv420p, two keyframes),
#: MJPEG (yuvj420p, full range, every frame a keyframe), PNG (rgb24: the
#: shim's BGRA route), FFV1 (bgr0: BGRA route), VP8 (yuv420p)
CLIPS = {
    "mp4": ("mp4v", ".mp4"),
    "avi_mjpg": ("MJPG", ".avi"),
    "avi_png": ("PNG ", ".avi"),
    "mkv_ffv1": ("FFV1", ".mkv"),
    "webm_vp8": ("VP80", ".webm"),
}
W, H, FRAMES, FPS = 80, 60, 20, 10


def frame(i: int, w: int = W, h: int = H) -> np.ndarray:
    """Frame i of the clips: BGR gradients that move with i."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 3 + i * 11) % 256, (yy * 4 + i * 5) % 256,
                     ((xx + 2 * yy) * 2 + i * 7) % 256],
                    -1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def clip(name: str) -> bytes:
    """The bytes of CLIPS[name], FRAMES frames of W x H at FPS."""
    import cv2
    fourcc, ext = CLIPS[name]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip" + ext)
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS,
                             (W, H))
        assert vw.isOpened(), f"cv2 cannot write {fourcc} into {ext}"
        for i in range(FRAMES):
            vw.write(frame(i))
        vw.release()
        with open(path, "rb") as f:
            return f.read()


@functools.lru_cache(maxsize=None)
def wav_bytes(seconds: float = 0.5, rate: int = 8000) -> bytes:
    """An audio-only WAV: a 440 Hz tone, 16-bit mono."""
    t = np.arange(int(seconds * rate)) / rate
    pcm = (8000 * np.sin(2 * np.pi * 440 * t)).astype("<i2")
    bio = io.BytesIO()
    with wave.open(bio, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return bio.getvalue()


def tiny_vp8() -> bytes:
    with open(TINY_VP8, "rb") as f:
        return f.read()


def webm_with_rotate(rotate) -> bytes:
    """tools/make_webm_fixture.make_webm_bytes(rotate=...)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from make_webm_fixture import make_webm_bytes
    finally:
        sys.path.pop(0)
    return make_webm_bytes(rotate=rotate)


def _bit(buf, pos: int) -> int:
    return (buf[pos // 8] >> (7 - pos % 8)) & 1


@functools.lru_cache(maxsize=None)
def anamorphic_mp4(aspect_ratio_info: int) -> bytes:
    """The "mp4" clip with the aspect_ratio_info of its VOL header (the
    first VOL start code in the esds decoder config) set to
    `aspect_ratio_info`: 2 is a 12:11 pixel aspect (the display width
    grows), 3 is 10:11 (the display height grows)."""
    buf = bytearray(clip("mp4"))
    vol = re.compile(rb"\x00\x00\x01[\x20-\x2f]").search(
        buf, buf.index(b"esds")).start()
    # random_accessible_vol (1), video_object_type_indication (8),
    # is_object_layer_identifier (1) [+ verid (4), priority (3)]
    pos = (vol + 4) * 8 + 9
    pos += 1 + (7 if _bit(buf, pos) else 0)
    for k in range(4):
        p = pos + k
        mask = 1 << (7 - p % 8)
        if (aspect_ratio_info >> (3 - k)) & 1:
            buf[p // 8] |= mask
        else:
            buf[p // 8] &= ~mask & 0xFF
    return bytes(buf)


def extract_ftyp_moov(buf: bytes) -> bytes:
    """ftyp + moov only, mdat stripped (tests/test_video.py's
    _extract_ftyp_moov): what a media proxy has after range-reading an
    MP4's metadata."""
    out = b""
    off = 0
    while off + 8 <= len(buf):
        size = int.from_bytes(buf[off:off + 4], "big")
        typ = buf[off + 4:off + 8]
        if size < 8 or off + size > len(buf):
            break
        if typ in (b"ftyp", b"moov"):
            out += buf[off:off + size]
        off += size
    return out
