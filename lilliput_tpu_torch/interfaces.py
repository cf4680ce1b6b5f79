"""Decoder/Encoder interfaces, mirroring lilliput.go:42-98.

The counterpart of ``lilliput_tpu/interfaces.py``, with its conventions:

* ``Decoder.decode_to(fb)`` fills the Framebuffer with the next frame and its
  animation metadata; raises ``EOFError`` when frames are exhausted.
* ``Encoder.encode(fb, opts)`` returns ``None`` to request another frame
  (multi-frame encoders); ``encode(None, opts)`` means "flush and return the
  final bytes" (ops.go:342-349).
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

from .framebuffer import Framebuffer, ImageHeader


class Decoder(abc.ABC):
    @abc.abstractmethod
    def header(self) -> ImageHeader:
        """Basic metadata; lazy (no full decode)."""

    def close(self) -> None:
        pass

    @abc.abstractmethod
    def description(self) -> str:
        """Image type, e.g. 'JPEG'."""

    def duration(self) -> float:
        """Total duration in seconds (0 for static images and GIFs)."""
        return 0.0

    @abc.abstractmethod
    def decode_to(self, fb: Framebuffer) -> None:
        """Decode the next frame into fb; raises EOFError at the end."""

    def skip_frame(self) -> None:
        from .errors import SkipNotSupportedError
        raise SkipNotSupportedError()

    def is_streamable(self) -> bool:
        return True

    def has_subtitles(self) -> bool:
        return False

    def background_color(self) -> int:
        """Background color as BGRA uint32."""
        return 0

    def icc(self) -> bytes:
        return b""

    def loop_count(self) -> int:
        return 0

    def video_codec(self) -> str:
        return "Unknown"

    def audio_codec(self) -> str:
        return "Unknown"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def check_encode_options(opts: Optional[Dict[int, int]], supported,
                         codec: str) -> None:
    """Unknown int-keyed encode options: warn and ignore, visibly.

    Callers pass ONE combined option map for every output format, so
    another codec's keys are normal and skipped silently; only keys outside
    the union of all known constants warn (OpenCV's loadsave.cpp logs 'An
    unknown key was specified and has been ignored' the same way), and each
    is counted in Metrics."""
    from .framebuffer import KNOWN_ENCODE_OPTION_KEYS
    for k in (opts or {}):
        if k not in supported and k not in KNOWN_ENCODE_OPTION_KEYS:
            import warnings

            from .utils.metrics import metrics
            warnings.warn(
                f"{codec} encoder: unknown option key {k} ignored "
                f"({codec} reads: {sorted(supported)})", stacklevel=3)
            metrics.incr(f"encode.unknown_option.{codec}")


class Encoder(abc.ABC):
    @abc.abstractmethod
    def encode(self, fb: Optional[Framebuffer], opts: Dict[int, int]) -> Optional[bytes]:
        """Encode a frame. None result = send another frame; fb=None = flush."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
