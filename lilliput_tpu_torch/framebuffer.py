"""Core data structures: Framebuffer (device-resident pixels) and ImageHeader.

The counterpart of ``lilliput_tpu/framebuffer.py``. Pixels live in a torch
tensor shaped (H, W, C) uint8 (BGR/BGRA channel order, the reference's
OpenCV convention) on an explicit device: the decoder's, "cuda" unless a
caller asks for the CPU. Per-frame animation metadata rides alongside as in
the JAX package. ``to_numpy`` is the one place where pixels leave the
device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .ops import blend as _blend
from .ops import orient as _orient
from .ops import resize as _resize


class DisposeMethod(enum.IntEnum):
    """How the previous frame region is disposed (opencv.go:19-27).

    RESTORE_PREVIOUS (GIF disposal 3) can surface from decoders; the
    Transform loop treats it like NO_DISPOSE (as the reference's switch
    does by omission, ops.go:431-441).
    """
    NO_DISPOSE = 0
    DISPOSE_TO_BACKGROUND_COLOR = 1
    RESTORE_PREVIOUS = 2


class BlendMethod(enum.IntEnum):
    """How a frame is composited onto the canvas (opencv.go:29-37)."""
    USE_ALPHA_BLENDING = 0
    NO_BLEND = 1


class ImageOrientation(enum.IntEnum):
    """EXIF orientation codes (opencv.hpp:17-26)."""
    TOP_LEFT = 1
    TOP_RIGHT = 2
    BOTTOM_RIGHT = 3
    BOTTOM_LEFT = 4
    LEFT_TOP = 5
    RIGHT_TOP = 6
    RIGHT_BOTTOM = 7
    LEFT_BOTTOM = 8


# Encode option keys: the same user-facing knobs and integer values as the
# JAX package (OpenCV's IMWRITE constants where they are OpenCV's).
JPEG_QUALITY = 1            # CV_IMWRITE_JPEG_QUALITY
JPEG_PROGRESSIVE = 2        # CV_IMWRITE_JPEG_PROGRESSIVE
JPEG_OPTIMIZE = 3           # CV_IMWRITE_JPEG_OPTIMIZE (optimize_coding)
JPEG_RST_INTERVAL = 4       # CV_IMWRITE_JPEG_RST_INTERVAL (DRI, MCU rows)
JPEG_LUMA_QUALITY = 5       # CV_IMWRITE_JPEG_LUMA_QUALITY (per-table scale)
JPEG_CHROMA_QUALITY = 6     # CV_IMWRITE_JPEG_CHROMA_QUALITY
PNG_COMPRESSION = 16        # CV_IMWRITE_PNG_COMPRESSION
PNG_STRATEGY = 17           # CV_IMWRITE_PNG_STRATEGY (zlib strategy 0..4)
PNG_BILEVEL = 18            # CV_IMWRITE_PNG_BILEVEL (1-bit grayscale)
WEBP_QUALITY = 64           # CV_IMWRITE_WEBP_QUALITY
# Extended WebP options (webp.hpp:13-23)
WEBP_METHOD = 1000
WEBP_FILTER_STRENGTH = 1001
WEBP_FILTER_TYPE = 1002
WEBP_AUTOFILTER = 1003
WEBP_PARTITIONS = 1004
WEBP_SEGMENTS = 1005
WEBP_PREPROCESSING = 1006
WEBP_THREAD_LEVEL = 1007
WEBP_PALETTE = 1008
# JPEG 2000: compression ratio x1000 (OpenCV's
# IMWRITE_JPEG2000_COMPRESSION_X1000 analog; 9/7 when set, else lossless)
JPEG2000_RATE = 1000
# AVIF options (avif.hpp:17)
AVIF_QUALITY = 1
AVIF_SPEED = 2

# The union of every encode-option key any codec reads. Callers pass ONE
# combined map for all output formats (the reference's examples/main.go
# builds exactly that); each encoder reads its own keys and silently skips
# the other codecs' — only keys outside this union are "unknown".
KNOWN_ENCODE_OPTION_KEYS = frozenset({
    JPEG_QUALITY, JPEG_PROGRESSIVE, JPEG_OPTIMIZE, JPEG_RST_INTERVAL,
    JPEG_LUMA_QUALITY, JPEG_CHROMA_QUALITY, PNG_COMPRESSION, PNG_STRATEGY,
    PNG_BILEVEL, WEBP_QUALITY, WEBP_METHOD, WEBP_FILTER_STRENGTH,
    WEBP_FILTER_TYPE, WEBP_AUTOFILTER, WEBP_PARTITIONS, WEBP_SEGMENTS,
    WEBP_PREPROCESSING, WEBP_THREAD_LEVEL, WEBP_PALETTE})


@dataclasses.dataclass
class ImageHeader:
    """Basic decoded image metadata (opencv.go:108-115)."""
    width: int
    height: int
    channels: int = 4
    orientation: ImageOrientation = ImageOrientation.TOP_LEFT
    num_frames: int = 1
    content_length: int = 0

    def is_animated(self) -> bool:
        return self.num_frames > 1

    def has_alpha(self) -> bool:
        return self.channels == 4

    def pixel_type_channels(self) -> int:
        return self.channels


class Framebuffer:
    """A decoded frame: device pixels + animation metadata.

    ``array`` is an (H, W, C) uint8 torch tensor in BGR(A) order, or None
    for an unallocated buffer. Ops return new Framebuffers (functional
    style); metadata copies mirror ops.go:465-470 semantics.
    """

    __slots__ = ("array", "duration", "x_offset", "y_offset", "dispose", "blend")

    def __init__(self, array: Optional[torch.Tensor] = None):
        self.array = array
        self.duration: float = 0.0  # seconds
        self.x_offset: int = 0
        self.y_offset: int = 0
        self.dispose: DisposeMethod = DisposeMethod.NO_DISPOSE
        self.blend: BlendMethod = BlendMethod.USE_ALPHA_BLENDING

    # -- construction -------------------------------------------------------

    @classmethod
    def from_array(cls, arr, device=None, **meta) -> "Framebuffer":
        """A Framebuffer of `arr` ((H, W, C) u8, numpy or torch) on
        `device`: "cuda" for a numpy array unless given, a tensor's own
        device unless given."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr)).to(
                "cuda" if device is None else device)
        elif device is not None:
            arr = arr.to(device)
        fb = cls(arr)
        for k, v in meta.items():
            setattr(fb, k, v)
        return fb

    def create_3channel(self, width: int, height: int,
                        device="cuda") -> None:
        self.array = torch.zeros((height, width, 3), dtype=torch.uint8,
                                 device=device)

    def create_4channel(self, width: int, height: int,
                        device="cuda") -> None:
        self.array = torch.zeros((height, width, 4), dtype=torch.uint8,
                                 device=device)

    # -- metadata -----------------------------------------------------------

    @property
    def width(self) -> int:
        return 0 if self.array is None else self.array.shape[1]

    @property
    def height(self) -> int:
        return 0 if self.array is None else self.array.shape[0]

    @property
    def channels(self) -> int:
        return 0 if self.array is None else self.array.shape[2]

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.array is None else self.array.device

    def has_alpha(self) -> bool:
        return self.channels == 4

    def copy_properties_from(self, other: "Framebuffer") -> None:
        self.duration = other.duration
        self.x_offset = other.x_offset
        self.y_offset = other.y_offset
        self.dispose = other.dispose
        self.blend = other.blend

    # -- transforms (all on the pixels' device) -----------------------------

    def orientation_transform(self, orientation: ImageOrientation) -> None:
        """In-place-style orientation normalization (opencv.go:261-269)."""
        if self.array is None:
            return
        self.array = _orient.orient(self.array, int(orientation))

    def resize_to(self, width: int, height: int) -> "Framebuffer":
        """INTER_AREA stretch-resize (opencv.go:284-299)."""
        width, height = max(width, 1), max(height, 1)
        out = Framebuffer(_resize.resize(self.array, width, height,
                                         _resize.AREA))
        out.copy_properties_from(self)
        return out

    def fit(self, width: int, height: int) -> "Framebuffer":
        """Aspect-preserving center-crop + INTER_AREA resize (opencv.go:316-364)."""
        if self.array is None:
            raise ValueError("framebuffer contains no pixels")
        fw, fh = self.width, self.height
        aspect_in = fw / fh
        aspect_out = width / height
        if aspect_in > aspect_out:
            width_post_crop = int(aspect_out * fh + 0.5)
            height_post_crop = fh
        else:
            height_post_crop = int(fw / aspect_out + 0.5)
            width_post_crop = fw
        width_post_crop = max(width_post_crop, 1)
        height_post_crop = max(height_post_crop, 1)
        left = max(int((fw - width_post_crop) * 0.5), 0)
        top = max(int((fh - height_post_crop) * 0.5), 0)
        cropped = _blend.crop(self.array, left, top, width_post_crop,
                              height_post_crop)
        out = Framebuffer(_resize.resize(cropped, width, height, _resize.AREA))
        out.copy_properties_from(self)
        return out

    def clear_to_transparent(self, x: int, y: int, w: int, h: int) -> None:
        self.array = _blend.clear_to_transparent(self.array, x, y, w, h)

    def copy_to_offset_with_alpha_blending(self, src: "Framebuffer",
                                           x: int, y: int, w: int, h: int) -> None:
        if x < 0 or y < 0 or x + w > self.width or y + h > self.height:
            raise ValueError("source image with offsets exceeds destination bounds")
        self.array = _blend.copy_to_region_with_alpha(self.array, src.array,
                                                      x, y, w, h)

    def copy_to_offset_no_blend(self, src: "Framebuffer",
                                x: int, y: int, w: int, h: int) -> None:
        if x < 0 or y < 0 or x + w > self.width or y + h > self.height:
            raise ValueError("source image with offsets exceeds destination bounds")
        self.array = _blend.copy_to_region(self.array, src.array, x, y, w, h)

    def to_numpy(self) -> np.ndarray:
        """The pixels on the host (waits for the device)."""
        return self.array.cpu().numpy()
