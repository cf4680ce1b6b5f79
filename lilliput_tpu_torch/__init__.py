"""lilliput_tpu_torch: the PyTorch/CUDA port of lilliput_tpu.

The JAX package (``lilliput_tpu``) is the reference; this package mirrors its
module names so each piece has an obvious counterpart. It imports ``torch``
and never ``jax`` or ``lilliput_tpu``. Ported so far:

* the JPEG Fit transcode serving path (``JpegTranscodePipeline``: 4:2:0,
  4:2:2, 4:4:0, 4:4:4 and grayscale sources at any EXIF orientation, JPEG
  or PNG output, in every mode: AREA, LINEAR or CUBIC resize, chroma_mode
  "rgb" or "direct", dct_scale 1, 2 or 4, and the LILLIPUT_FUSED_EXACT
  tier);
* the single-image surface: JPEG (YCbCr, gray, JCS_RGB, CMYK/YCCK),
  GIF and WebP (animated too; WebP through libwebp where its headers
  exist), PNG/APNG, BMP, PNM, PAM, Sun Raster, Radiance HDR, PFM, JPEG
  2000 (JP2/J2K: Tier-2 and Tier-1 on the host, the wavelet and colour
  transforms as torch ops on the device) and AVIF (still and animated,
  SDR and HDR: dav1d and libaom through ffmpeg where its headers exist,
  the HDR tone map as torch ops on the device) in, and the first frame
  of MP4/MOV/WebM/Matroska/AVI video (ffmpeg on the host where its
  headers exist, the YUV -> BGR conversion on the device; audio-only
  files probe with width 0); those (not APNG, not video) and thumbhash
  out::

      from lilliput_tpu_torch import (ImageOps, ImageOptions,
                                      ResizeMethod, new_decoder)
      d = new_decoder(open("in.png", "rb").read())      # device="cuda"
      out = ImageOps(8192).transform(d, ImageOptions(
          file_type=".jpeg", width=256, height=256,
          resize_method=ResizeMethod.FIT))

* the animated serving path, GIF -> GIF/WebP, WebP -> WebP and AVIF ->
  AVIF/WebP (``AnimatedTranscodePipeline``,
  ``pipeline.transcode_gif(_batch)``, ``transcode_webp(_batch)``,
  ``transcode_avif(_batch)``), with the palette and composite ops of
  ``ops/palette.py``; .webp output of the still fronts through the
  device's libwebp-exact YUV420 emit (``ops/color.py``);
* the still-input serving front: ``StillTranscodePipeline`` (batches of
  one non-JPEG still signature: host decode, one device step) and
  ``MultiGeometryPipeline``, which groups mixed JPEG/PNG/GIF/... traffic
  by signature into per-signature pipelines (an LRU), runs each group as
  one batch and restores the input order::

      from lilliput_tpu_torch import MultiGeometryPipeline
      mg = MultiGeometryPipeline(256, 256, quality=85)   # device="cuda"
      outs = mg.transcode(list_of_image_bytes, return_exceptions=True)

* the keyframe spritesheet of a video (``pipeline.spritesheet``: host
  keyframe decodes, one batched resize and thumbhash on the device);
* the command line, ``python -m lilliput_tpu_torch`` (``cli.py``);
* ``utils``: ``get_logger`` (key=value logs), ``device_trace`` (a
  torch.profiler Chrome trace) and ``measure_device_stages`` (a serving
  pipeline's decode, full step, dispatch and fetch times).

The decode kernels are CUDA (``csrc/*.cu``); the host entropy stages are
C++ built at first use (``binding.py``). Every entry point runs on "cuda"
unless the caller passes device="cpu".
"""

import torch as _torch

# Image fidelity depends on exact f32 matmuls (the counterpart of
# lilliput_tpu/__init__.py's "highest" matmul precision): TF32 passes corrupt
# IDCT/resize outputs by whole u8 levels. Pin full f32 for cuBLAS and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .errors import (BufTooSmallError, DecodingFailedError,  # noqa: E402,F401
                     EncodeTimeoutError, FrameBufNoPixelsError,
                     HostLibraryMissingError, InvalidImageError,
                     LilliputError, SkipNotSupportedError)
from .api import new_decoder, new_encoder  # noqa: E402,F401
from .framebuffer import (AVIF_QUALITY, AVIF_SPEED,  # noqa: E402,F401
                          JPEG2000_RATE, JPEG_PROGRESSIVE, JPEG_QUALITY,
                          PNG_COMPRESSION, WEBP_METHOD, WEBP_QUALITY, BlendMethod, DisposeMethod,
                          Framebuffer, ImageHeader, ImageOrientation)
from .imageops import ImageOps, ImageOptions, ResizeMethod  # noqa: E402,F401
from .interfaces import Decoder, Encoder  # noqa: E402,F401
from .pipeline import (AnimatedTranscodePipeline,  # noqa: E402,F401
                       JpegTranscodePipeline, MultiGeometryPipeline,
                       StillTranscodePipeline, spritesheet,
                       transcode_avif, transcode_avif_batch, transcode_gif,
                       transcode_gif_batch, transcode_webp,
                       transcode_webp_batch)

__version__ = "0.1.0"
