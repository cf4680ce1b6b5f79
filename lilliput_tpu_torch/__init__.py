"""lilliput_tpu_torch: the PyTorch/CUDA port of lilliput_tpu.

The JAX package (``lilliput_tpu``) is the reference; this package mirrors its
module names so each piece has an obvious counterpart. It imports ``torch``
and never ``jax`` or ``lilliput_tpu``. Ported so far:

* the JPEG Fit transcode serving path (``JpegTranscodePipeline``: 4:2:0,
  4:2:2, 4:4:0, 4:4:4 and grayscale sources at any EXIF orientation, JPEG
  or PNG output, in every mode: AREA, LINEAR or CUBIC resize, chroma_mode
  "rgb" or "direct", dct_scale 1, 2 or 4, and the LILLIPUT_FUSED_EXACT
  tier);
* the single-image surface for the still formats: JPEG (YCbCr, gray,
  JCS_RGB, CMYK/YCCK), PNG/APNG, BMP, PNM, PAM, Sun Raster, Radiance HDR
  and PFM in; those (not APNG) and thumbhash out::

      from lilliput_tpu_torch import (ImageOps, ImageOptions,
                                      ResizeMethod, new_decoder)
      d = new_decoder(open("in.png", "rb").read())      # device="cuda"
      out = ImageOps(8192).transform(d, ImageOptions(
          file_type=".jpeg", width=256, height=256,
          resize_method=ResizeMethod.FIT))

* the command line, ``python -m lilliput_tpu_torch`` (``cli.py``).

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
                     InvalidImageError, LilliputError, SkipNotSupportedError)
from .api import new_decoder, new_encoder  # noqa: E402,F401
from .framebuffer import (JPEG_PROGRESSIVE, JPEG_QUALITY,  # noqa: E402,F401
                          PNG_COMPRESSION, BlendMethod, DisposeMethod,
                          Framebuffer, ImageHeader, ImageOrientation)
from .imageops import ImageOps, ImageOptions, ResizeMethod  # noqa: E402,F401
from .interfaces import Decoder, Encoder  # noqa: E402,F401
from .pipeline import JpegTranscodePipeline  # noqa: E402,F401

__version__ = "0.1.0"
