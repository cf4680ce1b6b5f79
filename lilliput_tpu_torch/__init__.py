"""lilliput_tpu_torch: the PyTorch/CUDA port of lilliput_tpu.

The JAX package (``lilliput_tpu``) is the reference; this package mirrors its
module names so each piece has an obvious counterpart. It imports ``torch``
and never ``jax`` or ``lilliput_tpu``. The slice ported so far is the JPEG
Fit transcode serving path (``JpegTranscodePipeline``: 4:2:0, 4:2:2, 4:4:0,
4:4:4 and grayscale sources at any EXIF orientation, JPEG output, in every
JPEG-out mode: AREA, LINEAR or CUBIC resize, chroma_mode "rgb" or "direct",
dct_scale 1, 2 or 4, and the LILLIPUT_FUSED_EXACT tier); its decode
kernels are CUDA (``csrc/*.cu``), and the host entropy stages are C++
built at first use (``binding.py``).
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
from .pipeline import JpegTranscodePipeline  # noqa: E402,F401

__version__ = "0.1.0"
