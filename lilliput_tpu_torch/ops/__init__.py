"""Dense device stages of the port (torch), and its CUDA kernels."""
from . import blend, orient, resize  # noqa: F401
