"""Typed errors mirroring the reference's error variables (lilliput.go:24-31)."""


class LilliputError(Exception):
    """Base class for all framework errors."""


class InvalidImageError(LilliputError):
    """Unrecognized image format."""


class DecodingFailedError(LilliputError):
    """Failed to decode image."""


class BufTooSmallError(LilliputError):
    """Buffer too small to hold image."""


class FrameBufNoPixelsError(LilliputError):
    """Framebuffer contains no pixels."""


class SkipNotSupportedError(LilliputError):
    """Skip operation not supported by this decoder."""


class EncodeTimeoutError(LilliputError):
    """Encode timed out."""


class HostLibraryMissingError(LilliputError):
    """A system library a ported host stage links against is absent on this
    machine (its header is missing, so the stage's shim was not built).
    The code is ported; only the machine lacks the library, so this is
    neither NotImplementedError nor a reason to take another route."""

