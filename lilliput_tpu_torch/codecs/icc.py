"""ICC profile handling: embedded profiles + CICP-based HDR detection.

The counterpart of ``lilliput_tpu/codecs/icc.py``: a minimal ICC binary
parser that finds the 'cicp' tag and inspects its transfer-characteristics
byte (PQ=16, HLG=18), in place of the reference's lcms2-backed color_info
(color_info.cpp:8-27).

The profiles are the CC0 Compact-ICC-Profiles the reference embeds, copied
byte for byte into this package's ``icc_profiles/`` (held equal to the JAX
package's copies by tests) and read from there.
"""

from __future__ import annotations

import importlib.resources
import struct

CICP_TRANSFER_PQ = 16
CICP_TRANSFER_HLG = 18

MAX_ICC_PROFILE_SIZE = 1024 * 1024  # parity with color_info.cpp:5


def _load_profile(name: str) -> bytes:
    ref = importlib.resources.files("lilliput_tpu_torch") / "icc_profiles" / name
    return ref.read_bytes()


SRGB_PROFILE = _load_profile("srgb_profile.icc")
REC709_PROFILE = _load_profile("rec709_profile.icc")
REC2020_PROFILE = _load_profile("rec2020_profile.icc")
REC601_PAL_PROFILE = _load_profile("rec601_pal_profile.icc")
REC601_NTSC_PROFILE = _load_profile("rec601_ntsc_profile.icc")


def parse_cicp(icc: bytes):
    """Return (primaries, transfer, matrix, full_range) from the profile's
    cicp tag, or None when absent/malformed."""
    if len(icc) < 132 or len(icc) > MAX_ICC_PROFILE_SIZE:
        return None
    size = struct.unpack(">I", icc[0:4])[0]
    if size > len(icc):
        return None
    try:
        (tag_count,) = struct.unpack(">I", icc[128:132])
    except struct.error:
        return None
    if tag_count > 1024:
        return None
    for i in range(tag_count):
        off = 132 + i * 12
        if off + 12 > len(icc):
            return None
        sig, t_off, t_size = struct.unpack(">4sII", icc[off:off + 12])
        if sig == b"cicp":
            if t_off + 12 > len(icc) or t_size < 12:
                return None
            # type signature 'cicp' + reserved, then 4 bytes of data
            body = icc[t_off:t_off + 12]
            if body[0:4] != b"cicp":
                return None
            return (body[8], body[9], body[10], body[11])
    return None


def is_hdr_icc_profile(icc: bytes) -> bool:
    """True when the CICP tag reports a PQ or HLG transfer function
    (behavioral parity with IsHDRICCProfile, opencv.go:273-278)."""
    if not icc:
        return False
    cicp = parse_cicp(icc)
    if cicp is None:
        return False
    transfer = cicp[1]
    return transfer in (CICP_TRANSFER_PQ, CICP_TRANSFER_HLG)
