"""Shared inputs and JAX-side references for the port's parity tests
(tests/test_torch_*.py): the same numpy inputs go through the JAX package
and through lilliput_tpu_torch, and the results are compared as numpy."""

import io

import numpy as np

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs.jpeg import scaled_qtables
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import pallas_kernels as PK
from lilliput_tpu.ops import resize as JR

#: odd geometries of tests/test_megakernel.py (h, w)
CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129)]
QUALITIES = (30, 85, 95)
#: chroma layout -> (h2, v2): chroma halved along columns, along rows
LAYOUTS = {"420": (True, True), "422": (True, False), "440": (False, True),
           "444": (False, False)}
BENCH = "tests/assets/bench_1080p.jpg"


def bench_path(sub: str = "420") -> str:
    """The 1080p fixture; 4:2:2, 4:4:0, 4:4:4 ("422", "440", "444") and
    grayscale ("gray") are cv2 re-encodes of the 4:2:0 one at q85, "o6" and
    "gray_o6" the 4:2:0 and grayscale ones with an EXIF orientation 6
    segment (CHANGES.md gives the commands)."""
    return BENCH if sub == "420" else f"tests/assets/bench_1080p_{sub}.jpg"


def bench_bytes(sub: str = "420") -> bytes:
    with open(bench_path(sub), "rb") as f:
        return f.read()


def coefs(rng, h, w, sub="420", batch=3):
    """Random coefficient stacks for an h x w image in chroma layout `sub`,
    with the block counts of tests/test_megakernel.py:25-30."""
    h2, v2 = LAYOUTS[sub]

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    cshape = (batch, bl(h, 1 + v2), bl(w, 1 + h2), 64)
    yc = rng.integers(-300, 300, (batch, bl(h, 1), bl(w, 1), 64))
    cb = rng.integers(-200, 200, cshape)
    cr = rng.integers(-200, 200, cshape)
    return tuple(a.astype(np.int16) for a in (yc, cb, cr))


def qtables(qualities=QUALITIES):
    """Per-image (B, 64) uint16 luma and chroma tables."""
    qs = [scaled_qtables(q) for q in qualities]
    return (np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]))


def pil_jpeg(w, h, quality, seed, subsampling=2, **kw) -> bytes:
    """A smooth synthesized JPEG (PIL; subsampling 2 = 4:2:0)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (8, 8, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=quality, subsampling=subsampling, **kw)
    return bio.getvalue()


def layout_jpeg(w, h, quality, seed, sub="420", **kw) -> bytes:
    """pil_jpeg in chroma layout `sub`; PIL cannot write 4:4:0, so that one
    is the same picture through cv2 (kw are PIL's save options)."""
    if sub != "440":
        return pil_jpeg(w, h, quality, seed,
                        subsampling={"444": 0, "422": 1, "420": 2}[sub], **kw)
    import cv2
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(pil_jpeg(w, h, 100, seed))))
    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    assert ok and not kw
    return enc.tobytes()


def exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment whose big-endian TIFF holds one IFD entry: tag
    0x0112 (Orientation), type SHORT, count 1, the given value."""
    tiff = (b"MM\x00*" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + (0x0112).to_bytes(2, "big") + (3).to_bytes(2, "big")
            + (1).to_bytes(4, "big") + orientation.to_bytes(2, "big")
            + bytes(2) + bytes(4))
    return (b"\xff\xe1" + (len(tiff) + 8).to_bytes(2, "big")
            + b"Exif\x00\x00" + tiff)


def with_orientation(buf: bytes, orientation: int) -> bytes:
    """`buf` with an EXIF orientation segment inserted after SOI (as the
    o6 fixtures were made)."""
    return buf[:2] + exif_app1(orientation) + buf[2:]


def gray_jpeg(w, h, quality, seed) -> bytes:
    """A smooth synthesized 1-component JPEG (PIL)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (8, 8), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=quality)
    return bio.getvalue()


def jax_planes(yc, cb, cr, qy, qc):
    """The JAX package's 4:2:0 megakernel (Pallas interpret mode) planes,
    relayouted to raster: (b, g, r), each (B, 16*cbh_pad, 16*cbw) u8."""
    planes = JK.decode_ycc_u8_plane_blocks(
        jnp.asarray(yc), jnp.asarray(cb), jnp.asarray(cr), jnp.asarray(qy),
        jnp.asarray(qc), True, True, interpret=True)
    cbh_pad, cbw = planes[0].shape[-4], planes[0].shape[-2]
    return [np.asarray(PK._blocks_to_plane_xla(
        p.reshape(-1, 2 * cbh_pad, 2 * cbw, 64), 2 * cbh_pad, 2 * cbw))
        for p in planes]


def jax_packed(yc, cb, cr, qy, qc, out_h, out_w, h2, v2):
    """The JAX package's packed decode (jpeg_kernels.decode_ycc_packed,
    its Pallas kernel in interpret mode): (B, out_h, out_w) int32 BGRA, or
    None off-spec."""
    out = JK.decode_ycc_packed(
        jnp.asarray(yc), jnp.asarray(cb), jnp.asarray(cr), jnp.asarray(qy),
        jnp.asarray(qc), out_h, out_w, h2, v2, interpret=True)
    return None if out is None else np.asarray(out)


def _jax_emit(jpipe, out, emit):
    """The JAX colour tails' last stage on the resized planes: the encode
    coefficients, or (emit="pixels") the packed BGRA pixels, as numpy."""
    if emit == "pixels":
        return [np.asarray(JP._pack_pixels(out[0], out[1], out[2]))]
    res = JK.encode_from_bgr_planes(out[0], out[1], out[2], jpipe.enc_qt_y,
                                    jpipe.enc_qt_c, subsample=True)
    return [np.asarray(r) for r in res]


def jax_packed_tail(jpipe, ys, cbs, crs, qty, qtc, emit="coefs"):
    """The JAX pipeline's upright AREA packed tail
    (lilliput_tpu/pipeline.py:282-301), composed from the JAX package's own
    functions with the Pallas kernel in interpret mode (on the CPU the JAX
    pipeline itself takes the split path): quantized (yq, cbq, crq), or
    the packed pixels (emit="pixels"), as numpy."""
    g = jpipe.geom
    left, top, w, h = JP.fit_rect(g.width, g.height, jpipe.dst_w,
                                  jpipe.dst_h)
    x0, y0, rw, rh = jpipe.window_static
    packed = jnp.asarray(jax_packed(ys, cbs, crs, qty, qtc, rh, rw, g.h2,
                                    g.v2))
    cp = packed[..., top - y0:top - y0 + h, left - x0:left - x0 + w]
    planes = [p.astype(jnp.uint8) for p in JK.packed_to_planes(cp)]
    out = [jnp.clip(jnp.round(JR.resize_area_plane_embedded(
        p, 0, w, jpipe.dst_w, 0, h, jpipe.dst_h)), 0, 255) for p in planes]
    return _jax_emit(jpipe, out, emit)


def jax_tail(jpipe, *args, emit="coefs"):
    """The JAX tail the pipeline's layout takes: the block tail for 4:2:0,
    the packed tail for the others."""
    g = jpipe.geom
    tail = jax_block_tail if (g.h2 and g.v2) else jax_packed_tail
    return tail(jpipe, *args, emit=emit)


def jax_block_tail(jpipe, ys, cbs, crs, qty, qtc, emit="coefs"):
    """The JAX pipeline's upright AREA 4:2:0 block tail
    (lilliput_tpu/pipeline.py:259-281), composed from the JAX package's own
    functions with the megakernel in interpret mode: quantized (yq, cbq,
    crq), or the packed pixels (emit="pixels"), as numpy."""
    g = jpipe.geom
    left, top, w, h = JP.fit_rect(g.width, g.height, jpipe.dst_w,
                                  jpipe.dst_h)
    x0, y0 = jpipe.window_static[:2]
    out = [jnp.clip(jnp.round(JR.resize_area_plane_embedded(
        jnp.asarray(p), left - x0, w, jpipe.dst_w, top - y0, h,
        jpipe.dst_h)), 0, 255)
        for p in jax_planes(ys, cbs, crs, qty, qtc)]
    return _jax_emit(jpipe, out, emit)
