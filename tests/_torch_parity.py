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

#: odd 4:2:0 geometries of tests/test_megakernel.py (h, w)
CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129)]
QUALITIES = (30, 85, 95)
BENCH = "tests/assets/bench_1080p.jpg"


def bench_bytes() -> bytes:
    with open(BENCH, "rb") as f:
        return f.read()


def coefs_420(rng, h, w, batch=3):
    """Random 4:2:0 coefficient stacks for an h x w image."""
    def bl(n, f):
        return (-(-n // f) + 7) // 8
    yc = rng.integers(-300, 300, (batch, bl(h, 1), bl(w, 1), 64))
    cb = rng.integers(-200, 200, (batch, bl(h, 2), bl(w, 2), 64))
    cr = rng.integers(-200, 200, (batch, bl(h, 2), bl(w, 2), 64))
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


def jax_block_tail(jpipe, ys, cbs, crs, qty, qtc):
    """The JAX pipeline's upright AREA 4:2:0 block tail
    (lilliput_tpu/pipeline.py:259-281), composed from the JAX package's own
    functions with the megakernel in interpret mode: quantized (yq, cbq,
    crq) as numpy."""
    g = jpipe.geom
    left, top, w, h = JP.fit_rect(g.width, g.height, jpipe.dst_w,
                                  jpipe.dst_h)
    x0, y0 = jpipe.window_static[:2]
    out = [jnp.clip(jnp.round(JR.resize_area_plane_embedded(
        jnp.asarray(p), left - x0, w, jpipe.dst_w, top - y0, h,
        jpipe.dst_h)), 0, 255)
        for p in jax_planes(ys, cbs, crs, qty, qtc)]
    res = JK.encode_from_bgr_planes(out[0], out[1], out[2], jpipe.enc_qt_y,
                                    jpipe.enc_qt_c, subsample=True)
    return [np.asarray(r) for r in res]
