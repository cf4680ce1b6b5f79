"""The port's LINEAR/CUBIC serving modes and its LILLIPUT_FUSED_EXACT tier
end to end on the CPU, against the JAX package at atol 0
(test_torch_direct.check_step: decode_entropy's arrays, device_step's
quantized coefficients and the entropy-coded bytes):

* method="linear" and "cubic" in the four chroma layouts, upright (the
  layout's decode kernel, here its plain version, then crop and the
  streaming kernels; on the CPU the JAX pipeline takes the split decode,
  which the plain versions match bit for bit) and at EXIF orientation 6,
  and grayscale upright (the matmul IDCT) and oriented (decode_gray);
* LILLIPUT_FUSED_EXACT=1 at the geometries of tests/test_pipeline.py's
  exact-tier tests: the upright colour tails against the JAX tail of the
  layout (composed from the JAX package's functions, as on the TPU), the
  grayscale and oriented paths against the JAX pipeline's own step, and
  the exact upright output equal to crop + streaming AREA resize. JAX
  reads the variable at trace time, so its caches are cleared around
  each setting.
"""

import jax
import numpy as np
import pytest
import torch

from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch import pipeline as P
from lilliput_tpu_torch.ops import jpeg_kernels as K
from lilliput_tpu_torch.ops import resize as R

from _torch_parity import LAYOUTS, gray_jpeg, jax_tail, layout_jpeg, \
    with_orientation
from test_torch_direct import check_step


def _bufs(src, kind, orientation=1):
    def make(q, seed):
        return (gray_jpeg(*src, q, seed) if kind == "gray"
                else layout_jpeg(*src, q, seed, kind))
    bufs = [make(q, seed) for seed, q in enumerate((30, 85, 95))]
    if orientation != 1:
        bufs = [with_orientation(b, orientation) for b in bufs]
    return bufs


@pytest.mark.parametrize("orientation", [1, 6])
@pytest.mark.parametrize("kind", list(LAYOUTS) + ["gray"])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_method_step_matches_jax(method, kind, orientation):
    """200x150 to a 64x48 Fit (a downscale) in every layout and
    grayscale, upright and rotated."""
    _, tp, _ = check_step(_bufs((200, 150), kind, orientation), 64, 48,
                          method=method)
    assert tp.method == method and tp.orientation == orientation


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("kind", ["420", "444", "gray"])
def test_method_upscale_step_matches_jax(method, kind):
    """67x61 to a 100x90 Fit: both axes upscale."""
    check_step(_bufs((67, 61), kind), 100, 90, method=method)


def test_method_transcode_bytes_equal_jax():
    from lilliput_tpu import pipeline as JP
    icc = bytes(range(256)) * 20
    bufs = [layout_jpeg(320, 200, 88, s, "422", icc_profile=icc)
            for s in range(2)]
    jp = JP.JpegTranscodePipeline(bufs[0], 64, 64, quality=85,
                                  method="cubic")
    tp = JpegTranscodePipeline(bufs[0], 64, 64, quality=85, device="cpu",
                               method="cubic")
    want = jp.transcode(bufs)
    assert tp.transcode(bufs) == want
    assert tp.transcode_pipelined([bufs, bufs[::-1]]) == [want, want[::-1]]


# -- LILLIPUT_FUSED_EXACT ------------------------------------------------------

#: (src w, h, dst w, h): tests/test_pipeline.py:981-982 (the general taps,
#: the integer paths, the 2x2 specialization) and :1015-1017 (upscales)
EXACT_GEOMS = [(640, 360, 64, 64), (512, 512, 128, 128), (256, 256, 128, 128),
               (320, 199, 48, 36), (64, 48, 128, 96), (320, 199, 400, 80),
               (100, 90, 100, 180)]


@pytest.fixture
def fused_exact(monkeypatch):
    import lilliput_tpu.pipeline as JP
    fns = (JP.fused_jpeg_fit_transcode, JP.fused_jpeg_fit_transcode_ycc,
           JP._fused_jpeg_fit_donating, JP.fused_jpeg_fit_transcode_gray,
           JP._fused_jpeg_fit_gray_donating)
    for f in fns:
        f.clear_cache()
    monkeypatch.setenv("LILLIPUT_FUSED_EXACT", "1")
    yield
    monkeypatch.delenv("LILLIPUT_FUSED_EXACT")
    for f in fns:
        f.clear_cache()
    jax.clear_caches()


def _streaming_step(tp, args):
    """The exact tier's promise on the upright colour path: the window's
    decoded planes, cropped, through the streaming resize(AREA), rounded,
    then the same encode."""
    g = tp.geom
    left, top, w, h = P.fit_rect(g.width, g.height, tp.dst_w, tp.dst_h)
    x0, y0, rw, rh = tp.window_static
    t = [torch.from_numpy(a) for a in args]
    planes = K.decode_ycc_420(*t[:3], t[3].float(), t[4].float(), rh, rw,
                              g.h2, g.v2)
    out = [R.resize(p[..., top - y0:top - y0 + h, left - x0:left - x0 + w,
                      None], tp.dst_w, tp.dst_h, R.AREA)[..., 0].float()
           for p in planes]
    return [r.numpy() for r in K.encode_from_bgr_planes(
        *out, tp.enc_qt_y, tp.enc_qt_c)]


@pytest.mark.parametrize("sub", ["420", "444"])
@pytest.mark.parametrize("geom", EXACT_GEOMS, ids=str)
def test_fused_exact_colour_matches_jax_tail(geom, sub, fused_exact):
    sw, sh, dw, dh = geom
    bufs = [layout_jpeg(sw, sh, 88, (sw ^ sh) & 127, sub)]
    _, tp, args = check_step(bufs, dw, dh, ref_step=jax_tail)
    for g, r in zip([t.numpy() for t in tp.device_step(*args)],
                    _streaming_step(tp, args)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kind", ["gray", "gray_o6", "420_o6"])
@pytest.mark.parametrize("geom", EXACT_GEOMS, ids=str)
def test_fused_exact_gray_and_oriented_match_jax(geom, kind, fused_exact):
    """Grayscale upright (the crop folded into the exact window form),
    grayscale oriented (the streaming resize, untouched by the variable)
    and colour oriented (resize_area_mxu_or_exact, whose exact forms'
    values are encoded unrounded, as in the JAX package)."""
    sw, sh, dw, dh = geom
    src = (gray_jpeg(sw, sh, 88, 5) if kind.startswith("gray")
           else layout_jpeg(sw, sh, 88, 5, "420"))
    if kind.endswith("o6"):
        src = with_orientation(src, 6)
    check_step([src], dw, dh)
