"""The port's serving slice as a whole on the CPU: JpegTranscodePipeline
against the JAX package's JpegTranscodePipeline.

* The host decode window (or the whole frame, pad row included) and the
  per-image tables are equal.
* device_step's quantized coefficients equal the JAX function's at atol 0.
  Upright colour: the JAX tail of the source's chroma layout, the block
  tail for 4:2:0 (lilliput_tpu/pipeline.py:259-281), the packed tail for
  4:2:2, 4:4:0 and 4:4:4 (:282-301), each composed from the JAX package's
  own functions with its Pallas kernel in interpret mode. Grayscale
  (:422-478) and every EXIF orientation other than 1 (:304-318): the JAX
  pipeline's own device_step, whose split path on the CPU runs the IDCT
  as the XLA dot the Pallas kernel is held to (tests/test_torch_idct.py).
  For synthesized JPEGs at mixed qualities, all eight orientations on
  small non-square sources, and the 1080p fixtures.
* transcode's bytes equal the JAX encode_entropy of the JAX coefficients,
  3-component and grayscale.
* Corrupt buffers fail only their own slots, in every layout, grayscale
  and oriented, and a truncated scan decodes (libjpeg, as in the JAX
  package) into its own slot; optimize_coding's bytes equal the JAX
  front's; .png and .webp output and encode_options construct, and the
  direct, dct_scale and LINEAR/CUBIC modes construct (their parity tests
  are tests/test_torch_direct.py and tests/test_torch_pipeline_modes.py).
"""

import io

import numpy as np
import pytest

from lilliput_tpu import pipeline as JP
from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch.codecs import jpeg as J
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.utils.metrics import metrics

from _torch_parity import (LAYOUTS, bench_bytes, gray_jpeg, jax_tail,
                           layout_jpeg, pil_jpeg, with_orientation)

NEW_SUBS = ("422", "440", "444")


def _pair(bufs, dst_w, dst_h):
    jp = JP.JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85)
    tp = JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85,
                               device="cpu")
    return jp, tp


def _jax_step(jpipe, *args):
    """The JAX pipeline's own device step, as numpy."""
    return [np.asarray(r) for r in jpipe.device_step(*args, donate=False)]


def _check_step(bufs, dst_w, dst_h, ref_step=jax_tail):
    jp, tp = _pair(bufs, dst_w, dst_h)
    assert tp.window_static == jp.window_static
    jargs = jp.decode_entropy(bufs)
    targs = tp.decode_entropy(bufs)
    assert len(jargs) == len(targs)
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(a, b)
    ref = ref_step(jp, *jargs)
    DK.reset_launches()
    got = [t.numpy() for t in tp.device_step(*targs)]
    assert not any(DK.launches.values())  # CPU tensors: the plain version
    for g, r in zip(got, ref):
        assert g.dtype == np.int16 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    # bytes: the port's encoder on the port's coefficients vs libjpeg on
    # the JAX coefficients
    iccs = [b"profile-%d" % i for i in range(len(bufs))]
    assert tp.encode_entropy(*got, iccs=iccs) == jp.encode_entropy(
        *ref, iccs=iccs)
    return jp, tp


STEP_CASES = [((200, 150), (64, 48)), ((67, 61), (100, 90))]


def _check_layout_step(sub, src, dst):
    bufs = [layout_jpeg(*src, q, seed, sub)
            for seed, q in enumerate((30, 85, 95))]
    jp, _ = _check_step(bufs, *dst)
    assert (jp.geom.h2, jp.geom.v2) == LAYOUTS[sub]


@pytest.mark.parametrize("src,dst", STEP_CASES)
def test_device_step_matches_jax_block_tail(src, dst):
    _check_layout_step("420", src, dst)


@pytest.mark.parametrize("src,dst", STEP_CASES)
@pytest.mark.parametrize("sub", NEW_SUBS)
def test_device_step_matches_jax_packed_tail(sub, src, dst):
    _check_layout_step(sub, src, dst)


def test_device_step_matches_jax_on_bench_fixture():
    _check_step([bench_bytes()], 256, 256)


@pytest.mark.parametrize("sub", NEW_SUBS)
def test_device_step_matches_jax_on_layout_fixtures(sub):
    _check_step([bench_bytes(sub)], 256, 256)


def _check_bytes(sub):
    icc = bytes(range(256)) * 20
    if sub == "440":      # cv2 writes no ICC profile
        bufs = [layout_jpeg(320, 200, 88, s, sub) for s in range(2)]
        icc = b""
    else:
        bufs = [layout_jpeg(320, 200, 88, s, sub, icc_profile=icc)
                for s in range(2)]
    jp, tp = _pair(bufs, 64, 64)
    jcoefs = jax_tail(jp, *jp.decode_entropy(bufs))
    want = jp.encode_entropy(*jcoefs, iccs=[icc, icc])
    assert tp.transcode(bufs) == want
    assert tp.transcode_pipelined([bufs, bufs[::-1]]) == [want, want[::-1]]


def test_transcode_bytes_equal_jax():
    _check_bytes("420")


@pytest.mark.parametrize("sub", NEW_SUBS)
def test_transcode_bytes_equal_jax_in_every_layout(sub):
    _check_bytes(sub)


def _check_poison(sub):
    g1, g2 = (layout_jpeg(320, 200, 85, s, sub) for s in (11, 12))
    other = "444" if sub == "420" else "420"
    pipe = JpegTranscodePipeline(g1, 64, 64, quality=85, device="cpu")
    solo1 = pipe.transcode([g1])[0]
    solo2 = pipe.transcode([g2])[0]
    # a truncated scan decodes through libjpeg, as in the JAX package
    # (tests/test_torch_jpeg_libjpeg.py): its slot holds its own transcode
    cut = g1[:len(g1) // 2]
    solo_cut = pipe.transcode([cut])[0]
    assert isinstance(solo_cut, bytes) and solo_cut not in (solo1, solo2)
    assert pipe.transcode([g1, cut, g2]) == [solo1, solo_cut, solo2]
    for poison in (layout_jpeg(320, 200, 85, 13, sub)[:100],  # truncated
                   layout_jpeg(640, 360, 85, 14, sub),  # other geometry
                   layout_jpeg(320, 200, 85, 15, other),  # other layout
                   b"\xff\xd8\xff\xe0garbage"):         # unparseable
        metrics.reset()
        outs = pipe.transcode([g1, poison, g2], return_exceptions=True)
        assert outs[0] == solo1 and outs[2] == solo2
        assert isinstance(outs[1], DecodingFailedError)
        assert metrics.snapshot()["counters"]["serving.poison_isolated"] == 1
        with pytest.raises(DecodingFailedError):
            pipe.transcode([g1, poison, g2])
    res = pipe.transcode_pipelined([[g1, g2], [g1, g1[:70], g2]],
                                   return_exceptions=True)
    assert res[0] == [solo1, solo2]
    assert res[1][0] == solo1 and res[1][2] == solo2
    assert isinstance(res[1][1], DecodingFailedError)


def test_poison_isolation():
    _check_poison("420")


@pytest.mark.parametrize("sub", NEW_SUBS)
def test_poison_isolation_in_every_layout(sub):
    _check_poison(sub)


def _check_pooled_lane(sub):
    g, other = (layout_jpeg(320, 200, 85, s, sub) for s in (21, 22))
    pipe = JpegTranscodePipeline(g, 48, 48, quality=85, device="cpu")
    pipe.transcode([g, other])
    pipe.transcode([g, other])
    errors = {}
    arrs = pipe.decode_entropy([g, other[:80]], pool=True, errors=errors)
    assert list(errors) == [1]
    assert not np.any(arrs[0][1]) and not np.any(arrs[3][1])


def test_pooled_failed_lane_is_zeroed():
    _check_pooled_lane("420")


@pytest.mark.parametrize("sub", NEW_SUBS)
def test_pooled_failed_lane_is_zeroed_in_every_layout(sub):
    _check_pooled_lane(sub)


def _exif_jpeg(orientation: int) -> bytes:
    from PIL import Image
    img = Image.new("RGB", (64, 48), (10, 200, 30))
    exif = Image.Exif()
    exif[0x0112] = orientation
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=85, exif=exif.tobytes())
    return bio.getvalue()


def test_optimize_coding_equals_jax_and_every_path_constructs():
    src = pil_jpeg(200, 150, 85, 0)
    # optimize_coding: the JAX front's libjpeg bytes (optimal tables), in
    # colour and grayscale, each no larger than the baseline output
    for bufs, dst in (([src, pil_jpeg(200, 150, 60, 1)], (64, 48)),
                      ([gray_jpeg(64, 48, 85, s) for s in (0, 1)], (32, 32))):
        jp = JP.JpegTranscodePipeline(bufs[0], *dst, quality=85,
                                      optimize_coding=True)
        tp = JpegTranscodePipeline(bufs[0], *dst, quality=85,
                                   optimize_coding=True, device="cpu")
        coefs = [t.numpy() for t in tp.device_step(*tp.decode_entropy(bufs))]
        iccs = [b"", b"profile"]
        got = tp.encode_entropy(*coefs, iccs=iccs)
        assert got == jp.encode_entropy(*coefs, iccs=iccs)
        assert tp.transcode(bufs) == tp.encode_entropy(*coefs)
        base = JpegTranscodePipeline(bufs[0], *dst, quality=85,
                                     device="cpu").encode_entropy(*coefs)
        assert all(len(o) <= len(b) for o, b in zip(got, base))
    # .png and .webp output and encode_options are served (tests/
    # test_torch_pipeline_pixels.py and test_torch_webp_serving.py hold
    # them against the JAX package)
    for kw in ({"output_format": ".png"},
               {"output_format": ".png", "encode_options": {16: 9}},
               {"output_format": ".webp"},
               {"encode_options": {16: 9}}):
        assert JpegTranscodePipeline(src, 64, 48, device="cpu",
                                     **kw).output_format in (
            ".png", ".webp", ".jpeg")
    from PIL import Image
    # every chroma layout, grayscale, and EXIF orientations (PIL's own
    # Exif writer here) are served, in every JPEG-out mode
    assert JpegTranscodePipeline(_exif_jpeg(6), 64, 48,
                                 device="cpu").orientation == 6
    for sub in LAYOUTS:
        JpegTranscodePipeline(layout_jpeg(200, 150, 85, 0, sub), 64, 48,
                              device="cpu")
    for kw in ({"chroma_mode": "direct"},
               {"chroma_mode": "direct", "dct_scale": 2},
               {"chroma_mode": "direct", "dct_scale": 4},
               {"method": "linear"}, {"method": "cubic"}):
        for buf, dst in ((src, (64, 48)), (gray_jpeg(64, 48, 85, 0),
                                           (32, 32))):
            pipe = JpegTranscodePipeline(buf, *dst, device="cpu", **kw)
            assert pipe.dct_scale == kw.get("dct_scale", 1)
    bio = io.BytesIO()
    Image.new("L", (64, 48), 90).save(bio, "JPEG")
    assert JpegTranscodePipeline(bio.getvalue(), 32, 32,
                                 device="cpu").ncomp == 1
    with pytest.raises(ValueError):
        JpegTranscodePipeline(src, 64, 48, device="cpu", chroma_mode="x")


# -- grayscale and EXIF-oriented sources -------------------------------------

@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_gray_device_step_matches_jax_on_fixture(orientation):
    """The 1080p grayscale fixture, upright (the MCU window and the matmul
    IDCT) and oriented (the whole frame through decode_gray); 6 is the
    committed bench_1080p_gray_o6.jpg."""
    buf = bench_bytes("gray")
    if orientation != 1:
        buf = with_orientation(buf, orientation)
    jp, tp = _check_step([buf, buf], 256, 256, _jax_step)
    assert tp.ncomp == 1 and tp.orientation == orientation
    assert tp.window_static == ((408, 0, 1104, 1080) if orientation == 1
                                else None)


def test_oriented_device_step_matches_jax_on_fixture():
    """The 4:2:0 fixture with EXIF orientation 6: the whole frame (luma
    padded to 136 block rows) through the decode kernel's plain version."""
    buf = bench_bytes("o6")
    jp, tp = _check_step([buf, buf], 256, 256, _jax_step)
    assert tp.orientation == 6 and tp.window_static is None
    ys = tp.decode_entropy([buf])[0]
    assert ys.shape == (1, 136, 240, 64) and not ys[:, 135].any()


@pytest.mark.parametrize("sub", NEW_SUBS)
def test_oriented_device_step_matches_jax_in_every_layout(sub):
    bufs = [with_orientation(layout_jpeg(200, 150, q, seed, sub), 6)
            for seed, q in enumerate((30, 85, 95))]
    _check_step(bufs, 64, 48, _jax_step)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["gray", "420"])
def test_every_orientation_matches_jax(kind, orientation):
    """All eight codes on a non-square source (67 x 45) to a non-square
    destination, so that the Fit rect depends on the swap."""
    def make(q, seed):
        return (gray_jpeg(67, 45, q, seed) if kind == "gray"
                else layout_jpeg(67, 45, q, seed, "420"))
    bufs = [with_orientation(make(q, seed), orientation)
            for seed, q in enumerate((30, 85, 95))]
    _check_step(bufs, 40, 24, _jax_step)


def test_gray_transcode_bytes_equal_jax():
    icc = bytes(range(256)) * 20
    from PIL import Image
    upright = []
    for seed in range(2):
        bio = io.BytesIO()
        Image.open(io.BytesIO(gray_jpeg(320, 200, 88, seed))).save(
            bio, "JPEG", quality=88, icc_profile=icc)
        upright.append(bio.getvalue())
    for srcs in (upright, [with_orientation(b, 5) for b in upright]):
        jp, tp = _pair(srcs, 64, 64)
        want = jp.encode_entropy(*_jax_step(jp, *jp.decode_entropy(srcs)),
                                 iccs=[icc, icc])
        assert tp.transcode(srcs) == want
        assert tp.transcode_pipelined([srcs, srcs[::-1]]) == [want,
                                                             want[::-1]]
        assert all(J.read_info(o).num_components == 1 for o in want)


@pytest.mark.parametrize("sub", ["440", "420"])
def test_full_frame_pad_row_stays_zero_in_pooled_reuse(sub):
    """Whole frames of vertically subsampled layouts with an odd luma block
    row count (150 rows: 19) carry a zero pad row that nothing writes; the
    pooled arrays keep it zero across batches, as in the JAX package."""
    bufs = [with_orientation(layout_jpeg(200, 150, 85, s, sub), 3)
            for s in range(4)]
    jp, tp = _pair(bufs, 64, 48)
    for batch in (bufs[:2], bufs[2:], bufs[1:3]):
        got = tp.decode_entropy(batch, pool=True)
        want = jp.decode_entropy(batch, pool=True)
        assert got[0].shape[1] == 20 and not got[0][:, 19].any()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["gray", "gray_o6", "420_o6"])
def test_poison_isolation_gray_and_oriented(kind):
    def make(seed, w=320, h=200):
        src = (gray_jpeg(w, h, 85, seed) if kind.startswith("gray")
               else layout_jpeg(w, h, 85, seed, "420"))
        return with_orientation(src, 6) if kind.endswith("o6") else src
    g1, g2 = make(31), make(32)
    pipe = JpegTranscodePipeline(g1, 64, 64, quality=85, device="cpu")
    solo1, solo2 = pipe.transcode([g1])[0], pipe.transcode([g2])[0]
    # a truncated scan decodes through libjpeg, as in the JAX package
    # (tests/test_torch_jpeg_libjpeg.py): its slot holds its own transcode
    cut = g1[:len(g1) // 2]
    solo_cut = pipe.transcode([cut])[0]
    assert isinstance(solo_cut, bytes) and solo_cut not in (solo1, solo2)
    assert pipe.transcode([g1, cut, g2]) == [solo1, solo_cut, solo2]
    other = (layout_jpeg(320, 200, 85, 33, "420") if kind.startswith("gray")
             else gray_jpeg(320, 200, 85, 33))
    for poison in (g1[:100],                            # truncated header
                   make(34, 640, 360),                  # other geometry
                   with_orientation(other, 6),          # other components
                   with_orientation(make(35), 3),       # other orientation
                   b"\xff\xd8\xff\xe0garbage"):         # unparseable
        outs = pipe.transcode([g1, poison, g2], return_exceptions=True)
        assert outs[0] == solo1 and outs[2] == solo2
        assert isinstance(outs[1], DecodingFailedError)
    errors = {}
    arrs = pipe.decode_entropy([g1, g2[:80]], pool=True, errors=errors)
    assert list(errors) == [1]
    assert not any(np.any(a[1]) for a in arrs)
