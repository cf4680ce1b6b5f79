"""The port's serving slice as a whole on the CPU: JpegTranscodePipeline
against the JAX package's JpegTranscodePipeline.

* The host decode window and per-image tables are equal.
* device_step's quantized coefficients equal the JAX block tail
  (lilliput_tpu/pipeline.py:259-281 composed from the JAX package's own
  functions, megakernel in interpret mode) at atol 0, for synthesized
  4:2:0 JPEGs at mixed qualities and for the 1080p bench fixture.
* transcode's bytes equal the JAX encode_entropy of the JAX coefficients.
* Corrupt buffers fail only their own slots; paths outside the slice
  raise NotImplementedError.
"""

import io

import numpy as np
import pytest

from lilliput_tpu import pipeline as JP
from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch.errors import DecodingFailedError
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.utils.metrics import metrics

from _torch_parity import bench_bytes, jax_block_tail, pil_jpeg


def _pair(bufs, dst_w, dst_h):
    jp = JP.JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85)
    tp = JpegTranscodePipeline(bufs[0], dst_w, dst_h, quality=85,
                               device="cpu")
    return jp, tp


def _check_step(bufs, dst_w, dst_h):
    jp, tp = _pair(bufs, dst_w, dst_h)
    jargs = jp.decode_entropy(bufs)
    targs = tp.decode_entropy(bufs)
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(a, b)
    ref = jax_block_tail(jp, *jargs)
    DK.launches = 0
    got = [t.numpy() for t in tp.device_step(*targs)]
    assert DK.launches == 0          # CPU tensors take the plain version
    for g, r in zip(got, ref):
        assert g.dtype == np.int16 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    # bytes: the port's encoder on the port's coefficients vs libjpeg on
    # the JAX coefficients
    iccs = [b"profile-%d" % i for i in range(len(bufs))]
    assert tp.encode_entropy(*got, iccs=iccs) == jp.encode_entropy(
        *ref, iccs=iccs)
    return jp, tp


@pytest.mark.parametrize("src,dst", [((200, 150), (64, 48)),
                                     ((67, 61), (100, 90))])
def test_device_step_matches_jax_block_tail(src, dst):
    bufs = [pil_jpeg(*src, q, seed) for seed, q in enumerate((30, 85, 95))]
    _check_step(bufs, *dst)


def test_device_step_matches_jax_on_bench_fixture():
    _check_step([bench_bytes()], 256, 256)


def test_transcode_bytes_equal_jax():
    icc = bytes(range(256)) * 20
    bufs = [pil_jpeg(320, 200, 88, s, icc_profile=icc) for s in range(2)]
    jp, tp = _pair(bufs, 64, 64)
    jcoefs = jax_block_tail(jp, *jp.decode_entropy(bufs))
    want = jp.encode_entropy(*jcoefs, iccs=[icc, icc])
    assert tp.transcode(bufs) == want
    assert tp.transcode_pipelined([bufs, bufs[::-1]]) == [want, want[::-1]]


def test_poison_isolation():
    g1, g2 = pil_jpeg(320, 200, 85, 11), pil_jpeg(320, 200, 85, 12)
    pipe = JpegTranscodePipeline(g1, 64, 64, quality=85, device="cpu")
    solo1 = pipe.transcode([g1])[0]
    solo2 = pipe.transcode([g2])[0]
    for poison in (pil_jpeg(320, 200, 85, 13)[:100],   # truncated header
                   g1[:len(g1) // 2],                   # truncated scan
                   pil_jpeg(640, 360, 85, 14),          # other geometry
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


def test_pooled_failed_lane_is_zeroed():
    g, other = pil_jpeg(320, 200, 85, 21), pil_jpeg(320, 200, 85, 22)
    pipe = JpegTranscodePipeline(g, 48, 48, quality=85, device="cpu")
    pipe.transcode([g, other])
    pipe.transcode([g, other])
    errors = {}
    arrs = pipe.decode_entropy([g, other[:80]], pool=True, errors=errors)
    assert list(errors) == [1]
    assert not np.any(arrs[0][1]) and not np.any(arrs[3][1])


def _exif_jpeg(orientation: int) -> bytes:
    from PIL import Image
    img = Image.new("RGB", (64, 48), (10, 200, 30))
    exif = Image.Exif()
    exif[0x0112] = orientation
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=85, exif=exif.tobytes())
    return bio.getvalue()


def test_paths_outside_the_slice_refuse():
    src = pil_jpeg(200, 150, 85, 0)
    for kw in ({"chroma_mode": "direct"}, {"dct_scale": 2},
               {"method": "linear"}, {"output_format": ".webp"},
               {"optimize_coding": True}):
        with pytest.raises(NotImplementedError):
            JpegTranscodePipeline(src, 64, 48, device="cpu", **kw)
    from PIL import Image
    for other in (pil_jpeg(200, 150, 85, 0, subsampling=0),     # 4:4:4
                  pil_jpeg(200, 150, 85, 0, subsampling=1),     # 4:2:2
                  _exif_jpeg(6)):
        with pytest.raises(NotImplementedError):
            JpegTranscodePipeline(other, 64, 48, device="cpu")
    bio = io.BytesIO()
    Image.new("L", (64, 48), 90).save(bio, "JPEG")
    with pytest.raises(NotImplementedError):
        JpegTranscodePipeline(bio.getvalue(), 32, 32, device="cpu")
    with pytest.raises(ValueError):
        JpegTranscodePipeline(src, 64, 48, device="cpu", chroma_mode="x")
