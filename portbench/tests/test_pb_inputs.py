"""The input makers: the same seed gives the same bytes, the bytes hold
what the maker kept for the reference, and the JPEG sources have a
camera photo's compressed size."""

import numpy as np
import pytest

from portbench.inputs import gif_pans, jpeg_photos
from portbench.reference.gif_decode import decode_gif
from portbench.reference.jpeg_decode import decode_baseline

JPEG = {"width": 320, "height": 200, "sources": 3, "qualities": [80, 85, 90],
        "orientation": 1, "texture": 1.75, "rects": 6}
GIF = {"canvas": 96, "frame_counts": [3, 7], "photo_width": 240,
       "photo_height": 160, "photos": 2, "texture": 1.75, "rects": 6}
SEED = 2 ** 31 + 977


def test_jpeg_same_seed_same_bytes():
    a = jpeg_photos.make(JPEG, SEED, "cpu")
    b = jpeg_photos.make(JPEG, SEED, "cpu")
    c = jpeg_photos.make(JPEG, SEED + 1, "cpu")
    assert a["bufs"] == b["bufs"]
    assert a["bufs"] != c["bufs"]
    assert len(set(a["bufs"])) == JPEG["sources"]
    assert sorted(s["quality"] for s in a["sources"]) == [80, 85, 90]


def test_jpeg_bytes_hold_the_kept_coefficients():
    out = jpeg_photos.make(dict(JPEG, orientation=6), SEED, "cpu")
    for buf, src in zip(out["bufs"], out["sources"]):
        assert buf[2:4] == b"\xff\xe1" and b"Exif" in buf[:32]
        got = decode_baseline(buf)
        assert (got["width"], got["height"]) == (320, 200)
        assert got["sampling"] == [(2, 2), (1, 1), (1, 1)]
        for g, w in zip(got["coefs"], src["coefs"]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got["qtables"], src["qtables"]):
            np.testing.assert_array_equal(g, w)


def test_jpeg_bits_per_pixel_near_the_fixture():
    # tests/assets/bench_1080p.jpg: 191,383 B at 1920x1080, 0.74 bit/pixel;
    # the sources keep within 10% of it at the cells' size
    out = jpeg_photos.make(dict(JPEG, width=1920, height=1080, sources=3),
                           SEED, "cpu")
    assert out["bits_per_pixel"] == pytest.approx(0.74, rel=0.10)


def test_gif_same_seed_same_bytes():
    a = gif_pans.make(GIF, SEED, "cpu")
    b = gif_pans.make(GIF, SEED, "cpu")
    c = gif_pans.make(GIF, SEED + 1, "cpu")
    assert a["bufs"] == b["bufs"]
    assert a["bufs"] != c["bufs"]
    assert a["frames"] == 10
    assert sorted(len(s["frames"]) for s in a["sources"]) == [3, 7]


def test_gif_bytes_hold_the_kept_frames():
    out = gif_pans.make(GIF, SEED, "cpu")
    for buf, src in zip(out["bufs"], out["sources"]):
        got = decode_gif(buf)
        assert got["bg_index"] == src["bg_index"]
        np.testing.assert_array_equal(got["global_palette"],
                                      src["global_palette"])
        assert len(got["frames"]) == len(src["frames"])
        for g, w in zip(got["frames"], src["frames"]):
            np.testing.assert_array_equal(g["indices"], w["indices"])
            for k in ("left", "top", "trans", "disposal", "delay_cs",
                      "interlace"):
                assert g[k] == w[k], k
            assert (g["palette"] is None) == (w["palette"] is None)
