"""The plain reference's stages at small sizes, against hand counts, and
against the program's CPU path."""

import numpy as np
import pytest
import torch

from portbench import native
from portbench.inputs import gif_pans, jpeg_photos
from portbench.reference import gif_decode, gif_fit, jpeg_decode, jpeg_fit


def test_area_matrix_by_hand():
    # 4 -> 3: cells of 4/3 source pixels
    m = jpeg_fit.area_matrix(4, 3).numpy()
    np.testing.assert_allclose(m, [[0.75, 0.25, 0, 0], [0, 0.5, 0.5, 0],
                                   [0, 0, 0.25, 0.75]])
    for src, dst in ((1080, 256), (480, 128), (3024, 256)):
        m = jpeg_fit.area_matrix(src, dst).numpy()
        np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-12)
    with pytest.raises(ValueError):
        jpeg_fit.area_matrix(3, 4)


def test_fit_rect_by_hand():
    assert jpeg_fit.fit_rect(1920, 1080, 256, 256) == (420, 0, 1080, 1080)
    assert jpeg_fit.fit_rect(3024, 4032, 256, 256) == (0, 504, 3024, 3024)
    assert jpeg_fit.fit_rect(480, 480, 128, 128) == (0, 0, 480, 480)


def test_idct_of_a_dc_block_is_flat():
    coefs = np.zeros((1, 1, 64), np.int16)
    coefs[0, 0, 0] = 10
    q = np.full(64, 2, np.uint16)
    p = jpeg_fit.idct_plane(coefs, q, torch.float64, "cpu")
    np.testing.assert_allclose(p.numpy(), 128 + 10 * 2 / 8)


def test_fancy_upsample_taps():
    x = torch.tensor([[0.0, 4.0, 8.0]], dtype=torch.float64)
    np.testing.assert_allclose(jpeg_fit._fancy2x(x, 1).numpy(),
                               [[0, 1, 3, 5, 7, 8]])


def test_orientation_6_turns_clockwise():
    img = torch.arange(6, dtype=torch.float64).reshape(1, 2, 3)
    out = jpeg_fit.orient(img, 6)[0]
    # a quarter turn clockwise: out[i, j] = in[H - 1 - j, i]
    assert out.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            assert out[i, j] == img[0, 1 - j, i]


def test_jpeg_encode_decode_round_trip():
    rng = np.random.default_rng(1)
    comps = [rng.integers(-60, 60, (4, 6, 64)).astype(np.int16),
             rng.integers(-30, 30, (2, 3, 64)).astype(np.int16),
             rng.integers(-30, 30, (2, 3, 64)).astype(np.int16)]
    ql, qc = jpeg_fit.ijg_tables(85)
    got = jpeg_decode.decode_baseline(native.jpeg_encode(
        48, 32, comps, [2, 1, 1], [2, 1, 1], ql, qc))
    for g, w in zip(got["coefs"], comps):
        np.testing.assert_array_equal(g, w)


def test_ijg_tables_quality_85():
    ql, qc = jpeg_fit.ijg_tables(85)
    assert ql[0] == 5 and ql[1] == 3 and qc[0] == 5 and qc[-1] == 30


def _anim():
    pal = np.zeros((4, 3), np.uint8)
    pal[1], pal[2], pal[3] = (255, 0, 0), (0, 255, 0), (0, 0, 255)
    f0 = {"indices": np.full((4, 4), 1, np.uint8), "left": 0, "top": 0,
          "palette": None, "trans": -1, "disposal": 2, "delay_cs": 4,
          "interlace": False}
    f1 = {"indices": np.full((2, 2), 2, np.uint8), "left": 1, "top": 1,
          "palette": None, "trans": -1, "disposal": 3, "delay_cs": 4,
          "interlace": False}
    f2 = {"indices": np.array([[3, 0], [0, 3]], np.uint8), "left": 2,
          "top": 2, "palette": None, "trans": 0, "disposal": 1,
          "delay_cs": 4, "interlace": False}
    return {"width": 4, "height": 4, "global_palette": pal, "bg_index": 0,
            "frames": [f0, f1, f2]}


def test_composite_disposals_by_hand():
    fr = gif_fit.composite(_anim())
    red, green, blue, bg = ([0, 0, 255, 255], [0, 255, 0, 255],
                            [255, 0, 0, 255], [0, 0, 0, 255])
    assert (fr[0] == red).all()
    # frame 0's disposal 2 restores its whole rect to the background
    assert (fr[1][1:3, 1:3] == green).all()
    assert (fr[1][0] == bg).all()
    # frame 1's disposal 3 restores its rect to the canvas before it;
    # frame 2 draws only its non-transparent pixels
    assert (fr[2][2, 2] == blue).all() and (fr[2][3, 3] == blue).all()
    assert (fr[2][2, 3] == bg).all()
    assert (fr[2][1, 1] == bg).all()


def test_quantize_first_lowest_entry_and_transparency():
    pal = np.array([[0, 0, 0], [100, 100, 100], [100, 100, 100]], np.uint8)
    frames = np.zeros((1, 1, 3, 4), np.uint8)
    frames[0, 0, 0] = (100, 100, 100, 255)   # BGRA: ties between 1 and 2
    frames[0, 0, 1] = (5, 5, 5, 255)         # extreme dark: exact search
    frames[0, 0, 2] = (100, 100, 100, 0)     # transparent alpha
    plan = [{"trans": 2, "palette": pal, "local": False, "clear": True,
             "use_prev": False}]
    np.testing.assert_array_equal(gif_fit.quantize(frames, plan)[0, 0],
                                  [1, 0, 2])


def test_lzw_round_trip_through_the_frozen_encoder():
    rng = np.random.default_rng(3)
    idx = (rng.integers(0, 5, (37, 53)) * 50).astype(np.uint8)
    pal = np.stack([np.arange(256)] * 3, 1).astype(np.uint8)
    buf = native.gif_encode(53, 37, pal, 0, [
        {"indices": idx, "left": 0, "top": 0, "palette": None, "trans": -1,
         "disposal": 1, "delay_cs": 3, "interlace": True}])
    got = gif_decode.decode_gif(buf)["frames"][0]
    np.testing.assert_array_equal(got["indices"], idx)
    assert got["interlace"] and got["disposal"] == 1


def test_references_match_the_program_on_the_cpu():
    from lilliput_tpu_torch import pipeline
    src = jpeg_photos.make({"width": 400, "height": 300, "sources": 2,
                            "qualities": [85], "orientation": 6,
                            "texture": 1.75, "rects": 6}, 11, "cpu")
    pipe = pipeline.JpegTranscodePipeline(src["bufs"][0], 64, 64,
                                          quality=85, device="cpu")
    outs = pipe.transcode(src["bufs"])
    params = {"dst_w": 64, "dst_h": 64, "quality": 85}
    assert jpeg_fit.check(src["sources"], dict(enumerate(outs)), params,
                          "cpu")["coef_share"] <= 1e-3
    anims = gif_pans.make({"canvas": 160, "frame_counts": [5, 9],
                           "photo_width": 320, "photo_height": 240,
                           "photos": 1, "texture": 1.75, "rects": 6}, 12,
                          "cpu")
    outs = pipeline.transcode_gif_batch(anims["bufs"], 128, 128, fit=True,
                                        device="cpu")
    assert gif_fit.check(anims["sources"], dict(enumerate(outs)),
                         {"dst_w": 128, "dst_h": 128},
                         "cpu")["index_share"] == 0.0
