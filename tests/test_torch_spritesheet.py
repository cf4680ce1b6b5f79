"""The port's keyframe spritesheet (pipeline.spritesheet and its device
half spritesheet_tiles) and its video fronts on the CPU against the JAX
package:

* spritesheet of an MPEG-4 Part 2 MP4 (two keyframes) and an MJPEG AVI
  (every frame a keyframe; max_tiles cuts it), with and without
  thumbhashes, on one thread and on the pool: the sheet at atol 0, the
  timestamps equal, the hashes equal but where an AC sits on a rounding
  tie (thumbhash.order_dependent, ROADMAP queue 3 entry 12);
* the keyframe packets the JAX package cannot decode (queue 3 entries 21
  and 22: Matroska index entries of size 0, AVI offsets at the chunk
  header) fail in the port with the same error;
* spritesheet_tiles on frames made here, odd sizes, equal to the JAX
  package's _anim_crop_resize and thumbhash_batch;
* ImageOps.transform of the MP4 (and of the anamorphic one) to .jpeg and
  .png, the CLI on the MP4, and one MP4 request in MultiGeometryPipeline
  beside JPEG and PNG requests: bytes equal to the JAX package's; the
  still front takes the anamorphic MP4 as the JAX front does and refuses
  a decoded frame whose size is not its header's with the same error.

Everything here opens a container, so it skips where ffmpeg's headers are
absent (tests/test_torch_video.py holds the missing-library errors)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
from lilliput_tpu import ImageOps as JImageOps
from lilliput_tpu import ImageOptions as JImageOptions
from lilliput_tpu import new_decoder as jax_new_decoder
from lilliput_tpu import pipeline as JP
from lilliput_tpu.codecs import thumbhash as JTH
from lilliput_tpu_torch import (ImageOps, ImageOptions,
                                MultiGeometryPipeline, ResizeMethod,
                                StillTranscodePipeline, binding, new_decoder)
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.codecs import thumbhash as TTH
from lilliput_tpu_torch.errors import DecodingFailedError

import _torch_video_builders as VB
from _torch_parity import layout_jpeg
from _torch_still_builders import png_bytes

pytestmark = pytest.mark.skipif(
    not os.path.exists(binding.AVFORMAT_HEADER),
    reason="ffmpeg's headers are absent")


def _hashes_equal_but_ties(got, want, tiles):
    """Equal thumbhashes, but where the CPU grids leave an AC on a rounding
    tie (entry 12's rule, as chip_smoke.phase7_thumbhash_batch applies it,
    the grid bound the test_torch_thumbhash one)."""
    assert len(got) == len(want) == len(tiles)
    grids, sums = TTH.batch_grids(tiles, device="cpu")
    h, w = tiles.shape[1], tiles.shape[2]
    for i, (g, j) in enumerate(zip(got, want)):
        if g != j:
            assert TTH.order_dependent(
                TTH.hash_fields(grids, sums, i, w, h), 1e-6), i


@pytest.mark.parametrize("name,kw", [
    ("mp4", {}), ("mp4", {"with_thumbhashes": True, "workers": 1}),
    ("avi_mjpg", {"with_thumbhashes": True}),
    ("avi_mjpg", {"max_tiles": 7, "workers": 3})],
    ids=["mp4", "mp4_hashes_1thread", "mjpg_hashes", "mjpg_max7"])
def test_spritesheet_equal_jax(name, kw):
    buf = VB.clip(name)
    sheet, ts, hashes = TP.spritesheet(buf, 24, 18, device="cpu", **kw)
    jsheet, jts, jhashes = JP.spritesheet(buf, 24, 18, **kw)
    assert sheet.dtype == np.uint8 and np.array_equal(sheet, jsheet)
    assert ts == jts and len(ts) >= 2
    n = len(ts)
    cols = int(np.ceil(np.sqrt(n)))
    assert sheet.shape == (-(-n // cols) * 18, cols * 24, 4)
    if not kw.get("with_thumbhashes"):
        assert hashes is None and jhashes is None
        return
    tiles = np.stack([sheet[r * 18:(r + 1) * 18, c * 24:(c + 1) * 24]
                      for r, c in (divmod(i, cols) for i in range(n))])
    _hashes_equal_but_ties(hashes, jhashes, tiles)


@pytest.mark.parametrize("name", ["avi_png", "mkv_ffv1", "webm_vp8"])
def test_spritesheet_reference_faults_reproduced(name):
    """The JAX spritesheet passes video[offset:offset + size] as the index
    gives it: Matroska's index gives size 0 (FFV1, VP8), AVI's offset
    points at the 8-byte '00dc' chunk header (PNG's decoder rejects the
    signature; MJPEG's finds its SOI), so no keyframe decodes (ROADMAP
    queue 3 entries 21 and 22). The port reproduces it."""
    buf = VB.clip(name)
    with pytest.raises(DecodingFailedError) as got:
        TP.spritesheet(buf, 24, 18, device="cpu")
    with pytest.raises(Exception) as want:
        JP.spritesheet(buf, 24, 18)
    assert type(want.value).__name__ == "DecodingFailedError"
    assert str(got.value) == str(want.value)


def test_spritesheet_of_audio_fails_as_jax():
    got = want = None
    try:
        TP.spritesheet(VB.wav_bytes(), 24, 18, device="cpu")
    except Exception as e:  # noqa: BLE001 -- compared below
        got = (type(e).__name__, str(e))
    try:
        JP.spritesheet(VB.wav_bytes(), 24, 18)
    except Exception as e:  # noqa: BLE001 -- compared below
        want = (type(e).__name__, str(e))
    assert got == want and got is not None


@pytest.mark.parametrize("n,h,w,tile", [(3, 61, 83, (24, 18)),
                                         (5, 48, 37, (16, 20)),
                                         (1, 90, 160, (40, 30))])
def test_spritesheet_tiles_equal_jax(n, h, w, tile):
    rng = np.random.default_rng(n * h)
    frames = np.stack([VB.frame(i, w, h) for i in range(n)])
    frames = np.concatenate(
        [frames, rng.integers(0, 256, (n, h, w, 1), np.uint8)], -1)
    tiles, hashes = TP.spritesheet_tiles(frames, *tile, True, "cpu")
    jt = JP._anim_crop_resize(jnp.asarray(frames), None, *tile)
    assert np.array_equal(tiles, np.asarray(jt))
    _hashes_equal_but_ties(hashes, JTH.thumbhash_batch(jt), tiles)
    none_tiles, none = TP.spritesheet_tiles(frames, *tile, False, "cpu")
    assert none is None and np.array_equal(none_tiles, tiles)


def _transform(pkg, buf, fmt, w, h):
    if pkg == "jax":
        return JImageOps(8192).transform(jax_new_decoder(buf), JImageOptions(
            file_type=fmt, width=w, height=h, resize_method=ResizeMethod.FIT,
            disable_animated_output=True))
    return ImageOps(8192).transform(new_decoder(buf, device="cpu"),
                                    ImageOptions(
        file_type=fmt, width=w, height=h, resize_method=ResizeMethod.FIT,
        disable_animated_output=True))


@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("src", ["mp4", "anamorphic", "tiny_vp8"])
def test_transform_video_equal_jax(src, fmt):
    buf = {"mp4": lambda: VB.clip("mp4"),
           "anamorphic": lambda: VB.anamorphic_mp4(3),
           "tiny_vp8": VB.tiny_vp8}[src]()
    got = _transform("port", buf, fmt, 40, 30)
    assert got == _transform("jax", buf, fmt, 40, 30)
    assert got[:2] == b"\xff\xd8" if fmt == ".jpeg" else got[:4] == b"\x89PNG"


def test_cli_video_input_equal_examples_main(tmp_path, capsys):
    from test_torch_cli import _jax_cli, _port_cli, _untimed
    src = tmp_path / "in.mp4"
    src.write_bytes(VB.clip("mp4"))
    outs = {}
    for who, run in (("jax", _jax_cli), ("port", _port_cli)):
        out = tmp_path / f"out_{who}.jpg"
        argv = ["-input", str(src), "-output", str(out), "-width", "40",
                "-height", "32", "-disable-animated-output"]
        if who == "port":
            argv += ["-device", "cpu"]
        code, lines = run(argv, capsys)
        assert code == 0
        outs[who] = (out.read_bytes(), _untimed(
            [ln.replace(str(out), "OUT") for ln in lines]))
    assert outs["port"] == outs["jax"]


def test_multigeometry_video_slot_equal_jax():
    """One MP4 request among JPEG and PNG requests: every slot equals the
    JAX front's, the video's through a still pipeline of its own."""
    rng = np.random.default_rng(5)
    png = png_bytes(rng.integers(0, 256, (60, 80, 3), np.uint8), 2)
    bufs = [layout_jpeg(160, 120, 85, 1, "420"), VB.clip("mp4"), png,
            layout_jpeg(160, 120, 85, 2, "420")]
    want = JP.MultiGeometryPipeline(64, 64, quality=85).transcode(bufs)
    mg = MultiGeometryPipeline(64, 64, quality=85, device="cpu")
    got = mg.transcode(bufs)
    assert got == want
    assert mg.stats()["geometries_cached"] == 3
    kinds = {getattr(p, "kind", None) for p in mg._pipes.values()}
    assert "VideoDecoder" in kinds


def test_still_front_anamorphic_equal_jax(monkeypatch):
    """The still front needs decoded size == header size. An anamorphic
    source's header is its display size, which its decoder's LINEAR
    upscale gives, so both fronts take it, with the same bytes; a decoder
    whose frame differs from its header is refused with the JAX front's
    DecodingFailedError."""
    buf = VB.anamorphic_mp4(2)
    want = JP.StillTranscodePipeline(buf, 32, 32).transcode([buf])
    got = StillTranscodePipeline(buf, 32, 32, device="cpu").transcode([buf])
    assert got == want
    for pkg in (JP, TP):
        decode = pkg.StillTranscodePipeline._decode_array
        monkeypatch.setattr(pkg.StillTranscodePipeline, "_decode_array",
                            staticmethod(lambda d, f=decode: f(d)[:, 1:]))
    with pytest.raises(Exception) as jerr:
        JP.StillTranscodePipeline(buf, 32, 32)
    with pytest.raises(DecodingFailedError) as err:
        StillTranscodePipeline(buf, 32, 32, device="cpu")
    assert type(jerr.value).__name__ == "DecodingFailedError"
    assert str(err.value) == str(jerr.value)
