"""The port's GIF path on the CPU against the JAX package's, at atol 0 on
GIFs written by tests/_torch_gif_builders.py (numpy, no PIL): the
streaming decoder's frames and metadata, the batched decode
(animation_inputs, decode_animation), the GifEncoder's bytes,
ImageOps.transform to .gif, .jpeg, .png and .thumbhash, transcode_gif
and transcode_gif_batch (Fit crop, group chunking, inert frame and lane
padding), AnimatedTranscodePipeline's per-item isolation and what it
does not port yet, the CLI on a GIF, the max-dimension guard and corrupt
streams (the same error class as the JAX package). Batched == streaming
bytes is held on both packages. The builder's GIFs are held against PIL,
and the port's gif_codec.cpp against the JAX package's file.
"""

import functools
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import lilliput_tpu as L
import lilliput_tpu.pipeline as LP
from lilliput_tpu.codecs import gif as JG
import lilliput_tpu_torch as T
import lilliput_tpu_torch.pipeline as TP
from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import gif as TG
from lilliput_tpu_torch.framebuffer import Framebuffer
from lilliput_tpu_torch.ops import palette as TPal

import _torch_gif_builders as G
from test_torch_cli import _jax_cli, _port_cli, _untimed

FIT, RESIZE = T.ResizeMethod.FIT, T.ResizeMethod.RESIZE
DST = (20, 16)


@functools.lru_cache(maxsize=None)
def _rgb(w=120, h=90, seed=0):
    small = np.random.default_rng(seed).integers(0, 256, (6, 6, 3), np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))


def _idx(h, w, n, seed):
    return np.random.default_rng(seed).integers(0, n, (h, w), np.uint8)


_GCT4 = np.array([[9, 8, 7], [255, 0, 0], [0, 255, 0], [0, 0, 255]],
                 np.uint8)


def _cases():
    """name -> GIF bytes. Canvases are 48x40 (the pans) or 24x20."""
    F = G.Frame
    pal16 = np.random.default_rng(1).integers(0, 256, (16, 3), np.uint8)
    pal7 = np.random.default_rng(2).integers(0, 256, (7, 3), np.uint8)
    return {
        # pans: local palettes, partial and off-canvas rects,
        # transparency, disposals 1/2/3/0, an interlaced frame, loop and
        # comment extensions
        "pan9": G.pan_gif(_rgb(), 48, 40, 9),
        "pan4": G.pan_gif(_rgb(), 48, 40, 4, start=3, loop=2),
        # frame 1 DISPOSE_PREVIOUS restores transparent black
        "dispose_prev_first": G.gif_bytes(24, 20, [
            F(_idx(20, 24, 4, 3), disposal=3),
            F(_idx(6, 5, 4, 4), left=3, top=4)], global_palette=_GCT4),
        # no GCE at all: a transparent background, NO_DISPOSE frames
        "no_gce": G.gif_bytes(24, 20, [
            F(_idx(20, 24, 4, 5), gce=False),
            F(_idx(8, 9, 4, 6), left=2, top=3, gce=False)],
            global_palette=_GCT4, bg_index=2),
        # GIF87a with a local table of 7 entries (padded to 8) only
        "gif87a_local": G.gif_bytes(24, 20, [
            F(_idx(20, 24, 7, 7), palette=pal7, gce=False),
            F(_idx(20, 24, 7, 8), palette=pal7[::-1].copy(), gce=False)],
            version=b"GIF87a"),
        # rects clipped at the canvas edge, one wholly outside it
        "clipped": G.gif_bytes(24, 20, [
            F(_idx(20, 24, 16, 9), disposal=1),
            F(_idx(10, 12, 16, 10), left=18, top=15, disposal=2, trans=3),
            F(_idx(4, 4, 16, 11), left=30, top=2, disposal=1),
            F(_idx(20, 24, 16, 12), trans=0, disposal=3)],
            global_palette=pal16, bg_index=5, loop=0),
        # an interlaced first frame of 23 rows, comment before it
        "interlaced": G.gif_bytes(24, 23, [
            F(_idx(23, 24, 16, 13), interlace=True, comment=b"hi"),
            F(_idx(23, 24, 16, 14), interlace=True, trans=1)],
            global_palette=pal16),
        # trans == bg index of the global table with an opaque background:
        # the encoder drops the transparency (background removal rule)
        "bg_trans_removal": G.gif_bytes(24, 20, [
            F(_idx(20, 24, 16, 15), disposal=1),
            F(_idx(20, 24, 16, 16), trans=5, disposal=2),
            F(_idx(20, 24, 16, 17), trans=6)],
            global_palette=pal16, bg_index=5),
        # one frame: not animated
        "still": G.gif_bytes(24, 20, [F(_idx(20, 24, 16, 18), trans=2)],
                             global_palette=pal16),
    }


CASES = _cases()
ANIMATED = [k for k in CASES if k != "still"]


def _decode_all(dec, fb_cls):
    frames, metas = [], []
    while True:
        fb = fb_cls()
        try:
            dec.decode_to(fb)
        except EOFError:
            return frames, metas
        arr = fb.to_numpy() if isinstance(fb, Framebuffer) else \
            np.asarray(fb.array)
        m = dec.frame_header()
        frames.append((arr.copy(), fb.duration, int(fb.dispose),
                       int(fb.blend), fb.x_offset, fb.y_offset))
        metas.append(_meta_fields(m))


def _meta_fields(m):
    return (m.left, m.top, m.width, m.height, m.interlace, m.local_count,
            m.trans_idx, m.delay_cs, m.disposal, m.ext, m.pal_count,
            m.palette.tobytes())


# -- the builder and the host codec ---------------------------------------------


def test_gif_codec_source_is_the_jax_packages():
    """The port builds its GIF codec from its own copy of gif_codec.cpp;
    the copy must stay byte-identical to the JAX package's."""
    ours = os.path.join("lilliput_tpu_torch", "csrc", "host", "gif_codec.cpp")
    theirs = os.path.join("lilliput_tpu", "native", "src", "gif_codec.cpp")
    assert any(s.endswith(ours) for s in binding.HOST_SOURCES)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", ["pan9", "clipped", "interlaced",
                                  "gif87a_local"])
def test_builder_gifs_decode_under_pil(name):
    """PIL reads every frame of the builder's GIFs where the builder put
    it (rect, interlace flag, delay, disposal, loop, comment), and each
    frame's raster, wrapped alone, to the builder's indices and palette."""
    frames = {"pan9": G.pan_frames(_rgb(), 48, 40, 9)}.get(name)
    buf = CASES[name]
    im = Image.open(io.BytesIO(buf))
    assert im.info["version"] == (b"GIF87a" if name == "gif87a_local"
                                  else b"GIF89a")
    if frames is None:
        return _check_rasters_under_pil(buf)
    assert im.n_frames == len(frames) and im.info["loop"] == 0
    for k, f in enumerate(frames):
        im.seek(k)
        h, w = f.indices.shape
        tile = im.tile[0]
        assert tile.extents == (f.left, f.top, f.left + w, f.top + h)
        assert tile.args[1] == f.interlace
        assert im.info["duration"] == f.delay_cs * 10
        if f.disposal:
            assert im.disposal_method == f.disposal
        if k >= 1:
            assert im.info["comment"] == b"lilliput pan"
        pal = f.palette if f.palette is not None else G.palette_332()
        _check_raster(G.gif_bytes(w, h, [G.Frame(f.indices, palette=pal,
                                                 interlace=f.interlace)]),
                      f.indices, pal)


def test_codec_lzw_gif_decodes_as_the_literal_one():
    """pan_gif written with dictionary LZW (codec_gif_bytes, the C++
    encoder) decodes, under the JAX package's decoder and under PIL, to
    the literal-only writer's frames and frame headers, in fewer bytes."""
    lit = G.pan_gif(_rgb(), 48, 40, 9, start=2)
    dic = G.pan_gif(_rgb(), 48, 40, 9, start=2, codec=True)
    assert len(dic) < len(lit)
    want, want_m = _decode_all(L.new_decoder(lit), L.Framebuffer)
    got, got_m = _decode_all(L.new_decoder(dic), L.Framebuffer)
    assert len(got) == len(want) == 9 and got_m == want_m
    for k, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b[0], a[0], err_msg=f"frame {k}")
        assert b[1:] == a[1:], k
    pa, pb = Image.open(io.BytesIO(lit)), Image.open(io.BytesIO(dic))
    assert pb.n_frames == pa.n_frames and pb.info["loop"] == 0
    for k in range(pa.n_frames):
        pa.seek(k)
        pb.seek(k)
        np.testing.assert_array_equal(np.asarray(pb.convert("RGBA")),
                                      np.asarray(pa.convert("RGBA")))


def _check_raster(buf, indices, pal):
    im = Image.open(io.BytesIO(buf))
    assert im.mode == "P"
    np.testing.assert_array_equal(np.asarray(im), indices)
    got = np.array(im.getpalette(), np.uint8).reshape(-1, 3)[:len(pal)]
    np.testing.assert_array_equal(got, pal)


def _check_rasters_under_pil(buf):
    """Each frame of `buf`, read back by the port's container parser and
    wrapped alone at offset 0, decodes under PIL to its indices."""
    d = TG.GifDecoder(buf, device="cpu")
    n = 0
    while True:
        try:
            m = d._next_frame_meta()
        except EOFError:
            break
        raw = d._decode_raw_raster(m)
        pal = m.palette[:m.pal_count]
        _check_raster(G.gif_bytes(m.width, m.height, [G.Frame(
            raw, palette=pal, interlace=bool(m.interlace))]), raw, pal)
        n += 1
    assert n == Image.open(io.BytesIO(buf)).n_frames


# -- decoding ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_decode_frames_equal_jax(name):
    """decode_to: every composited frame, its timing/dispose/blend and the
    frame header (rect, palette, forced transparency, extensions), and
    the decoder's metadata."""
    buf = CASES[name]
    jd, td = L.new_decoder(buf), T.new_decoder(buf, device="cpu")
    assert isinstance(td, TG.GifDecoder) and td.device.type == "cpu"
    jh, th = jd.header(), td.header()
    assert (th.width, th.height, th.channels, th.orientation, th.num_frames,
            th.content_length) == (jh.width, jh.height, jh.channels,
                                   jh.orientation, jh.num_frames,
                                   jh.content_length)
    assert (td.description(), td.duration(), td.loop_count(),
            td.frame_count(), td.total_duration_ms(),
            td.background_color()) == (
        jd.description(), jd.duration(), jd.loop_count(), jd.frame_count(),
        jd.total_duration_ms(), jd.background_color())
    jf, jm = _decode_all(jd, L.Framebuffer)
    tf, tm = _decode_all(td, Framebuffer)
    assert len(tf) == len(jf) == jd.frame_count()
    for k, (a, b) in enumerate(zip(jf, tf)):
        np.testing.assert_array_equal(b[0], a[0], err_msg=f"frame {k}")
        assert b[1:] == a[1:], k
    assert tm == jm


def test_frames_handed_out_never_change():
    """Copy-on-write: a frame's tensor keeps its pixels while later frames
    decode, and shares no memory with the decoder's canvas."""
    d = T.new_decoder(CASES["pan9"], device="cpu")
    kept, copies = [], []
    while True:
        fb = Framebuffer()
        try:
            d.decode_to(fb)
        except EOFError:
            break
        kept.append(fb.array)
        copies.append(fb.array.clone())
        assert fb.array.data_ptr() != d._canvas.ctypes.data
    for a, b in zip(kept, copies):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ANIMATED)
def test_decode_animation_equals_jax_and_streaming(name):
    """The batched decode (inputs scattered on the host, the composite on
    the device, frames padded to their bucket) equals the JAX package's
    and the port's own streaming frames; its inputs equal the JAX
    package's, with one LZW thread or four."""
    buf = CASES[name]
    ji, jm = JG.GifDecoder(buf).animation_inputs(pad_frames=-1)
    for workers in (1, 4):
        ti, tm = TG.GifDecoder(buf, device="cpu").animation_inputs(
            pad_frames=-1, workers=workers)
        assert set(ti) == set(ji)
        for k in ji:
            np.testing.assert_array_equal(ti[k], np.asarray(ji[k]),
                                          err_msg=k)
        assert [_meta_fields(m) for m in tm] == [_meta_fields(m) for m in jm]
    want, _ = JG.GifDecoder(buf).decode_animation(pad_frames=-1)
    got, metas = TG.GifDecoder(buf, device="cpu").decode_animation(
        pad_frames=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stream, _ = _decode_all(T.new_decoder(buf, device="cpu"), Framebuffer)
    assert got.shape[0] == TPal.frame_bucket(len(stream))
    for k, s in enumerate(stream):
        np.testing.assert_array_equal(got[k].numpy(), s[0])


def _corrupt():
    good = CASES["clipped"]
    short = G.gif_bytes(24, 20, [G.Frame(_idx(20, 24, 16, 19),
                                         stop_after=100)],
                        global_palette=np.zeros((16, 3), np.uint8))
    zero = G.gif_bytes(24, 20, [G.Frame(_idx(20, 24, 16, 19)),
                                G.Frame(np.zeros((20, 0), np.uint8))],
                       global_palette=np.zeros((16, 3), np.uint8))
    return {
        "premature_eoi": short,
        "truncated": good[:len(good) // 2],
        "zero_width": zero,
        "no_color_map": G.gif_bytes(24, 20, [G.Frame(_idx(20, 24, 4, 1))]),
        "bad_header": b"GIF89a\x01",
    }


CORRUPT = _corrupt()


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 -- the class is compared
        return type(e).__name__


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_stream_fails_as_jax(name):
    """The streaming decode, the batched decode and transcode_gif raise the
    JAX package's error class on each corrupt stream."""
    buf = CORRUPT[name]

    def stream(new):
        return lambda: _decode_all(new(buf), L.Framebuffer if new is
                                   L.new_decoder else Framebuffer)
    got = [_outcome(stream(L.new_decoder)),
           _outcome(stream(lambda b: T.new_decoder(b, device="cpu"))),
           _outcome(lambda: LP.transcode_gif(buf, *DST)),
           _outcome(lambda: TP.transcode_gif(buf, *DST, device="cpu"))]
    assert got[0] == got[1] and got[2] == got[3], got
    assert got[1] is not None or name == "truncated", got


def test_max_dimension_guard_as_jax():
    buf = CASES["pan4"]
    try:
        for mod in (JG, TG):
            mod.set_gif_max_frame_dimension(30)
        with pytest.raises(L.InvalidImageError):
            L.new_decoder(buf).decode_to(L.Framebuffer())
        with pytest.raises(T.InvalidImageError):
            T.new_decoder(buf, device="cpu").decode_to(Framebuffer())
        with pytest.raises(T.InvalidImageError):
            TG.GifDecoder(buf, device="cpu").animation_inputs()
        with pytest.raises(T.InvalidImageError):
            TP.transcode_gif(buf, *DST, device="cpu")
    finally:
        for mod in (JG, TG):
            mod.set_gif_max_frame_dimension(10000)


def test_new_decoder_of_a_gif_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        assert T.new_decoder(CASES["still"]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.new_decoder(CASES["still"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.transcode_gif(CASES["still"], *DST)


# -- encoding and the transform ---------------------------------------------------


def _both(buf, **opt):
    opt.setdefault("encode_timeout", 300.0)
    a = L.ImageOps(8192).transform(L.new_decoder(buf), L.ImageOptions(**opt))
    b = T.ImageOps(8192).transform(T.new_decoder(buf, device="cpu"),
                                   T.ImageOptions(**opt))
    return a, b


@pytest.mark.parametrize("fmt", [".gif", ".jpeg", ".png", ".thumbhash"])
@pytest.mark.parametrize("name", list(CASES))
def test_transform_equals_jax(name, fmt):
    a, b = _both(CASES[name], file_type=fmt, width=DST[0], height=DST[1],
                 resize_method=FIT)
    assert a == b


@pytest.mark.parametrize("opt", [
    dict(resize_method=T.ResizeMethod.NO_RESIZE),
    dict(width=30, height=9, resize_method=RESIZE),
    dict(max_encode_frames=3, resize_method=T.ResizeMethod.NO_RESIZE),
    dict(width=12, height=12, resize_method=FIT,
         disable_animated_output=True)],
    ids=["no_resize", "stretch", "max_frames", "first_frame"])
def test_gif_encoder_bytes_equal_jax(opt):
    """The GifEncoder's bytes through the transform: palette reuse,
    extension replay, the transparency optimization and the cache."""
    a, b = _both(CASES["pan9"], file_type=".gif", **opt)
    assert a == b
    assert Image.open(io.BytesIO(b)).n_frames == (
        1 if opt.get("disable_animated_output") else
        opt.get("max_encode_frames") or 9)


def test_gif_encoder_needs_a_gif_decoder_as_jax():
    jpeg = io.BytesIO()
    Image.fromarray(_rgb()).save(jpeg, "JPEG")
    opt = dict(file_type=".gif", width=8, height=8, resize_method=FIT)
    a = _outcome(lambda: L.ImageOps(8192).transform(
        L.new_decoder(jpeg.getvalue()), L.ImageOptions(**opt)))
    b = _outcome(lambda: T.ImageOps(8192).transform(
        T.new_decoder(jpeg.getvalue(), device="cpu"), T.ImageOptions(**opt)))
    assert a == b == "InvalidImageError"
    with pytest.raises(T.InvalidImageError):
        T.new_encoder(".gif")


# -- the serving path -------------------------------------------------------------


@pytest.mark.parametrize("fit", [False, True], ids=["stretch", "fit"])
@pytest.mark.parametrize("name", ANIMATED)
def test_transcode_gif_equals_jax_and_streaming(name, fit):
    """transcode_gif's bytes equal the JAX package's, and on both packages
    equal the streaming ImageOps transform (RESIZE for stretch; FIT's crop
    of the 48x40 and 24x20 canvases to 20x16 is a real crop)."""
    buf = CASES[name]
    a = LP.transcode_gif(buf, *DST, fit=fit)
    b = TP.transcode_gif(buf, *DST, fit=fit, device="cpu")
    assert a == b
    sa, sb = _both(buf, file_type=".gif", width=DST[0], height=DST[1],
                   resize_method=FIT if fit else RESIZE)
    assert sa == sb
    assert sa == a, "JAX package: batched != streaming"
    assert sb == b


def test_transcode_gif_batch_equals_jax(monkeypatch):
    """Three canvases and three frame buckets make five groups; a lane cap
    of 3 cuts the four 9-frame pans into chunks of 3 (padded to the
    animation bucket 4 with an inert lane) and 1. Every output equals the
    JAX package's batch and the port's per-animation transcode_gif, and
    the stage clock (stage_times) times each group's stages without
    changing the bytes."""
    bufs = [CASES[k] for k in ("pan9", "pan4", "clipped", "dispose_prev_first",
                               "bg_trans_removal", "no_gce", "interlaced")]
    bufs += [G.pan_gif(_rgb(), 48, 40, 9, start=s) for s in (5, 9, 13)]
    for mod in (LP, TP):
        monkeypatch.setattr(mod, "_MAX_ANIM_LANES", 3)
    want = LP.transcode_gif_batch(bufs, *DST, fit=True)
    got = TP.transcode_gif_batch(bufs, *DST, fit=True, device="cpu",
                                 workers=2)
    assert got == want
    for buf, b in zip(bufs, got):
        assert TP.transcode_gif(buf, *DST, fit=True, device="cpu") == b
    from lilliput_tpu_torch.utils import metrics
    before = dict(metrics.snapshot()["counters"])
    times = {}
    assert TP.transcode_gif_batch(bufs, *DST, fit=True, device="cpu",
                                  stage_times=times) == want
    after = metrics.snapshot()["counters"]
    assert after["serving.anim_pad_lanes"] \
        == before.get("serving.anim_pad_lanes", 0) + 1
    groups = after["serving.anim_groups"] - before.get("serving.anim_groups",
                                                       0)
    assert groups == 6 and len(times.pop("lzw_decode")) == 1
    assert sorted(times) == sorted(("stack", "h2d", "composite", "resize",
                                    "plan", "quantize", "d2h", "lzw_encode"))
    assert all(len(ms) == groups and min(ms) >= 0 for ms in times.values())


def test_animated_pipeline_isolates_a_corrupt_gif():
    """A corrupt GIF in the batch fails only its own slot, with the JAX
    package's error class; the healthy slots equal transcode_gif's bytes."""
    bufs = [CASES["pan9"], CORRUPT["premature_eoi"], CASES["pan4"],
            CASES["clipped"]]
    jp = L.AnimatedTranscodePipeline(*DST, output_format=".gif")
    tp = T.AnimatedTranscodePipeline(*DST, output_format=".gif",
                                     device="cpu")
    want = jp.transcode(bufs, return_exceptions=True)
    got = tp.transcode(bufs, return_exceptions=True)
    assert [type(x).__name__ for x in got] == [type(x).__name__
                                              for x in want]
    assert isinstance(got[1], T.DecodingFailedError)
    for k in (0, 2, 3):
        assert got[k] == want[k] == TP.transcode_gif(bufs[k], *DST, fit=True,
                                                      device="cpu")
    with pytest.raises(T.DecodingFailedError):
        tp.transcode(bufs)


def test_animated_pipeline_not_ported():
    """What the port does not have yet raises NotImplementedError naming
    its item: a mesh (item 9) at once, AVIF sources (6.5) per item. GIF to
    .webp (item 4.7b, ported) equals the JAX package's bytes, batched and
    alone; a broken WebP header fails its slot as there. A GIF to .avif
    fails as in the JAX package."""
    with pytest.raises(NotImplementedError, match="item 9"):
        T.AnimatedTranscodePipeline(*DST, output_format=".gif",
                                    mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        TP.transcode_gif_batch([CASES["pan4"]], *DST, mesh=object(),
                               device="cpu")
    webp = b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(8)
    avif = b"\x00\x00\x00\x18ftypavif" + bytes(8)
    gif = CASES["pan4"]
    res = T.AnimatedTranscodePipeline(*DST, output_format=".webp",
                                      device="cpu").transcode(
        [gif, gif, webp, avif], return_exceptions=True)
    want = L.AnimatedTranscodePipeline(*DST, output_format=".webp") \
        .transcode([gif, gif, webp], return_exceptions=True)
    assert res[:2] == want[:2] and res[0][:4] == b"RIFF"
    assert type(res[2]).__name__ == type(want[2]).__name__ \
        == "InvalidImageError"
    assert isinstance(res[3], NotImplementedError)
    assert "(ROADMAP queue 1, item 6.5)" in str(res[3])
    assert TP.transcode_gif(gif, *DST, fit=True, file_type=".webp",
                            device="cpu") == res[0]
    for fmt, buf in ((".avif", gif), (".gif", webp), (".gif", avif)):
        j = L.AnimatedTranscodePipeline(*DST, output_format=fmt)
        t = T.AnimatedTranscodePipeline(*DST, output_format=fmt,
                                        device="cpu")
        assert type(t.transcode([buf], return_exceptions=True)[0]) \
            .__name__ == "DecodingFailedError"
        assert type(j.transcode([buf], return_exceptions=True)[0]) \
            .__name__ == "DecodingFailedError"


@pytest.mark.parametrize("ext", [".gif", ".jpg", ".png", ".thumbhash"])
def test_cli_gif(tmp_path, capsys, ext):
    """python -m lilliput_tpu_torch on a GIF: examples/main.py's lines and
    bytes (.jpg: progressive, as tests/test_torch_cli.py holds)."""
    src = tmp_path / "in.gif"
    src.write_bytes(CASES["pan9"])
    outs = {}
    for who, run in (("jax", _jax_cli), ("port", _port_cli)):
        out = tmp_path / f"out_{who}{ext}"
        argv = ["-input", str(src), "-output", str(out), "-width", "20",
                "-height", "16"] + (["-device", "cpu"] if who == "port"
                                    else [])
        code, lines = run(argv, capsys)
        assert code == 0
        outs[who] = (out.read_bytes(), _untimed(
            [ln.replace(str(out), "OUT") for ln in lines]))
    assert outs["port"][1][:2] == ["file type: GIF",
                                   "48x40, 4ch, 9 frame(s), orientation 1"]
    assert outs["port"] == outs["jax"]
    if ext == ".jpg":
        assert b"\xff\xc2" in outs["port"][0][:700]    # SOF2: progressive
