"""The port's multi-device serving (lilliput_tpu_torch/parallel/) on the
CPU, on meshes of eight torch.device("cpu") entries, against the JAX
package on its 8-device virtual CPU mesh (tests/conftest.py); the
counterpart of tests/test_parallel.py. Every input is made here (PIL, cv2,
tests/_torch_gif_builders.py), none read from a reference checkout.

* dp: the sharded fronts' bytes equal the port's one-device fronts' and
  the JAX package's sharded fronts' on (8, 1) meshes (4:2:0, 4:2:2, gray,
  direct mode, .png and .webp output; 5 requests pad to dp 8), and on
  (4, 2) meshes for the routes that run dp-only there (direct, oriented,
  LINEAR); a truncated buffer fails only its slot; the animated batch
  (GIF -> .gif and .webp, 3 members padded to a dp-multiple bucket) and
  MultiGeometryPipeline(mesh=) on mixed JPEG, PNG and GIF traffic.
* sp: a 1024x768 4:2:0 and gray JPEG -> 128x128 and a 128x96 RGBA PNG
  -> 40x40 .png on (4, 2): within 1 of the one-device port, the decoded
  pixels against the JAX package's one-device bytes, both counters (a
  1024x784 4:2:0 source splits its luma rows and counts its chroma
  planes' fallback; rows that do not divide run dp-only); each shard's
  decoded rows equal the unsharded decode bit for bit, which the halo is
  needed for.
* sharded_transcode_step on (8, 1) and (4, 2), make_mesh's refusals,
  and dryrun_multichip(8).
"""

import io
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from lilliput_tpu import parallel as JPAR
from lilliput_tpu import pipeline as JP
from lilliput_tpu_torch import (AnimatedTranscodePipeline,
                                JpegTranscodePipeline, MultiGeometryPipeline,
                                StillTranscodePipeline)
from lilliput_tpu_torch import parallel as TPAR
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.ops import jpeg_kernels as K
from lilliput_tpu_torch.parallel import serving as S
from lilliput_tpu_torch.utils import metrics

from _torch_gif_builders import pan_gif
from _torch_parity import bench_path, gray_jpeg, layout_jpeg, with_orientation
from _torch_still_builders import png_bytes

CPU8 = [torch.device("cpu")] * 8
RNG = np.random.default_rng(0)


def _meshes(sp):
    """(JAX mesh, port mesh) of 8 devices shaped (8 // sp, sp)."""
    return (JPAR.make_mesh(8, sp=sp),
            TPAR.make_mesh(sp=sp, devices=CPU8))


def _counters():
    c = metrics.snapshot()["counters"]
    return (int(c.get("serving.sp_sharded_planes", 0)),
            int(c.get("serving.sp_fallback_dp_only", 0)))


def _coef_diff(got, ref):
    d = [np.abs(np.asarray(g).astype(np.int32) - np.asarray(r))
         for g, r in zip(got, ref)]
    return max(int(x.max()) for x in d), sum(int((x > 0).sum()) for x in d)


def _smooth(w, h, c, seed):
    small = np.random.default_rng(seed).integers(0, 256, (6, 8, c), np.uint8)
    img = Image.fromarray(small if c > 1 else small[..., 0])
    return np.asarray(img.resize((w, h), Image.BICUBIC)).reshape(h, w, c)


DP_CASES = {
    "420": (layout_jpeg(160, 120, 85, 1, "420"), {}),
    "422": (layout_jpeg(160, 120, 85, 2, "422"), {}),
    "gray": (gray_jpeg(160, 120, 85, 3), {}),
    "direct": (layout_jpeg(160, 120, 85, 4, "420"),
               {"chroma_mode": "direct"}),
    "png": (layout_jpeg(160, 120, 85, 5, "420"), {"output_format": ".png"}),
    "webp": (layout_jpeg(160, 120, 85, 6, "420"),
             {"output_format": ".webp"}),
}
#: routes that run dp-only on a mesh with sp > 1
FALLBACK_CASES = {
    "direct": DP_CASES["direct"],
    "o6": (with_orientation(layout_jpeg(160, 120, 85, 7, "420"), 6), {}),
    "linear": (layout_jpeg(160, 120, 85, 8, "422"), {"method": "linear"}),
}


def _dp_check(buf, kw, sp):
    jm, tm = _meshes(sp)
    bufs = [buf] * 5       # 5 % dp != 0: the pad path
    metrics.reset()
    got = TPAR.ShardedJpegPipeline(buf, 48, 48, quality=85, mesh=tm,
                                   **kw).transcode(bufs)
    counters = _counters()
    one = JpegTranscodePipeline(buf, 48, 48, quality=85, device="cpu",
                                **kw).transcode(bufs)
    with jm:
        jax_got = JPAR.ShardedJpegPipeline(buf, 48, 48, quality=85,
                                           mesh=jm, **kw).transcode(bufs)
    assert got == one
    assert got == jax_got
    return counters


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_bytes_equal_one_device_and_jax(case):
    """dp over 8 slots: the bytes of the one-device port and of the JAX
    package's ShardedJpegPipeline, five requests padded to eight."""
    assert _dp_check(*DP_CASES[case], sp=1) == (0, 0)


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_dp_only_routes_on_a_4x2_mesh(case):
    """On a (4, 2) mesh the direct mode, oriented sources and LINEAR run
    dp-only, counting each plane's fallback, with the same bytes."""
    buf, kw = FALLBACK_CASES[case]
    assert _dp_check(buf, kw, sp=2) == (0, 3)


def test_sharded_still_dp_bytes_equal():
    """ShardedStillPipeline over dp 8: the one-device bytes and the JAX
    package's sharded front's, five requests padded to eight."""
    png = png_bytes(RNG.integers(0, 256, (96, 128, 3), np.uint8), 2)
    jm, tm = _meshes(1)
    bufs = [png] * 5
    got = TPAR.ShardedStillPipeline(png, 48, 48, mesh=tm).transcode(bufs)
    with jm:
        want = JPAR.ShardedStillPipeline(png, 48, 48, mesh=jm).transcode(bufs)
    assert got == StillTranscodePipeline(png, 48, 48,
                                         device="cpu").transcode(bufs)
    assert got == want


def test_poison_isolation_fails_only_its_slot():
    """A truncated buffer in a dp-sharded batch fails its own slot; the
    healthy slots keep the one-device bytes."""
    buf = DP_CASES["420"][0]
    _, tm = _meshes(1)
    ref = JpegTranscodePipeline(buf, 48, 48, device="cpu").transcode([buf])
    outs = TPAR.ShardedJpegPipeline(buf, 48, 48, mesh=tm).transcode(
        [buf, buf[:100], buf], return_exceptions=True)
    assert outs[0] == outs[2] == ref[0]
    assert isinstance(outs[1], Exception)


@pytest.mark.parametrize("fmt", [".gif", ".webp"])
def test_sharded_animated_batch(fmt):
    """AnimatedTranscodePipeline(mesh=): three GIFs of one canvas and one
    of another, each group padded to an 8-lane bucket split over dp 8
    (5 + 7 pad lanes), with the one-device bytes and the JAX package's
    sharded front's."""
    a = pan_gif(_smooth(120, 90, 3, 1), 80, 60, 4, start=1)
    b = pan_gif(_smooth(100, 80, 3, 2), 64, 48, 3, start=2)
    bufs = [a, a, b, a]
    jm, tm = _meshes(1)
    metrics.reset()
    got = AnimatedTranscodePipeline(20, 14, output_format=fmt, fit=False,
                                    mesh=tm).transcode(bufs)
    assert metrics.snapshot()["counters"]["serving.anim_pad_lanes"] == 12
    one = AnimatedTranscodePipeline(20, 14, output_format=fmt, fit=False,
                                    device="cpu").transcode(bufs)
    with jm:
        want = JP.AnimatedTranscodePipeline(20, 14, output_format=fmt,
                                            fit=False, mesh=jm).transcode(
            bufs)
    assert got == one == want
    assert TP._anim_bucket(3, tm) == 8
    assert [len(c) for c in TP._chunk_members(list(range(40)), tm)] == [
        32, 8]


def test_sharded_multigeometry_front():
    """MultiGeometryPipeline(mesh=) on mixed JPEG, PNG and GIF traffic to
    .webp: the one-device front's bytes and the JAX sharded front's."""
    jpg = DP_CASES["420"][0]
    png = png_bytes(RNG.integers(0, 256, (96, 128, 3), np.uint8), 2)
    gif = pan_gif(_smooth(120, 90, 3, 3), 80, 60, 3, start=3)
    bufs = [jpg, png, gif, jpg, gif, png]
    jm, tm = _meshes(1)
    front = MultiGeometryPipeline(32, 32, output_format=".webp", mesh=tm)
    got = front.transcode(bufs)
    assert {type(p) for p in front._pipes.values()} == {
        S.ShardedJpegPipeline, S.ShardedStillPipeline}
    assert front._anim_pipe.mesh is tm
    one = MultiGeometryPipeline(32, 32, output_format=".webp",
                                device="cpu").transcode(bufs)
    with jm:
        want = JP.MultiGeometryPipeline(32, 32, output_format=".webp",
                                        mesh=jm).transcode(bufs)
    assert got == one == want


def _big(gray):
    """A 1024x768 JPEG (q90) of the bench fixture's pixels (cv2)."""
    img = cv2.resize(cv2.imread(bench_path()), (1024, 768),
                     interpolation=cv2.INTER_AREA)
    if gray:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    ok, b = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return b.tobytes()


@pytest.mark.parametrize("gray", [False, True], ids=["420", "gray"])
def test_sp_jpeg_within_one(gray):
    """sp on a (4, 2) mesh: quantized coefficients within 1 of the
    one-device port (the JAX package's sp tier), every plane counted as
    split; decoded pixels within 2 u8 of the one-device port's, as
    tests/test_parallel.py gates its own, and of the JAX package's
    one-device bytes for gray. The JAX package's own CPU step of the 4:2:0
    source differs from its TPU tail (its colour resize sums differ in f32
    order, ROADMAP queue 3 entry 3), which the one-device port follows at
    atol 0: there sp is held within 1 of that tail's coefficients and its
    decoded pixels within 2 u8 of the tail's bytes, and the JAX CPU
    route's decoded difference within entry 3's 3 u8."""
    from _torch_parity import jax_tail
    buf = _big(gray)
    _, tm = _meshes(2)
    pipe = TPAR.ShardedJpegPipeline(buf, 128, 128, quality=85, mesh=tm)
    one = JpegTranscodePipeline(buf, 128, 128, quality=85, device="cpu")
    jax_one = JP.JpegTranscodePipeline(buf, 128, 128, quality=85)
    args = pipe.decode_entropy([buf] * 3)
    metrics.reset()
    got = [t.numpy() for t in pipe.device_step(*args).gather()]
    assert _counters() == (1 if gray else 3, 0)
    one_step = [t.numpy() for t in one.device_step(*args)]
    mx, nd = _coef_diff(got, one_step)
    print(f"sp vs one device: max {mx}, {nd} coefficients differ")
    assert mx <= 1
    jargs = jax_one.decode_entropy([buf] * 3)
    jmx, jnd = _coef_diff(got, jax_one.device_step(*jargs))
    assert jmx <= 1
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR

    def decoded(b):
        return cv2.imdecode(np.frombuffer(b, np.uint8), flag).astype(int)
    sp_px = decoded(pipe.transcode([buf])[0])
    refs = [("one-device port", one.transcode([buf])[0], 2),
            ("JAX one-device", jax_one.transcode([buf])[0], 2 if gray else 3)]
    if not gray:
        tail = [np.asarray(t) for t in jax_tail(jax_one, *jargs)]
        for g, r in zip(one_step, tail):
            np.testing.assert_array_equal(g, r)
        tmx, tnd = _coef_diff(got, tail)
        print(f"sp vs the JAX TPU tail: max {tmx}, {tnd} coefficients differ")
        assert tmx <= 1
        refs.append(("JAX TPU tail", one.encode_entropy(
            *[t[:1] for t in tail])[0], 2))
    for what, ref, bound in refs:
        d = np.abs(sp_px - decoded(ref))
        print(f"decoded vs {what}: max {d.max()}, {(d > 0).sum()} of "
              f"{d.size} values differ")
        assert d.max() <= bound, what


def test_sp_still_rows_within_one():
    """sp over a 128x96 RGBA PNG's rows -> 40x40 .png on (4, 2): within 1
    u8 of the one-device port and of the JAX package's bytes, one plane
    counted as split."""
    png = png_bytes(RNG.integers(0, 256, (128, 96, 4), np.uint8), 6)
    _, tm = _meshes(2)
    metrics.reset()
    outs = TPAR.ShardedStillPipeline(png, 40, 40, mesh=tm,
                                     output_format=".png").transcode(
        [png] * 4)
    assert _counters() == (1, 0)
    got = np.array(Image.open(io.BytesIO(outs[0]))).astype(int)
    assert outs[0] == outs[3]
    for ref in (StillTranscodePipeline(png, 40, 40, output_format=".png",
                                       device="cpu"),
                JP.StillTranscodePipeline(png, 40, 40,
                                          output_format=".png")):
        want = np.array(Image.open(io.BytesIO(ref.transcode([png])[0])))
        d = np.abs(got - want)
        print(f"sp still vs {type(ref).__module__}: max {d.max()}, "
              f"{(d > 0).sum()} differ")
        assert want.shape == (40, 40, 4) and d.max() <= 1


def test_sp_counts_a_chroma_plane_that_does_not_divide():
    """A 1024x784 4:2:0 source's window has 98 luma and 49 chroma block
    rows: sp=2 splits the luma rows (a cut inside an MCU row), so the
    step runs split, within 1 of the one-device port, counting the luma
    plane split and each chroma plane's fallback, as the JAX package
    counts them."""
    img = cv2.resize(cv2.imread(bench_path()), (1024, 784))
    buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])[1]
    buf = buf.tobytes()
    _, tm = _meshes(2)
    pipe = TPAR.ShardedJpegPipeline(buf, 128, 128, mesh=tm)
    args = pipe.decode_entropy([buf] * 3)
    metrics.reset()
    got = [t.numpy() for t in pipe.device_step(*args).gather()]
    assert _counters() == (1, 2)
    one = JpegTranscodePipeline(buf, 128, 128, device="cpu")
    assert _coef_diff(got, one.device_step(*args))[0] <= 1


def test_sp_fallback_when_the_rows_do_not_divide():
    """A gray 1024x776 source's 97 block rows and a still of 97 rows do
    not divide over sp=2: each step runs dp-only, counting the fallback,
    with the one-device bytes."""
    img = cv2.resize(cv2.imread(bench_path(), cv2.IMREAD_GRAYSCALE),
                     (1024, 776))
    buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])[1]
    buf = buf.tobytes()
    _, tm = _meshes(2)
    metrics.reset()
    got = TPAR.ShardedJpegPipeline(buf, 128, 128, mesh=tm).transcode(
        [buf] * 3)
    assert _counters() == (0, 1)
    assert got == JpegTranscodePipeline(buf, 128, 128,
                                        device="cpu").transcode([buf] * 3)
    png = png_bytes(RNG.integers(0, 256, (97, 64, 3), np.uint8), 2)
    metrics.reset()
    got = TPAR.ShardedStillPipeline(png, 40, 40, mesh=tm).transcode([png])
    assert _counters() == (0, 1)
    assert got == StillTranscodePipeline(png, 40, 40,
                                         device="cpu").transcode([png])


@pytest.mark.parametrize("sub,cbh,sp", [("420", 6, 3), ("420", 5, 2),
                                        ("440", 5, 2)])
def test_shard_decode_rows_equal_the_unsharded_decode(sub, cbh, sp):
    """Each shard (jpeg_shards: cut along the luma block rows, at an MCU
    row's edge or, for 5 MCU rows over 2, inside one) decodes the MCU
    rows its rows fall in plus one MCU row of halo across each inner edge
    and crops to its rows: they equal the whole decode's bit for bit.
    Without the halo the rows at a cut on an MCU row's edge differ (the
    triangle upsample reads one chroma row across it); a cut inside an
    MCU row has that row on both sides anyway."""
    h2 = sub == "420"
    rng = np.random.default_rng(3)
    cbw = 5
    yc, cb, cr = (torch.from_numpy(rng.integers(
        -200, 200, (2, 2 * cbh if i == 0 else cbh,
                    (1 + h2) * cbw if i == 0 else cbw, 64)).astype(
        np.int16)) for i in range(3))
    qy = qc = torch.from_numpy(np.full((2, 64), 4, np.float32))
    geom = S.jpeg_sp_geometry(8 * (1 + h2) * cbw, 16 * cbh, 16, 16, (0, 0),
                              False, h2, True)
    whole = S._decode_rows(geom, (yc, cb, cr, qy, qc), False)

    def sharded(g):
        parts = []
        for p0, p1, m0, m1 in S.jpeg_shards(g, 2 * cbh, sp):
            planes = S._decode_rows(g, (yc[:, 2 * m0:2 * m1], cb[:, m0:m1],
                                        cr[:, m0:m1], qy, qc), False)
            parts.append([p[:, p0 - 16 * m0:p1 - 16 * m0] for p in planes])
        return [torch.cat(ps, dim=1) for ps in zip(*parts)]
    for p, q in zip(sharded(geom), whole):
        assert torch.equal(p, q)
    no_halo = sharded(geom._replace(halo=0))
    on_edge = (2 * cbh) % (2 * sp) == 0
    assert on_edge == any(not torch.equal(p, q)
                          for p, q in zip(no_halo, whole))


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_transcode_step(sp):
    """sharded_transcode_step over 8 devices: dp equals the port's
    one-device step bit for bit, sp within 1; both within 1 of the JAX
    package's sharded step (tests/test_parallel.py's gate)."""
    rng = np.random.default_rng(0)
    yc = rng.integers(-64, 64, (8, 32, 32, 64), dtype=np.int16)
    cb, cr = (rng.integers(-64, 64, (8, 16, 16, 64), dtype=np.int16)
              for _ in range(2))
    qt = np.clip(rng.integers(1, 40, 64), 1, 255).astype(np.uint16)
    jm, tm = _meshes(sp)
    axis = 1 if sp > 1 else None
    step = TPAR.sharded_transcode_step(tm, 256, 256, True, True, 64, 64)
    got = step(TPAR.shard_batch(tm, yc, axis, halo=2),
               TPAR.shard_batch(tm, cb, axis, halo=1),
               TPAR.shard_batch(tm, cr, axis, halo=1),
               *[TPAR.replicate(tm, qt.astype(np.float32))
                 for _ in range(4)])
    q = torch.from_numpy(qt.astype(np.float32))
    one = TP._jpeg_fit_stages(
        *(torch.from_numpy(a) for a in (yc, cb, cr)), q, q, q, q,
        src_w=256, src_h=256, dst_w=64, dst_h=64,
        window=(0, 0, 256, 256), h2=True, v2=True).run()
    mx, nd = _coef_diff(got, one)
    assert (mx, nd) == (0, 0) if sp == 1 else mx <= 1
    jstep = JPAR.sharded_transcode_step(jm, 256, 256, True, True, 64, 64)
    with jm:
        want = jstep(JPAR.shard_batch(jm, yc, spatial_axis=axis),
                     JPAR.shard_batch(jm, cb, spatial_axis=axis),
                     JPAR.shard_batch(jm, cr, spatial_axis=axis),
                     *[JPAR.replicate(jm, qt) for _ in range(4)])
    assert _coef_diff(got, want)[0] <= 1
    if sp > 1:      # shards without the halo the 4:2:0 upsample reads
        with pytest.raises(ValueError, match="halo"):
            step(TPAR.shard_batch(tm, yc, 1), TPAR.shard_batch(tm, cb, 1),
                 TPAR.shard_batch(tm, cr, 1),
                 *[TPAR.replicate(tm, qt.astype(np.float32))
                   for _ in range(4)])


def test_make_mesh_and_its_refusals():
    """make_mesh's shapes and refusals: sp must divide the device count,
    the default (every card) raises without one, a front's device= must
    be the mesh's first device, and a mesh must be a Mesh."""
    m = TPAR.make_mesh(sp=2, devices=CPU8)
    assert m.shape == {"dp": 4, "sp": 2} and m.devices.shape == (4, 2)
    assert m.axis_names == ("dp", "sp") and m.slot(3, 1) == (
        torch.device("cpu"), None)
    assert TPAR.make_mesh(4, devices=CPU8).shape == {"dp": 4, "sp": 1}
    with pytest.raises(ValueError, match="sp=3"):
        TPAR.make_mesh(sp=3, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            TPAR.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA"):
            TPAR.ShardedJpegPipeline(DP_CASES["420"][0], 48, 48)
    with pytest.raises(ValueError, match="first device"):
        MultiGeometryPipeline(32, 32, mesh=m, device="cuda:1")
    with pytest.raises(ValueError, match="first device"):
        TPAR.ShardedStillPipeline(png_bytes(np.zeros((8, 8, 3), np.uint8),
                                            2), 4, 4, mesh=m, device="meta")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        TP.transcode_webp_batch([], 8, 8, mesh=JPAR.make_mesh(8))
    assert MultiGeometryPipeline(32, 32, mesh=m,
                                 device="cpu").device == torch.device("cpu")
    batch = TPAR.shard_batch(m, np.arange(5 * 4).reshape(5, 4), 1)
    assert batch.per_slot == 2 and batch.bounds == [(0, 2, 0, 2),
                                                    (2, 4, 2, 4)]
    assert batch.parts[2, 1].tolist() == [[18, 19], [18, 19]]
    assert batch.parts[3, 0].tolist() == [[16, 17], [16, 17]]


def test_dryrun_multichip():
    """dryrun_multichip(8) on eight CPU devices: one step of each front on
    a (4, 2) mesh; five devices: dp only."""
    assert TPAR.dryrun_multichip(8, devices=CPU8)["sp"] == 2
    assert TPAR.dryrun_multichip(5, devices=CPU8)["dp"] == 5


def test_idct_table_cache_keys_carry_the_index():
    """Per-device constant caches key on the indexed device, so a table
    uploaded for one card is never handed out for another."""
    from lilliput_tpu_torch.utils import device_key
    assert device_key("cpu") == "cpu"
    assert device_key(torch.device("cuda", 1)) == "cuda:1"
    assert K.idct_kron("cpu") is K.idct_kron(torch.device("cpu"))


@pytest.mark.parametrize("sub,fmt", [("422", ".jpeg"), ("440", ".jpeg"),
                                     ("444", ".jpeg"), ("420", ".png"),
                                     ("420", ".webp"), ("gray", ".png")])
def test_sp_layouts_and_emits_within_one(sub, fmt):
    """sp on a (4, 2) mesh for the packed tail's layouts and the pixel and
    yuv420 emits: the device step within 1 of the one-device port's, the
    luma plane counted as split (the 15 chroma block rows of 4:2:0 and
    4:4:0 count the fallback)."""
    buf = (gray_jpeg(320, 240, 85, 5) if sub == "gray"
           else layout_jpeg(320, 240, 85, 5, sub))
    _, tm = _meshes(2)
    pipe = TPAR.ShardedJpegPipeline(buf, 64, 64, mesh=tm, output_format=fmt)
    args = pipe.decode_entropy([buf] * 3)
    metrics.reset()
    got = [t.numpy() for t in pipe.device_step(*args).gather()]
    assert _counters() == {"gray": (1, 0), "420": (1, 2),
                           "440": (1, 2)}.get(sub, (3, 0))
    one = JpegTranscodePipeline(buf, 64, 64, output_format=fmt,
                                device="cpu").device_step(*args)
    if fmt == ".png":
        got, one = [got[0].view(np.uint8)], [one[0].numpy().view(np.uint8)]
    assert _coef_diff(got, one)[0] <= 1


def test_sharded_webp_and_avif_animation_batches():
    """transcode_webp_batch and transcode_avif_batch with a mesh split
    their groups over dp with the one-device bytes (the AVIF one where
    ffmpeg's headers exist)."""
    from lilliput_tpu_torch import binding
    from _torch_webp_builders import mixed_anim
    _, tm = _meshes(1)
    webp = [mixed_anim(48, 40, 5, s) for s in (1, 2, 3)]
    assert TP.transcode_webp_batch(webp, 24, 20, mesh=tm) == \
        TP.transcode_webp_batch(webp, 24, 20, device="cpu")
    if os.path.exists(binding.AVFORMAT_HEADER):
        with open("tests/assets/anim_4f_48x40.avif", "rb") as f:
            avif = [f.read()] * 3
        assert TP.transcode_avif_batch(avif, 24, 20, mesh=tm,
                                       file_type=".webp") == \
            TP.transcode_avif_batch(avif, 24, 20, device="cpu",
                                    file_type=".webp")
