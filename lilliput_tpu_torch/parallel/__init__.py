"""Multi-device serving: device meshes, the sharded JPEG Fit step and the
sharded serving fronts (the counterpart of ``lilliput_tpu/parallel/``),
and ``dryrun_multichip``, one step of each front over a mesh on tiny
shapes."""

from .mesh import (Mesh, Shards, make_mesh, replicate,  # noqa: F401
                   shard_batch, sharded_transcode_step)
from .serving import (ShardedJpegPipeline, ShardedStillPipeline,  # noqa: F401
                      transcode_sharded)

#: a 16x12 GIF of two frames (the second a 8x6 rect at (4, 3), disposal 2,
#: transparent index 0) over a 4-colour palette, looping: literal-only LZW
#: as tests/_torch_gif_builders.gif_bytes writes it
_TINY_GIF = bytes.fromhex(
    "47494638396110000c00f10000000000ff000000ff000000ff21ff0b4e455453"
    "43415045322e30030100000021f90404050000002c0000000010000c0000026d"
    "d48831a2c281091502048811e2c08419316e44a850a2c0890b33028c8831a0c6"
    "8d01270e849870a0c28c08014654887120428c12230e1c9871e0c6841b15628c"
    "283022c4890a0746140871e2c28c0011625c081122468d1233028c9871614485"
    "1a152604b830a2468d0a330a050021f90409050000002c040003000800060000"
    "021cdc085061408c1b05465ca850a2c08d0b130614385021c68c08134205003b")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of each multi-device front over a mesh of n_devices (the
    port's analog of __graft_entry__.dryrun_multichip): sp=2 when
    n_devices is even, else dp only. devices: what the mesh is built of,
    every visible card by default (make_mesh; e.g. [torch.device("cpu")]
    * 8 on the CPU, ["cuda:0"] * 4 on one card). Runs
    sharded_transcode_step on random coefficients (split over sp), a
    synthetic 1024x768 JPEG through ShardedJpegPipeline (sp) and in
    chroma_mode="direct" (dp only), a PNG through ShardedStillPipeline to
    .jpeg and .png and the device half of its .webp step, the tiny GIF
    through AnimatedTranscodePipeline and the three through
    MultiGeometryPipeline; each output's count and format is checked.
    Returns {"dp": dp, "sp": sp, "outputs": count}."""
    import numpy as np

    from ..codecs.jpeg import synthetic_jpeg
    from ..codecs.png import encode_png_pixels
    from ..pipeline import AnimatedTranscodePipeline, MultiGeometryPipeline

    sp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, sp=sp, devices=devices)
    dp = mesh.shape["dp"]
    outputs = 0

    def check(outs, n, magic):
        nonlocal outputs
        assert len(outs) == n and all(o[:len(magic)] == magic
                                      for o in outs), outs
        outputs += n

    rng = np.random.default_rng(0)
    batch, (src_w, src_h) = 2 * dp, (256, 128 * sp)
    yc, cb, cr = (rng.integers(-64, 64, (batch, src_h // f, src_w // f, 64),
                               dtype=np.int16) for f in (8, 16, 16))
    qt = np.clip(rng.integers(1, 40, 64), 1, 255).astype(np.float32)
    split = 1 if sp > 1 else None
    step = sharded_transcode_step(mesh, src_w, src_h, True, True, 64, 64)
    out = step(shard_batch(mesh, yc, split, halo=2),
               shard_batch(mesh, cb, split, halo=1),
               shard_batch(mesh, cr, split, halo=1),
               *[replicate(mesh, qt) for _ in range(4)])
    assert [tuple(o.shape) for o in out] == [
        (batch, 8, 8, 64), (batch, 4, 4, 64), (batch, 4, 4, 64)], out
    outputs += batch

    big = synthetic_jpeg(1024, 768)
    for kw in ({}, {"chroma_mode": "direct"}):
        check(ShardedJpegPipeline(big, 128, 128, mesh=mesh, **kw).transcode(
            [big] * (dp + 1)), dp + 1, b"\xff\xd8")
    png = encode_png_pixels(np.random.default_rng(1).integers(
        0, 256, (96 * sp, 128, 3), np.uint8), 6)
    for fmt, magic in ((".jpeg", b"\xff\xd8"), (".png", b"\x89PNG")):
        check(ShardedStillPipeline(png, 48, 48, mesh=mesh,
                                   output_format=fmt).transcode(
            [png] * (dp + 1)), dp + 1, magic)
    webp = ShardedStillPipeline(png, 48, 48, mesh=mesh,
                                output_format=".webp")
    args, _ = webp._host_decode([png] * (dp + 1))
    y, u, v = webp._to_host(webp._fetch(webp.device_step(*args)))
    assert (y.shape, u.shape) == ((dp + 1, 48, 48), (dp + 1, 24, 24))
    check(AnimatedTranscodePipeline(14, 9, output_format=".gif", fit=False,
                                    mesh=mesh).transcode([_TINY_GIF] * 3),
          3, b"GIF89a")
    mixed = MultiGeometryPipeline(32, 32, mesh=mesh).transcode(
        [big, png, _TINY_GIF])
    check(mixed, 3, b"\xff\xd8")
    print(f"DRYRUN OK: sharded step, JPEG sp and direct, still .jpeg .png "
          f".webp step, GIF and mixed fronts on {n_devices} devices "
          f"(dp={dp}, sp={sp})", flush=True)
    return {"dp": dp, "sp": sp, "outputs": outputs}
