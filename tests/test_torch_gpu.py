"""The port on a CUDA card: each decode kernel (decode420, decode422,
decode440, decode444, dequant_idct_blocks) against its plain PyTorch
version, and each serving path's device step (the four layouts upright,
grayscale upright and oriented, 4:2:0 oriented; chroma_mode="direct",
dct_scale 2 and 4, LINEAR and CUBIC, LILLIPUT_FUSED_EXACT) against the
same step through the plain version and on the CPU; the streaming
fixed-point LINEAR and CUBIC resize on the card equal to the CPU's; the
.png output's pixel step likewise; transcode_pipelined equal to transcode
per batch; the single-image decode (batch 1, whole frame) against its
stacked plain version and the CPU. Imports no jax, so it runs on the
card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernels have no CPU mode).

Tolerances: the kernel's 64-term IDCT sums run in k order with fmaf, the
plain version's in cuBLAS's order, so a u8 value may move by 1 where a sum
lands next to a .5 tie: max 1 on at most 1e-4 of the values. The device
step then allows max 1 on at most 1e-3 of the quantized coefficients
(a moved pixel shifts the resized value by a fraction, which can flip a
coefficient rounding). dequant_idct_blocks is held to the same u8 bound
after decode_gray's round and clip, and its u8 epilogue must equal its f32
output rounded and clipped (0 differing values), its centered epilogue
plus 128 its f32 output (bit for bit).

The still formats (JCS_RGB, CMYK and YCCK JPEG, PNG, BMP, PNM, PAM, Sun
Raster, HDR, PFM: chip_smoke.still_inputs, 1080p) decode on the card to
the CPU's pixels with 0 differing values, dequant_idct_blocks launched 3
or 4 times per JPEG decode and not at all for the others, and a JPEG's
frame is within the kernel bound of its plain route (2-image stack).

The still serving pipeline's device step (no kernel) on the card equals
its CPU step within the step gate (coefficients) or the kernel gate
(pixels), and MultiGeometryPipeline on the card gives each group the bytes
of its per-signature pipeline, launching each layout's kernel once per
group.

The GIF path (no kernel: torch ops) on the card equals the CPU port: the
quantizer's indices and cache tables across a palette change (argmin
ties included), the whole-animation quantizer and composite over an
animation axis, the streaming and batched decodes, transcode_gif_batch
(also equal to per-animation transcode_gif) and ImageOps.transform's
.gif, .png and .thumbhash bytes.

WebP (no kernel of its own): the yuv420 emit on the card equals the CPU
over every u8 value and at odd sizes, the .webp step launches decode420
once with planes equal to the CPU step's, and the animated composite and
its resize equal the CPU's (0 differing values).

JPEG 2000 (no kernel: the wavelet, colour transforms and decode tail are
torch ops): decode_to and the .jp2 encode on the card equal the CPU's
(0 differing values, equal bytes) on small lossless, 9/7, tiled and
sYCC streams, and each ops/wavelet function on the card equals the CPU
on random int64 and float64 stacks, bit for bit."""

import functools
import os

import numpy as np
import pytest
import torch

from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import jpeg_kernels as K

CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129),
         (1088, 1120)]
#: the 1080p fixtures' serving windows (h, w) of the other layouts
WINDOWS = {"422": (1080, 1120), "440": (1080, 1104), "444": (1080, 1104)}
LAYOUTS = {"420": (True, True), "422": (True, False), "440": (False, True),
           "444": (False, False)}
FIXTURE = "tests/assets/bench_1080p.jpg"


def _fixture(sub):
    """sub: a chroma layout, "gray", "o6" or "gray_o6"."""
    return FIXTURE if sub == "420" else FIXTURE.replace(".jpg",
                                                        f"_{sub}.jpg")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _diff(got, ref):
    """(max |got - ref|, differing values, values) over pairs of arrays."""
    ds = [(g.to(torch.int32) - r.to(torch.int32)).abs().flatten()
          for g, r in zip(got, ref)]
    d = torch.cat(ds)
    return int(d.max()), int((d > 0).sum()), d.numel()


def _args(h, w, batch=3, sub="420"):
    rng = np.random.default_rng(h * 1000 + w)
    h2, v2 = LAYOUTS[sub]

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    coefs = [rng.integers(-lim, lim, (batch, bl(h, fv), bl(w, fh), 64))
             for lim, fh, fv in ((300, 1, 1), (200, 1 + h2, 1 + v2),
                                 (200, 1 + h2, 1 + v2))]
    qs = [scaled_qtables((30, 85, 95)[i % 3]) for i in range(batch)]
    tabs = [np.stack([q[i] for q in qs]).astype(np.float32) for i in (0, 1)]
    return tuple(torch.from_numpy(c.astype(np.int16)).cuda()
                 for c in coefs) + tuple(
        K.fold_qtables(torch.from_numpy(t).cuda()) for t in tabs)


def _plain(args, h2, v2, out="planes"):
    """The plain version of one image's decode is taken from a stack of two
    copies of it: at batch 1 cuBLAS runs a single GEMM whose sum order
    differs from its batched one (which agrees with the kernel's k order),
    and with one image a single moved tie exceeds the 1e-4 share."""
    if args[0].shape[0] > 1:
        return DK.decode_ycc_reference(*args, h2, v2, out=out)
    ref = DK.decode_ycc_reference(*(torch.cat([a, a]) for a in args), h2, v2,
                                  out=out)
    return ref[:1] if out == "packed" else tuple(p[:1] for p in ref)


def _check_kernel(sub, h, w, batch=3):
    args = _args(h, w, batch, sub)
    h2, v2 = LAYOUTS[sub]
    name = "decode" + sub
    fn = getattr(DK, name)
    before = DK.launches[name]
    got = fn(*args)
    assert DK.launches[name] == before + 1
    ref = _plain(args, h2, v2)
    mx, nd, n = _diff(got, ref)
    assert mx <= 1 and nd <= 1e-4 * n
    got = fn(*args, out="packed")
    assert DK.launches[name] == before + 2
    ref = _plain(args, h2, v2, out="packed")
    mx, nd, n = _diff([(got >> s) & 255 for s in (0, 8, 16, 24)],
                      [(ref >> s) & 255 for s in (0, 8, 16, 24)])
    assert mx <= 1 and nd <= 1e-4 * n


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", CASES)
def test_kernel_matches_plain(h, w):
    _need_card()
    _check_kernel("420", h, w)


#: layout -> chroma block widths on either side of its kernel's strip edges
STRIP_EDGES = {"420": (1, 7, 8, 9, 10, 11, 17, 21),
               "422": (1, 13, 14, 15, 28, 29),
               "440": (1, 10, 15, 16, 17, 33),
               "444": (1, 15, 16, 17, 33)}
#: layout -> chroma block heights on either side of its kernel's band edges
#: (and decode444's steps of 4 MCU rows)
BAND_EDGES = {"420": (1, 16, 17, 18, 35), "422": (1, 16, 17, 18, 35),
              "440": (1, 16, 17, 18, 35),
              "444": (1, 3, 4, 5, 15, 16, 17, 35)}


@pytest.mark.gpu
@pytest.mark.parametrize("sub,ch,cw,batch", [
    (sub, ch, cw, batch) for sub, cws in STRIP_EDGES.items()
    for ch in BAND_EDGES[sub] for cw in cws for batch in (1, 3)])
def test_band_and_strip_edges(sub, ch, cw, batch):
    """decode420, decode422 and decode440 walk bands of 17 MCU rows in
    strips of 10, 14 and 16 MCUs, decode444 bands of 16 MCU rows, 4 per
    step, in strips of 16 MCUs: chroma heights and widths on either side of
    those edges, both epilogues."""
    _need_card()
    h2, v2 = LAYOUTS[sub]
    _check_kernel(sub, 8 * (1 + v2) * ch - 1, 8 * (1 + h2) * cw - 3, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("sub,h,w,batch", [
    (sub, h, w, 3) for sub in WINDOWS for h, w in CASES[:-1]] + [
    (sub, h, w, 16) for sub, (h, w) in WINDOWS.items()])
def test_layout_kernels_match_plain(sub, h, w, batch):
    """The odd geometries, and the serving window at batch 16."""
    _need_card()
    _check_kernel(sub, h, w, batch)


def _check_device_step(sub, name, **kw):
    """The path's device step launches `name` once (no kernel when None)
    and agrees with the plain step and the CPU step (pipelines built with
    the keywords kw)."""
    with open(_fixture(sub), "rb") as f:
        buf = f.read()
    gpu = JpegTranscodePipeline(buf, 256, 256, device="cuda", **kw)
    cpu = JpegTranscodePipeline(buf, 256, 256, device="cpu", **kw)
    args = gpu.decode_entropy([buf] * 4)
    before = dict(DK.launches)
    step = [t.cpu() for t in gpu.device_step(*args)]
    assert DK.launches == {k: v + (k == name) for k, v in before.items()}
    plain = [t.cpu() for t in gpu.device_step(*args, plain=True)]
    host = list(cpu.device_step(*args))
    for ref in (plain, host):
        mx, nd, n = _diff(step, ref)
        assert mx <= 1 and nd <= 1e-3 * n
    outs = gpu.transcode([buf] * 2)
    assert outs[0] == outs[1] and outs[0][:2] == b"\xff\xd8"


@pytest.mark.gpu
def test_device_step_matches_plain_and_cpu():
    _need_card()
    _check_device_step("420", "decode420")


@pytest.mark.gpu
@pytest.mark.parametrize("sub", ("422", "440", "444"))
def test_layout_device_step_matches_plain_and_cpu(sub):
    _need_card()
    _check_device_step(sub, "decode" + sub)


@pytest.mark.gpu
@pytest.mark.parametrize("sub,name", [("gray", None),
                                      ("gray_o6", "dequant_idct_blocks"),
                                      ("o6", "decode420")])
def test_gray_and_oriented_device_step_matches_plain_and_cpu(sub, name):
    _need_card()
    _check_device_step(sub, name)


@pytest.mark.gpu
@pytest.mark.parametrize("sub,name,kw", [
    ("420", None, {"chroma_mode": "direct"}),
    ("420", None, {"chroma_mode": "direct", "dct_scale": 2}),
    ("420", None, {"chroma_mode": "direct", "dct_scale": 4}),
    ("gray", None, {"chroma_mode": "direct", "dct_scale": 2}),
    ("420", "decode420", {"method": "linear"}),
    ("444", "decode444", {"method": "cubic"}),
    ("422", "decode422", {"method": "cubic"}),
    ("440", "decode440", {"method": "linear"}),
    ("o6", "decode420", {"method": "cubic"}),
    ("gray", None, {"method": "linear"}),
    ("gray_o6", "dequant_idct_blocks", {"method": "cubic"})],
    ids=lambda v: v if isinstance(v, str) else (
        "-".join(f"{k}={x}" for k, x in v.items()) if isinstance(v, dict)
        else str(v)))
def test_mode_device_step_matches_plain_and_cpu(sub, name, kw):
    """The direct, dct_scale and LINEAR/CUBIC modes: the direct modes launch
    no kernel (their IDCTs are matmuls); the others their layout's."""
    _need_card()
    _check_device_step(sub, name, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("sub,name", [("420", "decode420"),
                                      ("444", "decode444"), ("gray", None),
                                      ("o6", "decode420")])
def test_fused_exact_device_step_matches_plain_and_cpu(sub, name,
                                                       monkeypatch):
    """LILLIPUT_FUSED_EXACT=1: the exact tails on the card."""
    _need_card()
    monkeypatch.setenv("LILLIPUT_FUSED_EXACT", "1")
    _check_device_step(sub, name)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("src,dst", [((1080, 1080), (256, 256)),
                                     ((61, 67), (100, 90)),
                                     ((480, 640), (481, 320))], ids=str)
def test_fixed_point_resize_equals_cpu(method, src, dst):
    """_linear_u8 and _cubic_u8 are integer arithmetic: the card's result
    equals the CPU's at atol 0 (int32 wraps alike on both)."""
    _need_card()
    from lilliput_tpu_torch.ops import resize as R
    img = np.random.default_rng(sum(src) + sum(dst)).integers(
        0, 256, (4,) + src + (3,)).astype(np.uint8)
    t = torch.from_numpy(img)
    got = R.resize(t.cuda(), *dst, method).cpu()
    assert torch.equal(got, R.resize(t, *dst, method))
    if method == "linear":      # the AREA upscale's area-rule bilinear
        up = (src[1] + 7, src[0] + 3)
        assert torch.equal(R._linear_u8(t.cuda(), *up, True).cpu(),
                           R._linear_u8(t, *up, True))


def _check_idct_kernel(h, w, batch, shared):
    """Both epilogues of dequant_idct_blocks: f32 against the plain version
    within the u8 bound after decode_gray's round and clip, u8 equal to the
    rounded f32 output of the same kernel and within that bound of the
    plain version's u8. At batch 1 the plain version is taken from a stack
    of two copies (see _plain)."""
    rng = np.random.default_rng(h * 7 + w + batch)
    yc = rng.integers(-400, 400, (batch, -(-h // 8), -(-w // 8), 64))
    yc = torch.from_numpy(yc.astype(np.int16)).cuda()
    qs = np.stack([scaled_qtables((30, 85, 95)[i % 3])[0]
                   for i in range(1 if shared else batch)])
    wq = K.fold_qtables(torch.from_numpy(qs.astype(np.float32)).cuda())
    before = DK.launches["dequant_idct_blocks"]
    got = DK.dequant_idct_blocks(yc, wq)
    got8 = DK.dequant_idct_blocks(yc, wq, out="u8")
    gotc = DK.dequant_idct_blocks(yc, wq, out="centered")
    assert DK.launches["dequant_idct_blocks"] == before + 3
    # the f32 epilogue adds 128 to the same sums with one rounding
    assert torch.equal(gotc + 128.0, got)
    args = (yc, wq) if batch > 1 else (torch.cat([yc, yc]),
                                       torch.cat([wq, wq]))
    ref = DK.dequant_idct_blocks_reference(*args)[:batch]
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert got8.shape == ref.shape and got8.dtype == torch.uint8

    def u8(p):
        return torch.clamp(torch.round(p), 0, 255).to(torch.uint8)
    assert torch.equal(got8, u8(got))
    for g in (u8(got), got8):
        mx, nd, n = _diff([g], [u8(ref)])
        assert mx <= 1 and nd <= 1e-4 * n


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", CASES[:-1] + [(1080, 1920)])
@pytest.mark.parametrize("shared", [False, True], ids=["per_image", "shared"])
def test_idct_kernel_matches_plain(h, w, shared):
    """The odd geometries at batch 3, and a full 1080p frame at batch 8,
    with per-image tables and with one shared table."""
    _need_card()
    _check_idct_kernel(h, w, 8 if h == 1080 else 3, shared)


#: block rows and columns on either side of dequant_idct_blocks' step (4
#: rows), band (16 rows) and strip (16 columns) edges
IDCT_ROWS = (1, 3, 4, 5, 15, 16, 17, 33)
IDCT_COLS = (1, 15, 16, 17, 33)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,bw,batch", [
    (bh, bw, batch) for bh in IDCT_ROWS for bw in IDCT_COLS
    for batch in (1, 3)])
def test_idct_kernel_band_and_strip_edges(bh, bw, batch):
    _need_card()
    _check_idct_kernel(8 * bh - 1, 8 * bw - 3, batch, False)


# -- the .png output, the overlap of transcode_pipelined, the still surface --

@pytest.mark.gpu
@pytest.mark.parametrize("sub,name", [("420", "decode420"),
                                      ("gray_o6", "dequant_idct_blocks")])
def test_png_device_step_matches_plain_and_cpu(sub, name):
    """The pixel emit on the card: packed BGRA within the kernel gate of
    the plain step and the CPU step."""
    _need_card()
    with open(_fixture(sub), "rb") as f:
        buf = f.read()
    gpu = JpegTranscodePipeline(buf, 256, 256, device="cuda",
                                output_format=".png")
    cpu = JpegTranscodePipeline(buf, 256, 256, device="cpu",
                                output_format=".png")
    args = gpu.decode_entropy([buf] * 4)
    before = dict(DK.launches)
    (step,) = gpu.device_step(*args)
    assert DK.launches == {k: v + (k == name) for k, v in before.items()}
    for (ref,) in (gpu.device_step(*args, plain=True),
                   cpu.device_step(*args)):
        mx, nd, n = _diff([(step.cpu() >> s) & 255 for s in (0, 8, 16, 24)],
                          [(ref.cpu() >> s) & 255 for s in (0, 8, 16, 24)])
        assert mx <= 1 and nd <= 1e-4 * n


def _variants(n):
    """n distinct 4:2:0 JPEGs of one geometry (320x200), made on the CPU
    by the port itself (the card's machine has no image library): the
    fixture fitted, then rolled and brightened per variant."""
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    with open(FIXTURE, "rb") as f:
        fb = Framebuffer()
        new_decoder(f.read(), device="cpu").decode_to(fb)
    small = fb.fit(320, 200).to_numpy()
    out = []
    for i in range(n):
        px = np.roll(small, 17 * i, axis=1)
        px = np.clip(px.astype(int) + 9 * i, 0, 255).astype(np.uint8)
        out.append(new_encoder(".jpeg").encode(
            Framebuffer.from_array(px, device="cpu"), {}))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
def test_pipelined_equals_transcode_on_card(fmt):
    """Five batches of distinct images, one holding a truncated scan (it
    decodes through libjpeg where libjpeg exists, and fails its slot with
    HostLibraryMissingError elsewhere): transcode_pipelined (pinned output
    slots reused every other batch) equals transcode of each batch
    (chip_smoke.py phase 6 checks that it overlaps)."""
    _need_card()
    srcs = _variants(15)
    batches = [srcs[3 * b:3 * b + 3] for b in range(5)]
    batches[2][1] = batches[2][1][:len(batches[2][1]) // 2]
    pipe = JpegTranscodePipeline(srcs[0], 64, 48, device="cuda",
                                 output_format=fmt)
    got = pipe.transcode_pipelined(batches, return_exceptions=True)
    ref = [JpegTranscodePipeline(srcs[0], 64, 48, device="cuda",
                                 output_format=fmt).transcode(
                                     b, return_exceptions=True)
           for b in batches]
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert (type(a) is type(b)) if isinstance(b, Exception) \
                else a == b
    from lilliput_tpu_torch import binding
    assert len({o for b in got for o in b if isinstance(o, bytes)}) == (
        15 if os.path.exists(binding.JPEG_HEADER) else 14)


@pytest.mark.gpu
@pytest.mark.parametrize("sub,name", [
    ("420", "decode420"), ("422", "decode422"), ("440", "decode440"),
    ("444", "decode444"), ("gray", "dequant_idct_blocks"),
    ("o6", "decode420")])
def test_still_decode_matches_plain_and_cpu(sub, name):
    """JpegDecoder.decode_to on the card at batch 1 over the whole frame
    launches the layout's kernel once and equals the plain decode (taken
    from a 2-image stack, see _plain) and the CPU decode."""
    _need_card()
    from lilliput_tpu_torch import Framebuffer, new_decoder
    with open(_fixture(sub), "rb") as f:
        buf = f.read()
    dec = new_decoder(buf)
    fb = Framebuffer()
    before = dict(DK.launches)
    dec.decode_to(fb)
    assert DK.launches == {k: v + (k == name) for k, v in before.items()}
    info = dec._info
    two = [torch.stack([dec._coef(c)] * 2)
           for c in range(info.num_components)]
    tabs = [torch.stack([dec._qtable(c)] * 2)
            for c in range(min(info.num_components, 2))]
    if info.num_components == 1:
        plain = K.decode_gray(*two, *tabs, info.height, info.width,
                              plain=True)[0][..., None]
    else:
        h2, v2 = LAYOUTS["420" if sub == "o6" else sub]
        plain = torch.stack([p[0] for p in K.decode_ycc_420(
            *two, *tabs, info.height, info.width, h2, v2, plain=True)], -1)
    cpu = Framebuffer()
    new_decoder(buf, device="cpu").decode_to(cpu)
    for ref in (plain, cpu.array.cuda()):
        mx, nd, n = _diff([fb.array], [ref])
        assert mx <= 1 and nd <= 1e-4 * n


@functools.lru_cache(maxsize=1)
def _still_inputs():
    import chip_smoke
    return chip_smoke.still_inputs()


_STILL_NAMES = ["jpeg_rgb", "jpeg_cmyk", "jpeg_ycck", "png_rgb8",
                "png_rgba8", "png_gray8", "png_palette8", "png_rgb16",
                "png_adam7", "bmp_565", "bmp_rle8", "bmp_24", "bmp_32",
                "ppm", "pgm", "ppm16", "pam", "ras_24", "ras_palette", "hdr",
                "pfm"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _STILL_NAMES)
def test_still_format_decode_on_card_equals_cpu(name):
    _need_card()
    from lilliput_tpu_torch import Framebuffer, new_decoder
    buf, n = _still_inputs()[name]
    dec = new_decoder(buf)
    fb = Framebuffer()
    before = dict(DK.launches)
    dec.decode_to(fb)
    assert DK.launches == {k: v + (n if k == "dequant_idct_blocks" else 0)
                           for k, v in before.items()}
    assert fb.device.type == "cuda"
    cpu = Framebuffer()
    new_decoder(buf, device="cpu").decode_to(cpu)
    assert torch.equal(fb.array.cpu(), cpu.array)
    if n:   # decode_rgb / decode_cmyk: the kernel route vs the plain one
        def two(get):
            return lambda c: torch.stack([get(c), get(c)])
        plain = dec.frame(two(dec._coef), two(dec._qtable), plain=True)[0]
        mx, nd, count = _diff([fb.array], [plain])
        assert mx <= 1 and nd <= 1e-4 * count


@pytest.mark.gpu
def test_thumbhash_batch_on_card_equals_cpu():
    """thumbhash_batch of numpy BGRA tiles (opaque and with alpha,
    landscape and portrait) on the card: the same hashes as on the CPU."""
    _need_card()
    from lilliput_tpu_torch.codecs.thumbhash import thumbhash_batch
    rng = np.random.default_rng(12)
    for h, w in ((64, 96), (100, 37)):
        tiles = rng.integers(0, 256, (24, h, w, 4), dtype=np.uint8)
        tiles[:12, ..., 3] = 255
        assert thumbhash_batch(tiles) == thumbhash_batch(tiles, device="cpu")


def _gif_frames(rng, n, h, w):
    """BGRA frames with crushed-key collisions, extremes and transparency."""
    f = rng.integers(0, 256, (n, h, w, 4), np.uint8)
    f[:, :9, :9, :3] = rng.integers(0, 16, (n, 9, 9, 3))
    f[:, 9:14, :9, :3] = rng.integers(241, 256, (n, 5, 9, 3))
    f[:, 20:] = f[:, 20:21]
    f[..., 3] = np.where(f[..., 3] < 60, 10, 255)
    return f


def _gif_palettes(rng):
    pa = rng.integers(0, 256, (64, 3), np.uint8)
    pa[32:] = pa[:32]                      # every colour twice: ties
    pb = np.zeros((256, 3), np.uint8)      # few colours, black padding
    pb[:9] = rng.integers(0, 256, (9, 3))
    return pa, pb


@pytest.mark.gpu
def test_gif_quantizer_on_card_equals_cpu():
    """quantize_to_palette frame by frame with the carried cache tables
    (indices, seen keys and cache after each frame, across a palette
    change), and quantize_animation over 3 animations of 5 frames, on the
    card against the CPU; each lane also equals its sequential calls."""
    _need_card()
    from lilliput_tpu_torch.ops import palette as P
    rng = np.random.default_rng(31)
    frames = _gif_frames(rng, 5, 48, 40)
    pa, pb = _gif_palettes(rng)
    pals = [pa, pa, pa, pb, pb]
    trans = [5, 70, -1, 3, 3]
    outs = {}
    for dev in ("cuda", "cpu"):
        seen = cache = None
        res = []
        for k, (img, pal, tr) in enumerate(zip(frames, pals, trans)):
            if k in (0, 3):
                seen = torch.zeros(P.CACHE_SIZE, dtype=torch.bool,
                                   device=dev)
                cache = torch.zeros(P.CACHE_SIZE, dtype=torch.uint8,
                                    device=dev)
            use_prev = k > 0 and tr >= 0
            prev = torch.from_numpy(frames[k - 1] if use_prev
                                    else np.zeros_like(img)).to(dev)
            idx, seen, cache = P.quantize_to_palette(
                torch.from_numpy(img).to(dev),
                torch.from_numpy(pal.astype(np.int32)).to(dev), prev, seen,
                cache, tr, tr >= 0, use_prev)
            res.append((idx.cpu(), seen.cpu(), cache.cpu()))
        outs[dev] = res
    for (gi, gs, gc), (ci, cs, cc) in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(gi, ci) and torch.equal(gs, cs)
        assert torch.equal(gc, cc)
    pal256 = np.zeros((5, 256, 3), np.int32)
    for k, p in enumerate(pals):
        pal256[k, :len(p)] = p
    lane = [frames, pal256, np.array([len(p) for p in pals], np.int32),
            np.array(trans, np.int32),
            np.array([True, False, False, True, False]),
            np.array([k > 0 and t >= 0 for k, t in enumerate(trans)])]
    other = [_gif_frames(rng, 5, 48, 40)] + lane[1:]
    batch = [np.stack([a, b, np.zeros_like(a)]) for a, b in zip(lane, other)]
    got = {dev: P.quantize_animation(
        *(torch.from_numpy(a).to(dev) for a in batch)).cpu()
        for dev in ("cuda", "cpu")}
    assert torch.equal(got["cuda"], got["cpu"])
    for k in range(5):
        assert torch.equal(got["cuda"][0, k], outs["cpu"][k][0])


@pytest.mark.gpu
def test_gif_argmin_ties_on_card():
    """torch.min over the palette axis returns the first lowest index on
    the card, as giflib's search does."""
    _need_card()
    d = torch.full((3, 1000, 256), 500, dtype=torch.int16, device="cuda")
    d[0, :, 17] = 3
    d[0, :, 200] = 3
    d[1, :, ::2] = 7
    d[2] = 9
    _, i = torch.min(d, dim=-1)
    assert (i[0] == 17).all() and (i[1] == 0).all() and (i[2] == 0).all()


def _gif_inputs():
    import _torch_gif_builders as G
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (200, 260, 3), np.uint8)
    rgb = np.repeat(np.repeat(rgb[::4, ::4], 4, 0), 4, 1)
    return [G.pan_gif(rgb, 96, 80, n, start=s)
            for n, s in ((9, 0), (9, 4), (5, 2), (12, 1))]


@pytest.mark.gpu
def test_gif_decode_on_card_equals_cpu():
    """decode_to frame by frame and decode_animation (the device
    composite) on the card: the CPU port's frames."""
    _need_card()
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.codecs.gif import GifDecoder
    buf = _gif_inputs()[0]
    frames = {}
    for dev in ("cuda", "cpu"):
        d = new_decoder(buf, device=dev)
        got = []
        while True:
            fb = Framebuffer()
            try:
                d.decode_to(fb)
            except EOFError:
                break
            assert fb.device.type == dev
            got.append(fb.array.cpu())
        frames[dev] = got
        anim, _ = GifDecoder(buf, device=dev).decode_animation(pad_frames=-1)
        frames[dev + "_batch"] = anim.cpu()
    assert len(frames["cuda"]) == 9
    for a, b in zip(frames["cuda"], frames["cpu"]):
        assert torch.equal(a, b)
    assert torch.equal(frames["cuda_batch"], frames["cpu_batch"])
    for k, a in enumerate(frames["cuda"]):
        assert torch.equal(frames["cuda_batch"][k], a)


@pytest.mark.gpu
def test_gif_batch_on_card_equals_per_animation_and_cpu():
    _need_card()
    from lilliput_tpu_torch import AnimatedTranscodePipeline
    from lilliput_tpu_torch import pipeline as TP
    bufs = _gif_inputs()
    got = TP.transcode_gif_batch(bufs, 32, 24, fit=True)
    assert got == TP.transcode_gif_batch(bufs, 32, 24, fit=True,
                                         device="cpu")
    for buf, b in zip(bufs, got):
        assert TP.transcode_gif(buf, 32, 24, fit=True) == b
    pipe = AnimatedTranscodePipeline(32, 24, ".gif")
    res = pipe.transcode(bufs + [bufs[0][:300]], return_exceptions=True)
    assert res[:4] == got and isinstance(res[4], Exception)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [".gif", ".png", ".thumbhash"])
def test_gif_transform_on_card_equals_cpu(fmt):
    _need_card()
    from lilliput_tpu_torch import (ImageOps, ImageOptions, ResizeMethod,
                                    new_decoder)
    buf = _gif_inputs()[2]
    outs = [ImageOps(8192).transform(new_decoder(buf, device=dev),
                                     ImageOptions(file_type=fmt, width=40,
                                                  height=40,
                                                  resize_method=ResizeMethod.FIT,
                                                  encode_timeout=300.0))
            for dev in ("cuda", "cpu")]
    assert outs[0] == outs[1]


def _still_sources(n, w=160, h=120):
    """n distinct PNGs of each channel count (RGB8, RGBA8, gray8) and a
    GIF, made from the fixture by the port and the numpy builders."""
    from _torch_gif_builders import pan_gif
    from _torch_still_builders import png_bytes
    from lilliput_tpu_torch import Framebuffer, new_decoder
    with open(FIXTURE, "rb") as f:
        fb = Framebuffer()
        new_decoder(f.read(), device="cpu").decode_to(fb)
    rgb = np.ascontiguousarray(fb.fit(w + 40, h + 30).to_numpy()[..., ::-1])
    ramp = (np.arange(w) * 255 // (w - 1)).astype(np.uint8)
    out = {"png_rgb8": [], "png_rgba8": [], "png_gray8": []}
    for i in range(n):
        px = np.roll(rgb, 13 * i, axis=1)[:h, :w]
        alpha = np.broadcast_to(np.roll(ramp, 7 * i)[None, :, None],
                                (h, w, 1))
        out["png_rgb8"].append(png_bytes(px, 2))
        out["png_rgba8"].append(png_bytes(np.concatenate([px, alpha], -1),
                                          6))
        out["png_gray8"].append(png_bytes(px[..., 1:2], 0))
    out["gif"] = [pan_gif(rgb, w, h, 3, start=i) for i in range(n)]
    return out


def _coef_gate(got, ref):
    mx, nd, n = _diff([torch.from_numpy(np.asarray(g)) for g in got],
                      [torch.from_numpy(np.asarray(r)) for r in ref])
    assert mx <= 1 and nd <= 1e-3 * n


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [".jpeg", ".png"])
@pytest.mark.parametrize("kind", ["png_rgb8", "png_rgba8", "png_gray8",
                                  "gif"])
def test_still_device_step_on_card_matches_cpu(kind, fmt):
    """StillTranscodePipeline's device step on the card (no kernel: torch
    ops) against its CPU step on the same pixel batch: coefficients within
    the step gate, pixels within the kernel gate; the .png bytes and the
    transcode_pipelined bytes those of transcode."""
    _need_card()
    from lilliput_tpu_torch import StillTranscodePipeline
    bufs = _still_sources(3)[kind]
    gpu = StillTranscodePipeline(bufs[0], 64, 48, output_format=fmt)
    cpu = StillTranscodePipeline(bufs[0], 64, 48, output_format=fmt,
                                 device="cpu")
    (px,), _ = gpu._host_decode(bufs)
    before = dict(DK.launches)
    step = [t.cpu().numpy() for t in gpu.device_step(px)]
    assert DK.launches == before
    ref = [t.numpy() for t in cpu.device_step(px)]
    if fmt == ".jpeg":
        _coef_gate(step, ref)
    else:
        mx, nd, n = _diff([torch.from_numpy(step[0].view(np.uint8))],
                          [torch.from_numpy(ref[0].view(np.uint8))])
        assert mx <= 1 and nd <= 1e-4 * n
    out = gpu.transcode(bufs)
    assert gpu.transcode_pipelined([bufs, bufs[::-1]]) == [out, out[::-1]]


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["area", "linear", "cubic"])
def test_still_tail_on_card_matches_cpu(method):
    """_fused_still_fit_impl on the card, EXIF orientation 6, 1, 3 and 4
    channels: the CPU's coefficients within the step gate, its pixels
    within the kernel gate."""
    _need_card()
    from lilliput_tpu_torch import pipeline as TP
    ql, qc = (torch.from_numpy(q.astype(np.float32))
              for q in scaled_qtables(85))
    for c in (1, 3, 4):
        px = torch.from_numpy(np.random.default_rng(c).integers(
            0, 256, (3, 131, 97, c), np.uint8))
        for emit in ("coefs", "pixels"):
            got = TP._fused_still_fit_impl(px.cuda(), ql.cuda(), qc.cuda(),
                                           97, 131, 40, 30, method=method,
                                           orientation=6, emit=emit)
            ref = TP._fused_still_fit_impl(px, ql, qc, 97, 131, 40, 30,
                                           method=method, orientation=6,
                                           emit=emit)
            if emit == "coefs":
                _coef_gate([g.cpu() for g in got], ref)
            else:
                mx, nd, n = _diff(
                    [(got[0].cpu() >> s) & 255 for s in (0, 8, 16, 24)],
                    [(ref[0] >> s) & 255 for s in (0, 8, 16, 24)])
                assert mx <= 1 and nd <= 1e-4 * n


@pytest.mark.gpu
def test_multigeometry_on_card_equals_per_signature_pipelines():
    """A small mix (4:2:0, 4:2:2, 4:4:4, grayscale oriented, PNG RGB8,
    RGBA8 and gray8, GIF, a truncated scan, which fails where libjpeg is
    absent, and a RIFF/WEBP header) through
    MultiGeometryPipeline on the card: each group's bytes those of its
    per-signature pipeline on the card, in input order; the layouts'
    kernels launched once per group; the .jpeg coefficients within the
    step gate of the CPU front's."""
    _need_card()
    import chip_smoke
    from lilliput_tpu_torch import (JpegTranscodePipeline,
                                    MultiGeometryPipeline,
                                    StillTranscodePipeline)
    srcs = {sub: _fixture(sub) for sub in ("420", "422", "444", "gray_o6")}
    jpegs = {}
    for sub, path in srcs.items():
        with open(path, "rb") as f:
            jpegs[sub] = f.read()
    stills = _still_sources(2)
    items = [(sub, jpegs[sub]) for sub in jpegs for _ in range(2)]
    items += [(k, b) for k, bs in stills.items() for b in bs]
    webp = b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(8)
    from lilliput_tpu_torch import binding
    cut = ("420" if os.path.exists(binding.JPEG_HEADER)  # libjpeg decodes
           else "broken")
    items += [(cut, jpegs["420"][:len(jpegs["420"]) // 2]),
              ("broken", webp)]
    order = np.random.default_rng(5).permutation(len(items))
    labels = [items[i][0] for i in order]
    bufs = [items[i][1] for i in order]
    mg = MultiGeometryPipeline(96, 96)
    DK.reset_launches()
    got = mg.transcode(bufs, return_exceptions=True)
    assert dict(DK.launches) == {
        "decode420": 1, "decode422": 1, "decode440": 0, "decode444": 1,
        "dequant_idct_blocks": 1}
    assert [isinstance(g, Exception) for g in got] == [
        k == "broken" for k in labels]
    # a WebP header without a frame: not a valid WebP where libwebp is,
    # the missing library's error where it is not
    from lilliput_tpu_torch.errors import (HostLibraryMissingError,
                                           InvalidImageError)
    assert isinstance(got[bufs.index(webp)], (
        InvalidImageError if os.path.exists(binding.WEBP_HEADER)
        else HostLibraryMissingError))
    cpu = MultiGeometryPipeline(96, 96, device="cpu").transcode(
        bufs, return_exceptions=True)
    for label in set(labels) - {"broken"}:
        idx = [i for i, k in enumerate(labels) if k == label]
        members = [bufs[i] for i in idx]
        cls = (JpegTranscodePipeline if label in jpegs
               else StillTranscodePipeline)
        assert cls(members[0], 96, 96).transcode(members) == [
            got[i] for i in idx], label
        for i in idx:
            _coef_gate(chip_smoke.jpeg_coefs(got[i]),
                       chip_smoke.jpeg_coefs(cpu[i]))


def _jp2_streams():
    """name -> a small JP2 stream, written by the port's encoder on the
    CPU from the fixture's pixels (no PIL on the card's machine)."""
    import struct
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.codecs.jp2_enc import encode_j2k, encode_jp2
    with open(FIXTURE, "rb") as f:
        fb = Framebuffer()
        new_decoder(f.read(), device="cpu").decode_to(fb)
    rgb = np.ascontiguousarray(fb.fit(130, 98).to_numpy()[..., ::-1])
    out = {"lossless": encode_jp2(rgb),
           "97": encode_jp2(rgb, reversible=False),
           "97_rate": encode_jp2(rgb, reversible=False, rate=12.0),
           "tiled_97": encode_jp2(rgb, reversible=False, tile=(32, 32)),
           "tiled_gray": encode_j2k(np.ascontiguousarray(rgb[..., 1]),
                                    tile=(48, 40)),
           "sub_roi": encode_jp2(rgb, sub=[(1, 1), (2, 2), (2, 2)],
                                 roi=(8, 8, 60, 40))}
    buf = bytearray(encode_jp2(rgb, mct=False))
    i = bytes(buf).find(b"colr")
    buf[i + 7:i + 11] = struct.pack(">I", 18)         # sYCC
    out["sycc"] = bytes(buf)
    return out, rgb


@pytest.mark.gpu
def test_jp2_decode_and_encode_on_card_equal_cpu():
    _need_card()
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    from lilliput_tpu_torch.codecs.jp2_enc import encode_jp2
    streams, rgb = _jp2_streams()
    for name, b in streams.items():
        DK.reset_launches()
        fbs = []
        for dev in ("cuda", "cpu"):
            fb = Framebuffer()
            new_decoder(b, device=dev).decode_to(fb)
            fbs.append(fb)
        assert not any(DK.launches.values()), name
        assert fbs[0].array.device.type == "cuda"
        assert torch.equal(fbs[0].array.cpu(), fbs[1].array), name
        for opts in ({}, {1000: 9000}):
            enc = [new_encoder(".jp2").encode(fb, opts) for fb in fbs]
            assert enc[0] == enc[1], (name, opts)
    t = torch.from_numpy(rgb)
    for kw in ({}, dict(reversible=False), dict(tile=(32, 32)),
               dict(reversible=False, rate=20.0)):
        assert encode_jp2(t.cuda(), **kw) == encode_jp2(t, **kw), kw


@pytest.mark.gpu
@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
def test_wavelet_on_card_equals_cpu(reversible):
    """No FMA contraction, no reciprocal division: the card's lifting
    and colour transforms are the CPU's bit for bit."""
    _need_card()
    from lilliput_tpu_torch.ops import wavelet as W
    rng = np.random.default_rng(5)
    for x0, y0, w, h in ((0, 0, 64, 48), (1, 0, 33, 17), (3, 5, 7, 1),
                         (0, 1, 1, 9), (2, 3, 130, 129)):
        rect = (x0, y0, x0 + w, y0 + h)
        x = torch.from_numpy(rng.integers(-2000, 2000, (4, h, w))
                             if reversible else rng.normal(0, 500, (4, h, w)))
        cpu = W.forward_dwt_level(x, rect, reversible)
        gpu = W.forward_dwt_level(x.cuda(), rect, reversible)
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())
        bands = [torch.from_numpy(rng.normal(0, 200, a.shape)
                                  if not reversible else
                                  rng.integers(-900, 900, a.shape))
                 for a in cpu]
        assert torch.equal(
            W.inverse_dwt_level(*bands, None, rect, reversible),
            W.inverse_dwt_level(*[b.cuda() for b in bands], None, rect,
                                reversible).cpu())
    args = [torch.from_numpy(rng.integers(-128, 128, (3, 50, 70))
                             if reversible else rng.normal(0, 90, (3, 50, 70)))
            for _ in range(3)]
    fns = (("forward_rct", "inverse_rct") if reversible
           else ("forward_ict", "inverse_ict"))
    for fn in fns:
        for a, b in zip(getattr(W, fn)(*args),
                        getattr(W, fn)(*[a.cuda() for a in args])):
            assert torch.equal(a, b.cpu()), fn


@pytest.mark.gpu
def test_webp_yuv420_emit_on_card_equals_cpu():
    """ops.color.webp_yuv420_from_packed on the card equals the CPU (atol
    0) over every u8 value, at odd sizes and over a leading batch axis;
    JpegTranscodePipeline(".webp")'s device step launches decode420 once
    and its planes equal the CPU step's."""
    _need_card()
    from lilliput_tpu_torch.ops import color as C
    rng = np.random.default_rng(16)
    sweep = np.zeros((2, 512), np.int32)
    for v in range(256):
        sweep[:, 2 * v:2 * v + 2] = v * 0x010101
    stacks = [sweep[None]] + [
        rng.integers(0, 1 << 24, (b, h, w)).astype(np.int32)
        for b, h, w in ((1, 1, 1), (1, 5, 7), (3, 33, 47), (2, 256, 256))]
    for packed in stacks:
        packed = torch.from_numpy(packed | np.int32(-16777216))
        for a, b in zip(C.webp_yuv420_from_packed(packed),
                        C.webp_yuv420_from_packed(packed.cuda())):
            assert torch.equal(a, b.cpu())
    with open(FIXTURE, "rb") as f:
        buf = f.read()
    card = JpegTranscodePipeline(buf, 96, 96, output_format=".webp")
    cpu = JpegTranscodePipeline(buf, 96, 96, output_format=".webp",
                                device="cpu")
    assert card._emit == "yuv420"
    args, _ = card._host_decode([buf] * 2)
    DK.reset_launches()
    got = card.device_step(*args)
    torch.cuda.synchronize()
    assert dict(DK.launches)["decode420"] == 1
    assert sum(dict(DK.launches).values()) == 1
    want = cpu.device_step(*cpu._host_decode([buf] * 2)[0])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_webp_composite_on_card_equals_cpu():
    """ops.palette.composite_animation_rgba and the batch's crop + resize
    on the card equal the CPU's (atol 0) over an animation axis with
    partial alpha, both blends and both disposals."""
    _need_card()
    from lilliput_tpu_torch import pipeline as TP
    from lilliput_tpu_torch.ops import palette as P
    rng = np.random.default_rng(8)
    n, h, w = 9, 37, 45
    frames = rng.integers(0, 256, (3, n, h, w, 4)).astype(np.uint8)
    frames[..., 3] = rng.choice([0, 77, 200, 255], (3, n, h, w))
    inputs = [torch.from_numpy(a) for a in (
        frames, rng.random((3, n, h, w)) < 0.7,
        rng.integers(0, 2, (3, n)).astype(np.int32),
        rng.integers(0, 2, (3, n)).astype(np.int32),
        rng.random((3, n, h, w)) < 0.5)]
    inputs[3][:, 0] = 0
    cpu = P.composite_animation_rgba(*inputs)
    gpu = P.composite_animation_rgba(*[a.cuda() for a in inputs])
    assert torch.equal(cpu, gpu.cpu())
    crop = TP.fit_rect(w, h, 16, 16)
    assert torch.equal(
        TP._webp_batch_to_pixels(*inputs, crop, 16, 16),
        TP._webp_batch_to_pixels(*[a.cuda() for a in inputs], crop, 16,
                                 16).cpu())
