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
frame is within the kernel bound of its plain route (2-image stack)."""

import functools

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
    """Five batches of distinct images, one holding a corrupt buffer:
    transcode_pipelined (pinned output slots reused every other batch)
    equals transcode of each batch (chip_smoke.py phase 6 checks that it
    overlaps)."""
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
    assert len({o for b in got for o in b if isinstance(o, bytes)}) == 14


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
