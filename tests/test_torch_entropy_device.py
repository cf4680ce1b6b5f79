"""The device entropy route of JpegTranscodePipeline.decode_entropy on the
CPU: csrc/host/jpeg_scan.cpp's preparation and the plain version of the
huffman_decode kernels (ops/entropy_kernels.huffman_decode_plain), which
runs the kernels' phases (sync, scan, write, DC) in NumPy.

Held against the host decoder (jpeg_huff.cpp's lp_jpeg_decode_coefs_win)
coefficient for coefficient: every chroma layout and grayscale, no restart
interval, one MCU row and an odd one, whole frames (orientation 6) and the
upright decode window, qualities 50-100 with optimize_coding tables, and
subsequences as short as 32 bits (long sync chains). Streams the route
does not take (progressive, arithmetic, malformed headers) decline to the
host route exactly where lp_jpeg_decode_coefs_win declines; truncated and
bit-flipped scans are flagged exactly where it fails. The serving front
with the route on: the bytes of the host route, the decode span's
device_entropy and host_entropy counts and serving.device_entropy_redo.
"""

import ctypes

import cv2
import numpy as np
import pytest
import torch

from lilliput_tpu_torch import binding
from lilliput_tpu_torch.codecs import jpeg as J
from lilliput_tpu_torch.ops import entropy_kernels as E
from lilliput_tpu_torch.parallel.serving import ShardedJpegPipeline
from lilliput_tpu_torch.pipeline import JpegTranscodePipeline
from lilliput_tpu_torch.utils import StageTimer, metrics

from _torch_parity import with_orientation

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "gray": None}
#: (quality, optimize_coding) of each source of a batch
SOURCES = ((50, True), (85, False), (100, True))


def _picture(seed: int, w: int, h: int, gray: bool) -> np.ndarray:
    """A smooth colour field with noise: edges, gradients and texture."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3),
                                   dtype=np.uint8), (w, h),
                      interpolation=cv2.INTER_CUBIC)
    img = cv2.add(base, rng.integers(0, 48, (h, w, 3), dtype=np.uint8))
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def _jpeg(seed: int, layout: str, quality: int, optimize: bool,
          dri=None, w: int = 120, h: int = 90, progressive=False) -> bytes:
    """A JPEG of _picture by cv2 (libjpeg): layout, quality, optimal
    Huffman tables, a restart interval in MCUs ("row": one MCU row),
    baseline unless progressive."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if SAMPLING[layout] is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout]]
    if dri == "row":
        mcu_w = 8 if layout in ("444", "440", "gray") else 16
        dri = -(-w // mcu_w)
    if dri is not None:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, dri]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, enc = cv2.imencode(".jpg", _picture(seed, w, h, layout == "gray"),
                           params)
    assert ok
    return enc.tobytes()


def _pipe(buf: bytes, dst=48) -> JpegTranscodePipeline:
    return JpegTranscodePipeline(buf, dst, dst, device="cpu")


@pytest.fixture
def subseq_bits(request, monkeypatch):
    monkeypatch.setattr(E, "SUBSEQ_BITS", request.param)
    return request.param


#: (restart interval, EXIF orientation, subsequence bits) of each case of
#: a layout: no interval, one MCU row and an odd one; the decode window
#: (orientation 1) and whole frames (6); 32-bit subsequences (long sync
#: chains, bounded by the segments) and the kernel's size
DECODES = [(None, 1, 1024), ("row", 6, 32), (7, 1, 32), (None, 6, 1024)]


@pytest.mark.parametrize("dri,orientation,subseq_bits", DECODES,
                         indirect=["subseq_bits"])
@pytest.mark.parametrize("layout", list(SAMPLING))
def test_plain_decoder_equals_host_decoder(layout, dri, orientation,
                                           subseq_bits):
    """decode_entropy's device route (the plain version on the CPU) gives
    the host route's arrays bit for bit, with no stream flagged: upright
    sources in the decode window (narrower than the frame), orientation 6
    whole."""
    bufs = [_jpeg(7 * i + len(layout), layout, q, opt, dri, w=160, h=64)
            for i, (q, opt) in enumerate(SOURCES)]
    if orientation != 1:
        bufs = [with_orientation(b, orientation) for b in bufs]
    pipe = _pipe(bufs[0], dst=32)
    if orientation == 1:
        assert pipe._lane_shapes()[0][1] < pipe.geom.blocks[0][1]
    else:
        assert pipe.window_static is None
    host = pipe.decode_entropy(bufs)
    dev = pipe.decode_entropy(bufs, device="cpu")
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert d.dtype == torch.from_numpy(h).dtype
        assert tuple(d.shape) == h.shape
        np.testing.assert_array_equal(d.numpy(), h)
    status, _ = pipe._entropy_check()
    assert not status.any()


def _host_rc(buf: bytes, pipe: JpegTranscodePipeline) -> int:
    """lp_jpeg_decode_coefs_win's return on buf, into whole frames."""
    lib = binding.load()
    arr = np.frombuffer(buf, np.uint8)
    lane = [np.zeros(sh + (64,), np.int16) for sh in pipe._lane_shapes()]
    p16 = ctypes.POINTER(ctypes.c_int16)
    ptrs = (p16 * len(lane))(*[a.ctypes.data_as(p16) for a in lane])
    qt = np.zeros((4, 64), np.uint16)
    return lib.lp_jpeg_decode_coefs_win(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size, ptrs,
        qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 1, None)


def _prepare(buf: bytes, pipe: JpegTranscodePipeline):
    geom = pipe._scan_geom
    scan = np.zeros(E.scan_capacity(len(buf), geom.nmcu), np.uint8)
    return E.prepare_stream(
        binding.load(), np.frombuffer(buf, np.uint8), scan,
        np.zeros((geom.nmcu, 2), np.int32),
        np.zeros((2 * pipe.ncomp, E.TABLE_BYTES), np.uint8),
        np.zeros((4, 64), np.uint16), None)


def _sof_to(buf: bytes, marker: int) -> bytes:
    i = buf.index(b"\xff\xc0")
    return buf[:i + 1] + bytes([marker]) + buf[i + 2:]


def _drop_segment(buf: bytes, marker: int) -> bytes:
    i = buf.index(bytes([0xFF, marker]))
    n = int.from_bytes(buf[i + 2:i + 4], "big")
    return buf[:i] + buf[i + 2 + n:]


def _twelve_bit(buf: bytes) -> bytes:
    i = buf.index(b"\xff\xc0")
    return buf[:i + 4] + b"\x0c" + buf[i + 5:]


@pytest.mark.parametrize("make,host_declines", [
    (lambda b: _jpeg(3, "420", 85, False, progressive=True), False),
    (lambda b: _sof_to(b, 0xC9), True),       # arithmetic coding
    (lambda b: _sof_to(b, 0xC3), True),       # lossless
    (lambda b: _twelve_bit(b), True),
    (lambda b: _drop_segment(b, 0xC4), True),  # no Huffman tables
    (lambda b: _drop_segment(b, 0xDB), True),  # no quantization tables
    (lambda b: b[:-2], True),                  # no EOI
    (lambda b: b[:-2] + b"\xff\xdc\x00\x04\x00\x5a\xff\xd9", True),  # DNL
])
def test_declined_streams_take_the_host_route(make, host_declines):
    """jpeg_scan.cpp declines progressive streams (which jpeg_huff.cpp
    decodes on the host) and exactly the streams lp_jpeg_decode_coefs_win
    declines before its decode; in a batch they take the host route
    (the decode span's host_entropy) with the host route's arrays."""
    good = _jpeg(3, "420", 85, False)
    buf = make(good)
    pipe = _pipe(good)
    assert _prepare(buf, pipe) is None
    assert (_host_rc(buf, pipe) == -10) == host_declines
    if not host_declines:
        errors_h, errors_d = {}, {}
        host = pipe.decode_entropy([good, buf], errors=errors_h)
        with StageTimer("decode") as span:
            dev = pipe.decode_entropy([good, buf], errors=errors_d,
                                      device="cpu")
        assert not errors_h and not errors_d
        for h, d in zip(host, dev):
            np.testing.assert_array_equal(d.numpy(), h)
        assert span.counts == {"device_entropy": 1, "host_entropy": 1,
                               "workers": 2, "worker_wall_ns":
                               span.counts["worker_wall_ns"],
                               "worker_cpu_ns": span.counts["worker_cpu_ns"]}


def _damaged(seed: int):
    """Truncated scans (cut and closed with EOI) and bit-flipped scans of
    a 4:2:0 stream with a restart interval and of one without, at EXIF
    orientation 6 (whole frames: the host decoder's own layout)."""
    rng = np.random.default_rng(seed)
    out = []
    for dri in (None, 3):
        good = _jpeg(11 + seed, "420", 75, False, dri)
        sos = good.index(b"\xff\xda")
        start = sos + 2 + int.from_bytes(good[sos + 2:sos + 4], "big")
        for cut in rng.integers(start + 1, len(good) - 2, 3):
            out.append(good[:cut] + b"\xff\xd9")
        for _ in range(4):
            b = bytearray(good)
            for pos in rng.integers(start, len(good) - 2, 2):
                b[pos] ^= 1 << int(rng.integers(8))
            out.append(bytes(b))
    return [with_orientation(b, 6) for b in out]


@pytest.mark.parametrize("subseq_bits", [32, 256], indirect=True)
@pytest.mark.parametrize("seed", range(3))
def test_damaged_scans_flagged_where_host_fails(seed, subseq_bits):
    """Each damaged stream is declined where lp_jpeg_decode_coefs_win
    declines it, flagged in the status word where its decode fails, and
    decoded to its arrays bit for bit where it succeeds."""
    bufs = _damaged(seed)
    pipe = _pipe(with_orientation(_jpeg(11 + seed, "420", 75, False), 6))
    dev = pipe.decode_entropy(bufs, device="cpu")
    status = pipe._entropy_check()[0].numpy()
    flagged = declined = 0
    for i, buf in enumerate(bufs):
        rc = _host_rc(buf, pipe)
        if _prepare(buf, pipe) is None:
            assert rc == -10
            declined += 1
            continue
        assert bool(status[i]) == (rc != 0), (i, rc)
        flagged += rc != 0
        if rc == 0:
            host = pipe.decode_entropy([buf])
            for h, d in zip(host, dev):
                np.testing.assert_array_equal(d[i].numpy(), h[0])
    assert flagged  # the damage reached the decode


def test_front_counts_and_redo(monkeypatch):
    """transcode and transcode_pipelined with the device route on (the
    plain version on the CPU) give the host route's bytes and errors: a
    progressive source decodes on the host (host_entropy), a damaged scan
    is flagged and transcoded again alone on the host
    (serving.device_entropy_redo), a broken header fails in its slot.
    The decode span's device_entropy + host_entropy + failures = images."""
    good = [with_orientation(_jpeg(20 + i, "420", 75, i % 2 == 0), 6)
            for i in range(3)]
    prog = with_orientation(_jpeg(30, "420", 75, False, progressive=True),
                            6)
    pipe = _pipe(good[0])
    bad = [b for b in _damaged(1) if _prepare(b, pipe) is not None
           and _host_rc(b, pipe) not in (0, -10)][:1]
    assert bad
    bufs = good + [prog] + bad + [b"\xff\xd8\xff\xe0 not a jpeg"]
    ref = pipe.transcode(bufs, return_exceptions=True)
    monkeypatch.setattr(JpegTranscodePipeline, "_entropy_device",
                        lambda self: torch.device("cpu"))
    metrics.reset()
    got = pipe.transcode(bufs, return_exceptions=True)
    piped = pipe.transcode_pipelined([bufs, bufs[::-1]],
                                     return_exceptions=True)
    for out in (got, piped[0], piped[1][::-1]):
        for r, o in zip(ref, out):
            if isinstance(r, Exception):
                assert type(o) is type(r)
            else:
                assert o == r
    assert metrics.snapshot()["counters"]["serving.device_entropy_redo"] == 3
    decodes = [s for s in metrics.spans().records if s.name == "decode"]
    assert len(decodes) == 3
    for s in decodes:
        assert s.counts["device_entropy"] == 4
        assert s.counts["host_entropy"] == 1
        assert s.counts["images"] == 6


def test_route_choice():
    """The serving fronts take the device route only on one CUDA device
    at dct_scale 1: not on the CPU, not at dct_scale 2, never on a mesh."""
    buf = _jpeg(5, "420", 85, False, w=256, h=192)
    pipe = _pipe(buf)
    assert pipe._entropy_device() is None
    pipe.device = torch.device("cuda")
    assert pipe._entropy_device() == torch.device("cuda")
    scaled = JpegTranscodePipeline(buf, 48, 48, chroma_mode="direct",
                                   dct_scale=2, device="cpu")
    scaled.device = torch.device("cuda")
    assert scaled._entropy_device() is None
    assert ShardedJpegPipeline._device_entropy is False
    with pytest.raises(ValueError):
        JpegTranscodePipeline(buf, 48, 48, chroma_mode="direct",
                              dct_scale=2, device="cpu").decode_entropy(
            [buf], device="cpu")


def test_segment_table_and_capacity(monkeypatch):
    """The segment table: word offsets, bits, blocks and subsequences of
    each restart segment; a stream's capacity holds its padded segments."""
    buf = _jpeg(9, "420", 90, False, dri=7)
    pipe = _pipe(buf)
    geom = pipe._scan_geom
    row = _prepare(buf, pipe)
    assert row is not None
    nseg, ri = int(row[1]), int(row[2])
    assert ri == 7 and nseg == -(-geom.nmcu // 7)
    assert row[0] <= E.scan_capacity(len(buf), geom.nmcu)
    segs = np.array([[0, 10], [12, 3]], np.int32)
    monkeypatch.setattr(E, "SUBSEQ_BITS", 32)
    t = E.segment_table(geom, [64], [(segs, 7)])
    assert t.subseq_bits == 32
    np.testing.assert_array_equal(t.seg[:, 0], [16, 19])
    np.testing.assert_array_equal(t.seg[:, 1], [80, 24])
    np.testing.assert_array_equal(t.seg[:, 3], [0, 7 * geom.bpm])
    np.testing.assert_array_equal(t.seg[:, 6], [3, 1])
    np.testing.assert_array_equal(t.sub_start, [0, 3, 4])
    np.testing.assert_array_equal(t.img_ri, [7])
