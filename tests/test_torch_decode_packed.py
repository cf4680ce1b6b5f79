"""The port's 4:2:2, 4:4:0 and 4:4:4 decode (ops/decode_kernels decode422,
decode440, decode444 and jpeg_kernels.decode_ycc_packed/_planes) against
the JAX package's packed decode (jpeg_kernels.decode_ycc_packed, its Pallas
kernels decode422_packed, decode440_packed and decode444_packed in
interpret mode).

On the CPU each wrapper takes the plain PyTorch version
(decode_ycc_reference), which must equal the JAX kernels BIT FOR BIT
(atol 0) on both epilogues: at the odd geometries of test_megakernel.py
with per-image q30/85/95 tables, over the whole uncropped kernel output,
and at the 1080p fixtures' serving windows. Off-spec shapes return None,
as in JAX.

The CUDA kernels themselves are held against the plain version on the card
in tests/test_torch_gpu.py and chip_smoke.py phase 2.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lilliput_tpu import pipeline as JP
from lilliput_tpu.ops import jpeg_kernels as JK
from lilliput_tpu.ops import pallas_kernels as PK
from lilliput_tpu_torch import pipeline as TP
from lilliput_tpu_torch.ops import _build
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import entropy_kernels as E
from lilliput_tpu_torch.ops import jpeg_kernels as K

from _torch_parity import (CASES, LAYOUTS, bench_bytes, coefs, jax_packed,
                           qtables)

SUBS = ("422", "440", "444")
_JAX_KERNEL = {"422": PK.decode422_packed, "440": PK.decode440_packed,
               "444": PK.decode444_packed}


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _qt(qy, qc):
    return _t(qy.astype(np.float32), qc.astype(np.float32))


def _bgr(packed):
    """(..., 3) u8 B, G, R bytes of packed int32 pixels."""
    return np.asarray(packed).view(np.uint8).reshape(
        packed.shape + (4,))[..., :3]


def _assert_both_epilogues(yc, cb, cr, qy, qc, out_h, out_w, sub):
    """The port's packed and planes decode equal JAX's packed decode."""
    h2, v2 = LAYOUTS[sub]
    ref = jax_packed(yc, cb, cr, qy, qc, out_h, out_w, h2, v2)
    args = _t(yc, cb, cr) + _qt(qy, qc)
    got = K.decode_ycc_packed(*args, out_h, out_w, h2, v2)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    planes = K.decode_ycc_planes(*args, out_h, out_w, h2, v2)
    for k, p in enumerate(planes):
        assert p.dtype == torch.uint8 and p.shape == ref.shape
        np.testing.assert_array_equal(p.numpy(), _bgr(ref)[..., k])


@pytest.mark.parametrize("sub,h,w", [
    (sub, h, w) for sub in SUBS for h, w in CASES] + [
    # 4:2:2 chroma 18 x 15 and 35 x 29 blocks: across decode422's band
    # (17 MCU rows) and strip (14 MCUs) edges
    ("422", 143, 237), ("422", 279, 461),
    # 4:4:0 chroma 18 x 17 and 35 x 33 blocks: across decode440's band
    # (17 MCU rows) and strip (16 MCUs) edges
    ("440", 287, 133), ("440", 559, 261),
    # 4:4:4 chroma 18 x 17 and 35 x 33 blocks: across decode444's band
    # (16 MCU rows) and strip (16 MCUs) edges
    ("444", 143, 135), ("444", 279, 263)])
def test_packed_matches_jax(sub, h, w):
    rng = np.random.default_rng(h * 1000 + w + int(sub))
    yc, cb, cr = coefs(rng, h, w, sub)
    qy, qc = qtables()
    _assert_both_epilogues(yc, cb, cr, qy, qc, h, w, sub)
    # the whole uncropped kernel output (4:4:0's zero-padded luma row and
    # the ragged right edge included) against the JAX kernel's, which pads
    # further (even widths, whole tiles of rows) and is cut to ours
    h2, v2 = LAYOUTS[sub]
    args = _t(yc, cb, cr) + [K.fold_qtables(q) for q in _qt(qy, qc)]
    full = DK.decode_ycc_reference(*args, h2, v2, out="packed").numpy()
    ref = np.asarray(_JAX_KERNEL[sub](
        *(jnp.asarray(a.numpy()) for a in args), interpret=True))
    np.testing.assert_array_equal(full, ref[:, :full.shape[1],
                                            :full.shape[2]])


@pytest.mark.parametrize("sub", SUBS)
def test_bench_window_matches_jax(sub):
    """The 1080p fixture's window coefficients, as the serving path decodes
    them, with two images at different tables."""
    buf = bench_bytes(sub)
    pipe = TP.JpegTranscodePipeline(buf, 256, 256, device="cpu")
    yc, cb, cr, qy, qc = pipe.decode_entropy([buf])
    qy = np.concatenate([qy, qtables((30,))[0]])
    qc = np.concatenate([qc, qtables((30,))[1]])
    yc, cb, cr = (np.concatenate([a, a]) for a in (yc, cb, cr))
    x0, y0, rw, rh = pipe.window_static
    _assert_both_epilogues(yc, cb, cr, qy, qc, rh, rw, sub)


@pytest.mark.parametrize("sub", SUBS)
def test_serving_window_is_the_jax_pipelines(sub):
    """Both pipelines cut the same MCU window from each 1080p fixture
    (4:4:0 takes whole MCU rows of luma; the others do not)."""
    buf = bench_bytes(sub)
    jp = JP.JpegTranscodePipeline(buf, 256, 256)
    tp = TP.JpegTranscodePipeline(buf, 256, 256, device="cpu")
    assert tp.window_static == jp.window_static
    assert tp._window[4:] == jp._window[4:]
    want = {"444": (408, 0, 1104, 1080), "422": (400, 0, 1120, 1080),
            "440": (408, 0, 1104, 1080)}[sub]
    assert tp.window_static == want


@pytest.mark.parametrize("sub", SUBS)
def test_off_spec_shapes_return_none(sub):
    """The JAX shape gates: a coefficient stack of another layout, or Cb
    and Cr of different shapes, decode to None in both packages."""
    h2, v2 = LAYOUTS[sub]
    rng = np.random.default_rng(3)
    qy, qc = qtables((85,))
    for other in LAYOUTS:
        yc, cb, cr = coefs(rng, 40, 56, other, batch=1)
        args = _t(yc, cb, cr) + _qt(qy, qc)
        got = K.decode_ycc_packed(*args, 40, 56, h2, v2)
        if other == sub:
            assert got is not None and got.shape == (1, 40, 56)
            continue
        assert got is None
        assert K.decode_ycc_planes(*args, 40, 56, h2, v2) is None
        assert jax_packed(yc, cb, cr, qy, qc, 40, 56, h2, v2) is None
    yc, cb, cr = coefs(rng, 40, 56, sub, batch=1)
    args = _t(yc, cb, cr[:, :-1]) + _qt(qy, qc)
    assert K.decode_ycc_packed(*args, 40, 56, h2, v2) is None
    assert jax_packed(yc, cb, cr[:, :-1], qy, qc, 40, 56, h2, v2) is None


@pytest.mark.parametrize("sub", SUBS)
def test_wrapper_takes_plain_version_on_cpu(sub):
    h2, v2 = LAYOUTS[sub]
    rng = np.random.default_rng(5)
    yc, cb, cr = coefs(rng, 67, 61, sub)
    qy, qc = qtables()
    args = _t(yc, cb, cr) + [K.fold_qtables(q) for q in _qt(qy, qc)]
    fn = getattr(DK, DK.kernel_for(h2, v2))
    assert fn.__name__ == "decode" + sub
    DK.reset_launches()
    for out in ("planes", "packed"):
        got = fn(*args, out=out)
        ref = DK.decode_ycc_reference(*args, h2, v2, out=out)
        for g, r in zip(got if out == "planes" else [got],
                        ref if out == "planes" else [ref]):
            assert torch.equal(g, r)
    assert not any(DK.launches.values())


@pytest.mark.parametrize("sub", SUBS)
def test_wrapper_rejects_bad_inputs(sub):
    fn = getattr(DK, "decode" + sub)
    rng = np.random.default_rng(6)
    yc, cb, cr = coefs(rng, 32, 48, sub)
    qy, qc = qtables()
    args = _t(yc, cb, cr) + [K.fold_qtables(q) for q in _qt(qy, qc)]
    with pytest.raises(TypeError):
        fn(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        fn(args[0][:, :, :1], *args[1:])             # not the layout's luma
    with pytest.raises(ValueError):
        fn(args[0], args[1], args[2][:, :1], *args[3:])
    with pytest.raises(ValueError):
        fn(*args[:3], args[3][:1, :32], args[4])
    with pytest.raises(ValueError):
        fn(*args, out="rgb")
    assert not any(DK.launches.values())


def test_packed_to_planes_matches_jax():
    rng = np.random.default_rng(11)
    packed = rng.integers(-2**31, 2**31, (2, 9, 13), dtype=np.int64)
    packed = packed.astype(np.int32)
    got = K.packed_to_planes(torch.from_numpy(packed))
    ref = JK.packed_to_planes(jnp.asarray(packed))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _sources():
    return sorted(f for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))


def _entry_points(source):
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        return re.findall(r"^(?:int|const char\*) (lpt_\w+)\(", f.read(),
                          re.M)


def test_every_wrapper_has_a_kernel_source():
    """Every decode wrapper's library, and the split-path IDCT's, is built
    from a CUDA source that _LIBS names, and every CUDA source under csrc/
    is one of them or the entropy kernels' (ops/entropy_kernels.SOURCE): a
    source whose kernel moved is deleted."""
    libs = [lib for lib, _, _ in DK._KERNELS.values()] + [DK._IDCT_LIB]
    assert set(libs) == set(DK._LIBS)
    assert _sources() == sorted(list(DK._LIBS.values()) + [E.SOURCE])


@pytest.mark.parametrize("lib", sorted(DK._LIBS))
def test_kernel_source_defines_its_entry_points(lib):
    """The library's source under csrc/ defines lpt_<name> exactly once
    for each wrapper mapped to it (the IDCT also lpt_<name>_u8 and
    lpt_<name>_centered, its u8 and unshifted epilogues), and no lpt_decode* entry that _KERNELS
    maps elsewhere, beside one lpt_cuda_error_string; no other source
    under csrc/ defines those entries (a kernel moved to a source of its
    own must not leave a stale symbol behind). Read as text: no nvcc."""
    defined = _entry_points(DK._LIBS[lib])
    want = ["lpt_" + name for name, (lib_name, _, _) in DK._KERNELS.items()
            if lib_name == lib]
    if lib == DK._IDCT_LIB:
        want += ["lpt_dequant_idct_blocks", "lpt_dequant_idct_blocks_u8",
                 "lpt_dequant_idct_blocks_centered"]
    assert want
    for name in want + ["lpt_cuda_error_string"]:
        assert defined.count(name) == 1, (lib, name, defined)
    stale = [n for n in defined if n.startswith("lpt_decode")
             and n not in want]
    assert not stale, (lib, stale)
    for other in _sources():
        if other != DK._LIBS[lib]:
            assert not set(want) & set(_entry_points(other)), (lib, other)
