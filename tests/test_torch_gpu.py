"""The port on a CUDA card: the decode kernel against its plain PyTorch
version, and the serving device step against the same step through the
plain version and on the CPU. Imports no jax, so it runs on the card's
machine:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernel has no CPU mode).

Tolerances: the kernel's 64-term IDCT sums run in k order with fmaf, the
plain version's in cuBLAS's order, so a u8 value may move by 1 where a sum
lands next to a .5 tie: max 1 on at most 1e-4 of the values. The device
step then allows max 1 on at most 1e-3 of the quantized coefficients
(a moved pixel shifts the resized value by a fraction, which can flip a
coefficient rounding)."""

import numpy as np
import pytest
import torch

from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
from lilliput_tpu_torch.ops import decode_kernels as DK
from lilliput_tpu_torch.ops import jpeg_kernels as K

CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129),
         (1088, 1120)]
FIXTURE = "tests/assets/bench_1080p.jpg"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _diff(got, ref):
    """(max |got - ref|, differing values, values) over pairs of arrays."""
    ds = [(g.to(torch.int32) - r.to(torch.int32)).abs().flatten()
          for g, r in zip(got, ref)]
    d = torch.cat(ds)
    return int(d.max()), int((d > 0).sum()), d.numel()


def _args(h, w, batch=3):
    rng = np.random.default_rng(h * 1000 + w)

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    coefs = [rng.integers(-lim, lim, (batch, bl(h, f), bl(w, f), 64))
             for lim, f in ((300, 1), (200, 2), (200, 2))]
    qs = [scaled_qtables(q) for q in (30, 85, 95)][:batch]
    tabs = [np.stack([q[i] for q in qs]).astype(np.float32) for i in (0, 1)]
    return tuple(torch.from_numpy(c.astype(np.int16)).cuda()
                 for c in coefs) + tuple(
        K.fold_qtables(torch.from_numpy(t).cuda()) for t in tabs)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", CASES)
def test_kernel_matches_plain(h, w):
    _need_card()
    args = _args(h, w)
    before = DK.launches
    got = DK.decode420(*args)
    ref = DK.decode420_reference(*args)
    mx, nd, n = _diff(got, ref)
    assert mx <= 1 and nd <= 1e-4 * n
    got = DK.decode420(*args, out="packed")
    ref = DK.decode420_reference(*args, out="packed")
    mx, nd, n = _diff([(got >> s) & 255 for s in (0, 8, 16, 24)],
                      [(ref >> s) & 255 for s in (0, 8, 16, 24)])
    assert mx <= 1 and nd <= 1e-4 * n
    assert DK.launches == before + 2


@pytest.mark.gpu
def test_device_step_matches_plain_and_cpu():
    _need_card()
    with open(FIXTURE, "rb") as f:
        buf = f.read()
    gpu = JpegTranscodePipeline(buf, 256, 256, device="cuda")
    cpu = JpegTranscodePipeline(buf, 256, 256, device="cpu")
    args = gpu.decode_entropy([buf] * 4)
    before = DK.launches
    step = [t.cpu() for t in gpu.device_step(*args)]
    assert DK.launches == before + 1
    plain = [t.cpu() for t in gpu.device_step(*args, plain=True)]
    host = list(cpu.device_step(*args))
    for ref in (plain, host):
        mx, nd, n = _diff(step, ref)
        assert mx <= 1 and nd <= 1e-3 * n
    outs = gpu.transcode([buf] * 2)
    assert outs[0] == outs[1] and outs[0][:2] == b"\xff\xd8"
