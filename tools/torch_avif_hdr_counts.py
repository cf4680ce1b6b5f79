"""How far the port's HDR -> SDR tone map is from the JAX package's, on the
CPU: the u8 values that differ (and by how much) between the jitted JAX
functions and the port's torch ops on the inputs the CPU tests use.

    JAX_PLATFORMS=cpu python tools/torch_avif_hdr_counts.py

Prints one line per case:

* pq_to_linear and hlg_to_linear on 20,000 uniform f32 inputs (the f32
  values that differ and the largest relative difference);
* ops/color.hdr_to_sdr after yuv_to_rgb_norm, at the cases of
  tests/test_torch_color.py's test_hdr_to_sdr_within_the_tier;
* codecs/avif.hdr_planes_to_bgr against the JAX decoder's
  _decode_raw_hdr fed the same planes, at the cases of
  tests/test_torch_avif.py's test_hdr_device_half_equals_jax (needs
  ffmpeg's headers, for the JAX decoder's fixture);
* the two HDR stills of tests/test_torch_avif.py decoded by the port and
  by the JAX decoder given the colr box's transfer and primaries where
  the sequence header leaves them unspecified (needs ffmpeg).

The tests hold each at max 1 on at most 1e-3 of the values; this prints
the counts behind ROADMAP queue 3 entry 18.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def _line(what, got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    print(f"{what}: max_abs_diff={int(d.max())} "
          f"differing={int((d > 0).sum())}/{d.size}", flush=True)


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lilliput_tpu.ops import color as JC
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.ops import color as TC

    import torch

    import test_torch_color as TCC
    x = np.random.default_rng(3).random(20000, dtype=np.float32)
    for name in ("pq_to_linear", "hlg_to_linear"):
        want = np.asarray(jax.jit(getattr(JC, name))(x))
        got = getattr(TC, name)(torch.from_numpy(x)).numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        print(f"{name}: differing={int((got != want).sum())}/{x.size} "
              f"max_rel_diff={float(rel.max())!r}", flush=True)
    for depth, layout, full, space, prim, tr in TCC.HDR_CASES:
        y, u, v = TCC.hdr_planes(90, 121, depth, layout, depth + len(layout))
        kw = dict(space=space, full_range=full, depth=depth, out_h=90,
                  out_w=121)
        want = JC.hdr_to_sdr(JC.yuv_to_rgb_norm(y, u, v, **kw),
                             transfer=tr, primaries=prim)
        got = TC.hdr_to_sdr(TC.yuv_to_rgb_norm(
            *(TCC._t(p) for p in (y, u, v)), **kw), transfer=tr,
            primaries=prim)
        _line(f"hdr_to_sdr d{depth} {layout} "
              f"{'full' if full else 'limited'} {space} {prim} {tr}",
              got, want)
    if not os.path.exists(binding.AVFORMAT_HEADER):
        print("ffmpeg's headers are absent: the decoder cases are skipped")
        return 0
    from lilliput_tpu.codecs import avif as JA
    from lilliput_tpu_torch.codecs import avif as TA

    import test_torch_avif as TAV
    for depth, layout, full, matrix, prim, trc, cicp in TAV.DEVICE_HALF:
        rp, ap = TAV.raw_planes(depth, layout, full, matrix, prim, trc,
                                depth + trc)
        jd = JA.AvifDecoder(TAV.fixture("still_alpha_64x48.avif"))
        jd._w, jd._h, jd._cicp = 61, 45, cicp
        jd._next_planes = lambda rp=rp, ap=ap: (rp, ap)
        _line(f"hdr_planes_to_bgr d{depth} {layout} m{matrix} p{prim} "
              f"t{trc} cicp {cicp}",
              TA.hdr_planes_to_bgr(rp, ap, 45, 61, cicp, "cpu"),
              jd._decode_raw_hdr())
    for name, cicp in TAV.HDR_CICP.items():
        buf = TAV.hdr_still(cicp)
        _line(f"AvifDecoder HDR still colr {cicp} ({name})",
              TAV.decode_all("port", buf)[1][0], TAV.jax_hdr_from_box(buf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
