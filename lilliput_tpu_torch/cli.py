"""The port's command line: read a file, decode, print its metadata,
transform, write the result. The counterpart of ``examples/main.py`` (the
reference's examples/main.go:21-148), with its flags and output lines::

    python -m lilliput_tpu_torch -input in.png -output out.jpg \\
        -width 256 -height 256 [-stretch] [-disable-animated-output] \\
        [-max-encode-frames N] [-max-encode-duration SECONDS] \\
        [-force-sdr] [-quality Q] [-device cuda|cpu] [-stats]

The frames live on ``-device``: "cuda" unless it asks for the CPU. Every
output is examples/main.py's bytes, ``.jpg`` too, which its encode map
makes progressive (see the encode options below).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import ImageOps, ImageOptions, ResizeMethod, new_decoder
from .framebuffer import (AVIF_QUALITY, AVIF_SPEED, JPEG_QUALITY,
                          PNG_COMPRESSION, WEBP_QUALITY)
from .utils import metrics


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m lilliput_tpu_torch")
    p.add_argument("-input", required=True)
    p.add_argument("-output", default="")
    p.add_argument("-width", type=int, default=0)
    p.add_argument("-height", type=int, default=0)
    p.add_argument("-stretch", action="store_true")
    p.add_argument("-disable-animated-output", dest="disable_anim",
                   action="store_true")
    p.add_argument("-max-encode-frames", type=int, default=0)
    p.add_argument("-max-encode-duration", type=float, default=0.0)
    p.add_argument("-force-sdr", dest="force_sdr", action="store_true")
    p.add_argument("-quality", type=int, default=85)
    p.add_argument("-device", default="cuda",
                   help="torch device of the frames (cuda|cpu)")
    p.add_argument("-stats", action="store_true",
                   help="print per-stage p50/p99 timings after the transform")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        with open(args.input, "rb") as f:
            buf = f.read()
    except OSError as e:
        print(f"failed to read input file: {e}", file=sys.stderr)
        return 1
    try:
        dec = new_decoder(buf, device=args.device)
        header = dec.header()
    except Exception as e:
        print(f"error decoding image: {e}", file=sys.stderr)
        return 1

    print(f"file type: {dec.description()}")
    print(f"{header.width}x{header.height}, {header.channels}ch, "
          f"{header.num_frames} frame(s), orientation "
          f"{int(header.orientation)}")
    if dec.duration():
        print(f"duration: {dec.duration():.2f} s")
    if not args.output:
        return 0

    if args.stretch:
        method = ResizeMethod.RESIZE
    elif args.width and args.height:
        method = ResizeMethod.FIT
    else:
        method = ResizeMethod.NO_RESIZE
    ext = (os.path.splitext(args.output)[1]
           or "." + dec.description().lower())
    opts = ImageOptions(
        file_type=ext,
        width=args.width,
        height=args.height,
        resize_method=method,
        normalize_orientation=True,
        # the example's defaults (examples/main.go:14-19); AVIF_SPEED's
        # key (2) is also JPEG_PROGRESSIVE's, so .jpg output is
        # progressive, as examples/main.py's is
        encode_options={
            JPEG_QUALITY: args.quality,
            PNG_COMPRESSION: 7,
            WEBP_QUALITY: args.quality,
            AVIF_QUALITY: args.quality,
            AVIF_SPEED: 10,
        },
        max_encode_frames=args.max_encode_frames,
        max_encode_duration=args.max_encode_duration,
        encode_timeout=300.0,
        disable_animated_output=args.disable_anim,
        force_sdr=args.force_sdr,
    )
    t0 = time.time()
    out = ImageOps(8192).transform(dec, opts)
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(out)
    print(f"transformed in {dt * 1000:.1f} ms -> {args.output} "
          f"({len(out)} bytes)")
    if args.stats:
        print(json.dumps(metrics.snapshot(), indent=2))
    return 0
