"""Batch serving from the command line: the port's counterpart of
``examples/serve_batch.py``, with the same flags, files and lines.

    python -m lilliput_tpu_torch.serve_batch IMG.jpg [IMG2.png ...] \
        -width 256 -height 256 [-quality 85] [-mode rgb|direct] \
        [-dct-scale 1|2|4] [-format jpeg|webp|png] [-sharded] [-warm] \
        [-outdir DIR] [-device cuda|cpu]

Routes mixed requests (JPEG, PNG/WebP/BMP/AVIF stills, animated GIF/WebP/
AVIF alike) through MultiGeometryPipeline, which groups them by signature
into per-signature pipelines and restores the input order, and writes
each output as <outdir>/<input name>.out.<format>. -sharded hands the
front a parallel.make_mesh() mesh (every card; with -device cpu a mesh
of CPU_MESH CPU entries), so JPEG signatures take ShardedJpegPipeline,
other stills ShardedStillPipeline and animated batches split their
animations over dp. -mode direct selects the YCbCr-domain transcode where
eligible (4:2:0, upright, even output dims), falling back per group;
-dct-scale 2 or 4 decodes it at half or quarter scale. -warm builds and
runs each input's pipeline once before the clock starts and prints the
warm report; the last line then gives the LRU's counters. -device is a
torch device, "cuda" by default: without a card it raises unless
-device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

#: the CPU entries of -sharded -device cpu's mesh (the JAX package's tests
#: force 8 host devices)
CPU_MESH = 8


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lilliput_tpu_torch.serve_batch")
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("-width", type=int, default=256)
    ap.add_argument("-height", type=int, default=256)
    ap.add_argument("-quality", type=int, default=85)
    ap.add_argument("-mode", choices=("rgb", "direct"), default="rgb")
    ap.add_argument("-dct-scale", type=int, choices=(1, 2, 4), default=1,
                    help="reduced decode (2=half, 4=quarter; needs -mode "
                         "direct)")
    ap.add_argument("-format", choices=("jpeg", "webp", "png"),
                    default="jpeg", help="output container")
    ap.add_argument("-sharded", action="store_true")
    ap.add_argument("-warm", action="store_true",
                    help="build and run each input's pipeline once before "
                         "timing")
    ap.add_argument("-outdir", default=".")
    ap.add_argument("-device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    import torch

    from .pipeline import MultiGeometryPipeline
    from .utils import resolve_device

    device = resolve_device(args.device)
    bufs = []
    for p in args.inputs:
        with open(p, "rb") as f:
            bufs.append(f.read())
    kw = dict(quality=args.quality, chroma_mode=args.mode,
              dct_scale=args.dct_scale, output_format="." + args.format)
    t0 = time.time()
    if args.sharded:
        from .parallel import make_mesh
        mesh = (make_mesh() if device.type == "cuda"
                else make_mesh(devices=[torch.device(device)] * CPU_MESH))
        pipe = MultiGeometryPipeline(args.width, args.height, mesh=mesh,
                                     **kw)
        outs = pipe.transcode(bufs)
        kind = f"sharded over {mesh.devices.size} device(s)"
    else:
        pipe = MultiGeometryPipeline(args.width, args.height, device=device,
                                     **kw)
        if args.warm:
            rep = pipe.warm(bufs)
            print(f"warmed {rep['warmed']} geometries "
                  f"({rep['compiled_new']} new) in {rep['seconds']} s")
            t0 = time.time()
        outs = pipe.transcode(bufs)
        kind = "multi-geometry"
        stats = pipe.stats()
        kind += (f", cache {stats['geometries_cached']}/"
                 f"{stats['max_geometries']} "
                 f"(hits {stats['hits']}, evictions {stats['evictions']})")
    dt = time.time() - t0

    os.makedirs(args.outdir, exist_ok=True)
    for path, out in zip(args.inputs, outs):
        dst = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0]
            + ".out." + args.format)
        with open(dst, "wb") as f:
            f.write(out)
        print(f"{path} -> {dst} ({len(out)} bytes)")
    print(f"{len(bufs)} image(s) in {dt * 1e3:.1f} ms "
          f"({kind}, mode={args.mode}, incl. compile)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
