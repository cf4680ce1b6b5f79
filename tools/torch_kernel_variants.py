"""Compare variants of one of the port's decode kernels on one CUDA card.

    python tools/torch_kernel_variants.py decode444 base= \\
        unroll8='#pragma unroll 4=>#pragma unroll' old=path/to/decode444.cu

Each argument after the kernel name is NAME=SPEC. An empty SPEC is the
kernel's source as committed (``lilliput_tpu_torch/csrc``); ``OLD=>NEW``
is that source with its one occurrence of OLD replaced by NEW (``\\n`` in
either stands for a newline; several edits are joined by ``;;``); any
other SPEC is the path of a source file. For each variant the script

1. builds it with nvcc as ``ops/_build.build_cuda`` builds the kernels (all
   variants at once) and prints what ptxas says of registers and spills;
2. holds it against the plain version (``decode_ycc_reference``) at the
   kernel's fixture window x128, ``chip_smoke.CASES`` and the kernel's edge
   geometries from ``chip_smoke``, both epilogues, and prints the count of
   differing values;
3. times both epilogues at the fixture window (CUDA events, 20 launches
   after a warm-up), in turns: every variant in order, then in reverse.

Prints the card's name and power limit first. Needs a card, imports no
JAX; exits 1 if a variant differs from the plain version anywhere.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402

#: kernel -> the geometries of chip_smoke phase 2 at its band/strip edges
EDGES = {"decode420": S.EDGE_420, "decode422": S.EDGE_422,
         "decode440": S.EDGE_440, "decode444": S.EDGE_444}


def variant_source(spec: str, base: str, out: str) -> str:
    """Path of the source a SPEC names (see the module docstring)."""
    if not spec:
        return base
    if "=>" not in spec:
        return os.path.abspath(spec)
    with open(base) as f:
        text = f.read()
    for edit in spec.split(";;"):
        old, new = (s.replace("\\n", "\n") for s in edit.split("=>", 1))
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} occurs {text.count(old)} times in "
                             f"{base}, not once")
        text = text.replace(old, new)
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv) -> int:
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    from lilliput_tpu_torch.ops import _build
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K

    name, specs = argv[0], dict(a.split("=", 1) for a in argv[1:])
    S.check(torch.cuda.is_available(), "no CUDA device")
    print("card:", S.card_line(), flush=True)
    lib, h2, v2 = DK._KERNELS[name]
    base = os.path.join(_build.CSRC_DIR, DK._LIBS[lib])
    vdir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    libs = {}
    for v, spec in specs.items():
        libs[v] = f"{lib}_{v}"
        DK._LIBS[libs[v]] = variant_source(
            spec, base, os.path.join(vdir, f"{name}_{v}.cu"))
    with ThreadPoolExecutor(len(libs)) as ex:
        paths = dict(zip(libs, ex.map(lambda v: _build.build_cuda(
            libs[v], (DK._LIBS[libs[v]],)), libs)))
    for v, path in paths.items():
        for ln in _build.build_log(path).splitlines():
            if ("registers" in ln or "spill" in ln
                    or "Function properties" in ln):
                print(f"{v}: {ln.strip()}", flush=True)

    def use(v):
        DK._KERNELS[name] = (libs[v], h2, v2)
        DK._load(libs[v])

    fixture_name = next(f for f, k, _ in S.PATHS.values() if k == name)
    with open(os.path.join(S.ASSETS, fixture_name), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, S.DST, S.DST, device="cuda")
    ys, cbs, crs, qty, qtc = pipe.decode_entropy([fixture] * S.BATCH)
    serving = tuple(torch.from_numpy(a).cuda() for a in (ys, cbs, crs))
    serving += tuple(K.fold_qtables(torch.from_numpy(
        q.astype(np.float32)).cuda()) for q in (qty, qtc))
    kernel = getattr(DK, name)
    bad = 0
    for v in libs:
        use(v)
        rng = np.random.default_rng(5)
        inputs = [serving] + [S.random_case(rng, h, w, h2, v2)
                              for h, w in S.CASES] + [
            S.random_case(rng, 8 * (1 + v2) * ch - 1, 8 * (1 + h2) * cw - 3,
                          h2, v2, batch=1 + 2 * (i % 2))
            for i, (ch, cw) in enumerate(EDGES.get(name, []))]
        differing = 0
        for args in inputs:
            for out in ("planes", "packed"):
                got = kernel(*args, out=out)
                differing += S.diff_stats(
                    got, S.plain_decode(args, h2, v2, out))[1]
        print(f"{v}: differing values over {len(inputs)} inputs x 2 "
              f"epilogues: {differing}", flush=True)
        bad += differing > 0
    times = {v: [] for v in libs}
    for v in list(libs) + list(libs)[::-1]:
        use(v)
        times[v].append((S.cuda_ms(lambda: kernel(*serving), 20),
                         S.cuda_ms(lambda: kernel(*serving, out="packed"),
                                   20)))
    for v, ts in times.items():
        print(f"{v}: planes ms {[t[0] for t in ts]} packed ms "
              f"{[t[1] for t in ts]}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
