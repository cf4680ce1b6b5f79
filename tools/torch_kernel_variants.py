"""Compare variants of one of the port's kernels on one CUDA card.

    python tools/torch_kernel_variants.py decode444 base= \\
        unroll8='#pragma unroll 4=>#pragma unroll' old=path/to/decode444.cu
    python tools/torch_kernel_variants.py dequant_idct_blocks base= \\
        old=path/to/earlier/idct_blocks.cu

Each argument after the kernel name is NAME=SPEC. An empty SPEC is the
kernel's source as committed (``lilliput_tpu_torch/csrc``); ``OLD=>NEW``
is that source with its one occurrence of OLD replaced by NEW (``\\n`` in
either stands for a newline; several edits are joined by ``;;``); any
other SPEC is the path of a source file. For each variant the script

1. builds it with nvcc as ``ops/_build.build_cuda`` builds the kernels (all
   variants at once) and prints what ptxas says of registers and spills;
2. holds it against the plain version at the kernel's fixture (x128),
   ``chip_smoke.CASES`` and the kernel's edge geometries from
   ``chip_smoke``, and prints the count of differing values:

   * a decode kernel: both epilogues against ``decode_ycc_reference``;
   * ``dequant_idct_blocks``: the f32 epilogue within chip_smoke's u8
     bound of the plain version, the u8 epilogue against the rounded f32
     output, and the f32 output bit for bit against the first variant's.
     A source without ``lpt_dequant_idct_blocks_u8`` (an earlier design)
     runs its f32 epilogue only;
3. times both epilogues at the fixture (CUDA events, 20 launches after a
   warm-up), in turns: every variant in order, then in reverse.

Prints the card's name and power limit first. Needs a card, imports no
JAX; exits 1 if a variant fails a check of step 2.
"""

from __future__ import annotations

import ctypes
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
#: dequant_idct_blocks' C entries, f32 and u8 (coefs, wq, out, batch, bh,
#: bw, wq_batched, stream)
IDCT_ENTRIES = ("lpt_dequant_idct_blocks", "lpt_dequant_idct_blocks_u8")


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


def load_idct(path: str):
    """The IDCT library at `path` with argtypes set on the entries it
    defines; returns (library, whether it has the u8 epilogue)."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    has = [hasattr(lib, e) for e in IDCT_ENTRIES]
    for entry in (e for e, h in zip(IDCT_ENTRIES, has) if h):
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    lib.lpt_cuda_error_string.argtypes = [ci]
    lib.lpt_cuda_error_string.restype = ctypes.c_char_p
    return lib, has[1]


def check_idct(libs, use, has_u8, serving) -> int:
    """Step 2 for dequant_idct_blocks; returns the count of variants that
    fail it."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    first, bad = None, 0
    for v in libs:
        use(v)
        inputs = [("fixture", serving)] + S.idct_inputs(
            np.random.default_rng(5))
        outs, plain_bad, u8_differing, first_differing = [], 0, 0, 0
        for i, (_, args) in enumerate(inputs):
            got = DK.dequant_idct_blocks(*args)
            mx, nd, n = S.diff_stats([S._u8(got)],
                                     [S._u8(S.plain_idct(*args))])
            plain_bad += not (mx <= S.KERNEL_MAX_DIFF
                              and nd <= S.KERNEL_MAX_SHARE * n)
            if has_u8[v]:
                u8_differing += S.diff_stats(
                    [DK.dequant_idct_blocks(*args, out="u8")],
                    [S._u8(got)])[1]
            if first is None:
                outs.append(got)
            else:
                first_differing += int((got.view(torch.int32) != first[
                    i].view(torch.int32)).sum())
        first = outs if first is None else first
        print(f"{v}: over {len(inputs)} inputs: f32 outside the u8 bound "
              f"of the plain version on {plain_bad}; u8 epilogue values "
              f"differing from the rounded f32: "
              f"{u8_differing if has_u8[v] else 'no u8 epilogue'}; f32 "
              f"values differing bit for bit from {next(iter(libs))}: "
              f"{first_differing}", flush=True)
        bad += plain_bad > 0 or u8_differing > 0 or first_differing > 0
    return bad


def check_decode(name, libs, use, serving) -> int:
    """Step 2 for a decode kernel; returns the count of variants that
    differ from the plain version anywhere."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    _, h2, v2 = DK._KERNELS[name]
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
    return bad


def main(argv) -> int:
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    from lilliput_tpu_torch.ops import _build
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K

    name, specs = argv[0], dict(a.split("=", 1) for a in argv[1:])
    S.check(torch.cuda.is_available(), "no CUDA device")
    print("card:", S.card_line(), flush=True)
    idct = name == S.IDCT
    lib = DK._IDCT_LIB if idct else DK._KERNELS[name][0]
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
    has_u8 = dict.fromkeys(libs, True)
    if idct:   # loaded here: _load wants both entries, an earlier source
        for v in libs:   # has only the f32 one
            DK._libs[libs[v]], has_u8[v] = load_idct(paths[v])

    def use(v):
        if idct:
            DK._IDCT_LIB = libs[v]
        else:
            DK._KERNELS[name] = (libs[v],) + DK._KERNELS[name][1:]
            DK._load(libs[v])

    fixture_name = next(p.fixture for p in S.PATHS.values()
                        if p.kernel == name)
    with open(os.path.join(S.ASSETS, fixture_name), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, S.DST, S.DST, device="cuda")
    arrays = pipe.decode_entropy([fixture] * S.BATCH)
    ncoef = (len(arrays) + 1) // 2      # (ys, qty) or 3 planes + 2 tables
    serving = tuple(torch.from_numpy(a).cuda() for a in arrays[:ncoef])
    serving += tuple(K.fold_qtables(torch.from_numpy(
        q.astype(np.float32)).cuda()) for q in arrays[ncoef:])
    if idct:
        bad = check_idct(libs, use, has_u8, serving)
        runs = {"u8": lambda: DK.dequant_idct_blocks(*serving, out="u8"),
                "f32": lambda: DK.dequant_idct_blocks(*serving)}
    else:
        bad = check_decode(name, libs, use, serving)
        kernel = getattr(DK, name)
        runs = {"planes": lambda: kernel(*serving),
                "packed": lambda: kernel(*serving, out="packed")}
    times = {v: {out: [] for out in runs} for v in libs}
    for v in list(libs) + list(libs)[::-1]:
        use(v)
        for out, fn in runs.items():
            if out != "u8" or has_u8[v]:
                times[v][out].append(S.cuda_ms(fn, 20))
    for v, ts in times.items():
        print(f"{v}: " + " ".join(f"{out} ms {t}" for out, t in ts.items()),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
