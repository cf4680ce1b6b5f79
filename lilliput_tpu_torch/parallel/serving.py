"""Multi-device serving fronts: the JPEG and still batch transcodes over a
device mesh (the counterpart of ``lilliput_tpu/parallel/serving.py``).

    mesh = make_mesh()                       # every visible card
    pipe = ShardedJpegPipeline(sample, 256, 256, mesh=mesh)
    outs = pipe.transcode(list_of_jpeg_bytes)

dp: the batch pads to a multiple of dp by repeating its last image; each
dp slot copies its contiguous slice of the pinned host batch to its device
and runs the one-device step there (the layout's decode kernel, then the
tail) on its own stream, every slot issued from one host thread with no
host sync between them; _fetch copies each slot's real rows into its rows
of one pinned host array and drops the padding's. The bytes equal the
one-device pipeline's: requests never split.

sp (a mesh shaped (dp, sp), sp > 1): each image of a dp slot splits its
rows over the sp slots of the slot's group, on the upright AREA routes:
the 4:2:0 block tail, the packed tail of 4:2:2, 4:4:0 and 4:4:4,
grayscale, and the still front's upright AREA tail.

* Decode: the shards are cut along the luma block rows. Each holds the
  MCU rows its rows fall in plus a halo of one MCU row across each inner
  edge where the layout upsamples chroma vertically (4:2:0, 4:4:0: the
  triangle filter reads one chroma row across the cut; the other layouts
  need none), decodes them with the layout's kernel, and crops to its
  own pixel rows, so its rows equal the unsharded decode's bit for bit.
* Resize: each shard runs the horizontal AREA pass on its rows and its
  part of the vertical contraction (the columns of the AREA matrix its
  rows feed); the (dst_h, dst_w) f32 partial sums are added on the
  group's first device in shard order, which then rounds and converts,
  transforms and quantizes (or packs).

That re-associates the vertical f32 sums at the cut, as GSPMD does: the
JAX package's tier, quantized coefficients within 1 of the one-device
step and pixels within 1 u8. As in the JAX package, a plane is sp-split
when sp divides its block rows (the still front's: its image rows) and
counts serving.sp_sharded_planes, else serving.sp_fallback_dp_only. A step
splits when sp divides its luma block rows; a chroma plane whose block
rows sp does not divide (4K 4:2:0: 135) then counts the fallback, and the
MCU row a cut falls in is held and decoded by the shards on both sides.
Where the luma rows do not divide, or on the other routes, every plane
runs dp-only and counts the fallback: oriented sources, LINEAR and CUBIC,
chroma_mode="direct", LILLIPUT_FUSED_EXACT, and stills whose crop resizes
by whole factors (the streaming AREA) or not at all.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import pipeline as PL
from ..errors import DecodingFailedError
from ..ops import jpeg_kernels as K
from ..ops import resize as R
from ..ops import resize_tables as T
from ..ops._matmul import matmul
from ..utils import device_key, metrics
from .mesh import (Mesh, _host, check_mesh, join_slots, make_mesh,
                   put_slot, row_bounds, slot_context, to_slot)


class SpGeometry(NamedTuple):
    """An sp route's geometry. The crop (tx, ty, w, h) is in the decoded
    plane's pixels; mh pixel rows make an MCU row (the unit the shards
    split), fy luma block rows make one, halo MCU rows pad each inner
    edge. packed: the planes are cropped to the crop's columns before the
    horizontal pass (the packed tail, the still tail), else the crop folds
    into the horizontal matrix (the 4:2:0 block tail, grayscale)."""
    gray: bool
    h2: bool
    v2: bool
    fy: int
    mh: int
    halo: int
    tx: int
    ty: int
    w: int
    h: int
    packed: bool
    dst_w: int
    dst_h: int


def jpeg_sp_geometry(src_w: int, src_h: int, dst_w: int, dst_h: int,
                     origin, gray: bool, h2: bool, v2: bool) -> SpGeometry:
    """The sp geometry of an upright JPEG decoded from the window whose
    plane origin is origin = (x0, y0)."""
    left, top, w, h = PL.fit_rect(src_w, src_h, dst_w, dst_h)
    fy = 1 if gray else 1 + v2
    return SpGeometry(gray, h2, v2, fy, 8 * fy, int(fy == 2),
                      left - origin[0], top - origin[1], w, h,
                      not gray and not (h2 and v2), dst_w, dst_h)


def jpeg_shards(geom: SpGeometry, luma_rows: int, sp: int) -> List[tuple]:
    """Per sp shard (p0, p1, m0, m1): the pixel rows [p0, p1) it owns, an
    sp-th of the luma block rows (sp must divide them), and the MCU rows
    [m0, m1) it holds: those its rows fall in, plus the halo. A cut inside
    an MCU row (a chroma plane whose block rows sp does not divide) leaves
    that MCU row to the shards on both sides of it."""
    mcu_rows = luma_rows // geom.fy
    k = 8 * (luma_rows // sp)
    return [(j * k, (j + 1) * k, max(j * k // geom.mh - geom.halo, 0),
             min(-(-(j + 1) * k // geom.mh) + geom.halo, mcu_rows))
            for j in range(sp)]


def shards_of_bounds(geom: SpGeometry, bounds, luma_bounds) -> List[tuple]:
    """jpeg_shards' specs of shard_batch placements split along their rows
    (row_bounds' lists of the chroma and luma planes); ValueError unless
    the luma shards hold fy luma block rows per MCU row of the chroma
    shards' and each holds the halo the route reads."""
    rows = bounds[-1][1]
    if luma_bounds != [tuple(geom.fy * r for r in b) for b in bounds]:
        raise ValueError("luma shards must hold the luma rows of their "
                         "chroma shards' MCU rows")
    if any(h0 > max(r0 - geom.halo, 0) or h1 < min(r1 + geom.halo, rows)
           for r0, r1, h0, h1 in bounds):
        raise ValueError(f"the shards need a halo of {geom.halo} MCU "
                         "row(s) across each inner edge")
    return [(r0 * geom.mh, r1 * geom.mh, h0, h1)
            for r0, r1, h0, h1 in bounds]


@functools.lru_cache(maxsize=256)
def _v_slab(ty: int, h: int, dst_h: int, lin: bool, p0: int, p1: int,
            device: str):
    """The part of the vertical AREA contraction that pixel rows [p0, p1)
    feed: (d0, d1, c0, c1, slab), the slab the nonzero block of the
    embedded matrix's columns [p0, p1) (output rows [d0, d1), rows
    [p0 + c0, p0 + c1)) on `device`; None when the rows feed no output."""
    mv = R.area_matrix_embedded(max(p1, ty + h), ty, h, dst_h, lin)[:, p0:p1]
    rows = np.nonzero(mv.any(axis=1))[0]
    if rows.size == 0:
        return None
    cols = np.nonzero(mv.any(axis=0))[0]
    d0, d1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    return (int(d0), int(d1), int(c0), int(c1), torch.from_numpy(
        np.ascontiguousarray(mv[d0:d1, c0:c1])).to(torch.device(device)))


def _row_partial(geom: SpGeometry, plane: torch.Tensor, p0: int):
    """A shard's (..., rows, W) plane, its first row plane row p0: the
    horizontal AREA pass of the rows that feed the output, then their part
    of the vertical contraction, (d0, d1, (..., d1 - d0, dst_w) f32 partial
    sums), or None."""
    lin = geom.dst_w > geom.w or geom.dst_h > geom.h
    dev = device_key(plane.device)
    v = _v_slab(geom.ty, geom.h, geom.dst_h, lin, p0,
                p0 + plane.shape[-2], dev)
    if v is None:
        return None
    d0, d1, c0, c1, slab = v
    x = plane[..., c0:c1, :]
    if geom.packed:
        x = x[..., geom.tx:geom.tx + geom.w]
        mw = R._embedded_banded(geom.w, 0, geom.w, geom.dst_w, lin, dev)
    else:
        mw = R._embedded_banded(x.shape[-1], geom.tx, geom.w, geom.dst_w,
                                lin, dev)
    x = R._banded_plane_contract(x.to(torch.float32), mw, axis=-1)
    return d0, d1, matmul(slab, x)


def _sum_partials(mesh: Mesh, i: int, partials, shape) -> list:
    """Inside the first slot of dp group i: per plane, the shards' partial
    sums added in shard order into zeros of `shape` (f32)."""
    first = mesh.slot(i, 0)
    outs = []
    for k in range(len(partials[0])):
        acc = torch.zeros(shape, dtype=torch.float32, device=first[0])
        for j, shard in enumerate(partials):
            if shard[k] is not None:
                d0, d1, x = shard[k]
                acc[..., d0:d1, :] += to_slot(x, mesh.slot(i, j), first)
        outs.append(acc)
    return outs


def _decode_rows(geom: SpGeometry, args, plain: bool):
    """A shard's coefficient rows decoded to u8 planes: the layout's
    decode kernel (4:2:0's block-tail planes, the other layouts' packed
    ones), or grayscale's matmul IDCT (dequant_idct_u8)."""
    if geom.gray:
        return (K.dequant_idct_u8(args[0], args[1]),)
    if geom.h2 and geom.v2:
        planes = K.decode_ycc_u8_plane_blocks(*args, True, True, plain)
    else:
        planes = K.decode_ycc_planes(*args, None, None, geom.h2, geom.v2,
                                     plain)
    if planes is None:
        raise DecodingFailedError(
            f"coefficient shapes {tuple(args[0].shape)}/"
            f"{tuple(args[1].shape)} do not fit chroma sampling "
            f"h2={geom.h2} v2={geom.v2}")
    return planes


def sp_jpeg_group(mesh: Mesh, i: int, geom: SpGeometry, shards, inputs,
                  enc, emit: str, plain: bool) -> tuple:
    """dp group i's step split over its sp slots. shards: jpeg_shards'
    (p0, p1, m0, m1) per shard; inputs[j]: shard j's inputs on its slot,
    (ys, qty) or (ys, cbs, crs, qty, qtc) with the coefficients of MCU
    rows [m0, m1). Each shard decodes its MCU rows, crops them to its
    pixel rows and computes its partial sums on its stream; the group's
    first slot adds them and runs the tail with the encode tables enc.
    Returns the step's outputs there."""
    partials = []
    for j, (p0, p1, m0, _) in enumerate(shards):
        with slot_context(*mesh.slot(i, j)):
            planes = _decode_rows(geom, inputs[j], plain)
            lo, hi = p0 - m0 * geom.mh, p1 - m0 * geom.mh
            partials.append([_row_partial(geom, p[..., lo:hi, :], p0)
                             for p in planes])
            shape = (planes[0].shape[0], geom.dst_h, geom.dst_w)
    fused = PL._fused_emit(emit)
    with slot_context(*mesh.slot(i, 0)):
        outs = [torch.clamp(torch.round(o), 0, 255)
                for o in _sum_partials(mesh, i, partials, shape)]
        if geom.gray:
            return PL._emit_post(PL._gray_out(outs[0], enc[0], geom.dst_w,
                                              geom.dst_h, fused), emit)
        return PL._emit_post(PL._encode_or_pack(outs, enc[0], enc[1],
                                                fused), emit)


def _replicate_tables(mesh: Mesh, enc_y: np.ndarray, enc_c: np.ndarray):
    """The encode tables on each distinct device of the mesh, uploaded
    once: {device_key: (luma, chroma) f32}."""
    tables = {}
    for d in mesh.devices.ravel():
        if device_key(d) not in tables:
            tables[device_key(d)] = tuple(
                torch.from_numpy(t.astype(np.float32)).to(d)
                for t in (enc_y, enc_c))
    return tables


def _count(split: bool) -> None:
    """Count one plane of a step on a mesh with sp > 1."""
    metrics.incr("serving.sp_sharded_planes" if split
                 else "serving.sp_fallback_dp_only")


class _ShardedBase:
    """What both sharded fronts share: the mesh, the encode tables on each
    of its devices, and the dp loop."""

    def _init_mesh(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self._dp, self._sp = mesh.shape["dp"], mesh.shape["sp"]
        self._enc = _replicate_tables(mesh, self.enc_qt_y_np,
                                      self.enc_qt_c_np)

    def _run_slots(self, host, step, rows=None) -> PL._SlotOutputs:
        """The step over the mesh. First every slot's inputs are copied on
        its stream (put_slot of each host tensor), so a slot's copy runs
        under the kernels of the slots before it. Without rows (dp only)
        slot (i, 0) holds dp slot i's slice and step(inputs, encode tables)
        runs there, on its stream. With rows, per sp shard j a function
        rows[j](k) -> the rows of host tensor k that shard holds (None:
        all), and step(i, [inputs of slot (i, j) per j], encode tables)
        runs dp group i on its slots. Then the one-device front's current
        stream waits for every slot (its stage clock times them all)."""
        n = host[0].shape[0]
        c = -(-n // self._dp)
        placed = []
        for i in range(self._dp):
            placed.append([])
            for j, rows_j in enumerate(rows or [lambda k: None]):
                d, s = self.mesh.slot(i, j)
                with slot_context(d, s):
                    placed[-1].append([put_slot(t, i * c, c, d, rows_j(k))
                                       for k, t in enumerate(host)])
        slots = [self.mesh.slot(i, 0) for i in range(self._dp)]
        parts = []
        for i, slot in enumerate(slots):
            enc = self._enc[device_key(slot[0])]
            if rows is None:
                with slot_context(*slot):
                    parts.append(step(placed[i][0], enc))
            else:
                parts.append(step(i, placed[i], enc))
        join_slots(slots)
        return PL._SlotOutputs(parts, [max(0, min(c, n - i * c))
                                       for i in range(self._dp)], slots)


class ShardedJpegPipeline(_ShardedBase, PL.JpegTranscodePipeline):
    """JpegTranscodePipeline whose device step runs over a mesh: the batch
    over 'dp' and, on a mesh whose sp > 1, each image's block rows over
    'sp' on the upright AREA routes (the module's docstring). dp meshes
    give the one-device pipeline's bytes; sp carries the ±1 tier.

    Each dp slot runs the one-device step's decode kernel (decode420,
    decode422, decode440 or decode444, or dequant_idct_blocks' u8 epilogue
    for oriented grayscale) on its device and stream; plain=True runs
    their plain versions instead. The batch pads to a multiple of dp by
    repeating its last image, whose outputs are dropped. The encode
    tables are replicated to every device once, at construction.

    mesh: a parallel.Mesh, every visible card by default. device, if
    given, must be the mesh's first device (ValueError otherwise). The
    scans are decoded on the host (the step scatters host arrays to the
    mesh's slots)."""

    _device_entropy = False

    def __init__(self, sample: bytes, dst_w: int, dst_h: int,
                 quality: int = 85, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        mesh = make_mesh() if mesh is None else check_mesh(mesh)
        super().__init__(sample, dst_w, dst_h, quality=quality,
                         device=mesh.front_device(device), **kw)
        self._init_mesh(mesh)

    def _sp_geometry(self, host) -> Optional[SpGeometry]:
        """The step's sp route, or None (dp only). On a mesh with sp > 1 it
        counts each plane: split where sp divides its block rows (the
        step splits when it divides the luma plane's, on an sp route),
        else the fallback."""
        if self._sp == 1:
            return None
        coefs = host[:self.ncomp]
        g = self.geom
        fy = 1 + (g.v2 and self.ncomp == 3)
        split = (self.orientation == 1 and self.method == R.AREA
                 and self.chroma_mode == "rgb"
                 and not R._fused_exact_enabled()
                 and coefs[0].shape[1] == fy * coefs[-1].shape[1]
                 and coefs[0].shape[1] % self._sp == 0)
        for a in coefs:
            _count(split and a.shape[1] % self._sp == 0)
        if not split:
            return None
        return jpeg_sp_geometry(g.width, g.height, self.dst_w, self.dst_h,
                                self.window_static[:2], self.ncomp == 1,
                                g.h2, g.v2)

    def device_step(self, ys, cbs=None, crs=None, qty=None, qtc=None,
                    plain: bool = False) -> PL._SlotOutputs:
        """The batch's step over the mesh, as JpegTranscodePipeline's
        device_step (the same host arrays, one calling convention), every
        slot's work queued asynchronously; returns the _SlotOutputs that
        _fetch copies to the host (gather() puts them on one device)."""
        host = [_host(a) for a in ((ys, cbs) if self.ncomp == 1
                                   else (ys, cbs, crs, qty, qtc))]
        geom = self._sp_geometry(host)
        if geom is None:
            return self._run_slots(host, lambda x, enc: self._dense_step(
                x, enc, plain))
        shards = jpeg_shards(geom, host[0].shape[1], self._sp)

        def rows(m0, m1):       # MCU rows of the coefficients (k < ncomp)
            return lambda k: (None if k >= self.ncomp else
                              ((geom.fy if k == 0 else 1) * m0,
                               (geom.fy if k == 0 else 1) * m1))
        return self._run_slots(
            host, lambda i, x, enc: sp_jpeg_group(
                self.mesh, i, geom, shards, x, enc, self._emit, plain),
            [rows(m0, m1) for _, _, m0, m1 in shards])


class ShardedStillPipeline(_ShardedBase, PL.StillTranscodePipeline):
    """StillTranscodePipeline (non-JPEG stills) whose device step runs over
    a mesh: the pixel batch over 'dp' and, on a mesh whose sp > 1 that
    divides the image height, each image's rows over 'sp' on the upright
    AREA tail (the module's docstring: no halo, the partial sums meet on
    the group's first device). dp meshes give the one-device pipeline's
    bytes; sp carries the ±1 tier. The batch pads to a multiple of dp by
    repeating its last image, whose outputs are dropped.

    mesh: a parallel.Mesh, every visible card by default. device, if
    given, must be the mesh's first device (ValueError otherwise)."""

    def __init__(self, sample: bytes, dst_w: int, dst_h: int,
                 quality: int = 85, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        mesh = make_mesh() if mesh is None else check_mesh(mesh)
        super().__init__(sample, dst_w, dst_h, quality=quality,
                         device=mesh.front_device(device), **kw)
        self._init_mesh(mesh)

    def _sp_geometry(self) -> Optional[SpGeometry]:
        if self._sp == 1:
            return None
        left, top, w, h = PL.fit_rect(self.src_w, self.src_h, self.dst_w,
                                      self.dst_h)
        split = (self.orientation == 1 and self.method == R.AREA
                 and not R._fused_exact_enabled()
                 and (w, h) != (self.dst_w, self.dst_h)
                 and not (w >= self.dst_w and h >= self.dst_h
                          and T.area_is_fast(w, h, self.dst_w, self.dst_h))
                 and self.src_h % self._sp == 0)
        _count(split)
        if not split:
            return None
        return SpGeometry(False, False, False, 1, 1, 0, left, top, w, h,
                          True, self.dst_w, self.dst_h)

    def device_step(self, px) -> PL._SlotOutputs:
        """The pixel batch's step over the mesh; returns _SlotOutputs, as
        ShardedJpegPipeline.device_step."""
        host = [_host(px)]
        geom = self._sp_geometry()
        if geom is None:
            return self._run_slots(host, lambda x, enc: self._dense_step(
                x[0], enc))
        bounds = row_bounds(self.src_h, self._sp)
        return self._run_slots(
            host, lambda i, x, enc: self._sp_still_group(i, x, enc, bounds,
                                                         geom),
            [lambda k, b=b: b[:2] for b in bounds])

    def _sp_still_group(self, i: int, inputs, enc, bounds,
                        geom: SpGeometry) -> tuple:
        """dp group i's images with their rows split over its sp slots
        (inputs[j]: shard j's rows, bounds row_bounds'): each shard's
        channels through the horizontal pass and its part of the vertical
        one, summed on the first slot, rounded to u8 as the one-device
        resize does, then the still tail with the encode tables enc."""
        partials = []
        for j, (r0, _, _, _) in enumerate(bounds):
            with slot_context(*self.mesh.slot(i, j)):
                chans = inputs[j][0].movedim(-1, 0)
                partials.append([_row_partial(geom, chans, r0)])
        first = self.mesh.slot(i, 0)
        c = inputs[0][0].shape[0]
        with slot_context(*first):
            out = _sum_partials(self.mesh, i, partials,
                                (self.channels, c, self.dst_h,
                                 self.dst_w))[0]
            resized = torch.clamp(torch.round(out), 0, 255).to(
                torch.uint8).movedim(0, -1)
            emit = self._emit
            return PL._emit_post(PL._still_out(
                resized, enc[0], enc[1], self.dst_w, self.dst_h,
                PL._fused_emit(emit)), emit)


def transcode_sharded(bufs: Sequence[bytes], dst_w: int, dst_h: int,
                      quality: int = 85,
                      mesh: Optional[Mesh] = None) -> List[bytes]:
    """One-shot helper: same-geometry JPEGs -> Fit transcodes over the
    mesh (every visible card by default)."""
    pipe = ShardedJpegPipeline(bufs[0], dst_w, dst_h, quality=quality,
                               mesh=mesh)
    return pipe.transcode(bufs)
