"""Device meshes and the sharded JPEG Fit step (the counterpart of
``lilliput_tpu/parallel/mesh.py``).

The JAX package lets GSPMD partition one jitted program over a
``jax.sharding.Mesh``. torch has no GSPMD, so the port writes the split
out:

* data parallelism ('dp'): the batch splits into dp contiguous slices,
  padded to a multiple of dp by repeating its last image; each slice is
  copied to its slot's device and runs the one-device step there, and the
  outputs come back in order. Requests never split, so the bytes equal
  the one-device step's.
* spatial parallelism ('sp'): each image's rows split over the sp slots of
  its dp group, each shard with an explicit halo, and the resize's
  partial sums meet on the group's first device (``serving.py``).

A ``Mesh`` is a (dp, sp) grid of indexed torch devices. A device may
repeat (one card standing in for several): each slot still gets a CUDA
stream of its own, so the slots' work can overlap on one card as on
many. A slot's work is issued under ``slot_context(*mesh.slot(i, j))``,
every slot from one host thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import device_key, resolve_device


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device(device_key(dev))
    return dev


class Mesh:
    """A (dp, sp) grid of torch devices: ``devices`` (a numpy object array
    of indexed devices), ``shape`` ({"dp": dp, "sp": sp}) and
    ``axis_names`` ("dp", "sp"), as the JAX mesh has. ``slot(i, j)`` is
    the (device, CUDA stream) slot (i, j) issues its work on; the stream
    is the slot's own (None on the CPU)."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence[torch.device], sp: int = 1):
        dp = len(devices) // sp
        self.devices = np.empty((dp, sp), dtype=object)
        for k, d in enumerate(devices):
            self.devices[k // sp, k % sp] = d
        self.shape = {"dp": dp, "sp": sp}
        self._streams: dict = {}

    @property
    def size(self) -> int:
        return self.devices.size

    def slot(self, i: int, j: int = 0) -> Tuple[torch.device, object]:
        d = self.devices[i, j]
        if d.type != "cuda":
            return d, None
        s = self._streams.get((i, j))
        if s is None:
            s = self._streams[(i, j)] = torch.cuda.Stream(device=d)
        return d, s

    def front_device(self, device=None) -> torch.device:
        """The device a front built on this mesh runs its host-facing work
        on: the first slot's. A device= that names another raises
        ValueError: a front never falls back from its mesh."""
        first = self.devices[0, 0]
        if device is not None and _indexed(device) != first:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {first}")
        return first

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """(dp, sp) mesh over the first n_devices of `devices`, by default
    every visible card (cuda:0 .. cuda:N-1; it raises without one and never
    falls back to the CPU). devices may repeat one device, e.g.
    [torch.device("cpu")] * 8 for the CPU tests or ["cuda:0"] * 4 for the
    multi-slot paths on one card. Raises ValueError when sp does not divide
    the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh(devices=...) "
                               "builds a mesh of other devices")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devs)} given")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len(devs) % sp:
        raise ValueError(f"{len(devs)} devices not divisible by sp={sp}")
    return Mesh(devs, sp)


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a lilliput_tpu_torch.parallel.Mesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    return mesh


def slot_context(device, stream):
    """Issue work on a slot's device and stream (nothing to switch on the
    CPU, or for a one-device front's stream None)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def to_slot(t: torch.Tensor, src, dst) -> torch.Tensor:
    """Tensor t, made on slot src = (device, stream), for use on slot dst,
    inside dst's slot_context. On one device dst's stream waits for src's
    (and the allocator keeps t for dst's stream); across devices the copy
    runs on src's stream, after the work that made t, and dst's stream
    waits for it."""
    (ds, ss), (dd, sd) = src, dst
    if ds == dd:
        if ss is not None and ss is not sd:
            sd.wait_stream(ss)
            t.record_stream(sd)
        return t
    with contextlib.nullcontext() if ss is None else torch.cuda.stream(ss):
        return t.to(dd, non_blocking=True)


def join_slots(slots) -> None:
    """The current stream of the first slot's device waits for every
    slot's stream: work queued there after this (a CUDA event that times
    a step) orders after all of theirs. No host sync."""
    dev0 = slots[0][0]
    for _, s in slots:
        if s is not None:
            torch.cuda.current_stream(dev0).wait_stream(s)


def _host(arr) -> torch.Tensor:
    """A host batch as a CPU tensor sharing its memory (a pinned pooled
    array stays pinned)."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def put_slot(t: torch.Tensor, a: int, c: int, device,
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Images a .. a+c-1 of host batch t on `device`, those past the
    batch's end repeating its last image; non-blocking from pinned memory.
    The real images copy as one contiguous slice and the repeats expand on
    the device. rows=(h0, h1): those rows of each image's axis 1 only, one
    contiguous copy per image (a strided copy would stage through pageable
    memory)."""
    n = t.shape[0]
    b = min(a + c, n)
    if rows is None:
        x = (t[a:b] if b > a else t[n - 1:n]).to(device, non_blocking=True)
    else:
        h0, h1 = rows
        idx = list(range(a, b)) or [n - 1]
        x = torch.empty((len(idx), h1 - h0) + tuple(t.shape[2:]),
                        dtype=t.dtype, device=device)
        for k, i in enumerate(idx):
            x[k].copy_(t[i, h0:h1], non_blocking=True)
    if x.shape[0] < c:
        x = torch.cat([x, x[-1:].expand((c - x.shape[0],)
                                        + tuple(x.shape[1:]))])
    return x


def row_bounds(rows: int, sp: int, halo: int = 0) -> List[tuple]:
    """Per sp shard (r0, r1, h0, h1): the rows it owns and the rows it
    holds, `halo` more across each inner edge. ValueError unless sp
    divides rows."""
    if rows % sp:
        raise ValueError(f"{rows} rows do not divide over sp={sp}")
    k = rows // sp
    return [(j * k, (j + 1) * k, max(j * k - halo, 0),
             min((j + 1) * k + halo, rows)) for j in range(sp)]


@dataclasses.dataclass
class Shards:
    """A batch placed on a mesh (shard_batch): parts[i, j] is the tensor
    slot (i, j) holds; n the batch's requests, per_slot the images of each
    dp slot (the last slots' tail repeats the batch's last image); bounds
    row_bounds' list along axis 1 when it is split over sp, else None."""
    parts: np.ndarray
    n: int
    per_slot: int
    bounds: Optional[List[tuple]]


def shard_batch(mesh: Mesh, arr, spatial_axis: Optional[int] = None,
                halo: int = 0) -> Shards:
    """Place a (B, ...) host batch on the mesh: the batch over 'dp'
    (put_slot's slices, each copied on its slot's stream) and, with
    spatial_axis=1 on a mesh whose sp > 1, the rows of each image over
    'sp', each shard holding `halo` rows more across each inner edge
    (row_bounds); without it each slot of a dp group holds the group's
    whole slice, as the JAX package's P("dp") replicates over 'sp'."""
    t = _host(arr)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    n = t.shape[0]
    c = -(-n // dp)
    bounds = None
    if spatial_axis is not None and sp > 1:
        if spatial_axis != 1:
            raise ValueError("shard_batch splits axis 1 (the rows) over sp")
        bounds = row_bounds(t.shape[1], sp, halo)
    parts = np.empty((dp, sp), dtype=object)
    for i in range(dp):
        for j in range(sp):
            d, s = mesh.slot(i, j)
            with slot_context(d, s):
                parts[i, j] = put_slot(
                    t, i * c, c, d,
                    None if bounds is None else bounds[j][2:])
    return Shards(parts, n, c, bounds)


def replicate(mesh: Mesh, arr) -> np.ndarray:
    """`arr` on every slot's device: a (dp, sp) object array of tensors,
    one copy per distinct device."""
    t = _host(arr)
    copies: dict = {}
    out = np.empty(mesh.devices.shape, dtype=object)
    for (i, j), d in np.ndenumerate(mesh.devices):
        key = device_key(d)
        if key not in copies:
            copies[key] = t.to(d)
        out[i, j] = copies[key]
    return out


def sharded_transcode_step(mesh: Mesh, src_w: int, src_h: int, h2: bool,
                           v2: bool, dst_w: int, dst_h: int):
    """The fused JPEG Fit transcode of whole coefficient frames over the
    mesh (the port's _jpeg_fit_stages, AREA, upright, encode
    coefficients). Returns step(yc, cb, cr, qt_y, qt_c, eqt_y, eqt_c) ->
    (yq, cbq, crq), the dp-ordered outputs of the batch's requests on the
    mesh's first device. yc, cb and cr are shard_batch placements; on a
    mesh with sp > 1 each is split along its block rows with the halo the
    layout's upsample reads (halo=2 luma and 1 chroma block rows for
    4:2:0), or not split at all (dp only). The tables are replicate()
    placements, or shard_batch ones of per-image tables."""
    from .serving import jpeg_sp_geometry, shards_of_bounds, sp_jpeg_group
    from ..pipeline import _jpeg_fit_stages, _SlotOutputs
    fx, fy = 1 + h2, 1 + v2

    def part(x, i, j):
        return (x.parts if isinstance(x, Shards) else x)[i, j]

    def step(yc, cb, cr, qt_y, qt_c, eqt_y, eqt_c):
        split = cb.bounds is not None
        ybh, ybw = yc.parts[0, 0].shape[1:3]
        cbh, cbw = cb.parts[0, 0].shape[1:3]
        if split:
            ybh, cbh = yc.bounds[-1][1], cb.bounds[-1][1]
            geom = jpeg_sp_geometry(src_w, src_h, dst_w, dst_h, (0, 0),
                                    False, h2, v2)
            shards = shards_of_bounds(geom, cb.bounds, yc.bounds)
        window = (0, 0, min(ybw * 8, cbw * 8 * fx), min(ybh * 8,
                                                         cbh * 8 * fy))
        parts, slots = [], []
        for i in range(mesh.shape["dp"]):
            slot = mesh.slot(i, 0)
            enc = (part(eqt_y, i, 0), part(eqt_c, i, 0))
            if split:
                parts.append(sp_jpeg_group(
                    mesh, i, geom, shards,
                    [[part(x, i, j) for x in (yc, cb, cr, qt_y, qt_c)]
                     for j in range(len(shards))], enc, "coefs", False))
            else:
                with slot_context(*slot):
                    parts.append(_jpeg_fit_stages(
                        *[part(x, i, 0) for x in (yc, cb, cr, qt_y, qt_c)],
                        *enc, src_w=src_w, src_h=src_h, dst_w=dst_w,
                        dst_h=dst_h, window=window, h2=h2, v2=v2).run())
            slots.append(slot)
        c = yc.per_slot
        return _SlotOutputs(parts, [max(0, min(c, yc.n - i * c))
                                    for i in range(len(slots))],
                            slots).gather()
    return step
