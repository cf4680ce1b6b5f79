"""Device tracing and per-stage device timing.

The counterpart of ``lilliput_tpu/utils/profiling.py`` in torch's idiom:

* ``device_trace`` records the enclosed work with ``torch.profiler`` (CPU
  activity, and CUDA activity where a card is) and writes a Chrome trace
  under its directory, viewable in Perfetto or ``chrome://tracing``.
* ``measure_device_stages`` splits a JpegTranscodePipeline's device step
  into decode, full step, dispatch and fetch times and records them as
  ``device.*`` stages in the metrics registry, the device-side complement
  to the host stage times ``transcode`` records. On a card CUDA events
  time every stage, recorded after the last op of the stage has been
  queued, so each output is written before its stop event (eager torch
  materializes every op: no barrier is needed, and no chained checksum
  stands in for a stage). On the CPU the host clock times them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

from .metrics import Metrics, metrics


@dataclasses.dataclass
class DeviceTrace:
    """What device_trace yields: its directory, the torch profiler (for
    key_averages() and events()), and the trace file, set on exit."""
    log_dir: str
    profile: object = None
    path: Optional[str] = None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record the enclosed work with torch.profiler and write a Chrome
    trace, <log_dir>/lilliput_<pid>_<ns>.pt.trace.json, on exit. log_dir
    defaults to lilliput_trace in the temporary directory. Yields a
    DeviceTrace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "lilliput_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace = DeviceTrace(log_dir)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            # a synchronized op first: on the H100 machine a session opened
            # in a process that has run for minutes may drop its first
            # device records; this made it rarer there, not impossible
            # (tools/torch_profiler_drops.py)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        trace.profile = prof
        yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace.path = os.path.join(
        log_dir, f"lilliput_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(trace.path)


def _stage_ms(fn, cuda: bool) -> float:
    """The ms of fn(): CUDA events around it on a card, the host clock
    elsewhere."""
    if cuda:
        import torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def measure_device_stages(pipe, bufs: Sequence[bytes], iters: int = 3,
                          registry: Optional[Metrics] = None) -> Dict:
    """Per-stage device timing of a JpegTranscodePipeline batch.

    After a warm call, the minimum over `iters` calls of each stage feeds
    the ``device.decode``, ``device.full_step``, ``device.dispatch`` and
    ``device.fetch`` reservoirs of the registry (seconds, as the JAX
    package records them), and the returned dict holds "batch" and
    "decode_ms", "full_step_ms", "dispatch_ms", "fetch_ms".

    decode: the pipeline's decode route on coefficients already on the
    device: the layout's decode kernel (decode_kernels.decode4xx through
    jpeg_kernels.decode_ycc_420) for colour pipelines, dequant_idct (the
    dequant_idct_blocks kernel on a card) for grayscale; chroma_mode
    "direct" reports the full step and fetch only (its decode is the
    fused resample), as the JAX function does.
    full_step: device_step from the call, through _fetch and _to_host of
    its outputs; dispatch is the part until device_step returns and fetch
    the rest. On a card the three are CUDA events recorded at the call,
    at device_step's return (after every op of the step has been queued)
    and after the D2H copies, so dispatch is the step's device time,
    uploads included, and fetch the copies'."""
    import torch

    from ..ops import jpeg_kernels as K

    reg = registry if registry is not None else metrics
    cuda = pipe.device.type == "cuda"
    coefs = pipe.decode_entropy(bufs)
    out: Dict = {"batch": len(bufs)}

    def record(name, ms):
        reg.observe(f"device.{name}", ms / 1e3)
        out[name + "_ms"] = round(ms, 3)

    def timed(name, fn):
        fn()    # warm
        record(name, min(_stage_ms(fn, cuda) for _ in range(iters)))

    g = pipe.geom
    if pipe.ncomp == 1:
        ys, qty = (pipe._to_device(a) for a in coefs)
        timed("decode", lambda: K.dequant_idct(ys, qty))
    elif pipe.chroma_mode != "direct":
        ys, cbs, crs, qty, qtc = (pipe._to_device(a) for a in coefs)
        rh = min(ys.shape[-3] * 8, cbs.shape[-3] * 16)
        rw = min(ys.shape[-2] * 8, cbs.shape[-2] * 16)
        timed("decode", lambda: K.decode_ycc_420(ys, cbs, crs, qty, qtc, rh,
                                                 rw, g.h2, g.v2))

    def full_step():
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            arrs = pipe.device_step(*coefs)
            ev[1].record()
            fetch = pipe._fetch(arrs)
            ev[2].record()
            pipe._to_host(fetch)
            ev[2].synchronize()
            return (ev[0].elapsed_time(ev[2]), ev[0].elapsed_time(ev[1]),
                    ev[1].elapsed_time(ev[2]))
        t0 = time.perf_counter()
        arrs = pipe.device_step(*coefs)
        t1 = time.perf_counter()
        pipe._to_host(pipe._fetch(arrs))
        t2 = time.perf_counter()
        return 1e3 * (t2 - t0), 1e3 * (t1 - t0), 1e3 * (t2 - t1)

    full_step()    # warm
    best = min((full_step() for _ in range(iters)), key=lambda t: t[0])
    for name, ms in zip(("full_step", "dispatch", "fetch"), best):
        record(name, ms)
    return out
