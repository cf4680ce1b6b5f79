"""Device tracing and per-stage device timing.

The counterpart of ``lilliput_tpu/utils/profiling.py`` in torch's idiom:

* ``device_trace`` records the enclosed work with ``torch.profiler`` (CPU
  activity, and CUDA activity where a card is) and writes a Chrome trace
  under its directory, viewable in Perfetto or ``chrome://tracing``, with
  the count of its device records against its kernel launches and
  copies (``trace_records``) after a burn-in; ``profile_complete`` runs a
  function in sessions until one keeps a record of every one.
* ``measure_device_stages`` splits a JpegTranscodePipeline's device step
  into decode, resize, encode, full step, dispatch and fetch times (the
  counterpart of the JAX package's tools/profile_stages.py split and of
  its utils.profiling function) and records them as
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
import json
import os
import tempfile
import time
from typing import Dict, NamedTuple, Optional, Sequence

from .metrics import Metrics, metrics


#: the record_function window around a session's work: only the launches
#: inside it are counted (the burn-in before it is not)
WINDOW = "lilliput.profiled"
#: one-element kernels a session runs, synchronized, before its work
BURN_IN = 64


class TraceRecords(NamedTuple):
    """A torch.profiler session's device records against the calls it
    recorded on the host: kernel records against kernel launches, and
    memcpy/memset records against cudaMemcpy*/cudaMemset* calls. On the
    H100 machine a session opened late in a long process may keep fewer
    records than calls: it lost its first device records
    (tools/torch_profiler_drops.py), kernels or copies, so no busy share
    or event count may be read from it."""
    kernels: int
    launches: int
    copies: int = 0
    copy_calls: int = 0

    @property
    def complete(self) -> bool:
        return self.kernels >= self.launches and \
            self.copies >= self.copy_calls

    def __str__(self) -> str:
        return (f"{self.kernels} kernel records of {self.launches} "
                f"launches, {self.copies} copy records of "
                f"{self.copy_calls} copies")


class RecordsDropped(RuntimeError):
    """Every torch.profiler session tried dropped device records."""


#: device record categories, and the runtime calls each answers
_KERNEL, _COPY = ("kernel",), ("gpu_memcpy", "gpu_memset")


def _is_copy_call(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name


def _window_calls(events, window: Optional[str]):
    """The kernel launches and the memcpy/memset calls recorded on the
    host (cuda_runtime events), those inside the record_function `window`
    where one is named: (launches, copy calls)."""
    lo, hi = -float("inf"), float("inf")
    if window is not None:
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("name") == window
                 and e.get("cat") == "user_annotation"]
        if spans:
            lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and lo <= e.get("ts", 0) <= hi]
    return ([e for e in calls if "LaunchKernel" in e.get("name", "")],
            [e for e in calls if _is_copy_call(e.get("name", ""))])


def _correlations(events, cats):
    return {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in cats}


def trace_records(events, window: Optional[str] = None) -> TraceRecords:
    """Count a Chrome trace's events (its "traceEvents"): the kernel
    launches and memcpy/memset calls recorded on the host, inside the
    record_function `window` where one is named, and the device records
    correlated with one of them (kernels with launches, as
    tools/torch_profiler_drops.py counts them, and copies with copy
    calls)."""
    launches, copies = (
        {e["args"]["correlation"] for e in calls}
        for calls in _window_calls(events, window))
    return TraceRecords(len(_correlations(events, _KERNEL) & launches),
                        len(launches),
                        len(_correlations(events, _COPY) & copies),
                        len(copies))


def unmatched_launches(events, window: Optional[str] = None):
    """'call at ts (inside cpu op)' of each kernel launch and copy call
    of trace_records' count that has no device record."""
    launches, copies = _window_calls(events, window)
    recorded = (_correlations(events, _KERNEL), _correlations(events, _COPY))
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    out = []
    for calls, seen in zip((launches, copies), recorded):
        for e in calls:
            if e["args"]["correlation"] in seen:
                continue
            ts = e.get("ts", 0)
            inner = [o for o in ops if o["ts"] <= ts <= o["ts"] + o["dur"]]
            op = min(inner, key=lambda o: o["dur"])["name"] if inner else "-"
            out.append(f"{e['name']} at {ts} (in {op})")
    return out


def session_events(prof, log_dir: Optional[str] = None):
    """(path, events) of a finished torch.profiler session's Chrome trace
    (a session exports its trace once): written to
    <log_dir>/lilliput_<pid>_<ns>.pt.trace.json where log_dir is given,
    else through a file in the temporary directory that is removed (path
    None)."""
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"lilliput_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    else:
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return (path if log_dir is not None else None,
                    json.load(f)["traceEvents"])
    finally:
        if log_dir is None:
            os.remove(path)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    if torch.cuda.is_available():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _burn_in() -> None:
    """A session's first work on a card: BURN_IN one-element kernels,
    synchronized. A session opened late in a long process may drop its
    first device records, up to 34 of them on the H100 machine; after a
    burn-in of 64 it kept every record of the work in every session tried
    (tools/torch_profiler_drops.py). The sessions are counted all the
    same."""
    import torch
    if torch.cuda.is_available():
        x = torch.zeros(1, device="cuda")
        for _ in range(BURN_IN):
            x.add_(1)
        torch.cuda.synchronize()


@dataclasses.dataclass
class DeviceTrace:
    """A traced session: its directory, the torch profiler (for
    key_averages() and events()), and, once the session ends, the trace
    file, its TraceRecords of the launches and copies inside the
    session's window (check records.complete before reading counts or
    busy shares from it), and unmatched_launches' list of the calls
    without a device record."""
    log_dir: Optional[str]
    profile: object = None
    path: Optional[str] = None
    records: Optional[TraceRecords] = None
    missing: Optional[list] = None

    def _finish(self, prof) -> None:
        self.profile = prof
        self.path, events = session_events(prof, self.log_dir)
        self.records = trace_records(events, WINDOW)
        self.missing = unmatched_launches(events, WINDOW)


def profile_complete(fn, attempts: int = 2,
                     log_dir: Optional[str] = None) -> DeviceTrace:
    """Run fn() in a torch.profiler session opened as device_trace opens
    it (a burn-in, then fn in the WINDOW record_function), and return the
    DeviceTrace of the first session that kept a device record of every
    kernel launch and copy in the window; its trace is written to log_dir
    as device_trace writes its own where log_dir is given (path None
    otherwise). A session that dropped records is thrown away (its trace
    file too) and fn runs again in a fresh one, up to `attempts` sessions
    in all; then RecordsDropped names each session's counts and the last
    one's calls without a record."""
    import torch
    from torch.profiler import profile, record_function
    seen, missing = [], []
    for _ in range(attempts):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with profile(activities=_activities()) as prof:
            _burn_in()
            with record_function(WINDOW):
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        trace = DeviceTrace(log_dir)
        trace._finish(prof)
        if trace.records.complete:
            return trace
        if trace.path is not None:
            os.remove(trace.path)
        seen.append(trace.records)
        missing = trace.missing
    raise RecordsDropped(
        "torch.profiler dropped device records in every session: " +
        "; ".join(map(str, seen)) + f"; without a record: {missing[:8]}")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record the enclosed work with torch.profiler and write a Chrome
    trace, <log_dir>/lilliput_<pid>_<ns>.pt.trace.json, on exit. log_dir
    defaults to lilliput_trace in the temporary directory. Yields a
    DeviceTrace."""
    import torch
    from torch.profiler import profile, record_function
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "lilliput_trace")
    trace = DeviceTrace(log_dir)
    with profile(activities=_activities()) as prof:
        _burn_in()
        trace.profile = prof
        with record_function(WINDOW):
            yield trace
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    trace._finish(prof)


def _stage_ms(fn, cuda: bool):
    """(ms, output) of fn(): CUDA events around it on a card, recorded
    after fn has queued its last op, the host clock elsewhere."""
    if cuda:
        import torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), res
    t0 = time.perf_counter()
    res = fn()
    return 1e3 * (time.perf_counter() - t0), res


def measure_device_stages(pipe, bufs: Sequence[bytes], iters: int = 3,
                          registry: Optional[Metrics] = None) -> Dict:
    """Per-stage device timing of a JpegTranscodePipeline batch.

    After a warm call, the minimum over `iters` calls of each stage feeds
    the ``device.decode``, ``device.resize``, ``device.encode``,
    ``device.full_step``, ``device.dispatch`` and ``device.fetch``
    reservoirs of the registry (seconds, as the JAX package records
    them), and the returned dict holds "batch" and the "<stage>_ms" of
    each.

    decode, resize, encode: the pipeline's own step, split by
    JpegTranscodePipeline.device_stages, on the batch's inputs already on
    the device, each stage on the output of the one before: decode is the
    layout's decode kernel (decode420/422/440/444, dequant_idct_blocks for
    oriented grayscale), or the IDCTs as torch matmuls (upright grayscale,
    chroma_mode "direct" at every dct_scale); resize the orientation, crop
    and resize; encode the colour conversion, 4:2:0 downsample and
    fDCT/quantization, or the pixel pack (and the yuv420 emit) of .png and
    .webp output. Chained, they are device_step's work after its uploads.
    The JAX function reports no decode for chroma_mode "direct";
    this one reports its IDCTs.
    full_step: device_step from the call, through _fetch and _to_host of
    its outputs; dispatch is the part until device_step returns and fetch
    the rest. On a card the three are CUDA events recorded at the call,
    at device_step's return (after every op of the step has been queued)
    and after the D2H copies, so dispatch is the step's device time,
    uploads included, and fetch the copies'."""
    import torch

    reg = registry if registry is not None else metrics
    cuda = pipe.device.type == "cuda"
    coefs = pipe.decode_entropy(bufs)
    out: Dict = {"batch": len(bufs)}

    def record(name, ms):
        reg.observe(f"device.{name}", ms / 1e3)
        out[name + "_ms"] = round(ms, 3)

    def timed(name, fn):
        fn()    # warm
        runs = [_stage_ms(fn, cuda) for _ in range(iters)]
        record(name, min(ms for ms, _ in runs))
        return runs[-1][1]

    stages = pipe.device_stages([pipe._to_device(a) for a in coefs],
                                (pipe.enc_qt_y, pipe.enc_qt_c))
    planes = timed("decode", stages.decode)
    resized = timed("resize", lambda: stages.resize(planes))
    timed("encode", lambda: stages.encode(resized))

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
