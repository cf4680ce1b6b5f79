"""The port's utils/profiling.py and utils/logging.py on the CPU against the
JAX package's:

* measure_device_stages on 4:2:0, grayscale and chroma_mode="direct"
  JpegTranscodePipelines returns the JAX function's keys, and the resize
  and encode stages besides (and decode for "direct", which the JAX
  function leaves out), and puts each device.* stage in the registry
  once, with positive times;
* on every JPEG path of chip_smoke.PATHS, at a small geometry, each
  stage measure_device_stages times outputs the tensors device_step
  computes at the same point (atol 0), the decode stage of the kernel
  paths equals the plain decode, and the chained stages equal
  device_step's outputs;
* device_trace writes a Chrome trace that holds the enclosed step's ops,
  with its kernel records against its launches; trace_records counts a
  synthetic event list with and without dropped records, inside the
  profiled window only, unmatched_launches names the launches without a
  record, and profile_complete opens a fresh session after one that
  dropped records and raises RecordsDropped after a second;
* the port's _KVFormatter formats LogRecords (with and without key=value
  fields) to the JAX formatter's strings, and get_logger/kv log through
  the "lilliput" logger."""

import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch

from lilliput_tpu import pipeline as JP
from lilliput_tpu.utils import logging as JL
from lilliput_tpu.utils.metrics import Metrics as JMetrics
from lilliput_tpu.utils.profiling import \
    measure_device_stages as jax_measure_device_stages
from lilliput_tpu_torch import JpegTranscodePipeline
from lilliput_tpu_torch import utils as TU
from lilliput_tpu_torch.utils import logging as TL
from lilliput_tpu_torch.utils import profiling as TPROF


def _jpeg(gray: bool) -> bytes:
    rng = np.random.default_rng(0)
    img = cv2.resize(rng.integers(0, 256, (10, 10, 3), np.uint8), (320, 200),
                     interpolation=cv2.INTER_CUBIC)
    if gray:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 88])[1] \
        .tobytes()


MODES = {"420": (False, {}), "gray": (True, {}),
         "direct": (False, {"chroma_mode": "direct"})}


@pytest.mark.parametrize("mode", list(MODES))
def test_measure_device_stages_keys_equal_jax(mode):
    gray, kw = MODES[mode]
    buf = _jpeg(gray)
    jreg, reg = JMetrics(), TU.Metrics()
    want = jax_measure_device_stages(
        JP.JpegTranscodePipeline(buf, 64, 64, quality=85, **kw), [buf] * 2,
        iters=1, registry=jreg)
    pipe = JpegTranscodePipeline(buf, 64, 64, quality=85, device="cpu", **kw)
    assert pipe.chroma_mode == ("direct" if kw else "rgb")
    got = TU.measure_device_stages(pipe, [buf] * 2, iters=2, registry=reg)
    extra = {"resize_ms", "encode_ms"} | (
        {"decode_ms"} if mode == "direct" else set())
    assert set(got) - set(want) == extra and set(want) <= set(got)
    assert got["batch"] == want["batch"] == 2
    assert ("decode_ms" in want) == (mode != "direct")
    assert all(v > 0 for k, v in got.items() if k.endswith("_ms"))
    stages = reg.snapshot()["stages"]
    assert set(stages) == set(jreg.snapshot()["stages"]) | {
        "device." + k[:-3] for k in extra}
    assert all(s["count"] == 1 for s in stages.values())
    assert stages["device.full_step"]["mean_ms"] == pytest.approx(
        got["full_step_ms"], abs=1e-3)


def test_measure_device_stages_default_registry():
    buf = _jpeg(False)
    TU.metrics.reset()
    pipe = JpegTranscodePipeline(buf, 32, 32, device="cpu")
    TU.measure_device_stages(pipe, [buf], iters=1)
    assert {k: v["count"] for k, v in
            TU.metrics.snapshot()["stages"].items()} == {
        "device.decode": 1, "device.resize": 1, "device.encode": 1,
        "device.full_step": 1, "device.dispatch": 1, "device.fetch": 1}


#: chip_smoke.PATHS at a small geometry: (layout, orientation,
#: JpegTranscodePipeline keywords, environment)
SPLIT_PATHS = {
    "420": ("420", 1, {}, {}),
    "422": ("422", 1, {}, {}),
    "440": ("440", 1, {}, {}),
    "444": ("444", 1, {}, {}),
    "gray": ("gray", 1, {}, {}),
    "gray_o6": ("gray", 6, {}, {}),
    "420_o6": ("420", 6, {}, {}),
    "420_direct": ("420", 1, {"chroma_mode": "direct"}, {}),
    "420_direct_s2": ("420", 1, {"chroma_mode": "direct", "dct_scale": 2},
                      {}),
    "420_linear": ("420", 1, {"method": "linear"}, {}),
    "444_cubic": ("444", 1, {"method": "cubic"}, {}),
    "420_exact": ("420", 1, {}, {"LILLIPUT_FUSED_EXACT": "1"}),
    "420_png": ("420", 1, {"output_format": ".png"}, {}),
    "gray_o6_png": ("gray", 6, {"output_format": ".png"}, {}),
}


def _split_source(layout: str, orientation: int) -> bytes:
    from tests import _torch_parity as TPAR
    if layout == "gray":
        buf = TPAR.gray_jpeg(150, 110, 85, 3)
    else:
        buf = TPAR.layout_jpeg(150, 110, 85, 3, sub=layout)
    return TPAR.with_orientation(buf, orientation) if orientation != 1 \
        else buf


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("path", list(SPLIT_PATHS))
def test_stage_outputs_equal_device_step(path, monkeypatch):
    """Each stage measure_device_stages times is the step's own work:
    its output equals the tensor device_step computes at that point."""
    from lilliput_tpu_torch import pipeline as TPL
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    layout, orientation, kw, env = SPLIT_PATHS[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    buf = _split_source(layout, orientation)
    pipe = JpegTranscodePipeline(buf, 48, 40, quality=85, device="cpu",
                                 **kw)
    assert pipe.orientation == orientation
    bufs = [buf, buf[:2] + buf[2:]]
    kept = {}
    split = pipe.device_stages

    def keeping(dev, enc, plain=False):
        """pipe.device_stages, keeping each stage's last output."""
        def keep(name, fn):
            def run(*x):
                kept[name] = fn(*x)
                return kept[name]
            return run
        return TPL._Stages(*(keep(n, f) for n, f in zip(
            TPL._Stages._fields, split(dev, enc, plain))))
    pipe.device_stages = keeping
    got = TU.measure_device_stages(pipe, bufs, iters=1,
                                   registry=TU.Metrics())
    del pipe.device_stages
    assert {"decode_ms", "resize_ms", "encode_ms"} <= set(got)
    seen = {}

    def spy(self):
        seen["decode"] = self.decode()
        seen["resize"] = self.resize(seen["decode"])
        seen["encode"] = self.encode(seen["resize"])
        return seen["encode"]
    coefs = pipe.decode_entropy(bufs)
    want = pipe.device_step(*coefs)
    monkeypatch.setattr(TPL._Stages, "run", spy)
    step = pipe.device_step(*coefs)
    assert _same(step, want)
    for name in ("decode", "resize", "encode"):
        assert _same(kept[name], seen[name]), name
    resized = kept["resize"]
    planes = [resized] if isinstance(resized, torch.Tensor) else resized
    for p in planes:
        assert p.shape[0] == 2 and p.shape[-2:] in (
            (40, 48), (20, 24)), (path, p.shape)
    if layout != "gray" and "chroma_mode" not in kw:
        g = pipe.geom
        dev = [pipe._to_device(a) for a in coefs]
        if orientation != 1:
            rh, rw = g.height, g.width
        else:
            rw, rh = pipe.window_static[2:4]
        ref = K.decode_ycc_420(*dev, rh, rw, g.h2, g.v2, plain=True)
        dec = kept["decode"]
        if g.h2 and g.v2 and orientation == 1 and "method" not in kw:
            dec = [p[..., :rh, :rw] for p in dec]
        else:
            left, top, w, h = TPL.fit_rect(g.width, g.height, 48, 40)
            x0, y0 = pipe.window_static[:2] if orientation == 1 else (0, 0)
            if orientation == 1 and "method" not in kw:
                ref = [p[..., top - y0:top - y0 + h, left - x0:left - x0 + w]
                       for p in ref]
        assert _same(list(dec), list(ref)), path


def test_trace_records_counts_launches_and_kernels():
    def launch(c, name="cudaLaunchKernel"):
        return {"cat": "cuda_runtime", "name": name, "ts": c,
                "args": {"correlation": c}}

    def kernel(c):
        return {"cat": "kernel", "name": f"k{c}", "ts": c + 5,
                "args": {"correlation": c}}
    every = [launch(c) for c in range(10)] + [kernel(c) for c in range(10)]
    assert TU.trace_records(every) == TU.TraceRecords(10, 10)
    assert TU.trace_records(every).complete
    # a session that lost its first 4 device records
    dropped = [e for e in every if not (e["cat"] == "kernel"
                                        and e["args"]["correlation"] < 4)]
    rec = TU.trace_records(dropped)
    assert rec == TU.TraceRecords(6, 10) and not rec.complete
    # cuLaunchKernel counts; a kernel of a launch outside the session and
    # other runtime calls do not; a memcpy counts as a copy
    other = every + [launch(20, "cuLaunchKernel"), kernel(20), kernel(30),
                     {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1,
                      "args": {"correlation": 31}},
                     {"cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                      "ts": 1, "args": {"correlation": 31}},
                     {"cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                      "ts": 2, "args": {"correlation": 32}}]
    assert TU.trace_records(other) == TU.TraceRecords(11, 11, 1, 1)
    assert TU.trace_records(other).complete
    assert TU.trace_records([]) == TU.TraceRecords(0, 0)
    assert str(TU.TraceRecords(6, 10, 1, 2)) == (
        "6 kernel records of 10 launches, 1 copy records of 2 copies")


def _copy(c, name, ts, record=True):
    call = {"cat": "cuda_runtime", "name": name, "ts": ts,
            "args": {"correlation": c}}
    cat = "gpu_memset" if "Memset" in name else "gpu_memcpy"
    rec = {"cat": cat, "name": cat, "ts": ts + 5, "args": {"correlation": c}}
    return [call, rec] if record else [call]


def test_trace_records_counts_dropped_copies():
    """A session that kept every kernel record but lost its copies'
    records is not complete: busy shares are read from every device
    record, memcpys and memsets included."""
    ev = _session(9, 9)
    ev += (_copy(100, "cudaMemcpyAsync", 30)
           + _copy(101, "cudaMemsetAsync", 31)
           + _copy(102, "cudaMemcpy", 32))
    rec = TU.trace_records(ev, TPROF.WINDOW)
    assert rec == TU.TraceRecords(9, 9, 3, 3) and rec.complete
    assert TU.unmatched_launches(ev, TPROF.WINDOW) == []
    lost = _session(9, 9) + (
        _copy(100, "cudaMemcpyAsync", 30, record=False)
        + _copy(101, "cudaMemsetAsync", 31, record=False)
        + _copy(102, "cudaMemcpy", 32))
    rec = TU.trace_records(lost, TPROF.WINDOW)
    assert rec == TU.TraceRecords(9, 9, 1, 3) and not rec.complete
    assert TU.unmatched_launches(lost, TPROF.WINDOW) == [
        "cudaMemcpyAsync at 30 (in aten::add_)",
        "cudaMemsetAsync at 31 (in aten::add_)"]
    # a copy before the window (the burn-in's) counts without the window
    early = _session(9, 9) + _copy(103, "cudaMemcpyAsync", 2, record=False)
    assert TU.trace_records(early, TPROF.WINDOW).complete
    assert TU.trace_records(early) == TU.TraceRecords(9, 10, 0, 1)


def _session(kernels, launches, window=True):
    """A synthetic session: `launches` kernel launches inside the profile
    window, the first launches - kernels of them without a record, and a
    burn-in launch before the window whose record was dropped."""
    ev = [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1,
           "args": {"correlation": 999}}]
    if window:
        ev.append({"cat": "user_annotation", "name": TPROF.WINDOW,
                   "ts": 10, "dur": 1000})
    ev.append({"cat": "cpu_op", "name": "aten::add_", "ts": 10, "dur": 500})
    for c in range(launches):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": 20 + c, "args": {"correlation": c}})
        if c >= launches - kernels:
            ev.append({"cat": "kernel", "name": f"k{c}", "ts": 600 + c,
                       "args": {"correlation": c}})
    return ev


def test_trace_records_counts_the_window_only():
    ev = _session(9, 9)
    assert TU.trace_records(ev, TPROF.WINDOW) == TU.TraceRecords(9, 9)
    # the burn-in launch before the window counts without the window
    assert TU.trace_records(ev) == TU.TraceRecords(9, 10)
    assert TU.unmatched_launches(ev, TPROF.WINDOW) == []
    assert TU.unmatched_launches(ev) == [
        "cudaLaunchKernel at 1 (in -)"]
    dropped = _session(6, 9)
    assert TU.trace_records(dropped, TPROF.WINDOW) == TU.TraceRecords(6, 9)
    assert TU.unmatched_launches(dropped, TPROF.WINDOW) == [
        f"cudaLaunchKernel at {20 + c} (in aten::add_)" for c in range(3)]


def test_profile_complete_retries_then_raises(monkeypatch):
    calls = []
    answers = iter([_session(5, 9), _session(9, 9)])
    monkeypatch.setattr(TPROF, "session_events",
                        lambda prof, log_dir=None: (None, next(answers)))
    tr = TU.profile_complete(lambda: calls.append(1))
    assert tr.records == TU.TraceRecords(9, 9) and len(calls) == 2
    assert tr.profile is not None and tr.path is None and tr.missing == []
    calls.clear()
    answers = iter([_session(5, 9), _session(7, 9)])
    with pytest.raises(TU.RecordsDropped,
                       match="5 kernel records of 9 launches, 0 copy "
                             "records of 0 copies; 7 kernel records of 9 "
                             "launches, 0 copy records of 0 copies; "
                             r"without a record: \['cudaLaunchKernel at 20 "
                             r"\(in aten::add_\)', "):
        TU.profile_complete(lambda: calls.append(1))
    assert len(calls) == 2
    # a session that lost only its copies' records is thrown away too
    calls.clear()
    answers = iter([_session(9, 9) + _copy(7, "cudaMemcpyAsync", 40, False),
                    _session(9, 9) + _copy(7, "cudaMemcpyAsync", 40)])
    tr = TU.profile_complete(lambda: calls.append(1))
    assert tr.records == TU.TraceRecords(9, 9, 1, 1) and len(calls) == 2
    answers = iter([_session(9, 9) + _copy(7, "cudaMemcpyAsync", 40, False)
                    for _ in range(2)])
    with pytest.raises(TU.RecordsDropped,
                       match="9 kernel records of 9 launches, 0 copy "
                             "records of 1 copies; .*without a record: "
                             r"\['cudaMemcpyAsync at 40 \(in aten::add_\)'"):
        TU.profile_complete(lambda: calls.append(1))


def test_profile_complete_on_the_cpu():
    seen = []
    tr = TU.profile_complete(lambda: seen.append(
        torch.ones(4).add_(1).sum()))
    assert tr.records == TU.TraceRecords(0, 0) and tr.records.complete
    assert seen and tr.path is None
    assert any(e.name.startswith("aten::") for e in tr.profile.events())


def test_profile_complete_writes_the_kept_trace(tmp_path, monkeypatch):
    """With log_dir, the kept session's trace is written there (the
    trace a session exports once) and a dropped session's is removed."""
    tr = TU.profile_complete(lambda: torch.ones(4).add_(1),
                             log_dir=str(tmp_path / "t"))
    assert tr.path.startswith(str(tmp_path / "t"))
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert tr.records == TU.trace_records(events, TPROF.WINDOW)
    assert any(e.get("name") == TPROF.WINDOW for e in events)
    real = TPROF.session_events
    answers = iter([_session(5, 9), _session(9, 9)])

    def dropping_first(prof, log_dir=None):
        path, _ = real(prof, log_dir)
        return path, next(answers)
    monkeypatch.setattr(TPROF, "session_events", dropping_first)
    tr = TU.profile_complete(lambda: None, log_dir=str(tmp_path / "u"))
    assert os.listdir(tmp_path / "u") == [os.path.basename(tr.path)]


def test_device_trace_writes_a_trace(tmp_path):
    buf = _jpeg(False)
    pipe = JpegTranscodePipeline(buf, 32, 32, device="cpu")
    coefs = pipe.decode_entropy([buf])
    with TU.device_trace(str(tmp_path / "trace")) as tr:
        pipe.device_step(*coefs)
    assert tr.log_dir == str(tmp_path / "trace")
    assert tr.path.startswith(tr.log_dir) and tr.path.endswith(".json")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert tr.profile.key_averages()
    assert tr.records == TU.trace_records(events, TPROF.WINDOW)
    assert tr.records.complete and tr.missing == []
    assert any(e.get("name") == TPROF.WINDOW for e in events)


def test_device_trace_default_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with TPROF.device_trace() as tr:
        np.zeros(4).sum()
    assert tr.log_dir == str(tmp_path / "lilliput_trace")
    assert tr.path.startswith(tr.log_dir)


def _record(msg, args=(), kv=None, level=logging.WARNING):
    rec = logging.LogRecord("lilliput.test", level, __file__, 12, msg, args,
                            None)
    rec.created = 1_800_000_000.25
    if kv is not None:
        rec.kv = kv
    return rec


@pytest.mark.parametrize("msg,args,kv,level", [
    ("plain", (), None, logging.WARNING),
    ("with %s args", ("two",), None, logging.INFO),
    ("fields", (), {"batch": 128, "ms": 1.5, "fmt": ".jpeg"}, logging.ERROR),
    ("quote ' and \"", (), {}, logging.DEBUG)])
def test_kv_formatter_equal_jax(msg, args, kv, level):
    got = TL._KVFormatter().format(_record(msg, args, kv, level))
    assert got == JL._KVFormatter().format(_record(msg, args, kv, level))
    assert got.startswith("ts=") and f"level={logging.getLevelName(level)}" \
        .lower() in got


def test_get_logger_and_kv():
    log = TU.get_logger("lilliput.pipeline")
    assert log is logging.getLogger("lilliput.pipeline")
    root = logging.getLogger("lilliput")
    assert root.propagate is False
    assert any(isinstance(h.formatter, (TL._KVFormatter, JL._KVFormatter))
               for h in root.handlers)
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(TL._KVFormatter().format(record))
    h = Keep()
    root.addHandler(h)
    old = root.level
    root.setLevel(logging.INFO)
    try:
        TL.kv(log, logging.INFO, "step", batch=2, ms=3.25)
    finally:
        root.removeHandler(h)
        root.setLevel(old)
    assert seen and seen[0].endswith(
        "logger=lilliput.pipeline msg='step' batch=2 ms=3.25")
