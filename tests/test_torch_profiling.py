"""The port's utils/profiling.py and utils/logging.py on the CPU against the
JAX package's:

* measure_device_stages on 4:2:0, grayscale and chroma_mode="direct"
  JpegTranscodePipelines returns the JAX function's keys and puts each
  device.* stage the JAX function records in the registry once (direct:
  no decode stage, in both), with positive times;
* device_trace writes a Chrome trace that holds the enclosed step's ops;
* the port's _KVFormatter formats LogRecords (with and without key=value
  fields) to the JAX formatter's strings, and get_logger/kv log through
  the "lilliput" logger."""

import json
import logging

import cv2
import numpy as np
import pytest

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
    assert set(got) == set(want)
    assert got["batch"] == want["batch"] == 2
    assert ("decode_ms" in got) == (mode != "direct")
    assert all(v > 0 for k, v in got.items() if k.endswith("_ms"))
    stages = reg.snapshot()["stages"]
    assert set(stages) == set(jreg.snapshot()["stages"])
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
        "device.decode": 1, "device.full_step": 1, "device.dispatch": 1,
        "device.fetch": 1}


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
