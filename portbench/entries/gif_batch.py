"""Entry: pipeline.transcode_gif_batch in a closed loop.

One client that always has its next call ready: the cell's animations go
to ``transcode_gif_batch(..., fit=True)`` again and
again until the window's time is up; the window ends when the last call
returns. The call groups the animations by canvas and frame bucket, so
the frame counts of the traffic set the groups and their padded lanes.

In a traced run each call is marked as the profiler range
``portbench.transcode_gif_batch`` and timed on the host clock, and
nothing else changes: the call runs its host and device stages as it
serves them, overlapped, without the program's stage clock (whose CUDA
events synchronise after every device stage).
"""

from __future__ import annotations

import time
from typing import Dict, List

from portbench.entries import Window, refuse_unread, span


class Entry:
    def __init__(self, config: Dict, traffic: Dict, inputs: Dict, device):
        from lilliput_tpu_torch import pipeline
        refuse_unread(traffic, ())
        self.bufs = inputs["bufs"]
        self.frames = [len(s["frames"]) for s in inputs["sources"]]
        self.slot_source = list(range(len(self.bufs)))
        self.dst = (config["dst_w"], config["dst_h"])
        self.file_type = config["output"]
        self.device = device
        self.spans: Dict[str, List[float]] = {}
        self._call = pipeline.transcode_gif_batch

    def _once(self) -> list:
        return self._call(self.bufs, *self.dst, fit=True,
                          file_type=self.file_type,
                          device=self.device)

    def warm(self) -> None:
        self._once()

    def instrument(self) -> None:
        self._once = span("transcode_gif_batch", self._once, self.spans)

    def window(self, seconds: float) -> Window:
        outputs, units, failed = [], 0, 0
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        while time.perf_counter() < deadline:
            try:
                outs = self._once()
            except Exception as e:  # noqa: BLE001 - a failed call counts
                outs = [e] * len(self.bufs)
            outputs.append(outs)
            for o, n in zip(outs, self.frames):
                if isinstance(o, bytes) and o:
                    units += n
                else:
                    failed += 1
        elapsed = time.perf_counter() - t0
        return Window(seconds=elapsed, units=units,
                      attempted=len(outputs) * len(self.bufs), failed=failed,
                      calls=len(outputs), outputs=outputs,
                      slot_source=self.slot_source)

    def close(self) -> None:
        self._call = None
