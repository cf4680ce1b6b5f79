"""Entry: JpegTranscodePipeline.transcode_pipelined in a closed loop.

One client that always has its next batch ready: a generator hands the
pipeline the cell's batch until the window's time is up, and the
pipeline's double buffering overlaps batch i's device step with the host
decode of batch i+1 and the host encode of batch i-1. The window ends
when the call returns, after the last batch's encode.

In a traced run the pipeline instance's public stages are wrapped:
``decode_entropy`` (the host entropy decode), ``device_step`` (the
uploads and the device step's dispatch) and ``encode_entropy`` (the host
Huffman encode) are timed on the host clock and marked as profiler
ranges, and the shapes decode_entropy hands the device are kept for the
rooflines.
"""

from __future__ import annotations

import time
from typing import Dict, List

from portbench.entries import Window, refuse_unread, span


class Entry:
    def __init__(self, config: Dict, traffic: Dict, inputs: Dict, device):
        from lilliput_tpu_torch.pipeline import JpegTranscodePipeline
        refuse_unread(traffic, ("batch",))
        bufs = inputs["bufs"]
        n = traffic["batch"]
        self.slot_source: List[int] = [i % len(bufs) for i in range(n)]
        self.batch = [bufs[i] for i in self.slot_source]
        self.pipe = JpegTranscodePipeline(
            bufs[0], config["dst_w"], config["dst_h"],
            quality=config["quality"], method=config["method"],
            optimize_coding=config["optimize_coding"],
            output_format=config["output"], device=device)
        self.spans: Dict[str, List[float]] = {}
        self.shapes: List[tuple] = []

    def warm(self) -> None:
        """The cell's batch shape through the whole loop: the first
        batch alone and the pipelined pair."""
        self.pipe.transcode_pipelined([self.batch, self.batch])

    def instrument(self) -> None:
        pipe = self.pipe
        decode = pipe.decode_entropy

        def decode_and_keep_shapes(*args, **kw):
            out = decode(*args, **kw)
            self.shapes.append(tuple((tuple(x.shape), x.dtype.itemsize)
                                     for x in out))
            return out
        pipe.decode_entropy = span("decode_entropy", decode_and_keep_shapes,
                                   self.spans)
        for name in ("device_step", "encode_entropy"):
            setattr(pipe, name, span(name, getattr(pipe, name), self.spans))

    def window(self, seconds: float) -> Window:
        batches = [0]
        deadline = time.perf_counter() + seconds

        def feed():
            while time.perf_counter() < deadline:
                batches[0] += 1
                yield self.batch
        t0 = time.perf_counter()
        results = self.pipe.transcode_pipelined(feed(),
                                                return_exceptions=True)
        elapsed = time.perf_counter() - t0
        flat = [o for batch in results for o in batch]
        failed = sum(1 for o in flat if not isinstance(o, bytes) or not o)
        return Window(seconds=elapsed, units=len(flat) - failed,
                      attempted=len(flat), failed=failed, calls=batches[0],
                      outputs=results, slot_source=self.slot_source)

    def close(self) -> None:
        del self.pipe
