"""Entry: StillTranscodePipeline.transcode_pipelined in a closed loop.

The loop of ``jpeg_pipelined`` (its warm-up, window and close) around
the still serving front: one client that always has its next batch
ready, and the front's double buffering overlaps batch i's device step
with the host decode (inflate, unfilter, pixels into a pinned batch) of
batch i+1 and the host encode of batch i-1. The window ends when the
call returns, after the last batch's encode.

Nothing of the program is wrapped, in a traced run either: the cell's
per-layer readers read the program's own span log (portbench/spans.py),
whose decode and encode spans carry the PNG stage counts.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.entries import jpeg_pipelined, refuse_unread


class Entry(jpeg_pipelined.Entry):
    def __init__(self, config: Dict, traffic: Dict, inputs: Dict, device):
        from lilliput_tpu_torch.framebuffer import PNG_COMPRESSION
        from lilliput_tpu_torch.pipeline import StillTranscodePipeline
        refuse_unread(traffic, ("batch",))
        bufs = inputs["bufs"]
        n = traffic["batch"]
        self.slot_source: List[int] = [i % len(bufs) for i in range(n)]
        self.batch = [bufs[i] for i in self.slot_source]
        self.pipe = StillTranscodePipeline(
            bufs[0], config["dst_w"], config["dst_h"],
            quality=config["quality"], method=config["method"],
            optimize_coding=config["optimize_coding"],
            output_format=config["output"],
            encode_options={PNG_COMPRESSION: config["png_compression"]},
            device=device)

    def instrument(self) -> None:
        """Nothing to wrap: the readers read the program's spans."""
