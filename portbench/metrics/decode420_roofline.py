"""decode420_roofline (%): the least time the card could take for one
decode420 launch's work (portbench/roofline/decode420.py, at the
data-sheet peaks of portbench/peaks.json) over the mean decode420 kernel
record of the traced window. None (and so no result) where the trace
has no decode420 record, no batch shapes were seen, or the card has no
peaks entry."""

import importlib.util
import json
import os


def read(ctx):
    if ctx.trace is None or not ctx.shapes:
        return None
    durs = [d for name, _, d in ctx.trace.kernels if "decode420" in name]
    with open(os.path.join(ctx.pkg, "peaks.json")) as f:
        peaks = json.load(f).get(ctx.device_name)
    if not durs or peaks is None:
        return None
    path = os.path.join(ctx.pkg, "roofline", "decode420.py")
    spec = importlib.util.spec_from_file_location("roofline_decode420", path)
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    least, _ = roof.least_seconds(ctx.shapes[-1], peaks)
    return 100.0 * least / (sum(durs) / len(durs) / 1e6)
