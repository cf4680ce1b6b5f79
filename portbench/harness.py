"""The benchmark's run: set-up, the measured window, the check, the result.

Everything a cell needs is found by name, so a cell, configuration,
metric, input maker or roofline is added as files and entries only:

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names, and the metrics with the cells that report them;
* ``portbench/configs/<config>.json``: the deployment (sizes, quality,
  output), its ``entry`` and its ``reference``;
* ``portbench/workloads/<cell>.json``: the input ``maker`` and its
  ``inputs``, the ``traffic`` (batch), and the ``check`` (sample size and
  the limit of each compared number);
* ``portbench/entries/<entry>.py``, ``portbench/inputs/<maker>.py``,
  ``portbench/reference/<reference>.py``: code found by those names;
* ``portbench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``
  returning the value or None when it finds nothing to read. Every
  metric BENCHMARK.json lists for the cell has to read something: one
  that gives None ends the run without a result.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
#: top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lilliput_tpu")


class RunError(RuntimeError):
    """The run cannot give a result (no card, a forbidden module, ...)."""


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell `name`: its BENCHMARK.json entry, configuration, workload
    file and the metrics it reports, by kind."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    pkg = os.path.join(root, "portbench")
    config = _json(os.path.join(pkg, "configs", cell["config"] + ".json"))
    workload = _json(os.path.join(pkg, "workloads", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return SimpleNamespace(name=name, chips=cell["chips"], config=config,
                           workload=workload, end_to_end=e2e,
                           per_layer=per_layer, root=pkg)


def reader(pkg: str, metric: str):
    """The reader module of a metric: portbench/metrics/<metric>.py."""
    path = os.path.join(pkg, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def unstable_outputs(win) -> int:
    """Outputs that differ from their slot's output in the first call
    (the program is deterministic: one slot, one source, one answer)."""
    first = win.outputs[0]
    return sum(1 for outs in win.outputs[1:] for a, b in zip(outs, first)
               if isinstance(a, bytes) and a != b)


def sampled_outputs(win, n_sources: int, sample: int,
                    seed: int) -> Dict[int, bytes]:
    """One output for each of `sample` sources drawn from the seed, each
    from a call drawn from the seed (a failed output stays in, as an
    exception, and fails the check)."""
    rng = np.random.default_rng([seed % (1 << 63), 2024])
    picks = rng.choice(n_sources, size=min(sample, n_sources), replace=False)
    out = {}
    for src in sorted(int(p) for p in picks):
        slots = [j for j, s in enumerate(win.slot_source) if s == src]
        call = int(rng.integers(len(win.outputs)))
        out[src] = win.outputs[call][slots[int(rng.integers(len(slots)))]]
    return out


def judge(cell, inputs: Dict, win, seed: int, device) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} of every number the cell compares."""
    ref = importlib.import_module(
        "portbench.reference." + cell.config["reference"])
    check = cell.workload["check"]
    outs = sampled_outputs(win, len(inputs["sources"]), check["sample"],
                           seed)
    numbers = {"failed": win.failed, "unstable_outputs": unstable_outputs(win)}
    if any(not isinstance(o, bytes) for o in outs.values()):
        numbers.update({k: 1.0 for k in check["limits"] if k not in numbers})
    else:
        numbers.update(ref.check(inputs["sources"], outs, cell.config,
                                 device))
    limits = dict(check["limits"], failed=0, unstable_outputs=0)
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def run(name: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", root: str = ROOT) -> Dict:
    """One run of cell `name`; t0 is the process's start on the host
    clock. Returns the result line's object (without printing it)."""
    import torch
    marks = [("imports", time.perf_counter())]
    cell = load_cell(name, root)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise RunError(f"cell {name} needs {cell.chips} CUDA device(s); "
                       f"{torch.cuda.device_count()} available")
    maker = importlib.import_module(
        "portbench.inputs." + cell.workload["maker"])
    inputs = maker.make(cell.workload["inputs"], seed, device)
    marks.append(("inputs", time.perf_counter()))
    entry_mod = importlib.import_module(
        "portbench.entries." + cell.config["entry"])
    entry = entry_mod.Entry(cell.config, cell.workload["traffic"], inputs,
                            device)
    marks.append(("pipeline", time.perf_counter()))
    entry.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("setup: " + ", ".join(
        f"{k} {b - a:.3f} s" for (k, b), (_, a) in zip(
            marks, [("", t0)] + marks[:-1])), file=sys.stderr)
    tr = None
    if trace:
        entry.instrument()
        if cuda:
            from portbench.trace import traced
            win, tr = traced(lambda: entry.window(seconds))
        else:
            win = entry.window(seconds)
    else:
        win = entry.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = SimpleNamespace(cell=cell, window=win, setup_s=setup_s, trace=tr,
                          spans=getattr(entry, "spans", {}),
                          shapes=getattr(entry, "shapes", []),
                          device_name=(torch.cuda.get_device_name(0)
                                       if cuda else "cpu"),
                          pkg=cell.root)
    metrics, silent = {}, []
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"]).read(ctx)
        if value is None:
            silent.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if silent:
        # a metric listed for this cell lost what it reads (a stage the
        # entry wraps, a kernel's name, the card's peaks)
        raise RunError(f"metrics of cell {name} read nothing: {silent}")
    entry.close()
    del entry
    if cuda:
        torch.cuda.empty_cache()
    checks = judge(cell, inputs, win, seed, device)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx.device_name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv: Optional[List[str]] = None, t0: float = 0.0) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t0)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules the run loaded: {bad}", file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
