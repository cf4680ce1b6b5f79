"""Readings that set a cell's limits: the program's sound runs and the
control, on many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds <n>... \
        [--program-seconds <s>]

For each seed, one line of JSON: the numbers a run of the program
compares (harness.run with a window of --program-seconds, 0 to skip),
and the control's: the cell's reference put in the program's place,
computed in bfloat16 (the configuration states float32), on the same
sampled sources, its outputs judged by the same check. The benchmark's
runs do not run this; it needs a CUDA card.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_numbers(cell, inputs, seed: int, device, dtype) -> dict:
    """The compared numbers of the reference computed in `dtype`, in the
    program's place, on the sources a run of `seed` samples."""
    import numpy as np
    ref = importlib.import_module(
        "portbench.reference." + cell.config["reference"])
    n = len(inputs["sources"])
    rng = np.random.default_rng([seed % (1 << 63), 2024])
    picks = rng.choice(n, size=min(cell.workload["check"]["sample"], n),
                       replace=False)
    outs = {int(i): ref.emit(inputs["sources"][int(i)], cell.config, dtype,
                             device) for i in sorted(picks)}
    return ref.check(inputs["sources"], outs, cell.config, device)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program-seconds", type=float, default=3.0)
    args = p.parse_args()
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    maker = importlib.import_module(
        "portbench.inputs." + cell.workload["maker"])
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        if args.program_seconds > 0:
            out = harness.run(args.workload, seed, args.program_seconds,
                              False, time.perf_counter(), "cuda")
            line["program"] = {k: v["value"]
                               for k, v in out["checks"].items()}
            line["correct"] = out["correct"]
        inputs = maker.make(cell.workload["inputs"], seed, "cuda")
        line["control"] = control_numbers(cell, inputs, seed, "cuda",
                                          torch.bfloat16)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
