"""The benchmark of lilliput_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the program's kernels, the inputs made from the seed,
the pipeline, the warm-up of the cell's own shapes) is timed as setup_s
from the start of this process; then the closed loop runs for --seconds;
then the outputs are judged against the plain reference. The last line
of standard output is the result; the compared numbers and their limits
are the last lines of standard error. Needs a CUDA card.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "portbench", "_cache", sub)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
